"""int8 KV serving modes end-to-end (USE_INT8_KV / USE_INT8_KV_CROSS): the
Whisper and T5 generators quantize their caches and decode over them,
dequantizing on read. The attention math is pinned against fp32 attention
over the dequantized caches by tests/ops/test_int8_kv.py; these check the
generator plumbing (quantize-at-encode, decode-loop routing) runs, reads the
int8 caches, and is deterministic. Token identity with bf16 is NOT expected.
"""

import numpy as np
import pytest

from pytorch_models_tpu.audio2text import Whisper, WhisperGenerator
from pytorch_models_tpu.text import T5Generator, T5Model

INIT, EOT = [50, 51, 52], 99


@pytest.fixture(scope="module")
def whisper():
    return Whisper(vocab_size=100, n_layers=2, d_model=128, n_mels=80)


def _audios(seed):
    rng = np.random.default_rng(seed)
    return np.stack([(rng.standard_normal(16000 * 30) * 0.1).astype(np.float32)
                     for _ in range(2)])


def _check_whisper(gen, audios):
    a = gen.transcribe_tokens_batch(audios, INIT, EOT, max_tokens=10)
    assert a == gen.transcribe_tokens_batch(audios, INIT, EOT, max_tokens=10)
    for out in a:
        assert out[:3] == INIT and all(0 <= t < 100 for t in out)


def _check_t5(gen):
    prompts = [[5, 6, 7, 1], [8, 9, 1]]
    a = gen.generate_tokens_batch(prompts, 10, 0, 1)
    assert a == gen.generate_tokens_batch(prompts, 10, 0, 1)
    for out in a:
        assert out[0] == 0 and all(0 <= t < 120 for t in out)


def _t5():
    model = T5Model(vocab_size=120, dim=128, n_heads=2, n_layers=2, mlp_dim=256)
    return T5Generator(model=model, tokenizer=object())


def test_whisper_int8_cross_generation(whisper, int8_modes):
    reads = int8_modes(cross_kv=True)
    _check_whisper(WhisperGenerator(whisper), _audios(3))
    assert reads["n"] > 0


def test_t5_int8_cross_generation(int8_modes):
    reads = int8_modes(cross_kv=True)
    _check_t5(_t5())
    assert reads["n"] > 0


def test_t5_int8_self_and_cross_generation(int8_modes):
    """Full int8 serving for T5: self-KV (with the rel-pos bias on the
    dequantized path) + cross caches quantized."""
    reads = int8_modes(self_kv=True, cross_kv=True)
    _check_t5(_t5())
    assert reads["n"] > 0


def test_whisper_int8_self_generation(whisper, int8_modes):
    """Whisper int8 self-KV: the batched loop quantizes the prefilled cache
    once and every step writes quantized."""
    reads = int8_modes(self_kv=True)
    _check_whisper(WhisperGenerator(whisper), _audios(5))
    assert reads["n"] > 0
