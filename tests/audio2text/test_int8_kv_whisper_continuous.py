"""int8 self+cross KV in the whisper continuous-batching pool: the pool's
self caches quantize per admission (bf16 scratch prefill -> one commit) and
each segment's cross K/V quantizes once at admission — the plain generator's
quantization points — so pooled transcripts must be TOKEN-IDENTICAL to
``WhisperGenerator.transcribe_tokens`` under the same USE_INT8_KV /
USE_INT8_KV_CROSS flags (not to bf16; int8 changes numerics by design)."""

import numpy as np
import pytest

from pytorch_models_tpu.audio2text import (
    Whisper,
    WhisperContinuousBatchingGenerator,
    WhisperGenerator,
)

INIT, EOT = [50, 51, 52], 99


@pytest.fixture(scope="module")
def model():
    return Whisper(vocab_size=100, n_layers=2, d_model=128, n_mels=80)


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(11)
    return [(rng.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(4)]


def test_int8_pool_matches_plain_int8(model, audios, int8_modes):
    """Full int8 serving (self + cross) with mid-flight admissions over
    stale quantized state: every transcript matches the plain int8 loop."""
    reads = int8_modes(self_kv=True, cross_kv=True)
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                            pool_ctx=64)
    outs = cb.transcribe_tokens_many(audios, INIT, EOT, max_tokens=14)
    assert reads["n"] > 0
    plain = WhisperGenerator(model)
    assert outs == [plain.transcribe_tokens(a, INIT, EOT, max_tokens=14) for a in audios]


def test_int8_cross_only_pool(model, audios, int8_modes):
    """Cross-only int8 (bf16 self pool): the independent-stream gating."""
    int8_modes(cross_kv=True)
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=5,
                                            pool_ctx=64)
    outs = cb.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=12)
    plain = WhisperGenerator(model)
    assert outs == [plain.transcribe_tokens(a, INIT, EOT, max_tokens=12) for a in audios[:3]]
