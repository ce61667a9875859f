"""int8 self-KV serving mode end-to-end: DecoderGenerator with USE_INT8_KV
decodes over quantized caches (prefill quantizes once, decode steps write
quantized, attention dequantizes on read) and produces valid, deterministic
output.

Token identity with bf16 is NOT expected (per-key K/V rounding); the math
itself is pinned against fp32 attention over the dequantized caches in
tests/ops/test_int8_kv.py.
"""

import jax
import pytest

from pytorch_models_tpu.models.text._decoder_lm import DecoderLMConfig, decoder_lm_init
from pytorch_models_tpu.text import DecoderGenerator

VOCAB = 512


class _Tok:
    eos_token_id = -1

    def encode(self, s):
        return [int(t) for t in s.split()]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def gen():
    from types import SimpleNamespace

    cfg = DecoderLMConfig(vocab_size=VOCAB, max_seq_len=128, n_layers=2,
                          d_model=128, pre_norm=True, final_norm=True)
    params = decoder_lm_init(jax.random.PRNGKey(0), cfg)
    return DecoderGenerator(SimpleNamespace(cfg=cfg, params=params), _Tok())


PROMPTS = [[5, 6, 7], [9, 10], [11, 12, 13, 14]]


def test_int8_kv_generation_runs_and_is_deterministic(gen, int8_modes):
    reads = int8_modes(self_kv=True)
    a = gen.generate_tokens_batch(PROMPTS, max_tokens=10)
    assert a == gen.generate_tokens_batch(PROMPTS, max_tokens=10)
    assert reads["n"] > 0
    for p, out in zip(PROMPTS, a):
        assert out[: len(p)] == p
        assert len(out) == len(p) + 10
        assert all(0 <= t < VOCAB for t in out)


def test_int8_kv_tracks_bf16_closely(gen, int8_modes):
    """On a random tiny model the int8 and full-precision greedy streams
    share the same first step (prefill logits are full-precision) and stay
    in-vocab; stronger guarantees come from the dequantized-cache oracles."""
    base = gen.generate_tokens_batch(PROMPTS, max_tokens=10)
    int8_modes(self_kv=True)
    int8_out = gen.generate_tokens_batch(PROMPTS, max_tokens=10)
    for p, a, b in zip(PROMPTS, int8_out, base):
        # the first generated token comes from the (unquantized) prefill
        assert a[len(p)] == b[len(p)]
