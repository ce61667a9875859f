"""int8 self-KV continuous batching: the pool's caches live as per-key int8
(+ scales) and every admission prefills in bf16 on a 1-row scratch,
quantizing ONCE at commit — the same prefill-then-quantize order as the
plain int8 generator (generator.py), so per-request outputs must be
TOKEN-IDENTICAL to ``DecoderGenerator.generate_tokens`` under the same
USE_INT8_KV mode (not to bf16 — int8 changes numerics by design).
"""

from types import SimpleNamespace

import jax
import pytest

from pytorch_models_tpu.models.text._decoder_lm import DecoderLMConfig, decoder_lm_init
from pytorch_models_tpu.text import ContinuousBatchingGenerator, DecoderGenerator


class _Tok:
    def __init__(self, eos=-1):
        self.eos_token_id = eos

    def encode(self, s):
        return [ord(c) % 512 for c in s]

    def decode(self, ids):
        return " ".join(map(str, ids))


@pytest.fixture(scope="module")
def model():
    cfg = DecoderLMConfig(vocab_size=512, max_seq_len=128, n_layers=2,
                          d_model=128, pre_norm=True, final_norm=True)
    return SimpleNamespace(cfg=cfg, params=decoder_lm_init(jax.random.PRNGKey(0), cfg))


PROMPTS = [[3, 1, 4, 1, 5], [2, 7], [9, 2, 6, 5, 3, 5, 8, 9], [11]]


def test_int8_pool_matches_plain_int8_generator(model, int8_modes):
    """Staggered budgets admit mid-flight into slots holding stale int8
    state; every request must match the plain int8 greedy loop exactly."""
    reads = int8_modes(self_kv=True)
    tok = _Tok()
    budgets = [9, 4, 11, 6]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(PROMPTS, budgets)
    assert reads["n"] > 0
    plain = DecoderGenerator(model, tok)
    assert outs == [plain.generate_tokens(r, max_tokens=m) for r, m in zip(PROMPTS, budgets)]


def test_int8_pool_prefix_and_chunked_prefill(model, int8_modes):
    """Shared-prefix paste + a prompt longer than the bucket (chunked
    prefill) both run through the unified int8 admission path."""
    int8_modes(self_kv=True)
    tok = _Tok()
    prefix = [7, 8, 9]
    reqs = [[5, 6], [i * 3 % 512 for i in range(21)], [4]]  # 21 > bucket 16
    budgets = [6, 5, 8]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(reqs, budgets, shared_prefix=prefix)
    plain = DecoderGenerator(model, tok)
    assert outs == [plain.generate_tokens(prefix + r, max_tokens=m)
                    for r, m in zip(reqs, budgets)]
