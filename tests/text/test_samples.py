"""Shared-prefill parallel sampling (``generate_tokens_samples``): n samples
of ONE prompt must be token-identical to ``generate_tokens_batch`` over n
copies of that prompt (same seed) — the only difference is that the prompt is
prefilled once and its KV cache fans out to the n rows."""

from types import SimpleNamespace

import jax
import pytest

from pytorch_models_tpu.models.text._decoder_lm import DecoderLMConfig, decoder_lm_init
from pytorch_models_tpu.text import DecoderGenerator


class _Tok:
    def __init__(self, eos=-1):
        self.eos_token_id = eos

    def encode(self, s):
        return [3, 1, 4, 1, 5]

    def decode(self, ids):
        return " ".join(map(str, ids))


@pytest.fixture(scope="module")
def gen():
    cfg = DecoderLMConfig(vocab_size=512, max_seq_len=128, n_layers=2,
                          d_model=128, pre_norm=True, final_norm=True)
    params = decoder_lm_init(jax.random.PRNGKey(0), cfg)
    return DecoderGenerator(SimpleNamespace(cfg=cfg, params=params), _Tok())


PROMPT = [3, 1, 4, 1, 5]


@pytest.mark.parametrize("kw", [dict(topk=8), dict(topk=1, top_p=0.9),
                                dict(topk=16, temperature=0.7)])
def test_samples_match_batched_copies(gen, kw):
    n = 3
    batch = gen.generate_tokens_batch([PROMPT] * n, max_tokens=16, seed=11, **kw)
    samples = gen.generate_tokens_samples(PROMPT, n, max_tokens=16, seed=11, **kw)
    assert samples == batch


def test_samples_are_distinct_draws(gen):
    """Random-init logits are extreme (top-1 gap ~80), so flatten hard with
    temperature to show the n rows draw independently."""
    samples = gen.generate_tokens_samples(PROMPT, 4, max_tokens=16, topk=64,
                                          seed=3, temperature=20.0)
    assert len({tuple(s) for s in samples}) > 1, "independent rows should diverge"


def test_greedy_samples_all_identical(gen):
    samples = gen.generate_tokens_samples(PROMPT, 3, max_tokens=12, topk=1)
    assert samples[0] == samples[1] == samples[2]
    assert samples[0] == gen.generate_tokens(PROMPT, max_tokens=12)


def test_samples_eos_rows_stop_independently(gen):
    base = gen.generate_tokens_samples(PROMPT, 4, max_tokens=20, topk=32, seed=5)
    eos = base[0][5 + 6]
    g_eos = DecoderGenerator(gen.model, _Tok(eos=eos))
    batch = g_eos.generate_tokens_batch([PROMPT] * 4, max_tokens=20, topk=32, seed=5)
    samples = g_eos.generate_tokens_samples(PROMPT, 4, max_tokens=20, topk=32, seed=5)
    assert samples == batch


def test_samples_fused_interpret_path(gen, request):
    """The fanned-out rows decode through the Triton decode kernel
    (interpret mode) token-identically to the einsum path."""
    plain = gen.generate_tokens_samples(PROMPT, 2, max_tokens=8, topk=8, seed=2)
    calls = request.getfixturevalue("decode_kernel_interpret")
    assert gen.generate_tokens_samples(PROMPT, 2, max_tokens=8, topk=8, seed=2) == plain
    assert calls["traces"] > 0
