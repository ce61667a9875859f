"""Greedy speculative decoding must be token-identical to plain greedy.

The exactness property holds for ANY draft model: accepted drafts equal the
target's argmax by construction and the first mismatch is replaced by the
target's argmax. These tests pin it with a random (low-acceptance) draft, an
identical (full-acceptance) draft, EOS stopping, and several k values.
"""

from types import SimpleNamespace

import jax
import pytest

from pytorch_models_tpu.models.text._decoder_lm import DecoderLMConfig, decoder_lm_init
from pytorch_models_tpu.text import DecoderGenerator, SpeculativeDecoderGenerator


class _Tok:
    def __init__(self, eos=-1):
        self.eos_token_id = eos

    def encode(self, s):
        return [3, 1, 4, 1, 5]

    def decode(self, ids):
        return " ".join(map(str, ids))


def _small(seed, n_layers=2):
    cfg = DecoderLMConfig(vocab_size=512, max_seq_len=128, n_layers=n_layers,
                          d_model=128, pre_norm=True, final_norm=True)
    params = decoder_lm_init(jax.random.PRNGKey(seed), cfg)
    return SimpleNamespace(cfg=cfg, params=params)


@pytest.fixture(scope="module")
def models():
    return _small(0), _small(7)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_matches_plain_greedy_random_draft(models, k):
    target, draft = models
    tok = _Tok()
    base = DecoderGenerator(target, tok).generate_tokens([3, 1, 4, 1, 5], max_tokens=24)
    spec = SpeculativeDecoderGenerator(target, draft, tok, k=k).generate_tokens(
        [3, 1, 4, 1, 5], max_tokens=24)
    assert spec == base


def test_matches_plain_greedy_identical_draft(models):
    target, _ = models
    tok = _Tok()
    base = DecoderGenerator(target, tok).generate_tokens([3, 1, 4, 1, 5], max_tokens=20)
    spec = SpeculativeDecoderGenerator(target, target, tok, k=4).generate_tokens(
        [3, 1, 4, 1, 5], max_tokens=20)
    assert spec == base


def test_eos_stop_matches(models):
    """Pick the plain run's 6th generated token as EOS: both loops must stop
    at its first occurrence with identical output."""
    target, draft = models
    base_full = DecoderGenerator(target, _Tok()).generate_tokens([3, 1, 4, 1, 5], max_tokens=24)
    eos = base_full[5 + 6]  # 6th generated token
    tok = _Tok(eos=eos)
    base = DecoderGenerator(target, tok).generate_tokens([3, 1, 4, 1, 5], max_tokens=24)
    spec = SpeculativeDecoderGenerator(target, draft, tok, k=3).generate_tokens(
        [3, 1, 4, 1, 5], max_tokens=24)
    assert spec == base
    assert spec[-1] == eos and eos not in spec[5:-1]


def test_generate_text_api(models):
    target, draft = models
    out = SpeculativeDecoderGenerator(target, draft, _Tok(), k=2).generate("x", max_tokens=6)
    assert isinstance(out, str) and len(out.split()) == 5 + 6


def test_fused_draft_matches_plain_greedy(models, request):
    """Draft steps and verify chunk with their single-position reads through
    the Triton decode kernel (interpret mode) stay token-identical to plain
    greedy — any draft is exact by construction."""
    target, draft = models
    tok = _Tok()
    base = DecoderGenerator(target, tok).generate_tokens([3, 1, 4, 1, 5], max_tokens=16)
    calls = request.getfixturevalue("decode_kernel_interpret")
    spec = SpeculativeDecoderGenerator(target, draft, tok, k=3).generate_tokens(
        [3, 1, 4, 1, 5], max_tokens=16)
    assert spec == base
    assert calls["traces"] > 0


def test_acceptance_advances_multiple_tokens(models):
    """With draft == target every chunk accepts all k drafts: the loop body
    must be entered ~max_tokens/(k+1) times. Pin that via trace counting on
    the jitted function's cache (cheap proxy: output equality already proves
    correctness; here we just sanity-check the fast path emits k+1/iter)."""
    target, _ = models
    tok = _Tok()
    spec = SpeculativeDecoderGenerator(target, target, tok, k=4)
    out = spec.generate_tokens([3, 1, 4, 1, 5], max_tokens=21)
    assert len(out) == 5 + 21


@pytest.mark.parametrize("k", [2, 4])
def test_batch_matches_plain_greedy_per_row(models, k):
    """Batched speculative rows (differing prompt lengths, per-row acceptance
    and budgets) must each equal the plain greedy decode of that row."""
    target, draft = models
    tok = _Tok()
    prompts = [[3, 1, 4], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2]]
    outs = SpeculativeDecoderGenerator(target, draft, tok, k=k).generate_tokens_batch(
        prompts, max_tokens=20)
    plain = DecoderGenerator(target, tok)
    for p, o in zip(prompts, outs):
        assert o == plain.generate_tokens(p, max_tokens=20)


def test_batch_eos_rows_stop_independently(models):
    """One row hits EOS early while the other runs to budget; both must match
    their single-row plain decodes (the vmapped while_loop freezes done rows)."""
    target, draft = models
    base = DecoderGenerator(target, _Tok()).generate_tokens([3, 1, 4, 1, 5], max_tokens=24)
    eos = base[5 + 4]
    tok = _Tok(eos=eos)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8]]
    outs = SpeculativeDecoderGenerator(target, draft, tok, k=3).generate_tokens_batch(
        prompts, max_tokens=24)
    plain = DecoderGenerator(target, tok)
    for p, o in zip(prompts, outs):
        assert o == plain.generate_tokens(p, max_tokens=24)


def test_batch_identical_draft_full_acceptance(models):
    target, _ = models
    tok = _Tok()
    prompts = [[3, 1, 4, 1, 5], [9, 9, 2]]
    outs = SpeculativeDecoderGenerator(target, target, tok, k=4).generate_tokens_batch(
        prompts, max_tokens=15)
    plain = DecoderGenerator(target, tok)
    for p, o in zip(prompts, outs):
        assert o == plain.generate_tokens(p, max_tokens=15)


def test_buffer_edge_write_preserves_accepted_draft(models):
    """Prompt length 8 + full acceptance (draft==target, k=4) makes the loop
    run its last body at pos == max_seq_len - k, where the correction write
    index pos+n_acc == max_seq_len; dynamic_update_slice clamps that onto the
    last slot, which must NOT stomp the accepted draft living there."""
    target, _ = models
    tok = _Tok()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    base = DecoderGenerator(target, tok).generate_tokens(prompt, max_tokens=120)
    spec = SpeculativeDecoderGenerator(target, target, tok, k=4).generate_tokens(
        prompt, max_tokens=120)
    assert len(spec) >= len(base) - 4 and spec == base[:len(spec)]


def test_truncated_draft_matches_plain_greedy_and_counts_iters(models):
    """Honest draft = first-k layers of the target's own stack
    (truncate_decoder_lm): still token-identical to plain greedy, and the
    stats variant's iteration count yields a sane measured acceptance rate
    (tools/spec_bench.py uses exactly this path for the real operating
    point)."""
    import jax.numpy as jnp
    import numpy as np

    from pytorch_models_tpu.models.text.speculative import (
        _speculative_generate_stats,
        truncate_decoder_lm,
    )

    target = _small(0, n_layers=4)
    tok = _Tok()
    k = 3
    base = DecoderGenerator(target, tok).generate_tokens([3, 1, 4, 1, 5], max_tokens=20)

    dp, dc = truncate_decoder_lm(target.params, target.cfg, 2)
    assert dc.n_layers == 2
    assert jax.tree.leaves(dp["decoder"]["layers"])[0].shape[0] == 2
    # truncated stack shares the target's layer-0 weights exactly
    t0 = jax.tree.leaves(target.params["decoder"]["layers"])[0]
    assert np.array_equal(np.asarray(jax.tree.leaves(dp["decoder"]["layers"])[0][0]),
                          np.asarray(t0[0]))

    n, pad = 5, 8
    buf = np.zeros((pad,), np.int32)
    buf[:n] = [3, 1, 4, 1, 5]
    limit = n + 20
    out, length, n_iters = _speculative_generate_stats(
        target.params, target.cfg, dp, dc, jnp.asarray(buf), n, limit, k, -1)
    out, length, n_iters = np.asarray(out), int(length), int(n_iters)
    assert out[:length].tolist() == base
    emitted = length - (n + 1)
    assert n_iters >= 1
    a = (emitted / n_iters - 1) / k
    assert -1e-9 <= a <= 1.0  # 1 to k+1 tokens per iteration by construction

    # the generator-facing constructor wires the same thing up
    gen = SpeculativeDecoderGenerator.with_truncated_draft(target, tok, 2, k=k)
    assert gen.generate_tokens([3, 1, 4, 1, 5], max_tokens=20) == base


def test_last_accept_rate_stats(models):
    """Greedy generate_tokens records measured acceptance: 1.0 when the
    draft IS the target (every chunk accepts all k), in [0, 1] for a random
    draft, and output unchanged in both cases."""
    target, draft = models
    tok = _Tok()
    base = DecoderGenerator(target, tok).generate_tokens([3, 1, 4, 1, 5], max_tokens=15)

    gen_same = SpeculativeDecoderGenerator(target, target, tok, k=3)
    assert gen_same.generate_tokens([3, 1, 4, 1, 5], max_tokens=15) == base
    # every iteration emits k+1 tokens except possibly the last (limit clamp)
    assert gen_same.last_accept_rate is not None and gen_same.last_accept_rate > 0.7

    gen_rand = SpeculativeDecoderGenerator(target, draft, tok, k=3)
    assert gen_rand.generate_tokens([3, 1, 4, 1, 5], max_tokens=15) == base
    assert -1e-9 <= gen_rand.last_accept_rate <= 1.0
    assert gen_rand.last_iters >= gen_same.last_iters
