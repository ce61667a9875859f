"""Beam search must match (a) greedy decoding at beam_width=1, and (b) an
independent naive implementation — full re-forward per step, Python lists,
no KV caches — under the same top-2W selection rule. The naive oracle shares
the selection semantics (the t5x pattern) but none of the machinery under
test: caches, parent-gather reordering, fixed-shape buffers, early exit.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_models_tpu.models.text._decoder_lm import (
    DecoderLMConfig,
    decoder_lm_apply,
    decoder_lm_init,
)
from pytorch_models_tpu.text import DecoderGenerator


class _Tok:
    def __init__(self, eos=-1):
        self.eos_token_id = eos

    def encode(self, s):
        return [3, 1, 4, 1, 5]

    def decode(self, ids):
        return " ".join(map(str, ids))


@pytest.fixture(scope="module")
def model():
    cfg = DecoderLMConfig(vocab_size=512, max_seq_len=128, n_layers=2,
                          d_model=128, pre_norm=True, final_norm=True)
    return SimpleNamespace(cfg=cfg, params=decoder_lm_init(jax.random.PRNGKey(0), cfg))


def _logp(model, seq):
    lg = decoder_lm_apply(model.params, model.cfg, jnp.asarray([seq]))[0, -1]
    return np.asarray(jax.nn.log_softmax(lg.astype(jnp.float32)), np.float32)


def _pen(n_gen, alpha):
    return max(n_gen, 1) ** alpha


def naive_beam(model, prompt, max_tokens, w, eos, alpha):
    """Textbook beam search with the top-2W expansion rule, computed by full
    re-forward with no caches. Returns (sequences, scores) best-first."""
    lp = _logp(model, prompt)
    order = np.argsort(-lp, kind="stable")[:w]
    alive, fin = [], []  # (seq, score) / (seq, penalized score)
    for t in order:
        if t == eos:
            fin.append((prompt + [int(t)], lp[t] / _pen(1, alpha)))
        else:
            alive.append((prompt + [int(t)], float(lp[t])))
    n_gen = 1
    while n_gen < max_tokens and alive:
        best_alive = max(s for _, s in alive) / _pen(max_tokens, alpha)
        worst_fin = min((s for _, s in fin), default=-np.inf) if len(fin) >= w else -np.inf
        if not best_alive > worst_fin:
            break
        cand = np.concatenate([s + _logp(model, seq) for seq, s in alive])
        v = model.cfg.vocab_size
        top = np.argsort(-cand, kind="stable")[: 2 * w]
        n_gen += 1
        new_alive = []
        for flat in top:
            parent, t = divmod(int(flat), v)
            seq = alive[parent][0] + [t]
            if t == eos:
                fin.append((seq, cand[flat] / _pen(n_gen, alpha)))
            elif len(new_alive) < w:
                new_alive.append((seq, float(cand[flat])))
        fin = sorted(fin, key=lambda x: -x[1])[:w]
        alive = new_alive
    final = fin + [(seq, s / _pen(n_gen, alpha)) for seq, s in alive]
    final = sorted(final, key=lambda x: -x[1])[:w]
    return [seq for seq, _ in final], [s for _, s in final]


def test_beam1_equals_greedy_no_eos(model):
    gen = DecoderGenerator(model, _Tok())
    greedy = gen.generate_tokens([3, 1, 4, 1, 5], max_tokens=16)
    beam = gen.beam_search_tokens([3, 1, 4, 1, 5], max_tokens=16, beam_width=1)
    assert beam == greedy


def test_beam1_equals_greedy_with_eos(model):
    base = DecoderGenerator(model, _Tok()).generate_tokens([3, 1, 4, 1, 5], max_tokens=20)
    eos = base[5 + 7]
    gen = DecoderGenerator(model, _Tok(eos=eos))
    greedy = gen.generate_tokens([3, 1, 4, 1, 5], max_tokens=20)
    beam = gen.beam_search_tokens([3, 1, 4, 1, 5], max_tokens=20, beam_width=1)
    assert beam == greedy
    assert beam[-1] == eos


@pytest.mark.parametrize("w", [2, 3])
def test_matches_naive_no_eos(model, w):
    prompt = [3, 1, 4, 1, 5]
    seqs, scores = DecoderGenerator(model, _Tok()).beam_search_tokens(
        prompt, max_tokens=8, beam_width=w, return_all=True)
    n_seqs, n_scores = naive_beam(model, prompt, 8, w, -1, 0.0)
    assert seqs == n_seqs
    np.testing.assert_allclose(scores, n_scores, rtol=0, atol=2e-4)


def test_matches_naive_with_eos_and_penalty(model):
    prompt = [3, 1, 4, 1, 5]
    base = DecoderGenerator(model, _Tok()).generate_tokens(prompt, max_tokens=12)
    eos = base[5 + 3]  # fires early on the greedy path -> exercises the pool
    seqs, scores = DecoderGenerator(model, _Tok(eos=eos)).beam_search_tokens(
        prompt, max_tokens=12, beam_width=3, length_penalty=0.6, return_all=True)
    n_seqs, n_scores = naive_beam(model, prompt, 12, 3, eos, 0.6)
    assert seqs == n_seqs
    np.testing.assert_allclose(scores, n_scores, rtol=0, atol=2e-4)


def test_scores_sorted_and_text_api(model):
    gen = DecoderGenerator(model, _Tok())
    seqs, scores = gen.beam_search_tokens([3, 1, 4, 1, 5], max_tokens=6,
                                          beam_width=4, return_all=True)
    assert len(seqs) == 4 and scores == sorted(scores, reverse=True)
    assert len(set(map(tuple, seqs))) == 4  # distinct beams
    out = gen.beam_search("x", max_tokens=6, beam_width=2)
    assert isinstance(out, str)


@pytest.mark.parametrize("w", [1, 3])
def test_batched_matches_single(model, w):
    """G prompts of differing lengths through one flat G*W decode must equal
    per-prompt beam search (per-row pad_lens + group-independent selection)."""
    gen = DecoderGenerator(model, _Tok())
    prompts = [[3, 1, 4], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2]]
    b_seqs, b_scores = gen.beam_search_tokens_batch(
        prompts, max_tokens=8, beam_width=w, return_all=True)
    for i, p in enumerate(prompts):
        s_seqs, s_scores = gen.beam_search_tokens(p, max_tokens=8, beam_width=w,
                                                  return_all=True)
        assert b_seqs[i] == s_seqs
        np.testing.assert_allclose(b_scores[i], s_scores, rtol=0, atol=2e-4)


def test_batched_groups_close_independently(model):
    """One group hits EOS early (its pool closes) while others keep decoding;
    the shared loop must not disturb the closed group's result."""
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8]]
    base = DecoderGenerator(model, _Tok()).generate_tokens(prompts[0], max_tokens=12)
    eos = base[5 + 2]  # fires early for prompt 0 on the greedy path
    gen = DecoderGenerator(model, _Tok(eos=eos))
    b_seqs, b_scores = gen.beam_search_tokens_batch(
        prompts, max_tokens=12, beam_width=3, length_penalty=0.6, return_all=True)
    for i, p in enumerate(prompts):
        s_seqs, s_scores = gen.beam_search_tokens(p, max_tokens=12, beam_width=3,
                                                  length_penalty=0.6, return_all=True)
        assert b_seqs[i] == s_seqs
        np.testing.assert_allclose(b_scores[i], s_scores, rtol=0, atol=2e-4)


def test_fused_step_path_matches_einsum(model, request):
    """Beam search with every decode read through the Triton decode kernel
    (interpret mode) == the einsum path."""
    gen = DecoderGenerator(model, _Tok())
    base = gen.beam_search_tokens([3, 1, 4, 1, 5], max_tokens=8, beam_width=3,
                                  return_all=True)
    calls = request.getfixturevalue("decode_kernel_interpret")
    fused = gen.beam_search_tokens([3, 1, 4, 1, 5], max_tokens=8, beam_width=3,
                                   return_all=True)
    assert calls["traces"] > 0
    assert fused[0] == base[0]
    np.testing.assert_allclose(fused[1], base[1], atol=1e-3)


def test_fused_step_embed_fold_matches_einsum(model, request):
    """Batched beam search over left-padded prompts of different lengths
    (per-row pad masks inside the decode kernel, interpret mode) == the
    einsum path."""
    gen = DecoderGenerator(model, _Tok())
    prompts = [[3, 1, 4, 1, 5], [9, 2]]
    base = gen.beam_search_tokens_batch(prompts, max_tokens=8, beam_width=2, return_all=True)
    calls = request.getfixturevalue("decode_kernel_interpret")
    fused = gen.beam_search_tokens_batch(prompts, max_tokens=8, beam_width=2, return_all=True)
    assert calls["traces"] > 0
    assert fused[0] == base[0]
    np.testing.assert_allclose(fused[1], base[1], atol=1e-3)
