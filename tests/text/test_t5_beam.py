"""T5 beam search must match (a) greedy at beam_width=1 and (b) a naive beam
oracle computed by full decoder re-forward (``t5_decode``: no KV caches, no
parent-gather, no fixed-shape buffers) under the same top-2W selection rule
as models/text/beam.py. Under the decode-kernel route (interpret mode) T5
stays per-op — its self-attention carries the rel-pos bias — and agrees with
the einsum route token-for-token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_models_tpu.models.text.t5 import (
    ENC_BUCKET,
    T5Generator,
    T5Model,
    t5_decode,
    t5_encode,
)

TINY = dict(vocab_size=100, dim=64, n_heads=2, n_layers=2, mlp_dim=128)
PAD, EOS = 0, 1
# a full encoder bucket: the naive oracle uses unmasked t5_decode, which only
# matches the generator's valid_lens-masked cross-attention when every
# encoder position is valid
PROMPT = [(i % 97) + 2 for i in range(ENC_BUCKET)]


@pytest.fixture(scope="module")
def gen():
    return T5Generator(model=T5Model(**TINY), tokenizer=object())


def _pen(n_gen, alpha):
    return max(n_gen, 1) ** alpha


def naive_beam(gen, prompt, max_tokens, w, alpha):
    """Textbook beam search by full re-forward through t5_decode. Sequences
    start at the pad/start token; EOS id is EOS; generated count excludes the
    start token (matching beam_decode_loop's p_len=1)."""
    m = gen.model
    memory = t5_encode(m.params, m.cfg, jnp.asarray([prompt], jnp.int32))

    def logp(seq):
        lg = t5_decode(m.params, m.cfg, jnp.asarray([seq], jnp.int32), memory)[0, -1]
        return np.asarray(jax.nn.log_softmax(lg.astype(jnp.float32)), np.float32)

    lp = logp([PAD])
    order = np.argsort(-lp, kind="stable")[:w]
    alive, fin = [], []
    for t in order:
        if t == EOS:
            fin.append(([PAD, int(t)], lp[t] / _pen(1, alpha)))
        else:
            alive.append(([PAD, int(t)], float(lp[t])))
    n_gen = 1
    while 1 + n_gen < max_tokens and alive:
        best_alive = max(s for _, s in alive) / _pen(max_tokens - 1, alpha)
        worst_fin = min((s for _, s in fin), default=-np.inf) if len(fin) >= w else -np.inf
        if not best_alive > worst_fin:
            break
        cand = np.concatenate([s + logp(seq) for seq, s in alive])
        v = m.cfg.vocab_size
        top = np.argsort(-cand, kind="stable")[: 2 * w]
        n_gen += 1
        new_alive = []
        for flat in top:
            parent, t = divmod(int(flat), v)
            seq = alive[parent][0] + [t]
            if t == EOS:
                fin.append((seq, cand[flat] / _pen(n_gen, alpha)))
            elif len(new_alive) < w:
                new_alive.append((seq, float(cand[flat])))
        fin = sorted(fin, key=lambda x: -x[1])[:w]
        alive = new_alive
    final = fin + [(seq, s / _pen(n_gen, alpha)) for seq, s in alive]
    final = sorted(final, key=lambda x: -x[1])[:w]
    return [seq for seq, _ in final], [s for _, s in final]


def test_beam1_equals_greedy(gen):
    greedy = gen.generate_tokens(PROMPT, 12, PAD, EOS)
    beam = gen.generate_beam_tokens(PROMPT, 12, PAD, EOS, beam_width=1)
    assert beam == greedy


@pytest.mark.parametrize("w", [2, 3])
def test_matches_naive(gen, w):
    seqs, scores = gen.generate_beam_tokens(PROMPT, 8, PAD, EOS, beam_width=w,
                                            return_all=True)
    n_seqs, n_scores = naive_beam(gen, PROMPT, 8, w, 0.0)
    assert seqs == n_seqs
    np.testing.assert_allclose(scores, n_scores, rtol=0, atol=2e-4)


def test_matches_naive_with_penalty(gen):
    seqs, scores = gen.generate_beam_tokens(PROMPT, 10, PAD, EOS, beam_width=3,
                                            length_penalty=0.6, return_all=True)
    n_seqs, n_scores = naive_beam(gen, PROMPT, 10, 3, 0.6)
    assert seqs == n_seqs
    np.testing.assert_allclose(scores, n_scores, rtol=0, atol=2e-4)


def test_fused_step_path_matches_einsum(gen, request):
    """Beam decode under the decode-kernel route (interpret mode) never
    traces the kernel (rel-pos-biased self-attention, full-length cross
    memory) and == the einsum path."""
    base = gen.generate_beam_tokens(PROMPT, 8, PAD, EOS, beam_width=3, return_all=True)
    calls = request.getfixturevalue("decode_kernel_interpret")
    fused = gen.generate_beam_tokens(PROMPT, 8, PAD, EOS, beam_width=3, return_all=True)
    assert calls["traces"] == 0
    assert fused[0] == base[0]
    np.testing.assert_allclose(fused[1], base[1], atol=1e-3)


def test_fused_step_embed_fold_matches_einsum(gen, request):
    """Length-penalized beam decode under the decode-kernel route (interpret
    mode) stays per-op and == the einsum path."""
    kw = dict(beam_width=2, length_penalty=0.6, return_all=True)
    base = gen.generate_beam_tokens(PROMPT, 10, PAD, EOS, **kw)
    calls = request.getfixturevalue("decode_kernel_interpret")
    fused = gen.generate_beam_tokens(PROMPT, 10, PAD, EOS, **kw)
    assert calls["traces"] == 0
    assert fused[0] == base[0]
    np.testing.assert_allclose(fused[1], base[1], atol=1e-3)
