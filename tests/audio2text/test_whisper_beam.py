"""Whisper beam search must match (a) greedy at beam_width=1 and (b) a naive
beam oracle computed by full decoder re-forward (``whisper_decode``: no KV
caches, no parent-gather, no fixed-shape buffers) under the same top-2W
selection rule as models/text/beam.py. The decode-kernel route (interpret
mode) must agree with the einsum route token-for-token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_models_tpu.models.audio2text import Whisper, WhisperGenerator
from pytorch_models_tpu.models.audio2text.whisper import _whisper_encode_body, whisper_decode

TINY = dict(vocab_size=100, n_layers=2, d_model=64, n_mels=80)


@pytest.fixture(scope="module")
def gen():
    return WhisperGenerator(Whisper(**TINY))


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(7).standard_normal(16000) * 0.1).astype(np.float32)


def _pen(n_gen, alpha):
    return max(n_gen, 1) ** alpha


def naive_beam(gen, audio, init, max_tokens, w, eot, alpha):
    """Textbook beam search by full re-forward through whisper_decode."""
    m = gen.model
    padded = np.pad(np.asarray(audio, np.float32), (0, gen.N_SAMPLES - len(audio)))
    mel = gen.preprocessor(padded)[None]
    memory = _whisper_encode_body(m.params, m.cfg, mel)

    def logp(seq):
        lg = whisper_decode(m.params, m.cfg, jnp.asarray([seq]), memory)[0, -1]
        return np.asarray(jax.nn.log_softmax(lg.astype(jnp.float32)), np.float32)

    lp = logp(init)
    order = np.argsort(-lp, kind="stable")[:w]
    alive, fin = [], []
    for t in order:
        if t == eot:
            fin.append((list(init) + [int(t)], lp[t] / _pen(1, alpha)))
        else:
            alive.append((list(init) + [int(t)], float(lp[t])))
    n_gen = 1
    while len(init) + n_gen < max_tokens and alive:
        best_alive = max(s for _, s in alive) / _pen(max_tokens - len(init), alpha)
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
            if t == eot:
                fin.append((seq, cand[flat] / _pen(n_gen, alpha)))
            elif len(new_alive) < w:
                new_alive.append((seq, float(cand[flat])))
        fin = sorted(fin, key=lambda x: -x[1])[:w]
        alive = new_alive
    final = fin + [(seq, s / _pen(n_gen, alpha)) for seq, s in alive]
    final = sorted(final, key=lambda x: -x[1])[:w]
    return [seq for seq, _ in final], [s for _, s in final]


def test_beam1_equals_greedy_no_eot(gen, audio):
    greedy = gen.transcribe_tokens(audio, [1, 2], eot_id=-1, max_tokens=10)
    beam = gen.transcribe_beam_tokens(audio, [1, 2], eot_id=-1, max_tokens=10, beam_width=1)
    assert beam == greedy


def test_beam1_equals_greedy_with_eot(gen, audio):
    base = gen.transcribe_tokens(audio, [1, 2], eot_id=-1, max_tokens=12)
    eot = base[2 + 4]  # fires mid-decode on the greedy path
    greedy = gen.transcribe_tokens(audio, [1, 2], eot_id=eot, max_tokens=12)
    beam = gen.transcribe_beam_tokens(audio, [1, 2], eot_id=eot, max_tokens=12, beam_width=1)
    assert beam == greedy
    assert beam[-1] == eot


@pytest.mark.parametrize("w", [2, 3])
def test_matches_naive(gen, audio, w):
    seqs, scores = gen.transcribe_beam_tokens(audio, [1, 2], eot_id=-1, max_tokens=8,
                                              beam_width=w, return_all=True)
    n_seqs, n_scores = naive_beam(gen, audio, [1, 2], 8, w, -1, 0.0)
    assert seqs == n_seqs
    np.testing.assert_allclose(scores, n_scores, rtol=0, atol=2e-4)


def test_matches_naive_with_eot_and_penalty(gen, audio):
    base = gen.transcribe_tokens(audio, [1, 2], eot_id=-1, max_tokens=12)
    eot = base[2 + 3]
    seqs, scores = gen.transcribe_beam_tokens(audio, [1, 2], eot_id=eot, max_tokens=12,
                                              beam_width=3, length_penalty=0.6, return_all=True)
    n_seqs, n_scores = naive_beam(gen, audio, [1, 2], 12, 3, eot, 0.6)
    assert seqs == n_seqs
    np.testing.assert_allclose(scores, n_scores, rtol=0, atol=2e-4)


def test_fused_step_path_matches_einsum(gen, audio, request):
    """Beam decode with self- and cross-attention reads through the Triton
    decode kernel (interpret mode) == the einsum path."""
    kw = dict(eot_id=7, max_tokens=8, beam_width=3, return_all=True)
    base = gen.transcribe_beam_tokens(audio, [1, 2], **kw)
    calls = request.getfixturevalue("decode_kernel_interpret")
    fused = gen.transcribe_beam_tokens(audio, [1, 2], **kw)
    assert calls["traces"] > 0
    assert fused[0] == base[0]
    np.testing.assert_allclose(fused[1], base[1], atol=1e-3)


def test_fused_step_embed_fold_matches_einsum(gen, audio, request):
    """Length-penalized beam decode through the decode kernel (interpret
    mode) == the einsum path."""
    kw = dict(eot_id=7, max_tokens=10, beam_width=2, length_penalty=0.6, return_all=True)
    base = gen.transcribe_beam_tokens(audio, [1, 2], **kw)
    calls = request.getfixturevalue("decode_kernel_interpret")
    fused = gen.transcribe_beam_tokens(audio, [1, 2], **kw)
    assert calls["traces"] > 0
    assert fused[0] == base[0]
    np.testing.assert_allclose(fused[1], base[1], atol=1e-3)
