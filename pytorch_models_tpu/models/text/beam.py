"""Fixed-shape batched beam search (new vs the reference, whose generator is
greedy/top-k only, text/generator.py:26-31).

Fixed-shape algorithm (the t5x/flaxformer pattern): the W alive beams ARE a
batch — each step forwards all W rows through the same KV-cached decode path
the batched greedy loop uses, expands to the top 2W candidates
over (W, V) scores, routes EOS candidates into a W-slot finished pool, keeps
the top W non-EOS as the new alive set, and reorders the KV cache by parent
beam with one gather along the batch axis. Everything is static-shape inside
one ``lax.while_loop``; early exit once no alive beam's optimistic score can
beat the worst kept finished beam.

The loop core (:func:`beam_decode_loop`) is model-agnostic — it takes the
per-step forward and a cache-gather callback — so Whisper/T5 beam decoding
reuses it (models/audio2text/whisper.py).

Scoring: sum of token log-probs; ``length_penalty`` alpha divides by
``len_generated ** alpha`` (HF convention; alpha=0 -> pure log-prob).
2W candidates guarantee >= W non-EOS continuations (each parent beam
contributes exactly one EOS candidate, so at most W of the 2W end in EOS).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ._decoder_lm import decoder_lm_forward_cached_batch, decoder_lm_make_cache
from .generator import PROMPT_BUCKET

# finite (-inf would NaN through masked softmax rows); a Python float, NOT a
# jnp scalar: a module-level device array becomes a hoisted closure constant
# whose presence varies across beam_width traces, and jax 0.9's dispatch
# fastpath then supplies the wrong buffer count to sibling cache entries of
# the same jit ("Execution supplied N buffers but compiled program expected M")
NEG_INF = -1e30


def _length_penalty(n_gen, alpha: float):
    return jnp.power(jnp.maximum(n_gen, 1).astype(jnp.float32), alpha)


def beam_decode_loop_batched(forward, gather_caches, caches, last_logits, buf,
                             p_len: int, limit, w: int, eos_id, alpha):
    """Model-agnostic beam loop over G independent prompt groups of W beams.

    ``forward(tok (G*W, 1), caches, pos) -> (logits (G*W, V), caches)`` runs
    all groups' beams as one flat batch; ``gather_caches(caches, idx (G*W,))
    -> caches`` reorders the flat per-beam state (indices are global row
    numbers). ``last_logits``: (G, V) logits for each group's last prompt
    token; ``buf``: (G, W, L) int32 pre-filled with each group's prompt at
    ``[g, ?, :p_len)`` (shared left-pad convention: ``p_len`` is the common
    padded prompt length). Returns ``(seqs (G, W, L), scores (G, W),
    lengths (G, W))`` best-first per group, with still-alive beams merged in
    at the limit (HF behavior). Groups whose early-exit bound closes keep
    stepping until ALL close (correctness-neutral: a closed group's pool can
    only be offered worse candidates).
    """
    g = last_logits.shape[0]
    v = last_logits.shape[-1]

    # first expansion: all of a group's rows are the same beam — take the
    # top W distinct first tokens (an EOS here finishes immediately)
    logp0 = jax.nn.log_softmax(last_logits.astype(jnp.float32), axis=-1)
    scores, toks = lax.top_k(logp0, w)  # (G, W)
    buf = buf.at[:, :, p_len].set(toks.astype(jnp.int32))
    fin_buf = jnp.zeros_like(buf)
    fin_scores = jnp.full((g, w), NEG_INF)
    fin_lens = jnp.zeros((g, w), jnp.int32)
    is_eos0 = toks == eos_id
    fin_buf = jnp.where(is_eos0[..., None], buf, fin_buf)
    fin_scores = jnp.where(is_eos0, scores / _length_penalty(1, alpha), fin_scores)
    fin_lens = jnp.where(is_eos0, p_len + 1, fin_lens)
    scores = jnp.where(is_eos0, NEG_INF, scores)

    state = (buf, scores, fin_buf, fin_scores, fin_lens, caches, jnp.int32(p_len + 1))

    def cond(s):
        _, scores, _, fin_scores, _, _, pos = s
        # optimistic alive bound per group: log-probs only decrease; the best
        # final penalty an alive beam can reach is at the max generated length
        best_alive = jnp.max(scores, axis=1) / _length_penalty(limit - p_len, alpha)
        any_open = jnp.any(best_alive > jnp.min(fin_scores, axis=1))
        return jnp.logical_and(pos < limit, any_open)

    def body(s):
        buf, scores, fin_buf, fin_scores, fin_lens, caches, pos = s
        tok = lax.dynamic_slice(buf.reshape(g * w, -1), (0, pos - 1), (g * w, 1))
        logits, caches = forward(tok, caches, pos)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1).reshape(g, w, v)

        flat = (scores[:, :, None] + logp).reshape(g, w * v)
        top_scores, top_idx = lax.top_k(flat, 2 * w)  # (G, 2W)
        parents = (top_idx // v).astype(jnp.int32)
        toks = (top_idx % v).astype(jnp.int32)
        is_eos = toks == eos_id

        cand_buf = jnp.take_along_axis(buf, parents[:, :, None], axis=1)  # (G, 2W, L)
        cand_buf = lax.dynamic_update_slice(cand_buf, toks[:, :, None], (0, 0, pos))

        # ---- finished pool: merge EOS candidates, keep best W per group
        n_gen = pos + 1 - p_len
        cand_fin = jnp.where(is_eos, top_scores / _length_penalty(n_gen, alpha), NEG_INF)
        all_fin_scores = jnp.concatenate([fin_scores, cand_fin], axis=1)
        all_fin_buf = jnp.concatenate([fin_buf, cand_buf], axis=1)
        all_fin_lens = jnp.concatenate(
            [fin_lens, jnp.full((g, 2 * w), pos + 1, jnp.int32)], axis=1)
        fin_scores, keep = lax.top_k(all_fin_scores, w)
        fin_buf = jnp.take_along_axis(all_fin_buf, keep[:, :, None], axis=1)
        fin_lens = jnp.take_along_axis(all_fin_lens, keep, axis=1)

        # ---- alive set: best W non-EOS candidates; caches follow parents
        alive_cand = jnp.where(is_eos, NEG_INF, top_scores)
        scores, sel = lax.top_k(alive_cand, w)  # (G, W)
        buf = jnp.take_along_axis(cand_buf, sel[:, :, None], axis=1)
        parent_sel = jnp.take_along_axis(parents, sel, axis=1)  # (G, W)
        flat_idx = (jnp.arange(g)[:, None] * w + parent_sel).reshape(g * w)
        caches = gather_caches(caches, flat_idx)
        return buf, scores, fin_buf, fin_scores, fin_lens, caches, pos + 1

    buf, scores, fin_buf, fin_scores, fin_lens, _, pos = lax.while_loop(cond, body, state)

    # merge still-alive beams as length-limit finishes (HF behavior)
    alive_final = scores / _length_penalty(pos - p_len, alpha)
    all_scores = jnp.concatenate([fin_scores, alive_final], axis=1)
    all_buf = jnp.concatenate([fin_buf, buf], axis=1)
    all_lens = jnp.concatenate([fin_lens, jnp.full((g, w), pos, jnp.int32)], axis=1)
    out_scores, keep = lax.top_k(all_scores, w)
    return (jnp.take_along_axis(all_buf, keep[:, :, None], axis=1), out_scores,
            jnp.take_along_axis(all_lens, keep, axis=1))


def beam_decode_loop(forward, gather_caches, caches, last_logits, buf,
                     p_len: int, limit, w: int, eos_id, alpha):
    """Single-prompt beam loop: the G=1 case of
    :func:`beam_decode_loop_batched`. ``forward(tok (W, 1), caches, pos) ->
    (logits (W, V), caches)``; ``gather_caches(caches, idx (W,))`` reorders
    the per-beam state by parent; ``last_logits``: (V,); ``buf``: (W, L)
    pre-filled with the prompt at ``[?, :p_len)``. Returns ``(seqs (W, L),
    scores (W,), lengths (W,))`` best-first.
    """
    seqs, scores, lens = beam_decode_loop_batched(
        forward, gather_caches, caches, last_logits[None], buf[None],
        p_len, limit, w, eos_id, alpha)
    return seqs[0], scores[0], lens[0]


@partial(jax.jit, static_argnums=(1, 5, 8))
def _beam_search_batch(params, cfg, prompt_bufs, pad_lens_g, limit, beam_width,
                       eos_id, alpha, p_len):
    """Decoder-LM beam search over G prompts at once. ``prompt_bufs``:
    (G, p_len) int32, each row LEFT-padded to the shared bucket length;
    ``pad_lens_g``: (G,) per-prompt pad counts. Prefill runs once per prompt
    (G rows), then caches fan out to the G*W beam rows with the same gather
    the loop uses for parent reordering. Returns ``(seqs (G, W, max_seq_len),
    scores (G, W), lengths (G, W))`` best-first per group.
    """
    w = beam_width
    g = prompt_bufs.shape[0]
    pos_ids = jnp.clip(jnp.arange(p_len)[None, :] - pad_lens_g[:, None], 0, None)
    rows = prompt_bufs.astype(jnp.int32)

    dtype = params["token_embs"].dtype
    caches = decoder_lm_make_cache(cfg, (g,), dtype=dtype, stacked=False)
    logits, caches = decoder_lm_forward_cached_batch(
        params, cfg, rows, pos_ids, caches, 0, pad_lens_g)

    gather = lambda caches, idx: jax.tree.map(lambda c: jnp.take(c, idx, axis=0), caches)
    caches = gather(caches, jnp.repeat(jnp.arange(g), w))  # (.., G*W, ..)
    pad_lens = jnp.repeat(pad_lens_g, w)  # (G*W,)

    buf = jnp.zeros((g, w, cfg.max_seq_len), jnp.int32)
    buf = lax.dynamic_update_slice(
        buf, jnp.broadcast_to(rows[:, None], (g, w, p_len)), (0, 0, 0))

    def forward(tok, caches, pos):
        p_ids = (pos - 1 - pad_lens)[:, None]
        lg, caches = decoder_lm_forward_cached_batch(
            params, cfg, tok, p_ids, caches, pos - 1, pad_lens)
        return lg[:, 0], caches

    return beam_decode_loop_batched(forward, gather, caches, logits[:, -1], buf,
                                    p_len, limit, w, eos_id, alpha)


def beam_search_tokens_batch(model, token_lists, max_tokens: int = 100,
                             beam_width: int = 4, eos_id: int = -1,
                             length_penalty: float = 0.0,
                             return_all: bool = False):
    """Beam-search continuations of G prompts in one batched decode (all
    G*W beam rows step together). Returns a list of best sequences, or
    ``(sequences (G lists of W), scores (G lists of W))`` with ``return_all``
    (best first per prompt; scores are length-penalized log-probs)."""
    cfg = model.cfg
    g = len(token_lists)
    ns = [len(t) for t in token_lists]
    assert g >= 1 and beam_width >= 1 and min(ns) >= 1
    assert length_penalty >= 0.0, "negative length_penalty breaks the early-stop bound"
    n_max = max(ns)
    p_len = min(-(-n_max // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
    if max_tokens <= 0 or n_max >= cfg.max_seq_len or p_len >= cfg.max_seq_len:
        outs = [list(t) for t in token_lists]
        return ([[o] for o in outs], [[0.0]] * g) if return_all else outs
    assert n_max <= p_len, f"prompt too long for context {cfg.max_seq_len}"
    prompt_bufs = np.zeros((g, p_len), np.int32)
    pad_lens = np.zeros((g,), np.int32)
    for i, t in enumerate(token_lists):  # left-pad: beams ride the batched path
        pad_lens[i] = p_len - ns[i]
        prompt_bufs[i, pad_lens[i]:] = t
    limit = min(p_len + max_tokens, cfg.max_seq_len)

    seqs, scores, lens = _beam_search_batch(
        model.params, cfg, jnp.asarray(prompt_bufs), jnp.asarray(pad_lens),
        limit, beam_width, eos_id, float(length_penalty), p_len)
    seqs, scores, lens = np.asarray(seqs), np.asarray(scores), np.asarray(lens)
    outs = [[seqs[i, j, pad_lens[i]: lens[i, j]].tolist() for j in range(beam_width)]
            for i in range(g)]
    if return_all:
        return outs, [scores[i].tolist() for i in range(g)]
    return [o[0] for o in outs]


def beam_search_tokens(model, tokens: list[int], max_tokens: int = 100,
                       beam_width: int = 4, eos_id: int = -1,
                       length_penalty: float = 0.0,
                       return_all: bool = False):
    """Beam-search continuation of ``tokens``: the G=1 case of
    :func:`beam_search_tokens_batch`. Returns the best sequence as a token
    list, or ``(sequences, scores)`` for all ``beam_width`` beams when
    ``return_all`` (best first; scores are length-penalized log-probs)."""
    out = beam_search_tokens_batch(model, [tokens], max_tokens, beam_width,
                                   eos_id, length_penalty, return_all)
    if return_all:
        return out[0][0], out[1][0]
    return out[0]
