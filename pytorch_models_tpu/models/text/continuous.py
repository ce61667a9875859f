"""Continuous batching: dynamic request admission into a running batched
greedy decode (the serving-engine pattern; new vs the reference, whose
generator is single-prompt, text/generator.py:11-37).

Static batching decodes a fixed cohort and waits for the SLOWEST row before
any new work starts; with mixed output lengths most rows idle parked on EOS.
Here a fixed pool of B cache slots runs one shared decode loop, and whenever
a slot finishes its request a new one is admitted mid-flight — the other
rows never stop. Decode stays on the exact batched fast path (the decode
kernel on the GPU): per-row left-pad masking makes each slot's
math identical to a fresh left-padded batch row, so outputs are
token-identical to ``DecoderGenerator.generate_tokens`` per request.

How admission works on fixed shapes (no paging):
- All rows share one monotic cache position ``pos``. A request with n prompt
  tokens admitted at ``pos`` occupies buffer/cache slots ``[pos-n, pos)`` and
  sets ``pad_lens[row] = pos - n``: every earlier slot — including the
  PREVIOUS request's stale KV — is masked by the standard left-pad rule
  (transformer.py mha_apply), so no cache eviction is needed.
- The admit prefill re-forwards one fixed-size chunk ``[pos-1-P, pos-1)``
  through the stack for that row only (its cache rows are sliced out and
  written back); the admitting step then decodes from the last prompt token
  like any other row. Exactly TWO jitted programs run ever (steps + admit):
  shapes never vary, so each compiles once.
- ``pos`` never rewinds mid-epoch. When the head-of-queue request no longer
  fits (``pos + max_tokens > max_seq_len``) the pool drains and ``pos``
  resets to the prompt bucket — an "epoch reset". Stale buffers need no
  clearing (masked as above).

Prefix caching: ``generate_tokens_many(..., shared_prefix=...)`` forwards a
common prompt prefix (system prompt) ONCE per call; admissions paste its KV
into the slot (K/V depend only on row-relative positions, so one prefix
cache serves every slot and position) and prefill only the request suffix.

Chunked prefill: prompts longer than ``prompt_bucket`` admit by forwarding
bucket-size chunks left to right (each attending to the KV the previous
chunks — and any pasted prefix — already wrote), with the ordinary admit
program running the tail and arming the row. The only prompt-length limit is
``max_seq_len``; all admissions still compile exactly three programs
(admit, chunk, admit_prefix) regardless of prompt lengths.

Greedy only, like the speculative decoder: the equivalence oracle is the
plain greedy loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

import time
from dataclasses import dataclass

from ...ops import attention as _attn
from ...ops.int8_kv import quantize_kv
from ._decoder_lm import (
    decoder_lm_forward_cached_batch,
    decoder_lm_hidden_cached_batch,
    decoder_lm_make_cache,
)
from .generator import PROMPT_BUCKET, _is_greedy, _parse_sampling_params, _sample


def _bucket_pow2(m: int) -> int:
    """Smallest power of two >= m (batched-admission encode buckets: a
    bounded set of compiled batch shapes)."""
    mb = 1
    while mb < m:
        mb *= 2
    return mb


def _cb_row_prefill(params, cfg, buf, caches, row, c0, pad_len, p):
    """Prefill slot ``row``'s KV cache over the buffer chunk ``[c0, c0+P)``.
    Slots below ``pad_len`` hold garbage the pad mask hides; cached KV below
    ``c0`` (a pasted shared prefix, or earlier chunks of a long prompt) is
    attended to but not recomputed. Returns the updated layer-stacked
    caches."""
    chunk = lax.dynamic_slice(buf, (row, c0), (1, p))
    p_ids = jnp.clip(jnp.arange(p)[None, :] + c0 - pad_len, 0, None)
    n_layers = caches["k"].shape[0]
    l_max, width = caches["k"].shape[2], caches["k"].shape[3]
    row_caches = {
        kv: lax.dynamic_slice(caches[kv], (0, row, 0, 0), (n_layers, 1, l_max, width))
        for kv in ("k", "v")
    }
    _, row_caches = decoder_lm_hidden_cached_batch(
        params, cfg, chunk, p_ids, row_caches, c0, pad_len[None])
    return {kv: lax.dynamic_update_slice(caches[kv], row_caches[kv], (0, row, 0, 0))
            for kv in ("k", "v")}


def _cb_arm_row(pad_lens, limits, done, row, pad_len, pos, max_new):
    pad_lens = lax.dynamic_update_slice(pad_lens, pad_len[None], (row,))
    limits = lax.dynamic_update_slice(limits, (pos + max_new)[None], (row,))
    done = lax.dynamic_update_slice(done, jnp.zeros((1,), bool), (row,))
    return pad_lens, limits, done


def _cb_admit_body(params, cfg, buf, caches, pad_lens, limits, done,
                   row, pos, n, prompt_chunk, max_new):
    """Admit one request into slot ``row`` at global position ``pos``.

    ``prompt_chunk``: (P,) with the LAST min(n, P) prompt tokens
    RIGHT-aligned. Writes them into ``buf[row, pos-P:pos)``, prefills the
    row's KV cache over the chunk ``[c0, c0+P)`` with ``c0 = max(0,
    pos-1-P)`` (slots below ``pos-n`` and above ``pos-1`` hold garbage that
    the pad/length masks hide and later steps overwrite; for n > P the
    earlier prompt slots were written/prefilled by :func:`_cb_chunk_body`
    passes), and arms the row: ``pad_lens[row] = pos-n``, ``limits[row] =
    pos+max_new``, done cleared. Requires (host-enforced): n >= 1, P <= pos,
    pos+1 <= max_seq_len, and buffer+cache coverage of ``[pos-n, pos-1-P)``
    when n > P.
    """
    p = prompt_chunk.shape[0]
    pad_len = pos - n

    old = lax.dynamic_slice(buf, (row, pos - p), (1, p))[0]
    merged = jnp.where(jnp.arange(p) >= p - n, prompt_chunk.astype(jnp.int32), old)
    buf = lax.dynamic_update_slice(buf, merged[None], (row, pos - p))

    caches = _cb_row_prefill(params, cfg, buf, caches, row,
                             jnp.maximum(pos - 1 - p, 0), pad_len, p)
    pad_lens, limits, done = _cb_arm_row(pad_lens, limits, done, row, pad_len, pos, max_new)
    return buf, caches, pad_lens, limits, done


def _cb_chunk_body(params, cfg, buf, caches, row, c0, pad_len, chunk):
    """Chunked prefill for prompts LONGER than the bucket: write the (P,)
    ``chunk`` of prompt tokens into ``buf[row, c0:c0+P)`` and forward it
    against the row's cache (attending to everything already cached below
    ``c0`` — earlier chunks and any pasted prefix). The host runs this left
    to right until coverage reaches ``pos-P``; the ordinary admit program
    then writes/prefills the tail and arms the row. One fixed chunk shape =
    one compile, shared with the admit path's P."""
    p = chunk.shape[0]
    buf = lax.dynamic_update_slice(buf, chunk.astype(jnp.int32)[None], (row, c0))
    caches = _cb_row_prefill(params, cfg, buf, caches, row, c0, pad_len, p)
    return buf, caches


def _cb_paste_body(buf, caches, row, pad_len, k, prefix_chunk, prefix_caches):
    """Paste the precomputed shared-prefix KV + tokens into slot ``row`` at
    ``[pad_len, pad_len+k)`` without any forward pass (the paste half of
    :func:`_cb_admit_prefix_body`, standalone for chunked long-suffix
    admissions). The ``Kp - k`` pad tail is masked so stale state there
    survives."""
    kp = prefix_chunk.shape[0]
    keep = jnp.arange(kp) < k
    old = lax.dynamic_slice(buf, (row, pad_len), (1, kp))[0]
    buf = lax.dynamic_update_slice(
        buf, jnp.where(keep, prefix_chunk.astype(jnp.int32), old)[None], (row, pad_len))
    n_layers, _, _, width = caches["k"].shape
    for kv in ("k", "v"):
        old_kv = lax.dynamic_slice(caches[kv], (0, row, pad_len, 0), (n_layers, 1, kp, width))
        pre = lax.dynamic_slice(prefix_caches[kv], (0, 0, 0, 0), (n_layers, 1, kp, width))
        merged_kv = jnp.where(keep[None, None, :, None], pre, old_kv)
        caches = dict(caches) | {
            kv: lax.dynamic_update_slice(caches[kv], merged_kv, (0, row, pad_len, 0))}
    return buf, caches


def _cb_prefix_body(params, cfg, prefix_chunk):
    """KV cache for a SHARED prompt prefix, computed once per serving call.

    ``prefix_chunk``: (Kp,) LEFT-aligned prefix tokens (slots ``[k, Kp)``
    are pad). Returns a fresh layer-stacked (L, 1, max_seq_len, W) cache
    whose slots ``[0, k)`` hold the prefix KV at relative positions
    ``0..k-1`` — K/V depend only on the row-relative position, so the same
    cache pastes into any slot at any admission position.
    """
    kp = prefix_chunk.shape[0]
    caches = decoder_lm_make_cache(cfg, (1,), dtype=params["token_embs"].dtype, stacked=True)
    pos_ids = jnp.arange(kp, dtype=jnp.int32)[None]
    _, caches = decoder_lm_hidden_cached_batch(
        params, cfg, prefix_chunk[None], pos_ids, caches, 0,
        jnp.zeros((1,), jnp.int32))
    return caches


def _cb_admit_prefix_body(params, cfg, buf, caches, pad_lens, limits, done,
                          row, pos, n, k, prefix_chunk, prefix_caches,
                          suffix_chunk, max_new):
    """Admit a request whose prompt is ``shared_prefix[:k] + suffix`` into
    slot ``row`` at position ``pos`` WITHOUT re-forwarding the prefix: the
    precomputed prefix KV (:func:`_cb_prefix_body`) is pasted into the
    slot's cache at ``[pos-n, pos-n+k)`` and only the suffix chunk is
    prefilled. ``n = k + s`` is the full prompt length; ``prefix_chunk``:
    (Kp,) LEFT-aligned prefix tokens; ``suffix_chunk``: (P,) suffix tokens
    RIGHT-aligned. Host-enforced: k >= 1, 1 <= s <= P (the prefill chunk
    ``[pos-1-P, pos-1)`` must cover every non-prefix prompt slot),
    n <= pos, pos+1 <= max_seq_len.
    """
    kp = prefix_chunk.shape[0]
    p = suffix_chunk.shape[0]
    pad_len = pos - n

    # prefix tokens + pasted KV land at buffer slots [pos-n, pos-n+k);
    # the Kp-k pad tail is masked off so stale state there survives
    keep = jnp.arange(kp) < k
    old = lax.dynamic_slice(buf, (row, pad_len), (1, kp))[0]
    buf = lax.dynamic_update_slice(
        buf, jnp.where(keep, prefix_chunk.astype(jnp.int32), old)[None], (row, pad_len))
    n_layers, _, _, width = caches["k"].shape
    new_caches = {}
    for kv in ("k", "v"):
        old_kv = lax.dynamic_slice(caches[kv], (0, row, pad_len, 0), (n_layers, 1, kp, width))
        pre = lax.dynamic_slice(prefix_caches[kv], (0, 0, 0, 0), (n_layers, 1, kp, width))
        merged_kv = jnp.where(keep[None, None, :, None], pre, old_kv)
        new_caches[kv] = lax.dynamic_update_slice(caches[kv], merged_kv, (0, row, pad_len, 0))

    # suffix tokens land at [pos-s, pos)
    s = n - k
    old = lax.dynamic_slice(buf, (row, pos - p), (1, p))[0]
    merged = jnp.where(jnp.arange(p) >= p - s, suffix_chunk.astype(jnp.int32), old)
    buf = lax.dynamic_update_slice(buf, merged[None], (row, pos - p))

    # the chunk forward recomputes any prefix-tail tokens it covers (reading
    # the pasted KV below c0) and writes the suffix KV
    caches = _cb_row_prefill(params, cfg, buf, new_caches, row,
                             jnp.maximum(pos - 1 - p, 0), pad_len, p)
    pad_lens, limits, done = _cb_arm_row(pad_lens, limits, done, row, pad_len, pos, max_new)
    return buf, caches, pad_lens, limits, done


def _cb_steps_body(params, cfg, buf, pad_lens, limits, ends, caches, pos,
                   done, n_steps, eos_id, topk=1, top_p=None, temperature=1.0,
                   keys=None, t0s=None, tps=None):
    """Up to ``n_steps`` decode steps over the whole pool (early exit when
    every row is done). Finished rows park writing EOS; a row's ``ends``
    is latched to pos+1 the step it finishes (EOS emitted or per-row limit
    reached).

    Sampling (``topk``/``top_p``/``temperature`` beyond greedy): each row
    draws with the SCHEDULE-INVARIANT key ``fold_in(keys[row], pos -
    t0s[row])`` — ``keys[row]`` is the request's own key and ``t0s[row]``
    its admission position, so generated token g of a request always uses
    ``fold_in(request_key, g)`` regardless of pool size, admission order,
    check_every, or epoch resets. ``temperature`` and ``tps`` are PER-ROW
    (B,) value vectors (requests may carry different sampling params);
    ``top_p`` is only the static mode flag (None = nucleus off).
    Returns ``(buf, ends, caches, pos, done)``.
    """
    b = buf.shape[0]
    l_max = cfg.max_seq_len
    greedy = _is_greedy(topk, top_p)

    def cond(s):
        _, _, _, pos, done, i = s
        return jnp.logical_and(i < n_steps,
                               jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < l_max))

    def body(s):
        buf, ends, caches, pos, done, i = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        p_ids = (pos - 1 - pad_lens)[:, None]
        full, caches = decoder_lm_forward_cached_batch(params, cfg, tok, p_ids, caches,
                                                       pos - 1, pad_lens)
        logits = full[:, 0]
        if not greedy:
            step_keys = jax.vmap(jax.random.fold_in)(keys, pos - t0s)
            if top_p is not None:
                nxt = jax.vmap(lambda l, sk, tp, tm: _sample(l, sk, topk, tp, tm))(
                    logits, step_keys, tps, temperature).astype(jnp.int32)
            else:
                nxt = jax.vmap(lambda l, sk, tm: _sample(l, sk, topk, None, tm))(
                    logits, step_keys, temperature).astype(jnp.int32)
        else:
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        nxt = jnp.where(done, jnp.int32(eos_id), nxt)
        new_done = jnp.logical_or(done, jnp.logical_or(nxt == eos_id, pos + 1 >= limits))
        ends = jnp.where(jnp.logical_and(new_done, jnp.logical_not(done)), pos + 1, ends)
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos))
        return buf, ends, caches, pos + 1, new_done, i + 1

    buf, ends, caches, pos, done, _ = lax.while_loop(
        cond, body, (buf, ends, caches, pos, done, jnp.int32(0)))
    return buf, ends, caches, pos, done


def _cb_i8_prefill(params, cfg, buf, scratch, row, c0, pad_len, p):
    """Prefill the (L, 1, Lmax, W) bf16 admission SCRATCH cache over the
    buffer chunk ``[c0, c0+P)`` of pool row ``row``. The int8 pool never
    participates in prefill math: the whole admission (paste + chunks +
    tail) runs in full precision on the scratch and quantizes ONCE at
    commit — exactly the plain int8 generator's prefill-then-quantize order
    (generator.py), so per-request outputs stay token-identical to it."""
    chunk = lax.dynamic_slice(buf, (row, c0), (1, p))
    p_ids = jnp.clip(jnp.arange(p)[None, :] + c0 - pad_len, 0, None)
    _, scratch = decoder_lm_hidden_cached_batch(
        params, cfg, chunk, p_ids, scratch, c0, pad_len[None])
    return scratch


def _cb_i8_paste_body(buf, scratch, row, pad_len, k, prefix_chunk, prefix_caches):
    """int8-mode prefix paste: prefix TOKENS land in the pool buffer row
    (later prefills read them back), the bf16 prefix KV lands in the
    admission scratch at ``[pad_len, pad_len+k)`` — the pool's int8 row is
    rewritten wholesale by :func:`_cb_i8_commit_body`."""
    kp = prefix_chunk.shape[0]
    keep = jnp.arange(kp) < k
    old = lax.dynamic_slice(buf, (row, pad_len), (1, kp))[0]
    buf = lax.dynamic_update_slice(
        buf, jnp.where(keep, prefix_chunk.astype(jnp.int32), old)[None], (row, pad_len))
    n_layers, _, _, width = scratch["k"].shape
    for kv in ("k", "v"):
        old_kv = lax.dynamic_slice(scratch[kv], (0, 0, pad_len, 0), (n_layers, 1, kp, width))
        pre = lax.dynamic_slice(prefix_caches[kv], (0, 0, 0, 0), (n_layers, 1, kp, width))
        scratch = dict(scratch) | {kv: lax.dynamic_update_slice(
            scratch[kv],
            jnp.where(keep[None, None, :, None], pre.astype(old_kv.dtype), old_kv),
            (0, 0, pad_len, 0))}
    return buf, scratch


def _cb_i8_chunk_body(params, cfg, buf, scratch, row, c0, pad_len, chunk):
    """Chunked-prefill pass against the admission scratch (int8-mode twin of
    :func:`_cb_chunk_body`)."""
    p = chunk.shape[0]
    buf = lax.dynamic_update_slice(buf, chunk.astype(jnp.int32)[None], (row, c0))
    return buf, _cb_i8_prefill(params, cfg, buf, scratch, row, c0, pad_len, p)


def _cb_i8_admit_body(params, cfg, buf, scratch, pad_lens, limits, done,
                      row, pos, n, n_tok, prompt_chunk, max_new):
    """Tail admit against the admission scratch. ``n_tok`` is how many
    rightmost chunk slots hold real prompt tokens (min(suffix, P) — with a
    shared prefix the chunk's left slots must NOT clobber the pasted prefix
    tokens); ``n`` is the FULL prompt length (pad/limit bookkeeping)."""
    p = prompt_chunk.shape[0]
    pad_len = pos - n
    old = lax.dynamic_slice(buf, (row, pos - p), (1, p))[0]
    merged = jnp.where(jnp.arange(p) >= p - n_tok, prompt_chunk.astype(jnp.int32), old)
    buf = lax.dynamic_update_slice(buf, merged[None], (row, pos - p))
    scratch = _cb_i8_prefill(params, cfg, buf, scratch, row,
                             jnp.maximum(pos - 1 - p, 0), pad_len, p)
    pad_lens, limits, done = _cb_arm_row(pad_lens, limits, done, row, pad_len, pos, max_new)
    return buf, scratch, pad_lens, limits, done


def _cb_i8_commit_body(caches, scratch, row, tp_axis=None):
    """Quantize the admission scratch row (per-key int8, ops/int8_kv.py
    rule) and write it into the int8 pool's row — cache + scales.
    One whole-row write: every slot outside ``[pad_len, pos)`` is masked
    by the pad/length rules, so requantized stale garbage is harmless.
    ``tp_axis``: width-sharded ranks pmax to the full-width scale."""
    from ...ops.int8_kv import quantize_rows

    kq, ks = quantize_rows(scratch["k"], tp_axis=tp_axis)
    vq, vs = quantize_rows(scratch["v"], tp_axis=tp_axis)
    return dict(caches) | {
        "k": lax.dynamic_update_slice(caches["k"], kq, (0, row, 0, 0)),
        "v": lax.dynamic_update_slice(caches["v"], vq, (0, row, 0, 0)),
        "ks": lax.dynamic_update_slice(caches["ks"], ks[..., 0], (0, row, 0)),
        "vs": lax.dynamic_update_slice(caches["vs"], vs[..., 0], (0, row, 0)),
    }


_cb_admit = partial(jax.jit, static_argnums=(1,))(_cb_admit_body)
_cb_chunk = partial(jax.jit, static_argnums=(1,))(_cb_chunk_body)
_cb_paste = jax.jit(_cb_paste_body)
_cb_prefix = partial(jax.jit, static_argnums=(1,))(_cb_prefix_body)
_cb_admit_prefix = partial(jax.jit, static_argnums=(1,))(_cb_admit_prefix_body)
_cb_steps = partial(jax.jit, static_argnums=(1, 11, 12))(_cb_steps_body)
_cb_i8_paste = jax.jit(_cb_i8_paste_body)
_cb_i8_chunk = partial(jax.jit, static_argnums=(1,))(_cb_i8_chunk_body)
_cb_i8_admit = partial(jax.jit, static_argnums=(1,))(_cb_i8_admit_body)
_cb_i8_commit = partial(jax.jit, static_argnums=(3,))(_cb_i8_commit_body)


@dataclass
class ServingStats:
    """Scheduler-side counters for one ``generate_*_many`` call (set as
    ``gen.last_stats``). All counters are host-observed: ``decode_steps`` is
    the device-executed step count (early-exit chunks count what actually
    ran), ``live_slot_steps`` integrates pool occupancy over those steps, and
    ``tokens_generated`` counts returned generated tokens (incl. EOS)."""

    requests: int = 0
    admissions: int = 0
    epoch_resets: int = 0
    scheduling_points: int = 0
    decode_steps: int = 0
    slot_steps: int = 0        # decode_steps x pool size (capacity)
    live_slot_steps: int = 0   # occupied-slot steps (parked-done slots excluded)
    tokens_generated: int = 0
    wall_time_s: float = 0.0

    @property
    def occupancy(self) -> float:
        """Fraction of slot-step capacity spent on live requests."""
        return self.live_slot_steps / self.slot_steps if self.slot_steps else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_time_s if self.wall_time_s else 0.0


class ContinuousBatchingGenerator:
    """Greedy serving over a fixed pool of ``batch_size`` KV-cache slots with
    mid-flight request admission. Per-request outputs are token-identical to
    ``DecoderGenerator(model, tok).generate_tokens(prompt, max_tokens)``.

    ``prompt_bucket`` is the admit-chunk width (one shape = one compile);
    longer prompts admit via chunked prefill (bucket-size chunks forwarded
    left to right), capped only by ``max_seq_len``. ``check_every`` is how
    many decode steps run between host
    scheduling points — larger amortizes the host round-trip, smaller
    admits waiting requests sooner (finished slots park up to
    ``check_every - 1`` steps).
    """

    def __init__(self, model, tokenizer, batch_size: int = 8,
                 prompt_bucket: int = PROMPT_BUCKET, check_every: int = 16) -> None:
        assert batch_size >= 1 and prompt_bucket >= 1 and check_every >= 1
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.prompt_bucket = prompt_bucket
        self.check_every = check_every

    # ---- sharding hooks (overridden by parallel/cb_serving.py) ----------
    def _params_cfg(self):
        return self.model.params, self.model.cfg

    def _init_pool(self, params, cfg, b):
        """Zeroed layer-stacked KV caches for a fresh slot pool."""
        return decoder_lm_make_cache(cfg, (b,), dtype=params["token_embs"].dtype, stacked=True)

    def _admit(self, *args):
        return _cb_admit(*args)

    def _prefill_chunk(self, *args):
        return _cb_chunk(*args)

    def _paste(self, *args):
        return _cb_paste(*args)

    def _prefill_prefix(self, *args):
        return _cb_prefix(*args)

    def _admit_prefix(self, *args):
        return _cb_admit_prefix(*args)

    def _steps(self, *args, **kw):
        return _cb_steps(*args, **kw)

    # ---- int8 self-KV pool (opt-in, ops/attention.py USE_INT8_KV) -------

    def _i8_paste(self, *args):
        return _cb_i8_paste(*args)

    def _i8_chunk(self, *args):
        return _cb_i8_chunk(*args)

    def _i8_admit(self, *args):
        return _cb_i8_admit(*args)

    def _i8_commit(self, *args):
        return _cb_i8_commit(*args)

    def generate_many(self, prompts: list[str], max_tokens: int | list[int] = 100,
                      shared_prefix: str | None = None, topk: int = 1,
                      top_p: float | None = None, temperature: float = 1.0,
                      seed: int = 0) -> list[str]:
        outs = self.generate_tokens_many(
            [self.tokenizer.encode(p) for p in prompts], max_tokens,
            shared_prefix=None if shared_prefix is None else self.tokenizer.encode(shared_prefix),
            topk=topk, top_p=top_p, temperature=temperature, seed=seed)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_many(self, requests: list[list[int]],
                             max_tokens: int | list[int] = 100,
                             shared_prefix: list[int] | None = None,
                             topk: int = 1, top_p: float | None = None,
                             temperature: float = 1.0, seed: int = 0,
                             on_tokens=None) -> list[list[int]]:
        """Schedule all ``requests`` (admitted in order as slots free up) and
        return each request's full prompt+generated token list, in order.

        ``shared_prefix``: optional common prompt prefix (a system prompt).
        Each request's full prompt is ``shared_prefix + request``; the prefix
        is forwarded ONCE per call and its KV is pasted into each slot at
        admission (prefix caching), so per-request prefill cost is the suffix
        only. Outputs include the prefix, identical to
        ``DecoderGenerator.generate_tokens(prefix + request)`` per request.
        Prompts longer than ``prompt_bucket`` admit via chunked prefill
        (module docstring); the only length limit is ``max_seq_len``.

        ``topk``/``top_p``/``temperature``/``seed``: sampling (greedy by
        default). ``temperature`` and ``top_p`` also accept PER-REQUEST
        lists (length ``len(requests)``); ``topk`` and the nucleus on/off
        mode are per-call (they change the sampling graph shape, so mixing
        would force recompiles). Request r's generated token g always draws with
        ``fold_in(fold_in(PRNGKey(seed), r), g)`` — outputs are independent
        of pool size, admission order, and scheduling, so a request's sample
        stream is reproducible from ``(seed, r)`` alone.

        ``on_tokens(request_index, new_tokens)``: streaming callback, invoked
        at every scheduling point (each ``check_every``-step chunk) with the
        tokens each live request generated since the previous point. Every
        generated token is delivered exactly once, in order; concatenated
        deliveries equal the returned output minus the prompt.
        """
        params, cfg = self._params_cfg()
        n_req = len(requests)
        if n_req == 0:
            return []
        greedy, has_tp, temps_l, tps_l = _parse_sampling_params(
            n_req, topk, top_p, temperature)
        budgets = [max_tokens] * n_req if isinstance(max_tokens, int) else list(max_tokens)
        assert len(budgets) == n_req
        p_bucket = self.prompt_bucket
        l_max = cfg.max_seq_len
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1

        k = len(shared_prefix) if shared_prefix else 0
        if k:
            # prefix chunk is LEFT-aligned in a bucket-multiple shape (one
            # compile per bucket count); its KV is computed once, up front
            kp = -(-k // p_bucket) * p_bucket
            prefix_chunk = np.zeros((kp,), np.int32)
            prefix_chunk[:k] = shared_prefix
            prefix_chunk = jnp.asarray(prefix_chunk)
        else:
            kp = 0
        # epoch start: admissions need pos >= n = k + s, so the base covers
        # the LONGEST request (long prompts chunk-prefill at admission)
        # no bucket rounding: pos is a traced scalar (compiled shapes depend
        # only on the chunk width), and rounding up would reject feasible
        # prompts near max_seq_len (and, via the plan asserts, sink every
        # short request batched with one long one)
        max_s = max(len(t) for t in requests)
        base = kp + max(p_bucket, max_s)

        def fits(pos, n, m_eff):
            if pos + m_eff > l_max or pos + 1 > l_max:
                return False
            # the prefix paste window [pos-n, pos-n+kp) must stay in bounds
            # (dynamic_update_slice would clamp-shift it, corrupting the slot)
            return not k or pos - n + kp <= l_max

        plans = []  # (tokens, effective max_new) with the plain generator's clamp
        for toks, m in zip(requests, budgets):
            s = len(toks)
            assert s >= 1, "empty request"
            n = k + s
            m_eff = min(m, l_max - n)  # plain generator: limit = min(n+max_tokens, L)
            assert m_eff >= 1 and fits(base, n, m_eff), (
                f"request (n={n}, max_tokens={m}) cannot fit a fresh epoch "
                f"(epoch base {base} + {m_eff} > max_seq_len {l_max})")
            plans.append((toks, m_eff))

        prefix_caches = self._prefill_prefix(params, cfg, prefix_chunk) if k else None

        b = self.batch_size
        caches = self._init_pool(params, cfg, b)
        use_i8 = _attn.USE_INT8_KV
        if use_i8:
            # pool caches live as per-key int8 + scales for the whole serving
            # call: halves the pool's memory footprint. Zeros quantize
            # harmlessly (q=0, s=1/127).
            caches = quantize_kv(caches)
        buf = jnp.zeros((b, l_max), jnp.int32)
        pad_lens = jnp.zeros((b,), jnp.int32)
        limits = jnp.zeros((b,), jnp.int32)
        ends = jnp.zeros((b,), jnp.int32)
        done = jnp.ones((b,), bool)
        if greedy:
            keys = t0s = temps_d = tps_d = None
        else:
            base_key = jax.random.PRNGKey(seed)
            keys = jnp.zeros((b,) + base_key.shape, base_key.dtype)
            t0s = jnp.zeros((b,), jnp.int32)
            temps_d = jnp.ones((b,), jnp.float32)
            # always an array (unused when nucleus is off): keeps the steps
            # pytree structure fixed across modes and shard_map specs simple
            tps_d = jnp.ones((b,), jnp.float32)

        pos = base  # host-tracked; device copies flow through the jits
        next_req = 0
        slot_req = [None] * b  # request index occupying each slot
        slot_pad = [0] * b
        slot_n = [0] * b  # admitted prompt length (stats)
        slot_seen = [0] * b  # next unstreamed buffer slot (on_tokens)
        outputs: list[list[int] | None] = [None] * n_req
        done_h = np.ones((b,), bool)
        ends_h = np.zeros((b,), np.int32)
        buf_h = None  # host snapshot of buf, set after each step chunk
        stats = ServingStats(requests=n_req)
        t_start = time.perf_counter()

        while next_req < n_req or any(r is not None for r in slot_req):
            # ---- harvest finished slots, admit queued requests in order.
            # buf_h/ends_h came with the scheduler view in ONE round trip
            # after the last step chunk; finished rows' [pad:end) spans are
            # never touched by admissions, so the snapshot stays valid here
            for row in range(b):
                if slot_req[row] is not None and done_h[row]:
                    end = int(ends_h[row])
                    outputs[slot_req[row]] = buf_h[row, slot_pad[row]: end].tolist()
                    stats.tokens_generated += end - slot_pad[row] - slot_n[row]
                    slot_req[row] = None
            for row in range(b):
                if slot_req[row] is None and next_req < n_req:
                    toks, m_eff = plans[next_req]
                    s = len(toks)
                    n = k + s
                    if not fits(pos, n, m_eff):
                        continue  # head-of-queue doesn't fit this epoch
                    if use_i8:
                        # int8 pool: ONE unified admission path (paste if
                        # prefix, chunk while long, tail admit) running in
                        # bf16 on a 1-row scratch, quantized once at commit —
                        # the plain int8 generator's prefill-then-quantize
                        # order, so outputs stay token-identical to it.
                        scratch = decoder_lm_make_cache(
                            cfg, (1,), dtype=params["token_embs"].dtype, stacked=True)
                        pad_len = pos - n
                        if k:
                            buf, scratch = self._i8_paste(
                                buf, scratch, jnp.int32(row), jnp.int32(pad_len),
                                jnp.int32(k), prefix_chunk, prefix_caches)
                        c0 = pad_len + k
                        while c0 + p_bucket < pos:
                            off = c0 - pad_len - k
                            buf, scratch = self._i8_chunk(
                                params, cfg, buf, scratch, jnp.int32(row),
                                jnp.int32(c0), jnp.int32(pad_len),
                                jnp.asarray(toks[off:off + p_bucket], jnp.int32))
                            c0 += p_bucket
                        n_tok = min(s, p_bucket)
                        chunk = np.zeros((p_bucket,), np.int32)
                        chunk[p_bucket - n_tok:] = toks[-n_tok:]
                        buf, scratch, pad_lens, limits, done = self._i8_admit(
                            params, cfg, buf, scratch, pad_lens, limits, done,
                            jnp.int32(row), jnp.int32(pos), jnp.int32(n),
                            jnp.int32(n_tok), jnp.asarray(chunk), jnp.int32(m_eff))
                        caches = self._i8_commit(caches, scratch, jnp.int32(row))
                    elif s > p_bucket:
                        # chunked prefill: paste the prefix (if any), forward
                        # the prompt in bucket-size chunks left to right, and
                        # let the ordinary admit run the tail + arm the row.
                        # Same two compiled shapes as short prompts plus ONE
                        # chunk program shared by every long request.
                        pad_len = pos - n
                        if k:
                            buf, caches = self._paste(
                                buf, caches, jnp.int32(row), jnp.int32(pad_len),
                                jnp.int32(k), prefix_chunk, prefix_caches)
                        # chunks must cover buffer slots up to pos-P (the
                        # tail admit writes [pos-P, pos) and its prefill
                        # reads buf from pos-1-P): loop until c0+P >= pos
                        c0 = pad_len + k
                        while c0 + p_bucket < pos:
                            off = c0 - pad_len - k
                            buf, caches = self._prefill_chunk(
                                params, cfg, buf, caches, jnp.int32(row),
                                jnp.int32(c0), jnp.int32(pad_len),
                                jnp.asarray(toks[off:off + p_bucket], jnp.int32))
                            c0 += p_bucket
                        buf, caches, pad_lens, limits, done = self._admit(
                            params, cfg, buf, caches, pad_lens, limits, done,
                            jnp.int32(row), jnp.int32(pos), jnp.int32(n),
                            jnp.asarray(toks[-p_bucket:], jnp.int32), jnp.int32(m_eff))
                    elif k:
                        chunk = np.zeros((p_bucket,), np.int32)
                        chunk[p_bucket - s:] = toks
                        buf, caches, pad_lens, limits, done = self._admit_prefix(
                            params, cfg, buf, caches, pad_lens, limits, done,
                            jnp.int32(row), jnp.int32(pos), jnp.int32(n), jnp.int32(k),
                            prefix_chunk, prefix_caches, jnp.asarray(chunk),
                            jnp.int32(m_eff))
                    else:
                        chunk = np.zeros((p_bucket,), np.int32)
                        chunk[p_bucket - s:] = toks
                        buf, caches, pad_lens, limits, done = self._admit(
                            params, cfg, buf, caches, pad_lens, limits, done,
                            jnp.int32(row), jnp.int32(pos), jnp.int32(n),
                            jnp.asarray(chunk), jnp.int32(m_eff))
                    if not greedy:
                        # the request's own key + admission position: token g
                        # of request r draws fold_in(fold_in(base, r), g)
                        keys = keys.at[row].set(jax.random.fold_in(base_key, next_req))
                        t0s = t0s.at[row].set(pos)
                        temps_d = temps_d.at[row].set(temps_l[next_req])
                        if has_tp:
                            tps_d = tps_d.at[row].set(tps_l[next_req])
                    done_h[row] = False
                    slot_req[row] = next_req
                    slot_pad[row] = pos - n
                    slot_n[row] = n
                    slot_seen[row] = pos  # generated tokens start at slot pos
                    stats.admissions += 1
                    next_req += 1

            if all(r is None for r in slot_req):
                if next_req < n_req:
                    # epoch reset: pool drained, head-of-queue didn't fit.
                    # pad_lens/limits must be zeroed so parked rows don't
                    # compute negative position ids against the rewound pos
                    # (their stale cache/buffer stays — admission masks it).
                    pos = base
                    pad_lens = jnp.zeros_like(pad_lens)
                    limits = jnp.zeros_like(limits)
                    stats.epoch_resets += 1
                    continue
                break

            # ---- run a chunk of decode steps, then sync the scheduler view
            live = sum(1 for row in range(b)
                       if slot_req[row] is not None and not done_h[row])
            pos_before = pos
            buf, ends, caches, pos_d, done = self._steps(
                params, cfg, buf, pad_lens, limits, ends, caches, jnp.int32(pos),
                done, jnp.int32(self.check_every), eos,
                topk, True if has_tp else None,
                jnp.float32(1.0) if greedy else temps_d, keys, t0s, tps_d)
            # ONE host round trip for the whole scheduler view (pos, done,
            # ends, token buffer) instead of one device sync per array
            pos, done_h, ends_h, buf_h = jax.device_get((pos_d, done, ends, buf))
            pos = int(pos)
            done_h = np.array(done_h)  # device_get results are read-only
            d_steps = pos - pos_before
            stats.scheduling_points += 1
            stats.decode_steps += d_steps
            stats.slot_steps += d_steps * b
            stats.live_slot_steps += d_steps * live  # chunk-granularity occupancy

            if on_tokens is not None:
                deliver = []  # (row, request, upto); buffers batched below
                for row in range(b):
                    r = slot_req[row]
                    if r is None:
                        continue
                    # finished rows park writing EOS past their latched end
                    upto = int(ends_h[row]) if done_h[row] else pos
                    if upto > slot_seen[row]:
                        deliver.append((row, r, upto))
                for row, r, upto in deliver:  # buf_h from the same round trip
                    on_tokens(r, buf_h[row, slot_seen[row]: upto].tolist())
                    slot_seen[row] = upto

        assert all(o is not None for o in outputs)
        stats.wall_time_s = time.perf_counter() - t_start
        self.last_stats = stats
        return outputs  # type: ignore[return-value]
