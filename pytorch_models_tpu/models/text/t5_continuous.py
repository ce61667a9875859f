"""Continuous batching for T5 generation: a fixed pool of decoder slots
serves encoder-decoder requests with mid-flight admission (the serving-engine
pattern of models/text/continuous.py + models/audio2text/continuous.py,
instantiated for the rel-pos-bias seq2seq decoder).

Static batching decodes a cohort in lockstep and waits for the slowest
output; here a pool of B slots runs one shared decode loop, and the moment a
slot's generation finishes the next request is admitted — the encoder +
cross-KV projection for the new prompt runs once at admission while the
other rows keep decoding between scheduling points.

Fixed shapes throughout (two jitted programs: admit + steps):
- All rows share one monotonic cache position ``pos``; a request admitted at
  ``pos`` puts its leading pad token at buffer/cache slot ``pos-1`` and sets
  ``pad_lens[row] = pos-1`` — the left-pad mask hides every earlier slot,
  including the previous occupant's stale self-KV, so no eviction.
- T5's relative-position bias depends only on ``q_pos - k_pos``, which is
  invariant under the per-row shift: one GLOBAL (H, pool_ctx, L_pad) decode
  bias table serves every row exactly, no per-row position ids needed.
- Admission pastes the prompt's freshly projected cross-attention K/V over
  the slot's cross cache (each row attends to its OWN memory via per-row
  ``len``); there is no self-KV prefill — the decoder "prompt" is the single
  pad token, whose K/V the first decode step computes.
- Per-request outputs are token-identical to ``T5Generator.generate_tokens``
  (pad + generated + EOS). T5 has no decoder position table, so ``pool_ctx``
  may exceed ``max_tokens`` freely (default 4x: fewer epoch resets).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ... import transformer as tfm
from ...ops import attention as _attn
from ...ops import linear
from ...ops.int8_kv import quantize_kv
from .t5 import (
    ENC_BUCKET,
    NEG_INF,
    T5Config,
    relative_position_bias,
    rms_norm,
    t5_block_apply,
    t5_encoder_apply,
)

from .continuous import ServingStats, _bucket_pow2


def _t5cb_encode_body(params, cfg: T5Config, enc_tokens, n_enc):
    """(1, P) right-padded prompt -> (1, P, d) memory (pad positions masked
    out of encoder self-attention, as t5._t5_generate_batch_body)."""
    p_len = enc_tokens.shape[1]
    enc_valid = jnp.arange(p_len)[None, :] < n_enc[:, None]
    pad_bias = jnp.where(enc_valid, 0.0, NEG_INF).astype(jnp.float32)[:, None, None, :]
    x = jnp.take(params["token_embs"], enc_tokens, axis=0)
    return t5_encoder_apply(params["encoder"], cfg, x, pad_bias=pad_bias)


def _t5cb_hidden(params, cfg: T5Config, cross, tok, caches, pos, pad_lens, bias):
    """Pad-aware single-position decode through the layer stack at cache slot
    ``pos`` (stacked caches, per-layer ``cache_layer`` writes) + final RMSNorm.
    ``bias``: the global table's (H, 1, L_pad) q-row at ``pos``."""
    dec = params["decoder"]
    h = jnp.take(params["token_embs"], tok, axis=0)  # (B, 1, d)
    n_layers = cross["k"].shape[0]
    for i in range(n_layers):
        lp = jax.tree.map(lambda a: a[i], dec["layers"])
        cc = jax.tree.map(lambda a: a[i], cross)
        h, caches = t5_block_apply(lp, cfg, h, attn_bias=bias, self_cache=caches,
                                   cross_cache=cc, pos=pos, cache_layer=i,
                                   pad_lens=pad_lens)
    return rms_norm(dec["norm"], h), caches


def _t5cb_admit_body(params, cfg, buf, cross, pad_lens, limits, done,
                     row, pos, memory_row, n_enc_row, max_new, pad_id):
    """Admit one request into slot ``row`` at global position ``pos``:
    project the prompt's cross-attention K/V (the same once-per-request work
    the plain generator does), paste it over the slot's cross cache, write
    the leading pad token at ``buf[row, pos-1]``, and arm the row.
    Host-enforced: pos >= 1, pos + max_new <= pool ctx."""
    dec = params["decoder"]
    lc = cfg.layer

    row_cross = tfm.precompute_cross_caches(dec, lc, memory_row, valid_lens=n_enc_row)
    new_cross = {
        kv: lax.dynamic_update_slice(cross[kv], row_cross[kv].astype(cross[kv].dtype),
                                     (0, row, 0, 0))
        for kv in ("k", "v")
    }
    new_cross["len"] = lax.dynamic_update_slice(
        cross["len"], row_cross["len"].astype(cross["len"].dtype), (0, row))

    buf = lax.dynamic_update_slice(buf, jnp.full((1, 1), pad_id, jnp.int32), (row, pos - 1))
    pad_lens = lax.dynamic_update_slice(pad_lens, (pos - 1)[None], (row,))
    limits = lax.dynamic_update_slice(limits, (pos + max_new)[None], (row,))
    done = lax.dynamic_update_slice(done, jnp.zeros((1,), bool), (row,))
    return buf, new_cross, pad_lens, limits, done


def _t5cb_admit_i8_body(params, cfg, buf, cross, pad_lens, limits, done,
                        row, pos, memory_row, n_enc_row, max_new, pad_id):
    """int8-cross admission (opt-in USE_INT8_KV_CROSS): the request's freshly
    projected cross K/V quantizes ONCE here — write-once, the plain
    generator's quantize-at-encode point — and the int8 rows + scales paste
    over the slot. T5 has no self-KV prefill (the pad
    token's K/V comes from the first decode step), so int8 SELF needs no
    admission work at all: the pool just starts as quantized zeros."""
    from ...ops.int8_kv import quantize_rows

    dec = params["decoder"]
    lc = cfg.layer

    row_cross = tfm.precompute_cross_caches(dec, lc, memory_row, valid_lens=n_enc_row)
    # tp ranks hold width shards: pmax gives every rank the full-width scale
    kq, ks = quantize_rows(row_cross["k"], tp_axis=lc.tp_axis)
    vq, vs = quantize_rows(row_cross["v"], tp_axis=lc.tp_axis)
    new_cross = dict(cross) | {
        "k": lax.dynamic_update_slice(cross["k"], kq, (0, row, 0, 0)),
        "v": lax.dynamic_update_slice(cross["v"], vq, (0, row, 0, 0)),
        "ks": lax.dynamic_update_slice(cross["ks"], ks[..., 0], (0, row, 0)),
        "vs": lax.dynamic_update_slice(cross["vs"], vs[..., 0], (0, row, 0)),
        "len": lax.dynamic_update_slice(
            cross["len"], row_cross["len"].astype(cross["len"].dtype), (0, row)),
    }

    buf = lax.dynamic_update_slice(buf, jnp.full((1, 1), pad_id, jnp.int32), (row, pos - 1))
    pad_lens = lax.dynamic_update_slice(pad_lens, (pos - 1)[None], (row,))
    limits = lax.dynamic_update_slice(limits, (pos + max_new)[None], (row,))
    done = lax.dynamic_update_slice(done, jnp.zeros((1,), bool), (row,))
    return buf, new_cross, pad_lens, limits, done


def _t5cb_steps_body(params, cfg, buf, pad_lens, limits, ends, caches, cross, pos,
                     done, n_steps, eos_id, bias_tab, topk=1, top_p=None,
                     temperature=1.0, keys=None, t0s=None, tps=None):
    """Up to ``n_steps`` decode steps over the whole pool (early exit when
    every row is done); finished rows park writing EOS, ``ends`` latches
    pos+1 the step a row finishes. ``bias_tab``: the pool-global (H, P, L)
    decode bias.

    Sampling (``topk``/``top_p``/``temperature`` beyond greedy): each row
    draws with the SCHEDULE-INVARIANT key ``fold_in(keys[row], pos -
    t0s[row])`` — generated token g of request r always uses
    ``fold_in(request_key, g)`` (models/text/continuous.py semantics).
    Returns ``(buf, ends, caches, pos, done)``."""
    from .generator import _is_greedy, _sample

    dec = params["decoder"]
    b, l_max = buf.shape
    greedy = _is_greedy(topk, top_p)

    def cond(s):
        _, _, _, pos, done, i = s
        return jnp.logical_and(i < n_steps,
                               jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < l_max))

    def body(s):
        buf, ends, caches, pos, done, i = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        bias = lax.dynamic_slice(bias_tab, (0, pos - 1, 0),
                                 (bias_tab.shape[0], 1, bias_tab.shape[2]))
        hn, caches = _t5cb_hidden(params, cfg, cross, tok, caches, pos - 1, pad_lens, bias)
        logits = linear(params["classifier"], hn[:, 0])
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


_t5cb_encode = partial(jax.jit, static_argnums=(1,))(_t5cb_encode_body)
_t5cb_admit = partial(jax.jit, static_argnums=(1,))(_t5cb_admit_body)
_t5cb_admit_i8 = partial(jax.jit, static_argnums=(1,))(_t5cb_admit_i8_body)
_t5cb_steps = partial(jax.jit, static_argnums=(1, 13, 14))(_t5cb_steps_body)


class T5ContinuousBatchingGenerator:
    """Greedy T5 generation serving over a fixed pool of ``batch_size``
    decoder slots with mid-flight request admission. Per-request outputs are
    token-identical to ``T5Generator.generate_tokens``.

    ``pool_ctx`` is the pool's shared position budget (defaults to 4x the
    call's ``max_tokens``; a larger pool context just means fewer epoch
    resets — T5's relative positions put no upper bound on it);
    ``check_every`` is decode steps between host scheduling points.
    """

    def __init__(self, model, tokenizer=None, batch_size: int = 4,
                 check_every: int = 16, pool_ctx: int | None = None) -> None:
        assert batch_size >= 1 and check_every >= 1
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.check_every = check_every
        self.pool_ctx = pool_ctx

    # ---- sharding hooks (overridden by parallel/cb_serving.py) -------------

    def _params_cfg(self):
        return self.model.params, self.model.cfg

    def _encode(self, params, cfg, enc_tokens, n_enc):
        return _t5cb_encode(params, cfg, enc_tokens, n_enc)

    def _admit_i8(self, params, cfg, *args):
        return _t5cb_admit_i8(params, cfg, *args)

    def _init_pool(self, params, cfg, b: int, l_max: int, t_pad: int):
        """Build the pool state: zeroed ``(caches, cross)`` self/cross caches
        and the pool-global (H, P, L) decode-bias table."""
        dec = params["decoder"]
        lc = cfg.layer
        dtype = params["token_embs"].dtype
        l_pad = tfm.padded_cache_len(l_max)
        # ONE global decode-bias table: rel-pos bias is a function of
        # q_pos - k_pos only, so the pool's shifted rows reuse it exactly
        bias_tab = relative_position_bias(
            dec["attn_bias"], jnp.arange(l_max), jnp.arange(l_pad), False, cfg)
        caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, l_max, lc.head_dim,
                                   dtype=dtype, stacked=True)
        width = lc.n_heads * lc.head_dim
        cross = {
            "k": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "v": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "len": jnp.zeros((cfg.n_layers, b), jnp.int32),
        }
        return caches, cross, bias_tab

    def _admit(self, params, cfg, *args):
        return _t5cb_admit(params, cfg, *args)

    def _steps(self, params, cfg, *args):
        return _t5cb_steps(params, cfg, *args)

    def generate_many(self, prompts: list[str], max_tokens: int = 100,
                      on_tokens=None, topk: int = 1, top_p: float | None = None,
                      temperature: float = 1.0, seed: int = 0) -> list[str]:
        """Prompts -> generated texts (requires a sentencepiece tokenizer)."""
        if self.tokenizer is None:
            raise ValueError(
                "generate_many() returns text and needs a tokenizer: construct with "
                "T5ContinuousBatchingGenerator(model, T5Model.get_tokenizer(tag)), "
                "or call generate_tokens_many(...) for raw token ids")
        token_lists = [self.tokenizer.Encode(p, add_eos=True) for p in prompts]
        outs = self.generate_tokens_many(token_lists, max_tokens,
                                         self.tokenizer.pad_id(), self.tokenizer.eos_id(),
                                         on_tokens=on_tokens, topk=topk, top_p=top_p,
                                         temperature=temperature, seed=seed)
        return [self.tokenizer.Decode(o) for o in outs]

    def generate_tokens_many(self, token_lists: list[list[int]], max_tokens: int,
                             pad_id: int, eos_id: int, on_tokens=None,
                             topk: int = 1, top_p: float | None = None,
                             temperature: float = 1.0, seed: int = 0) -> list[list[int]]:
        """Schedule all requests (admitted in order as slots free up); returns
        each request's pad+generated token list, in order — identical per
        request to ``T5Generator.generate_tokens(token_ids, max_tokens,
        pad_id, eos_id)``.

        ``on_tokens(request_index, new_tokens)``: streaming callback, invoked
        at every scheduling point (each ``check_every``-step chunk) with the
        tokens each live request generated since the previous point. Every
        generated token is delivered exactly once, in order; concatenated
        deliveries equal the returned output minus the leading pad token.

        ``topk``/``top_p``/``temperature``/``seed``: sampling (greedy by
        default). Request r's generated token g always draws with
        ``fold_in(fold_in(PRNGKey(seed), r), g)`` — schedule-invariant, the
        models/text/continuous.py contract."""
        from .generator import _parse_sampling_params

        params, cfg = self._params_cfg()
        n_req = len(token_lists)
        if n_req == 0:
            return []
        greedy, has_tp, temps_l, tps_l = _parse_sampling_params(
            n_req, topk, top_p, temperature)
        assert max_tokens >= 2, "max_tokens must fit the pad token plus one"
        assert all(len(ts) >= 1 for ts in token_lists), "empty prompt"
        max_new = max_tokens - 1  # plain generator: buffer = max_tokens total
        l_max = self.pool_ctx if self.pool_ctx is not None else 4 * max_tokens
        base = 1  # admission writes the pad token at slot pos-1
        assert base + max_new <= l_max, (
            f"max_tokens={max_tokens} cannot fit the pool context ({l_max}); "
            "raise pool_ctx")

        b = self.batch_size
        # one shared encoder bucket: per-row cross "len" masks the tail, so a
        # wider bucket changes nothing (and avoids per-length admit retraces)
        p_pad = -(-max(len(ts) for ts in token_lists) // ENC_BUCKET) * ENC_BUCKET
        t_pad = tfm.padded_cache_len(p_pad)
        i8_self, i8_cross = _attn.USE_INT8_KV, _attn.USE_INT8_KV_CROSS
        caches, cross, bias_tab = self._init_pool(params, cfg, b, l_max, t_pad)
        # int8 pools: per-key int8 + scales; T5 has no self prefill, so
        # quantized zeros ARE the initial self state and every decode step
        # writes quantized (the plain generator's order)
        if i8_self:
            caches = quantize_kv(caches)
        if i8_cross:
            cross = quantize_kv(cross)
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
            tps_d = jnp.ones((b,), jnp.float32)  # unused lanes when nucleus off

        pos = base
        next_req = 0
        stats = ServingStats(requests=n_req)
        t_start = time.perf_counter()
        slot_req = [None] * b
        slot_pad = [0] * b
        slot_seen = [0] * b  # next unstreamed buffer slot (on_tokens)
        outputs: list[list[int] | None] = [None] * n_req
        done_h = np.ones((b,), bool)
        ends_h = np.zeros((b,), np.int32)
        buf_h = None  # host snapshot of buf, set after each step chunk

        while next_req < n_req or any(r is not None for r in slot_req):
            # buf_h/ends_h came with the scheduler view in ONE round trip
            # after the last step chunk; finished rows'
            # [pad:end) spans are never touched by admissions
            for row in range(b):
                if slot_req[row] is not None and done_h[row]:
                    end = int(ends_h[row])
                    outputs[slot_req[row]] = buf_h[row, slot_pad[row]: end].tolist()
                    stats.tokens_generated += end - slot_pad[row] - 1
                    slot_req[row] = None

            # all admissions at one scheduling point run ONE batched encoder
            # forward (power-of-2 buckets bound the compile count; tail rows
            # repeat — per-row n_enc masks them identically either way)
            free = [r for r in range(b) if slot_req[r] is None]
            m = (min(len(free), n_req - next_req)
                 if pos + max_new <= l_max else 0)
            if m > 0:
                mb = _bucket_pow2(m)
                enc_buf = np.zeros((mb, p_pad), np.int32)
                lens = np.zeros((mb,), np.int32)
                for i in range(mb):
                    ts = token_lists[next_req + min(i, m - 1)]
                    enc_buf[i, : len(ts)] = ts
                    lens[i] = len(ts)
                mems = self._encode(params, cfg, jnp.asarray(enc_buf),
                                    jnp.asarray(lens))
                for i in range(m):
                    row = free[i]
                    ts = token_lists[next_req]
                    admit = self._admit_i8 if i8_cross else self._admit
                    buf, cross, pad_lens, limits, done = admit(
                        params, cfg, buf, cross, pad_lens, limits, done,
                        jnp.int32(row), jnp.int32(pos),
                        mems[i: i + 1], jnp.asarray([len(ts)], jnp.int32),
                        jnp.int32(max_new), jnp.int32(pad_id))
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
                    slot_pad[row] = pos - 1
                    slot_seen[row] = pos  # generated tokens start at slot pos
                    stats.admissions += 1
                    next_req += 1

            if all(r is None for r in slot_req):
                if next_req < n_req:
                    # epoch reset (see models/text/continuous.py): zero the
                    # per-row state so parked rows can't reference the
                    # rewound pos
                    pos = base
                    pad_lens = jnp.zeros_like(pad_lens)
                    limits = jnp.zeros_like(limits)
                    stats.epoch_resets += 1
                    continue
                break

            live = sum(1 for row in range(b)
                       if slot_req[row] is not None and not done_h[row])
            pos_before = pos
            buf, ends, caches, pos_d, done = self._steps(
                params, cfg, buf, pad_lens, limits, ends, caches, cross,
                jnp.int32(pos), done, jnp.int32(self.check_every), eos_id,
                bias_tab, topk, True if has_tp else None,
                jnp.float32(1.0) if greedy else temps_d, keys, t0s, tps_d)
            # ONE host round trip for the whole scheduler view
            pos, done_h, ends_h, buf_h = jax.device_get((pos_d, done, ends, buf))
            pos = int(pos)
            done_h = np.array(done_h)
            d_steps = pos - pos_before
            stats.scheduling_points += 1
            stats.decode_steps += d_steps
            stats.slot_steps += d_steps * b
            stats.live_slot_steps += d_steps * live  # chunk-granularity occupancy

            if on_tokens is not None:
                deliver = []
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
