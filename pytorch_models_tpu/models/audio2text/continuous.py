"""Continuous batching for Whisper transcription: a fixed pool of decoder
slots serves 30 s segments with mid-flight admission (the serving-engine
pattern of models/text/continuous.py, extended to a cross-attention decoder).

Static batching decodes a cohort in lockstep and waits for the slowest
transcript; here a pool of B slots runs one shared decode loop, and the
moment a slot's transcript finishes the next segment is admitted — encoder
+ cross-KV projection for the new segment runs once at admission while the
other rows keep decoding between scheduling points.

Fixed shapes throughout (two jitted programs: admit + steps), exactly like
the text pool:
- All rows share one monotonic cache position ``pos``; a segment admitted at
  ``pos`` puts its I initial tokens at buffer/cache slots ``[pos-I, pos)``
  and sets ``pad_lens[row] = pos-I`` — the left-pad mask hides every earlier
  slot, including the previous transcript's stale self-KV, so no eviction.
- Admission pastes the segment's freshly projected cross-attention K/V over
  the slot's cross cache (each row attends to its OWN memory via per-row
  ``cross_lens``) and prefills self-KV for the first I-1 prompt tokens.
- Per-row position-table rows (``pos - pad_len``) keep each slot's math
  identical to a fresh batch row: outputs are token-identical to
  ``WhisperGenerator.transcribe_tokens`` per segment.
- ``pos`` never rewinds mid-epoch; a drained pool resets to the base
  position (stale buffers stay — masked as above). The pool context may
  exceed the decoder position table: position-table rows are per-row
  RELATIVE, so only a single transcript's length is bounded by it.
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
from ...ops import layer_norm
from ...ops.int8_kv import quantize_kv
from ...ops.layers import dot_precision
from .whisper import DEC_MAX_LEN, WhisperPreprocessor, _whisper_encode_body

from ..text.continuous import ServingStats, _bucket_pow2


def _wcb_hidden(p, lc, cross, tokens, pos_ids, caches, pos, pad_lens):
    """Pad-aware decode-side forward for a pooled (B, S) chunk at cache slots
    ``[pos, pos+S)``: per-row position-table gather + KV-cached decoder +
    final LN (the left-padded analogue of whisper._decoder_hidden_chunk)."""
    x = jnp.take(p["token_embs"], tokens, axis=0)
    x = x + jnp.take(p["pos_embs"], pos_ids, axis=0).astype(x.dtype)
    x, caches = tfm.decoder_apply(p, lc, x, self_caches=caches, cross_caches=cross,
                                  pos=pos, pad_lens=pad_lens)
    return layer_norm(p["norm"], x), caches


def _wcb_admit_body(params, cfg, buf, caches, cross, pad_lens, limits, done,
                    row, pos, memory_row, init_chunk, max_new):
    """Admit one segment into slot ``row`` at global position ``pos``.

    ``memory_row``: (1, T, d) encoder output for the segment; ``init_chunk``:
    (I,) the initial token sequence. Projects the segment's cross-attention
    K/V (the same per-segment work the plain generator does once), pastes it
    over the slot's cross cache, writes the prompt into ``buf[row, pos-I:pos)``,
    prefills the row's self-KV for the first I-1 prompt tokens (chunk
    ``[pos-1-I, pos-1)``; the one slot below ``pos-I`` is pad-masked), and
    arms the row. Host-enforced: I >= 1, pos >= I + 1, pos + 1 <= pool ctx.
    """
    p = params["decoder"]
    lc = cfg.dec_layer
    i = init_chunk.shape[0]
    pad_len = pos - i

    row_cross = tfm.precompute_cross_caches(p, lc, memory_row)
    new_cross = {
        kv: lax.dynamic_update_slice(cross[kv], row_cross[kv].astype(cross[kv].dtype),
                                     (0, row, 0, 0))
        for kv in ("k", "v")
    }
    new_cross["len"] = lax.dynamic_update_slice(
        cross["len"], row_cross["len"].astype(cross["len"].dtype), (0, row))

    buf = lax.dynamic_update_slice(buf, init_chunk.astype(jnp.int32)[None], (row, pad_len))

    c0 = pos - 1 - i
    chunk = lax.dynamic_slice(buf, (row, c0), (1, i))
    p_ids = jnp.clip(jnp.arange(i)[None, :] + c0 - pad_len, 0, None)
    n_layers = caches["k"].shape[0]
    l_max, width = caches["k"].shape[2], caches["k"].shape[3]
    row_self = {
        kv: lax.dynamic_slice(caches[kv], (0, row, 0, 0), (n_layers, 1, l_max, width))
        for kv in ("k", "v")
    }
    _, row_self = _wcb_hidden(p, lc, row_cross, chunk, p_ids, row_self, c0, pad_len[None])
    caches = {kv: lax.dynamic_update_slice(caches[kv], row_self[kv], (0, row, 0, 0))
              for kv in ("k", "v")}

    pad_lens = lax.dynamic_update_slice(pad_lens, pad_len[None], (row,))
    limits = lax.dynamic_update_slice(limits, (pos + max_new)[None], (row,))
    done = lax.dynamic_update_slice(done, jnp.zeros((1,), bool), (row,))
    return buf, caches, new_cross, pad_lens, limits, done


def _wcb_admit_i8_body(params, cfg, buf, caches, cross, pad_lens, limits, done,
                       row, pos, memory_row, init_chunk, max_new,
                       i8_self: bool, i8_cross: bool):
    """int8-pool admission (opt-in USE_INT8_KV / USE_INT8_KV_CROSS): same
    contract as :func:`_wcb_admit_body`, but each int8 stream quantizes at
    its plain-generator point so outputs stay token-identical to
    ``WhisperGenerator.transcribe_tokens`` under the same flags:

    - CROSS: the segment's freshly projected K/V quantize ONCE here
      (write-once; the plain path quantizes at encode time) and the int8
      rows + scales paste over the slot.
    - SELF: the prompt prefill runs in bf16 on a fresh 1-row scratch and the
      row quantizes ONCE at commit (prefill-then-quantize, the plain order);
      decode steps write quantized (transformer.py _write_cache).
    """
    from ...ops.int8_kv import quantize_rows

    p = params["decoder"]
    lc = cfg.dec_layer
    i = init_chunk.shape[0]
    pad_len = pos - i

    row_cross = tfm.precompute_cross_caches(p, lc, memory_row)
    new_cross = dict(cross) | {"len": lax.dynamic_update_slice(
        cross["len"], row_cross["len"].astype(cross["len"].dtype), (0, row))}
    if i8_cross:
        # tp ranks hold width shards: pmax gives every rank the full-width
        # scale (single-device identity; ops/int8_kv.py quantize_rows)
        kq, ks = quantize_rows(row_cross["k"], tp_axis=lc.tp_axis)
        vq, vs = quantize_rows(row_cross["v"], tp_axis=lc.tp_axis)
        new_cross |= {
            "k": lax.dynamic_update_slice(cross["k"], kq, (0, row, 0, 0)),
            "v": lax.dynamic_update_slice(cross["v"], vq, (0, row, 0, 0)),
            "ks": lax.dynamic_update_slice(cross["ks"], ks[..., 0], (0, row, 0)),
            "vs": lax.dynamic_update_slice(cross["vs"], vs[..., 0], (0, row, 0)),
        }
    else:
        new_cross |= {
            kv: lax.dynamic_update_slice(cross[kv], row_cross[kv].astype(cross[kv].dtype),
                                         (0, row, 0, 0))
            for kv in ("k", "v")
        }

    buf = lax.dynamic_update_slice(buf, init_chunk.astype(jnp.int32)[None], (row, pad_len))

    c0 = pos - 1 - i
    chunk = lax.dynamic_slice(buf, (row, c0), (1, i))
    p_ids = jnp.clip(jnp.arange(i)[None, :] + c0 - pad_len, 0, None)
    n_layers = caches["k"].shape[0]
    l_max, width = caches["k"].shape[2], caches["k"].shape[3]
    if i8_self:
        dtype = p["token_embs"].dtype
        scratch = {kv: jnp.zeros((n_layers, 1, l_max, width), dtype) for kv in ("k", "v")}
        _, scratch = _wcb_hidden(p, lc, row_cross, chunk, p_ids, scratch, c0, pad_len[None])
        kq, ks = quantize_rows(scratch["k"], tp_axis=lc.tp_axis)
        vq, vs = quantize_rows(scratch["v"], tp_axis=lc.tp_axis)
        caches = dict(caches) | {
            "k": lax.dynamic_update_slice(caches["k"], kq, (0, row, 0, 0)),
            "v": lax.dynamic_update_slice(caches["v"], vq, (0, row, 0, 0)),
            "ks": lax.dynamic_update_slice(caches["ks"], ks[..., 0], (0, row, 0)),
            "vs": lax.dynamic_update_slice(caches["vs"], vs[..., 0], (0, row, 0)),
        }
    else:
        row_self = {
            kv: lax.dynamic_slice(caches[kv], (0, row, 0, 0), (n_layers, 1, l_max, width))
            for kv in ("k", "v")
        }
        _, row_self = _wcb_hidden(p, lc, row_cross, chunk, p_ids, row_self, c0, pad_len[None])
        caches = {kv: lax.dynamic_update_slice(caches[kv], row_self[kv], (0, row, 0, 0))
                  for kv in ("k", "v")}

    pad_lens = lax.dynamic_update_slice(pad_lens, pad_len[None], (row,))
    limits = lax.dynamic_update_slice(limits, (pos + max_new)[None], (row,))
    done = lax.dynamic_update_slice(done, jnp.zeros((1,), bool), (row,))
    return buf, caches, new_cross, pad_lens, limits, done


def _wcb_steps_body(params, cfg, buf, pad_lens, limits, ends, caches, cross, pos,
                    done, n_steps, eot_id, topk=1, top_p=None, temperature=1.0,
                    keys=None, t0s=None, tps=None):
    """Up to ``n_steps`` decode steps over the whole pool (early exit when
    every row is done); finished rows park writing EOT, ``ends`` latches
    pos+1 the step a row finishes.

    Sampling (``topk``/``top_p``/``temperature`` beyond greedy): each row
    draws with the SCHEDULE-INVARIANT key ``fold_in(keys[row], pos -
    t0s[row])`` — ``keys[row]`` is the segment's own key, ``t0s[row]`` its
    admission position — so transcript token g of segment r always uses
    ``fold_in(segment_key, g)`` (models/text/continuous.py semantics).
    Returns ``(buf, ends, caches, pos, done)``."""
    from ..text.generator import _is_greedy, _sample

    p = params["decoder"]
    lc = cfg.dec_layer
    b, l_max = buf.shape
    greedy = _is_greedy(topk, top_p)

    def cond(s):
        _, _, _, pos, done, i = s
        return jnp.logical_and(i < n_steps,
                               jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < l_max))

    def body(s):
        buf, ends, caches, pos, done, i = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        p_ids = pos - 1 - pad_lens
        hn, caches = _wcb_hidden(p, lc, cross, tok, p_ids[:, None], caches, pos - 1, pad_lens)
        logits = jnp.matmul(hn[:, 0], p["token_embs"].astype(hn.dtype).T,
                            precision=dot_precision(hn))
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
        nxt = jnp.where(done, jnp.int32(eot_id), nxt)
        new_done = jnp.logical_or(done, jnp.logical_or(nxt == eot_id, pos + 1 >= limits))
        ends = jnp.where(jnp.logical_and(new_done, jnp.logical_not(done)), pos + 1, ends)
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos))
        return buf, ends, caches, pos + 1, new_done, i + 1

    buf, ends, caches, pos, done, _ = lax.while_loop(
        cond, body, (buf, ends, caches, pos, done, jnp.int32(0)))
    return buf, ends, caches, pos, done


_wcb_admit = partial(jax.jit, static_argnums=(1,))(_wcb_admit_body)
_wcb_admit_i8 = partial(jax.jit, static_argnums=(1, 13, 14))(_wcb_admit_i8_body)
_wcb_steps = partial(jax.jit, static_argnums=(1, 12, 13))(_wcb_steps_body)


class WhisperContinuousBatchingGenerator:
    """Greedy transcription serving over a fixed pool of ``batch_size``
    decoder slots with mid-flight segment admission. Per-segment outputs are
    token-identical to ``WhisperGenerator.transcribe_tokens``.

    ``pool_ctx`` is the pool's shared position budget (may exceed the
    decoder position table — per-row positions are relative; a LARGER pool
    context just means fewer epoch resets); ``check_every`` is decode steps
    between host scheduling points.
    """

    SAMPLE_RATE = 16_000
    N_SAMPLES = 30 * 16_000

    def __init__(self, model, tokenizer=None, batch_size: int = 4,
                 check_every: int = 16, pool_ctx: int = 2 * DEC_MAX_LEN) -> None:
        assert batch_size >= 1 and check_every >= 1
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.check_every = check_every
        self.pool_ctx = pool_ctx
        variant = "large-v3" if model.cfg.n_mels == 128 else "tiny"
        self.preprocessor = WhisperPreprocessor(variant)
        pre_fwd, cfg = self.preprocessor._forward, model.cfg

        @jax.jit
        def _encode(params, wav):  # (1, N_SAMPLES) -> (1, T, d)
            return _whisper_encode_body(params, cfg, pre_fwd(wav))

        self._encode = _encode

    def _stage_segment(self, audio) -> jnp.ndarray:
        if isinstance(audio, jnp.ndarray) and audio.shape == (self.N_SAMPLES,):
            return audio.astype(jnp.float32)[None]
        audio = np.asarray(audio, np.float32)[: self.N_SAMPLES]
        return jnp.asarray(np.pad(audio, (0, self.N_SAMPLES - len(audio)))[None])

    # ---- sharding hooks (overridden by parallel/cb_serving.py) -------------

    def _params_cfg(self):
        return self.model.params, self.model.cfg

    def _init_pool(self, params, cfg, b: int, l_max: int, t_pad: int):
        """Build the pool state: zeroed ``(caches, cross)`` self/cross caches."""
        p = params["decoder"]
        lc = cfg.dec_layer
        dtype = p["token_embs"].dtype
        caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, l_max, lc.head_dim,
                                   dtype=dtype, stacked=True)
        width = lc.n_heads * lc.head_dim
        cross = {
            "k": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "v": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "len": jnp.zeros((cfg.n_layers, b), jnp.int32),
        }
        return caches, cross

    def _admit(self, params, cfg, *args):
        return _wcb_admit(params, cfg, *args)

    def _admit_i8(self, params, cfg, *args):
        return _wcb_admit_i8(params, cfg, *args)

    def _steps(self, params, cfg, *args):
        return _wcb_steps(params, cfg, *args)

    def transcribe_many(self, audios, language: str = "en", task: str = "transcribe",
                        max_tokens: int = DEC_MAX_LEN, on_tokens=None, topk: int = 1,
                        top_p: float | None = None, temperature: float = 1.0,
                        seed: int = 0) -> list[str]:
        """Waveforms -> transcribed texts (requires a WhisperTokenizer)."""
        if self.tokenizer is None:
            raise ValueError(
                "transcribe_many() returns text and needs a tokenizer: construct with "
                "WhisperContinuousBatchingGenerator(model, WhisperTokenizer.from_openai()), "
                "or call transcribe_tokens_many(...) for raw token ids")
        init = self.tokenizer.sot_sequence(language, task)
        outs = self.transcribe_tokens_many(audios, init, self.tokenizer.eot, max_tokens,
                                           on_tokens=on_tokens, topk=topk, top_p=top_p,
                                           temperature=temperature, seed=seed)
        return [self.tokenizer.decode(o) for o in outs]

    def transcribe_long_many(self, audios, language: str = "en",
                             task: str = "transcribe",
                             max_tokens: int = DEC_MAX_LEN, topk: int = 1,
                             top_p: float | None = None, temperature: float = 1.0,
                             seed: int = 0) -> list[str]:
        """Long-form (>30 s) waveforms -> texts through the slot pool
        (requires a WhisperTokenizer). Independent-window mode: every 30 s
        window of every audio schedules as its own segment, so a pool of B
        slots keeps decoding while windows of different audios finish at
        different times — the serving-engine counterpart of
        ``WhisperGenerator.transcribe_long(condition_on_previous_text=False)``."""
        if self.tokenizer is None:
            raise ValueError(
                "transcribe_long_many() returns text and needs a tokenizer; "
                "construct with WhisperTokenizer.from_openai() or call "
                "transcribe_long_tokens_many(...) for raw token ids")
        init = self.tokenizer.sot_sequence(language, task)
        outs = self.transcribe_long_tokens_many(audios, init, self.tokenizer.eot,
                                                max_tokens, topk=topk, top_p=top_p,
                                                temperature=temperature, seed=seed)
        return ["".join(self.tokenizer.decode(w) for w in wins) for wins in outs]

    def transcribe_long_tokens_many(self, audios, initial_tokens: list[int],
                                    eot_id: int, max_tokens: int = DEC_MAX_LEN,
                                    topk: int = 1, top_p: float | None = None,
                                    temperature: float = 1.0,
                                    seed: int = 0) -> list[list[list[int]]]:
        """Split each waveform into fixed 30 s windows and schedule ALL
        windows of ALL audios through the pool as independent segments;
        returns per-audio lists of per-window GENERATED token ids (prompt and
        EOT stripped), window-identical to
        ``WhisperGenerator.transcribe_long_tokens(audio, ..., sot_prev_id=None)``.

        Sampling: window w (in global admission order across all audios)
        draws with ``fold_in(fold_in(PRNGKey(seed), w), g)`` — the segment
        contract of :meth:`transcribe_tokens_many`."""
        from .whisper import _strip_generated, split_windows

        windows, owners = [], []
        for i, a in enumerate(audios):
            w = split_windows(a, self.N_SAMPLES)
            windows.extend(w)
            owners.extend([i] * len(w))
        outs = self.transcribe_tokens_many(windows, initial_tokens, eot_id,
                                           max_tokens, topk=topk, top_p=top_p,
                                           temperature=temperature, seed=seed)
        per: list[list[list[int]]] = [[] for _ in audios]
        for owner, o in zip(owners, outs):
            per[owner].append(_strip_generated(o, len(initial_tokens), eot_id))
        return per

    def transcribe_tokens_many(self, audios, initial_tokens: list[int], eot_id: int,
                               max_tokens: int = DEC_MAX_LEN, on_tokens=None,
                               topk: int = 1, top_p: float | None = None,
                               temperature: float = 1.0, seed: int = 0) -> list[list[int]]:
        """Schedule all segments (admitted in order as slots free up); returns
        each segment's prompt+transcript token list, in order — identical per
        segment to ``WhisperGenerator.transcribe_tokens(audio, initial_tokens,
        eot_id, max_tokens)``.

        ``on_tokens(segment_index, new_tokens)``: streaming callback, invoked
        at every scheduling point (each ``check_every``-step chunk) with the
        tokens each live segment transcribed since the previous point. Every
        transcript token is delivered exactly once, in order; concatenated
        deliveries equal the returned output minus the initial tokens.

        ``topk``/``top_p``/``temperature``/``seed``: sampling (greedy by
        default). Segment r's transcript token g always draws with
        ``fold_in(fold_in(PRNGKey(seed), r), g)`` — schedule-invariant, the
        models/text/continuous.py contract."""
        from ..text.generator import _parse_sampling_params

        assert max_tokens <= DEC_MAX_LEN, (
            f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN}); "
            "dynamic_slice would silently clamp into the last position embedding")
        params, cfg = self._params_cfg()
        n_req = len(audios)
        if n_req == 0:
            return []
        greedy, has_tp, temps_l, tps_l = _parse_sampling_params(
            n_req, topk, top_p, temperature)
        n_init = len(initial_tokens)
        assert 1 <= n_init < max_tokens, "prompt leaves no room to generate"
        max_new = max_tokens - n_init  # plain generator: buffer = max_tokens total
        l_max = self.pool_ctx
        base = n_init + 1  # admission prefill chunk [pos-1-I, pos-1) needs pos >= I+1
        assert base + max_new <= l_max, (
            f"max_tokens={max_tokens} cannot fit the pool context ({l_max}); "
            "raise pool_ctx")

        b = self.batch_size
        # cross pool sized from one probe projection (padded memory length)
        mem0 = self._encode(params, self._stage_segment(audios[0]))
        t_pad = tfm.padded_cache_len(mem0.shape[1])
        caches, cross = self._init_pool(params, cfg, b, l_max, t_pad)
        i8_self, i8_cross = _attn.USE_INT8_KV, _attn.USE_INT8_KV_CROSS
        # int8 pools live as per-key int8 + scales ("len" passes through);
        # zeros quantize harmlessly (q=0, scale 1/127)
        if i8_self:
            caches = quantize_kv(caches)
        if i8_cross:
            cross = quantize_kv(cross)
        buf = jnp.zeros((b, l_max), jnp.int32)
        pad_lens = jnp.zeros((b,), jnp.int32)
        limits = jnp.zeros((b,), jnp.int32)
        ends = jnp.zeros((b,), jnp.int32)
        done = jnp.ones((b,), bool)
        init_dev = jnp.asarray(initial_tokens, jnp.int32)
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
            # after the last step chunk; finished rows' [pad:end) spans are
            # never touched by admissions
            for row in range(b):
                if slot_req[row] is not None and done_h[row]:
                    end = int(ends_h[row])
                    outputs[slot_req[row]] = buf_h[row, slot_pad[row]: end].tolist()
                    stats.tokens_generated += end - slot_pad[row] - n_init
                    slot_req[row] = None

            # all admissions at one scheduling point share the same pos and
            # prompt length, so their encoder forwards run as ONE batched
            # call (power-of-2 buckets bound the compile count; the tail
            # pads by repeating a segment). The per-segment encode is the
            # dominant admission cost — batch-1 encodes underuse the card.
            free = [r for r in range(b) if slot_req[r] is None]
            fits = pos + max_new <= l_max and pos + 1 <= l_max
            m = min(len(free), n_req - next_req) if fits else 0
            if m > 0:
                # segment 0's memory is the pool probe (mem0): don't stage or
                # encode it a second time
                first_probe = next_req == 0
                n_enc = m - 1 if first_probe else m
                mems = None
                if n_enc > 0:
                    mb = _bucket_pow2(n_enc)
                    start = next_req + (1 if first_probe else 0)
                    segs = [self._stage_segment(audios[start + i])[0]
                            for i in range(n_enc)]
                    wavs = jnp.stack(segs + [segs[-1]] * (mb - n_enc))
                    mems = self._encode(params, wavs)
                for i in range(m):
                    row = free[i]
                    if first_probe:
                        memory = mem0 if i == 0 else mems[i - 1: i]
                    else:
                        memory = mems[i: i + 1]
                    if i8_self or i8_cross:
                        buf, caches, cross, pad_lens, limits, done = self._admit_i8(
                            params, cfg, buf, caches, cross, pad_lens, limits, done,
                            jnp.int32(row), jnp.int32(pos), memory, init_dev,
                            jnp.int32(max_new), i8_self, i8_cross)
                    else:
                        buf, caches, cross, pad_lens, limits, done = self._admit(
                            params, cfg, buf, caches, cross, pad_lens, limits, done,
                            jnp.int32(row), jnp.int32(pos), memory, init_dev,
                            jnp.int32(max_new))
                    if not greedy:
                        # the segment's own key + admission position: token g
                        # of segment r draws fold_in(fold_in(base, r), g)
                        keys = keys.at[row].set(jax.random.fold_in(base_key, next_req))
                        t0s = t0s.at[row].set(pos)
                        temps_d = temps_d.at[row].set(temps_l[next_req])
                        if has_tp:
                            tps_d = tps_d.at[row].set(tps_l[next_req])
                    done_h[row] = False
                    slot_req[row] = next_req
                    slot_pad[row] = pos - n_init
                    slot_seen[row] = pos  # transcript tokens start at slot pos
                    stats.admissions += 1
                    next_req += 1

            if all(r is None for r in slot_req):
                if next_req < n_req:
                    # epoch reset (see models/text/continuous.py): zero the
                    # per-row state so parked rows can't compute negative
                    # position ids against the rewound pos
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
                jnp.int32(pos), done, jnp.int32(self.check_every), eot_id,
                topk, True if has_tp else None,
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
                    # finished rows park writing EOT past their latched end
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
