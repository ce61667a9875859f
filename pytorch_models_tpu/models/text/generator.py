"""Autoregressive text generation with a jitted KV-cached decode loop.

API-compatible with the reference ``DecoderGenerator`` (reference
text/generator.py:11-37): greedy (``topk=1``) or top-k sampling, EOS stop,
same tokenizer protocol — plus top-p/nucleus sampling and a temperature
knob (extensions; the reference has top-k only). Instead of the
reference's per-token full re-forward + ``.item()`` host sync: one jitted
prefill over the (bucket-padded) prompt fills the KV cache, then a single
``lax.while_loop`` generates tokens on-device with no host round-trips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...ops import attention as _attn
from ...ops.int8_kv import quantize_kv
from ._decoder_lm import (
    decoder_lm_apply,
    decoder_lm_forward_cached,
    decoder_lm_forward_cached_batch,
    decoder_lm_make_cache,
)

PROMPT_BUCKET = 64  # prompts are right-padded to a multiple of this to bound recompiles


def _check_sampling(topk: int, top_p, temperature) -> None:
    assert topk >= 1, f"topk must be >= 1, got {topk}"
    assert top_p is None or 0.0 < top_p <= 1.0, f"top_p must be in (0, 1], got {top_p}"
    assert temperature > 0.0, f"temperature must be > 0 (use topk=1 for greedy), got {temperature}"


def _is_greedy(topk: int, top_p) -> bool:
    return topk == 1 and top_p is None


def _parse_sampling_params(n_req: int, topk: int, top_p, temperature):
    """Per-request sampling params for the serving engines: ``temperature``
    and ``top_p`` may be lists (length ``n_req``); ``topk`` and the nucleus
    on/off mode are per-call (they change the sampling graph shape).
    Returns ``(greedy, has_tp, temps_l, tps_l)``."""
    temps_l = (list(temperature) if isinstance(temperature, (list, tuple))
               else [temperature] * n_req)
    has_tp = top_p is not None
    tps_l = ((list(top_p) if isinstance(top_p, (list, tuple))
              else [top_p] * n_req) if has_tp else [None] * n_req)
    assert len(temps_l) == n_req and len(tps_l) == n_req, \
        "per-request temperature/top_p lists must have one entry per request"
    for tp_r, tm_r in zip(tps_l, temps_l):
        assert not has_tp or tp_r is not None, "mixed top_p on/off is per-call"
        _check_sampling(topk, tp_r, tm_r)
    return _is_greedy(topk, 1.0 if has_tp else None), has_tp, temps_l, tps_l


def _nucleus_mask(vals: jnp.ndarray, top_p: float) -> jnp.ndarray:
    """Mask DESC-sorted logits outside the smallest set with prob mass >= top_p.

    The token that crosses the threshold is kept (standard nucleus rule), so
    at least one token always survives.
    """
    probs = jax.nn.softmax(vals.astype(jnp.float32), axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = (cum - probs) < top_p
    return jnp.where(keep, vals, jnp.finfo(vals.dtype).min)


def _sample(logits: jnp.ndarray, key, topk: int, top_p=None, temperature=1.0) -> jnp.ndarray:
    """Greedy / top-k (ref generator.py:26-31) / top-p / combined sampling.

    Works on (..., V) logits; temperature is a dynamic scalar, topk/top_p are
    static (they change the sampling graph). ``topk == 1`` with ``top_p``
    set means nucleus-only sampling over the full vocabulary.
    """
    if _is_greedy(topk, top_p):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    k = topk if topk > 1 else (logits.shape[-1] if top_p is not None else topk)
    vals, idx = lax.top_k(logits / temperature, k)
    if top_p is not None:
        vals = _nucleus_mask(vals, top_p)
    choice = jax.random.categorical(key, vals, axis=-1)
    return jnp.take_along_axis(idx, choice[..., None], axis=-1)[..., 0].astype(jnp.int32)


@partial(jax.jit, static_argnums=(1, 5, 8))
def _generate(params, cfg, prompt_buf, n_prompt, limit, topk, eos_id, key,
              top_p=None, temperature=1.0):
    """Prefill + while_loop decode, fully on device.

    ``prompt_buf``: (P,) right-padded prompt, P a static bucket multiple.
    ``limit``: total token budget (prompt + max_tokens, ≤ cfg.max_seq_len).
    Returns ``(tokens_buf (max_seq_len,), length)``.
    """
    greedy = _is_greedy(topk, top_p)
    cache_dtype = params["token_embs"].dtype
    caches = decoder_lm_make_cache(cfg, dtype=cache_dtype, stacked=False)
    logits, caches = decoder_lm_forward_cached(params, cfg, prompt_buf, caches, 0)
    if _attn.USE_INT8_KV:  # int8 self-KV (opt-in): quantize the prefilled cache once
        caches = quantize_kv(caches)
    last_logits = lax.dynamic_index_in_dim(logits, n_prompt - 1, axis=0, keepdims=False)

    tokens_buf = jnp.zeros((cfg.max_seq_len,), jnp.int32)
    tokens_buf = lax.dynamic_update_slice(tokens_buf, prompt_buf.astype(jnp.int32), (0,))

    key, sub = (key, key) if greedy else jax.random.split(key)
    first = _sample(last_logits, sub, topk, top_p, temperature)
    tokens_buf = lax.dynamic_update_slice(tokens_buf, first[None], (n_prompt,))
    state = (tokens_buf, n_prompt + 1, caches, key, first == eos_id)

    def cond(s):
        _, pos, _, _, done = s
        return jnp.logical_and(jnp.logical_not(done), pos < limit)

    def body(s):
        buf, pos, caches, key, _ = s
        tok = lax.dynamic_slice(buf, (pos - 1,), (1,))
        logits, caches = decoder_lm_forward_cached(params, cfg, tok, caches, pos - 1)
        # greedy never consumes randomness: skip the per-step threefry split
        key, sub = (key, key) if greedy else jax.random.split(key)
        nxt = _sample(logits[0], sub, topk, top_p, temperature)
        buf = lax.dynamic_update_slice(buf, nxt[None], (pos,))
        return (buf, pos + 1, caches, key, nxt == eos_id)

    tokens_buf, length, _, _, _ = lax.while_loop(cond, body, state)
    return tokens_buf, length


def _generate_batch_body(params, cfg, prompt_buf, pad_lens, limit, topk, eos_id, key,
                         top_p=None, temperature=1.0):
    """Batched greedy/top-k generation over LEFT-padded prompts.

    Beyond the reference (single-prompt only, text/generator.py:17-37):
    all rows share cache slots because prompts are left-aligned to the same
    end position; per-row position ids and a pad-mask bias keep each row's
    math identical to its unpadded equivalent.

    ``prompt_buf``: (B, P) with each row's tokens right-aligned;
    ``pad_lens``: (B,) number of left-pad slots per row. Returns
    ``(tokens (B, max_seq_len), lengths (B,))`` where row i's output occupies
    slots ``[pad_i, len_i)``.
    """
    greedy = _is_greedy(topk, top_p)
    b, p_len = prompt_buf.shape
    l_max = cfg.max_seq_len
    pos_ids = jnp.clip(jnp.arange(p_len)[None, :] - pad_lens[:, None], 0, None)

    cache_dtype = params["token_embs"].dtype
    # a LIST of per-layer caches: no layer-slice read-modify-write per step
    caches = decoder_lm_make_cache(cfg, (b,), dtype=cache_dtype, stacked=False)
    logits, caches = decoder_lm_forward_cached_batch(params, cfg, prompt_buf, pos_ids, caches, 0, pad_lens)
    last = logits[:, -1]  # rows are right-aligned: slot P-1 is each row's last prompt token
    if _attn.USE_INT8_KV:
        # int8 self-KV serving (opt-in): the prefilled cache quantizes once
        # here; decode steps write quantized
        caches = quantize_kv(caches)

    buf = jnp.zeros((b, l_max), jnp.int32)
    buf = lax.dynamic_update_slice(buf, prompt_buf.astype(jnp.int32), (0, 0))
    return _decode_rows(params, cfg, buf, p_len, last, caches, pad_lens, limit, topk,
                        eos_id, key, top_p, temperature)


def _decode_rows(params, cfg, buf, p_len, last, caches, pad_lens, limit, topk, eos_id,
                 key, top_p, temperature):
    """Shared decode loop over B prefilled rows: sample each row's first token
    from ``last`` (B, V), then while_loop single-token steps until every row
    hits EOS or ``limit``. Returns ``(buf (B, max_seq_len), lengths (B,))``."""
    greedy = _is_greedy(topk, top_p)
    b = buf.shape[0]

    def sample_rows(lg, key):
        return _sample(lg, key, topk, top_p, temperature)

    key, sub = (key, key) if greedy else jax.random.split(key)
    nxt = sample_rows(last, sub)
    buf = buf.at[:, p_len].set(nxt)
    done = nxt == eos_id
    state = (buf, jnp.int32(p_len + 1), caches, key, done)

    def cond(s):
        _, pos, _, _, done = s
        return jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < limit)

    def body(s):
        buf, pos, caches, key, done = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        p_ids = (pos - 1 - pad_lens)[:, None]
        logits, caches = decoder_lm_forward_cached_batch(params, cfg, tok, p_ids, caches,
                                                         pos - 1, pad_lens)
        key, sub = (key, key) if greedy else jax.random.split(key)
        nxt = sample_rows(logits[:, 0], sub)
        nxt = jnp.where(done, jnp.int32(eos_id), nxt)  # finished rows stay parked on EOS
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos))
        return buf, pos + 1, caches, key, jnp.logical_or(done, nxt == eos_id)

    buf, length, _, _, done = lax.while_loop(cond, body, state)
    # per-row length: first EOS among actually-generated slots, else `length`
    # (untouched buffer zeros beyond `length` must not read as EOS)
    gen = buf[:, p_len:]
    generated = jnp.arange(gen.shape[1])[None, :] < (length - p_len)
    is_eos = jnp.logical_and(gen == eos_id, generated)
    first_eos = jnp.argmax(is_eos, axis=1)
    has_eos = jnp.any(is_eos, axis=1)
    lengths = jnp.where(has_eos, p_len + first_eos + 1, length)
    return buf, lengths


_generate_batch = partial(jax.jit, static_argnums=(1, 5, 8))(_generate_batch_body)


def _generate_samples_body(params, cfg, prompt_buf, pad_len, limit, topk, eos_id,
                           key, n, top_p=None, temperature=1.0):
    """N independent samples of ONE prompt with a SHARED prefill: the prompt
    is forwarded once (batch 1), its KV cache is broadcast to ``n`` rows, and
    the rows decode through the same loop as :func:`_generate_batch_body` —
    token-identical to generating ``n`` copies of the prompt, minus n-1
    prefills (best-of-n / self-consistency serving; beyond the reference).

    ``prompt_buf``: (P,) LEFT-padded (``pad_len`` pad slots); returns
    ``(tokens (n, max_seq_len), lengths (n,))``.
    """
    p_len = prompt_buf.shape[0]
    l_max = cfg.max_seq_len
    pad1 = pad_len.reshape(1)
    pos_ids = jnp.clip(jnp.arange(p_len)[None, :] - pad1[:, None], 0, None)

    cache_dtype = params["token_embs"].dtype
    caches = decoder_lm_make_cache(cfg, (1,), dtype=cache_dtype, stacked=False)
    logits, caches = decoder_lm_forward_cached_batch(
        params, cfg, prompt_buf[None], pos_ids, caches, 0, pad1)
    last = jnp.broadcast_to(logits[:, -1], (n, logits.shape[-1]))

    # fan the prefilled per-layer caches out to n rows
    caches = jax.tree.map(lambda c: jnp.broadcast_to(c, (n,) + c.shape[1:]), caches)

    buf = jnp.zeros((n, l_max), jnp.int32)
    buf = lax.dynamic_update_slice(buf, jnp.broadcast_to(prompt_buf, (n, p_len)).astype(jnp.int32), (0, 0))
    pad_lens = jnp.broadcast_to(pad1, (n,))
    return _decode_rows(params, cfg, buf, p_len, last, caches, pad_lens, limit, topk,
                        eos_id, key, top_p, temperature)


_generate_samples = partial(jax.jit, static_argnums=(1, 5, 8, 9))(_generate_samples_body)


@partial(jax.jit, static_argnums=(1,))
def _score_tokens(params, cfg, buf, n_rows):
    """Teacher-forced per-token log-probs: (B, P) right-padded rows with (B,)
    valid lengths -> (B, P-1) fp32 ``log p(x_t | x_<t)`` for t in [1, P),
    zeroed past each row's length (causal masking makes right-pad harmless)."""
    logits = decoder_lm_apply(params, cfg, buf)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    tgt = buf[:, 1:].astype(jnp.int32)
    ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return ll * (jnp.arange(1, buf.shape[1])[None, :] < n_rows[:, None])


class DecoderGenerator:
    """Drop-in equivalent of the reference DecoderGenerator (generator.py:11-37)."""

    def __init__(self, model, tokenizer) -> None:
        self.model = model
        self.tokenizer = tokenizer

    def generate(self, prompt: str, max_tokens: int = 100, topk: int = 1, seed: int = 0,
                 top_p: float | None = None, temperature: float = 1.0) -> str:
        tokens = self.tokenizer.encode(prompt)
        out = self.generate_tokens(tokens, max_tokens=max_tokens, topk=topk, seed=seed,
                                   top_p=top_p, temperature=temperature)
        return self.tokenizer.decode(out)

    def generate_tokens(self, tokens: list[int], max_tokens: int = 100, topk: int = 1, seed: int = 0,
                        top_p: float | None = None, temperature: float = 1.0) -> list[int]:
        """Greedy (default), top-k (ref generator.py:26-31), top-p/nucleus,
        or combined sampling; ``temperature`` rescales logits when sampling
        (top-p and temperature are extensions beyond the reference)."""
        _check_sampling(topk, top_p, temperature)
        cfg = self.model.cfg
        n = len(tokens)
        if max_tokens <= 0 or n >= cfg.max_seq_len:
            return list(tokens)
        pad = -(-n // PROMPT_BUCKET) * PROMPT_BUCKET
        pad = min(pad, cfg.max_seq_len)
        assert n <= pad, f"prompt too long for context {cfg.max_seq_len}"
        prompt_buf = np.zeros((pad,), np.int32)
        prompt_buf[:n] = tokens

        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1  # never matches
        limit = min(n + max_tokens, cfg.max_seq_len)
        buf, length = _generate(
            self.model.params, cfg, jnp.asarray(prompt_buf), n, limit, topk, eos,
            jax.random.PRNGKey(seed), top_p, temperature,
        )
        length = int(length)
        return np.asarray(buf)[:length].tolist()

    def beam_search(self, prompt: str, max_tokens: int = 100, beam_width: int = 4,
                    length_penalty: float = 0.0) -> str:
        tokens = self.tokenizer.encode(prompt)
        out = self.beam_search_tokens(tokens, max_tokens, beam_width, length_penalty)
        return self.tokenizer.decode(out)

    def beam_search_tokens(self, tokens: list[int], max_tokens: int = 100, beam_width: int = 4,
                           length_penalty: float = 0.0, return_all: bool = False):
        """Beam-search decoding (extension; the reference is greedy/top-k
        only). Returns the best sequence, or ``(sequences, scores)`` with
        ``return_all`` — see models/text/beam.py."""
        from .beam import beam_search_tokens

        eos = getattr(self.tokenizer, "eos_token_id", None)
        return beam_search_tokens(self.model, tokens, max_tokens, beam_width,
                                  -1 if eos is None else eos, length_penalty, return_all)

    def beam_search_batch(self, prompts: list[str], max_tokens: int = 100, beam_width: int = 4,
                          length_penalty: float = 0.0) -> list[str]:
        """Beam search over multiple prompts in one batched decode."""
        token_lists = [self.tokenizer.encode(p) for p in prompts]
        outs = self.beam_search_tokens_batch(token_lists, max_tokens, beam_width, length_penalty)
        return [self.tokenizer.decode(o) for o in outs]

    def beam_search_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100,
                                 beam_width: int = 4, length_penalty: float = 0.0,
                                 return_all: bool = False):
        """Batched :meth:`beam_search_tokens`: all G*W beam rows of the G
        prompts step together through the batched decode path. Returns the
        best sequence per prompt, or ``(sequences, scores)`` lists with
        ``return_all`` — see models/text/beam.py."""
        from .beam import beam_search_tokens_batch

        eos = getattr(self.tokenizer, "eos_token_id", None)
        return beam_search_tokens_batch(self.model, token_lists, max_tokens, beam_width,
                                        -1 if eos is None else eos, length_penalty, return_all)

    def generate_batch(self, prompts: list[str], max_tokens: int = 100, topk: int = 1, seed: int = 0,
                       top_p: float | None = None, temperature: float = 1.0) -> list[str]:
        """Batched generation over multiple prompts (new vs the reference)."""
        token_lists = [self.tokenizer.encode(p) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens=max_tokens, topk=topk, seed=seed,
                                          top_p=top_p, temperature=temperature)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100, topk: int = 1,
                              seed: int = 0, top_p: float | None = None,
                              temperature: float = 1.0) -> list[list[int]]:
        _check_sampling(topk, top_p, temperature)
        cfg = self.model.cfg
        if max_tokens <= 0:
            return [list(ts) for ts in token_lists]
        max_n = max(len(ts) for ts in token_lists)
        pad = min(-(-max_n // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        assert max_n <= pad, f"prompt too long for context {cfg.max_seq_len}"
        if pad >= cfg.max_seq_len:  # no room left to generate (mirrors the single-path guard)
            return [list(ts) for ts in token_lists]
        b = len(token_lists)
        buf = np.zeros((b, pad), np.int32)
        pad_lens = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):  # LEFT-pad: right-align each row
            pad_lens[i] = pad - len(ts)
            buf[i, pad_lens[i]:] = ts

        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1
        limit = min(pad + max_tokens, cfg.max_seq_len)
        out, lengths = _generate_batch(
            self.model.params, cfg, jnp.asarray(buf), jnp.asarray(pad_lens), limit, topk, eos,
            jax.random.PRNGKey(seed), top_p, temperature,
        )
        out, lengths = np.asarray(out), np.asarray(lengths)
        return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(b)]

    def generate_samples(self, prompt: str, n: int, max_tokens: int = 100, topk: int = 40,
                         seed: int = 0, top_p: float | None = None,
                         temperature: float = 1.0) -> list[str]:
        """N independent samples of one prompt with a SHARED prefill (the
        prompt is forwarded once and its KV cache fans out to the n rows) —
        best-of-n / self-consistency serving. Token-identical to
        :meth:`generate_batch` over n copies of the prompt."""
        outs = self.generate_tokens_samples(self.tokenizer.encode(prompt), n,
                                            max_tokens=max_tokens, topk=topk, seed=seed,
                                            top_p=top_p, temperature=temperature)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_samples(self, tokens: list[int], n: int, max_tokens: int = 100,
                                topk: int = 40, seed: int = 0, top_p: float | None = None,
                                temperature: float = 1.0) -> list[list[int]]:
        """Token-level :meth:`generate_samples`. With greedy settings
        (``topk=1``, no ``top_p``) all n rows are identical by construction."""
        _check_sampling(topk, top_p, temperature)
        assert n >= 1
        cfg = self.model.cfg
        if max_tokens <= 0:
            return [list(tokens) for _ in range(n)]
        pad = min(-(-max(len(tokens), 1) // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        assert len(tokens) <= pad, f"prompt too long for context {cfg.max_seq_len}"
        if pad >= cfg.max_seq_len:
            return [list(tokens) for _ in range(n)]
        buf = np.zeros((pad,), np.int32)
        pad_len = pad - len(tokens)
        buf[pad_len:] = tokens

        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1
        limit = min(pad + max_tokens, cfg.max_seq_len)
        out, lengths = _generate_samples(
            self.model.params, cfg, jnp.asarray(buf), jnp.asarray(pad_len, jnp.int32),
            limit, topk, eos, jax.random.PRNGKey(seed), n, top_p, temperature,
        )
        out, lengths = np.asarray(out), np.asarray(lengths)
        return [out[i, pad_len: lengths[i]].tolist() for i in range(n)]

    def score_tokens(self, tokens: list[int]) -> list[float]:
        """Per-token log-probs ``log p(x_t | x_<t)`` for t >= 1 (teacher-forced,
        one jitted forward; new vs the reference). Length: len(tokens) - 1."""
        return self.score_tokens_batch([tokens])[0]

    def score_tokens_batch(self, token_lists: list[list[int]]) -> list[list[float]]:
        """Batched :meth:`score_tokens` over right-padded rows."""
        cfg = self.model.cfg
        assert all(len(ts) >= 2 for ts in token_lists), "scoring needs >= 2 tokens"
        max_n = max(len(ts) for ts in token_lists)
        assert max_n <= cfg.max_seq_len, f"sequence too long for context {cfg.max_seq_len}"
        pad = min(-(-max_n // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        b = len(token_lists)
        buf = np.zeros((b, pad), np.int32)
        ns = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            buf[i, : len(ts)] = ts
            ns[i] = len(ts)
        ll = np.asarray(_score_tokens(self.model.params, cfg, jnp.asarray(buf), jnp.asarray(ns)))
        return [ll[i, : ns[i] - 1].tolist() for i in range(b)]

    def perplexity(self, text: str) -> float:
        """exp(-mean per-token log-prob) of the tokenized text."""
        lls = self.score_tokens(self.tokenizer.encode(text))
        return float(np.exp(-np.mean(lls)))
