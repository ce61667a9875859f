"""Greedy speculative decoding: a small draft model proposes k tokens, the
target model verifies them in ONE chunked KV-cached forward.

Serving rationale: single-stream decode is memory-bandwidth-bound — every
step reads all of the target's weights for one token. The verify
chunk reads the weights ONCE for k+1 positions, so with an acceptance rate a
the per-token weight traffic drops by ~(1 + a·k)/(1 + draft_cost). Greedy
speculative decoding is EXACT: the emitted sequence is token-identical to
the target model's own greedy decode for ANY draft model (accepted drafts
equal the target argmax by construction; the first mismatch is replaced by
the target argmax), which is what the equivalence tests pin.

This is a capability beyond the reference (reference text/generator.py
re-forwards the whole prefix per token and has no speculative mode).

Mechanics on fixed shapes (everything under one jit, no host syncs):
- ``buf`` slots >= ``pos`` are scratch: drafts are written there and simply
  not advanced over when rejected — rolled-back KV-cache slots are never
  read because attention masks by position, and are overwritten by the next
  iteration's writes at the same positions.
- The verify chunk re-feeds the last accepted token (chunk start pos-1),
  rewriting its K/V with identical values; its logits row supplies the
  verification target for draft 0.
- The loop stops when fewer than k+1 cache slots remain (generation ends up
  to k tokens before ``max_seq_len``); final length is clamped to ``limit``
  and truncated at the first EOS, matching the plain greedy loop exactly.

Sampling (``topk>1`` / ``top_p`` / ``temperature``) uses distribution-level
rejection sampling (the speculative-sampling scheme of Leviathan et al. 2023
/ Chen et al. 2023): draft token x_j ~ q_j is accepted with probability
min(1, p_j(x_j)/q_j(x_j)); on the first rejection the replacement is drawn
from the residual max(0, p_j - q_j) (renormalized), and if all k drafts are
accepted a bonus token is drawn from p_{k+1}. The emitted sequence is then
distributed EXACTLY as step-by-step sampling from the target's (filtered)
distribution, for any draft. Sampling keys are derived positionally
(``fold_in(key, position)``) so the draft==target case is token-identical to
a positional-key plain sampler — the property the tests pin.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ._decoder_lm import decoder_lm_forward_cached, decoder_lm_make_cache
from .generator import PROMPT_BUCKET, _check_sampling, _is_greedy, _nucleus_mask


def spec_greedy_decode_loop(draft_step, verify_chunk, t_state, d_state, buf,
                            pos0, done0, limit, k: int, eos_id, l_max: int,
                            with_iters: bool = False):
    """Model-agnostic greedy speculative loop (the seq2seq generators reuse
    it with their own cached forwards — see models/text/t5.py and
    models/audio2text/whisper.py).

    ``draft_step(tok (1,), d_state, pos) -> (next_tok (), d_state)``: one
    greedy draft step given the token at position ``pos``.
    ``verify_chunk(chunk (k+1,), t_state, pos) -> (argmaxes (k+1,), t_state)``:
    target argmaxes for a chunk placed at positions ``[pos, pos+k]``.
    ``buf``: (l_max,) int32 with everything below ``pos0`` already decoded
    (prompt/start tokens + the first target token); slots >= pos0 are scratch.
    Returns ``(buf, length)`` with length clamped to ``limit``; with
    ``with_iters`` also the loop's iteration count, from which the measured
    acceptance rate follows as ``((length - pos0) / n_iters - 1) / k``
    (tokens emitted per iteration = 1 + accepted drafts).
    """
    state = (buf, pos0, t_state, d_state, done0, jnp.int32(0))

    def cond(s):
        _, pos, _, _, done, _ = s
        # need slots [pos, pos+k) for drafts and chunk [pos-1, pos+k)
        return jnp.logical_and(jnp.logical_not(done),
                               jnp.logical_and(pos < limit, pos + k <= l_max))

    def body(s):
        buf, pos, t_state, d_state, done, n_iter = s

        # ---- draft phase: k sequential single-token steps into buf[pos+j)
        for j in range(k):
            tok = lax.dynamic_slice(buf, (pos - 1 + j,), (1,))
            nxt, d_state = draft_step(tok, d_state, pos - 1 + j)
            buf = lax.dynamic_update_slice(buf, nxt[None], (pos + j,))

        # ---- verify phase: one (k+1)-token chunk through the target
        chunk = lax.dynamic_slice(buf, (pos - 1,), (k + 1,))
        t_toks, t_state = verify_chunk(chunk, t_state, pos - 1)

        drafts = lax.dynamic_slice(buf, (pos,), (k,))
        eq = (drafts == t_toks[:k]).astype(jnp.int32)
        n_acc = jnp.sum(jnp.cumprod(eq))  # leading run of accepted drafts
        correction = t_toks[n_acc]
        # pos+n_acc can be l_max exactly (all k accepted at the buffer edge);
        # dynamic_update_slice would clamp the write onto l_max-1 and stomp
        # the accepted draft there — make the clamped write a no-op instead
        val = jnp.where(pos + n_acc >= l_max, buf[l_max - 1], correction)
        buf = lax.dynamic_update_slice(buf, val[None], (pos + n_acc,))

        # emitted this iteration = t_toks[0..n_acc] (accepted drafts == the
        # target argmaxes, plus the correction/bonus token)
        idx = jnp.arange(k + 1)
        eos_hit = jnp.any(jnp.logical_and(idx <= n_acc, t_toks == eos_id))
        return buf, pos + n_acc + 1, t_state, d_state, eos_hit, n_iter + 1

    buf, length, _, _, _, n_iters = lax.while_loop(cond, body, state)
    length = jnp.minimum(length, limit)  # an iteration may overshoot
    return (buf, length, n_iters) if with_iters else (buf, length)


def _spec_greedy_loop(params, cfg, draft_params, draft_cfg, prompt_buf,
                      n_prompt, limit, k, eos_id, count_iters=False):
    """Prefill both models + while_loop of (k draft steps, 1 verify chunk).

    ``prompt_buf``: (P,) right-padded prompt; ``limit``: prompt + max_tokens
    budget. Returns ``(tokens_buf (max_seq_len,), length)`` like _generate.
    """
    l_max = cfg.max_seq_len
    dtype_t = params["token_embs"].dtype
    dtype_d = draft_params["token_embs"].dtype

    t_caches = decoder_lm_make_cache(cfg, dtype=dtype_t, stacked=False)
    d_caches = decoder_lm_make_cache(draft_cfg, dtype=dtype_d, stacked=False)

    t_logits, t_caches = decoder_lm_forward_cached(params, cfg, prompt_buf, t_caches, 0)
    _, d_caches = decoder_lm_forward_cached(draft_params, draft_cfg, prompt_buf, d_caches, 0)
    last = lax.dynamic_index_in_dim(t_logits, n_prompt - 1, axis=0, keepdims=False)

    buf = jnp.zeros((l_max,), jnp.int32)
    buf = lax.dynamic_update_slice(buf, prompt_buf.astype(jnp.int32), (0,))
    first = jnp.argmax(last, axis=-1).astype(jnp.int32)
    buf = lax.dynamic_update_slice(buf, first[None], (n_prompt,))

    def draft_step(tok, d_caches, pos):
        lg, d_caches = decoder_lm_forward_cached(
            draft_params, draft_cfg, tok, d_caches, pos)
        return jnp.argmax(lg[0], axis=-1).astype(jnp.int32), d_caches

    def verify_chunk(chunk, t_caches, pos):
        lg, t_caches = decoder_lm_forward_cached(params, cfg, chunk, t_caches, pos)
        return jnp.argmax(lg, axis=-1).astype(jnp.int32), t_caches

    return spec_greedy_decode_loop(draft_step, verify_chunk, t_caches, d_caches,
                                   buf, n_prompt + 1, first == eos_id, limit, k,
                                   eos_id, l_max, with_iters=count_iters)


_speculative_generate = partial(jax.jit, static_argnums=(1, 3, 7))(_spec_greedy_loop)
# measurement variant: also returns the loop's iteration count so tools can
# report the MEASURED acceptance rate (tools/spec_bench.py)
_speculative_generate_stats = partial(
    jax.jit, static_argnums=(1, 3, 7))(partial(_spec_greedy_loop, count_iters=True))


def truncate_decoder_lm(params: dict, cfg, n_layers: int):
    """Build an HONEST draft model from the target's own weights: the first
    ``n_layers`` of the scan-stacked decoder plus the shared embeddings and
    final norm. No training, no distillation — the prefix of a pretrained
    stack is a real (if crude) predictor of the full stack's argmax, so the
    acceptance rate it yields is a genuine operating point rather than the
    a=1 / a~0 brackets random draft weights give.

    Returns ``(draft_params, draft_cfg)`` sharing buffers with the target
    (slices of stacked arrays are views under jit; no copy until device put).
    """
    assert 1 <= n_layers <= cfg.n_layers
    draft_params = dict(params)
    draft_params["decoder"] = {
        "layers": jax.tree.map(lambda a: a[:n_layers], params["decoder"]["layers"])
    }
    from dataclasses import replace

    return draft_params, replace(cfg, n_layers=n_layers)


@partial(jax.jit, static_argnums=(1, 3, 7))
def _speculative_generate_batch(params, cfg, draft_params, draft_cfg, prompt_bufs,
                                n_prompts, limits, k, eos_id):
    """Batched greedy speculative decoding: vmap of the unbatched loop over B
    independent rows (per-row prompt length, budget, acceptance, and cache
    positions; the batched while_loop runs until every row's cond closes).
    Weights broadcast, so each draft/verify step reads them ONCE for all B
    rows — the batch axis multiplies the speculative weight-traffic win.

    ``prompt_bufs``: (B, P) RIGHT-padded rows; ``n_prompts``/``limits``: (B,).
    Caller must pass configs with ``attn_impl="xla"``: per-row cache
    positions rule out the decode kernel under vmap.
    """
    core = lambda pb, n, lim: _spec_greedy_loop(
        params, cfg, draft_params, draft_cfg, pb, n, lim, k, eos_id)
    return jax.vmap(core)(prompt_bufs, n_prompts, limits)


def _filtered_probs(logits, topk: int, top_p, temperature) -> jnp.ndarray:
    """Full-vocab fp32 probs of the SAME filtered distribution that
    generator._sample draws from (top-k and/or nucleus over temperature-scaled
    logits; zero outside the kept set). ``logits``: (R, V) rows."""
    r, v = logits.shape
    kk = topk if topk > 1 else v  # topk==1 here means nucleus-only
    vals, idx = lax.top_k(logits / temperature, kk)
    if top_p is not None:
        vals = _nucleus_mask(vals, top_p)
    pk = jax.nn.softmax(vals.astype(jnp.float32), axis=-1)
    return jnp.zeros((r, v), jnp.float32).at[jnp.arange(r)[:, None], idx].set(pk)


def _sample_probs(probs, key) -> jnp.ndarray:
    """Categorical draw from (..., V) probs (zeros stay unreachable)."""
    return jax.random.categorical(key, jnp.log(probs + 1e-30), axis=-1).astype(jnp.int32)


def _accept_and_correct(q_probs, p_probs, drafts, pos, dkey, akey, rkey):
    """The rejection-sampling core: accept the leading run of drafts with
    probability min(1, p/q) each, then draw the correction token — from the
    normalized residual max(0, p_{n_acc} - q_{n_acc}) on a rejection, or from
    p_k with the positional draft key when all k are accepted (so that
    draft==target stays a plain positional-key sampler).

    ``q_probs``: (k, V) draft rows; ``p_probs``: (k+1, V) target rows;
    ``drafts``: (k,) sampled draft tokens living at buffer positions
    ``pos + j``. Returns ``(n_acc, correction_token)``. Marginally, the
    emitted tokens (accepted drafts + correction) are distributed exactly as
    sequential draws from the ``p`` rows — pinned distributionally by
    tests/text/test_speculative_sampling.py.
    """
    k, v = q_probs.shape
    qd = jnp.take_along_axis(q_probs, drafts[:, None], axis=1)[:, 0]
    pd = jnp.take_along_axis(p_probs[:k], drafts[:, None], axis=1)[:, 0]
    us = jax.vmap(lambda j: jax.random.uniform(jax.random.fold_in(akey, pos + j)))(
        jnp.arange(k))
    acc = us * qd < pd  # u < p/q without the q=0 division
    n_acc = jnp.sum(jnp.cumprod(acc.astype(jnp.int32)))

    p_na = lax.dynamic_index_in_dim(p_probs, n_acc, axis=0, keepdims=False)
    q_ext = jnp.concatenate([q_probs, jnp.zeros((1, v), jnp.float32)])
    q_na = lax.dynamic_index_in_dim(q_ext, n_acc, axis=0, keepdims=False)
    residual = jnp.clip(p_na - q_na, 0.0, None)
    rsum = jnp.sum(residual)
    residual = jnp.where(rsum > 0, residual / rsum, p_na)  # p==q: residual is p itself
    res_tok = _sample_probs(residual, jax.random.fold_in(rkey, pos + n_acc))
    bonus_tok = _sample_probs(p_probs[k], jax.random.fold_in(dkey, pos + k))
    return n_acc, jnp.where(n_acc == k, bonus_tok, res_tok)


def spec_sample_decode_loop(draft_probs, verify_probs, t_state, d_state, buf,
                            pos0, done0, limit, k: int, eos_id, dkey, akey,
                            rkey, l_max: int):
    """Model-agnostic speculative-SAMPLING loop (rejection-sampling core; see
    module docstring). ``draft_probs(tok (1,), d_state, pos) -> (q (V,),
    d_state)`` returns the draft's FILTERED probs for position ``pos+1``; the
    loop itself draws the draft token with the positional key
    ``fold_in(dkey, pos+1)``. ``verify_probs(chunk (k+1,), t_state, pos) ->
    (p (k+1, V), t_state)`` returns the target's filtered probs for the chunk
    at positions ``[pos, pos+k]``. Buffer/early-stop semantics as
    :func:`spec_greedy_decode_loop`."""
    state = (buf, pos0, t_state, d_state, done0)

    def cond(s):
        _, pos, _, _, done = s
        return jnp.logical_and(jnp.logical_not(done),
                               jnp.logical_and(pos < limit, pos + k <= l_max))

    def body(s):
        buf, pos, t_state, d_state, done = s

        # ---- draft phase: k sampled single-token steps; keep each q row
        qs = []
        for j in range(k):
            tok = lax.dynamic_slice(buf, (pos - 1 + j,), (1,))
            q, d_state = draft_probs(tok, d_state, pos - 1 + j)
            nxt = _sample_probs(q, jax.random.fold_in(dkey, pos + j))
            qs.append(q)
            buf = lax.dynamic_update_slice(buf, nxt[None], (pos + j,))
        q_probs = jnp.stack(qs)  # (k, V)

        # ---- verify phase: one (k+1)-token chunk through the target
        chunk = lax.dynamic_slice(buf, (pos - 1,), (k + 1,))
        p_probs, t_state = verify_probs(chunk, t_state, pos - 1)

        drafts = lax.dynamic_slice(buf, (pos,), (k,))
        n_acc, correction = _accept_and_correct(q_probs, p_probs, drafts, pos,
                                                dkey, akey, rkey)
        # buffer-edge no-op write: see spec_greedy_decode_loop
        val = jnp.where(pos + n_acc >= l_max, buf[l_max - 1], correction)
        buf = lax.dynamic_update_slice(buf, val[None], (pos + n_acc,))

        # emitted = accepted drafts + the correction (buffer-read-free: a
        # window re-slice at the buffer edge would shift and mis-detect EOS)
        idx = jnp.arange(k)
        eos_hit = jnp.logical_or(
            jnp.any(jnp.logical_and(idx < n_acc, drafts == eos_id)),
            correction == eos_id)
        return buf, pos + n_acc + 1, t_state, d_state, eos_hit

    buf, length, _, _, _ = lax.while_loop(cond, body, state)
    return buf, jnp.minimum(length, limit)


def _spec_sample_loop(params, cfg, draft_params, draft_cfg, prompt_buf,
                      n_prompt, limit, k, eos_id, key, topk, top_p,
                      temperature):
    """Speculative SAMPLING: the rejection-sampling analogue of
    :func:`_speculative_generate` (same fixed-shape skeleton; see module
    docstring for the accept/residual scheme). Keys: three independent
    streams (draft/bonus, accept, residual), each folded with the ABSOLUTE
    buffer position — static key consumption regardless of acceptance, and
    draft==target reduces to a positional-key plain sampler.
    """
    l_max = cfg.max_seq_len
    dtype_t = params["token_embs"].dtype
    dtype_d = draft_params["token_embs"].dtype
    dkey, akey, rkey = jax.random.split(key, 3)

    t_caches = decoder_lm_make_cache(cfg, dtype=dtype_t, stacked=False)
    d_caches = decoder_lm_make_cache(draft_cfg, dtype=dtype_d, stacked=False)

    t_logits, t_caches = decoder_lm_forward_cached(params, cfg, prompt_buf, t_caches, 0)
    _, d_caches = decoder_lm_forward_cached(draft_params, draft_cfg, prompt_buf, d_caches, 0)
    last = lax.dynamic_index_in_dim(t_logits, n_prompt - 1, axis=0, keepdims=False)

    buf = jnp.zeros((l_max,), jnp.int32)
    buf = lax.dynamic_update_slice(buf, prompt_buf.astype(jnp.int32), (0,))
    p0 = _filtered_probs(last[None], topk, top_p, temperature)[0]
    first = _sample_probs(p0, jax.random.fold_in(dkey, n_prompt))
    buf = lax.dynamic_update_slice(buf, first[None], (n_prompt,))

    def draft_probs(tok, d_caches, pos):
        lg, d_caches = decoder_lm_forward_cached(draft_params, draft_cfg, tok, d_caches, pos)
        return _filtered_probs(lg[:1], topk, top_p, temperature)[0], d_caches

    def verify_probs(chunk, t_caches, pos):
        lg_t, t_caches = decoder_lm_forward_cached(params, cfg, chunk, t_caches, pos)
        return _filtered_probs(lg_t, topk, top_p, temperature), t_caches

    return spec_sample_decode_loop(draft_probs, verify_probs, t_caches, d_caches,
                                   buf, n_prompt + 1, first == eos_id, limit, k,
                                   eos_id, dkey, akey, rkey, l_max)


_speculative_sample_generate = partial(
    jax.jit, static_argnums=(1, 3, 7, 10, 11))(_spec_sample_loop)


@partial(jax.jit, static_argnums=(1, 3, 7, 10, 11))
def _speculative_sample_generate_batch(params, cfg, draft_params, draft_cfg,
                                       prompt_bufs, n_prompts, limits, k, eos_id,
                                       key, topk, top_p, temperature):
    """Batched speculative SAMPLING (see :func:`_speculative_generate_batch`
    for the vmap scheme). Row r's key stream is ``fold_in(key, r)``, so each
    row is distribution-exact independently and row r reproduces the
    single-row sampler run with that folded key."""
    keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(
        jnp.arange(prompt_bufs.shape[0]))
    core = lambda pb, n, lim, kk: _spec_sample_loop(
        params, cfg, draft_params, draft_cfg, pb, n, lim, k, eos_id, kk,
        topk, top_p, temperature)
    return jax.vmap(core)(prompt_bufs, n_prompts, limits, keys)


class SpeculativeDecoderGenerator:
    """DecoderGenerator accelerated by a draft model (B=1 serving).

    Greedy (default) is token-identical to
    ``DecoderGenerator(model, tok).generate_tokens(...)`` for any draft;
    sampling (topk/top_p/temperature) is distribution-exact w.r.t. the
    target (module docstring). The draft only changes speed. Draft and
    target must share the tokenizer/vocab.
    """

    def __init__(self, model, draft_model, tokenizer, k: int = 4) -> None:
        assert model.cfg.vocab_size == draft_model.cfg.vocab_size, \
            "draft and target must share a vocabulary"
        assert k >= 1
        self.model = model
        self.draft_model = draft_model
        self.tokenizer = tokenizer
        self.k = k

    @classmethod
    def with_truncated_draft(cls, model, tokenizer, n_draft_layers: int,
                             k: int = 4) -> "SpeculativeDecoderGenerator":
        """Zero-extra-weights speculative serving: draft = the first
        ``n_draft_layers`` of the target's own stack (:func:`truncate_decoder_lm`).
        Output stays token-identical to plain greedy for any draft; the
        truncation depth only moves the speed/acceptance trade-off."""
        from types import SimpleNamespace

        dp, dc = truncate_decoder_lm(model.params, model.cfg, n_draft_layers)
        return cls(model, SimpleNamespace(params=dp, cfg=dc), tokenizer, k)

    def generate(self, prompt: str, max_tokens: int = 100, topk: int = 1, seed: int = 0,
                 top_p: float | None = None, temperature: float = 1.0) -> str:
        return self.tokenizer.decode(
            self.generate_tokens(self.tokenizer.encode(prompt), max_tokens,
                                 topk=topk, seed=seed, top_p=top_p, temperature=temperature))

    def generate_tokens(self, tokens: list[int], max_tokens: int = 100, topk: int = 1,
                        seed: int = 0, top_p: float | None = None,
                        temperature: float = 1.0) -> list[int]:
        """Greedy (default) or sampled (top-k/top-p/temperature) speculative
        generation; sampling is distribution-exact w.r.t. the target (module
        docstring)."""
        _check_sampling(topk, top_p, temperature)
        cfg = self.model.cfg
        n = len(tokens)
        pad = min(-(-n // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        assert n <= pad, f"prompt too long for context {cfg.max_seq_len}"
        if max_tokens <= 0 or pad >= cfg.max_seq_len:
            return list(tokens)
        prompt_buf = np.zeros((pad,), np.int32)
        prompt_buf[:n] = tokens
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1
        limit = min(n + max_tokens, cfg.max_seq_len)
        if _is_greedy(topk, top_p):
            buf, length, n_iters = _speculative_generate_stats(
                self.model.params, cfg, self.draft_model.params, self.draft_model.cfg,
                jnp.asarray(prompt_buf), n, limit, self.k, eos)
            # serving observability (same spirit as the CB engines'
            # ServingStats): measured acceptance of the last greedy call
            emitted = int(length) - (n + 1)
            self.last_iters = int(n_iters)
            self.last_accept_rate = (
                (emitted / self.last_iters - 1) / self.k if self.last_iters else None)
        else:
            buf, length = _speculative_sample_generate(
                self.model.params, cfg, self.draft_model.params, self.draft_model.cfg,
                jnp.asarray(prompt_buf), n, limit, self.k, eos,
                jax.random.PRNGKey(seed), topk, top_p, temperature)
        out = np.asarray(buf)[:int(length)]
        # truncate at the first EOS among generated tokens (plain-loop parity)
        gen = out[n:]
        hits = np.nonzero(gen == eos)[0]
        if hits.size:
            out = out[: n + hits[0] + 1]
        return out.tolist()

    def generate_batch(self, prompts: list[str], max_tokens: int = 100, topk: int = 1,
                       seed: int = 0, top_p: float | None = None,
                       temperature: float = 1.0) -> list[str]:
        """Batched speculative generation over multiple prompts."""
        token_lists = [self.tokenizer.encode(p) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens, topk=topk, seed=seed,
                                          top_p=top_p, temperature=temperature)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100,
                              topk: int = 1, seed: int = 0, top_p: float | None = None,
                              temperature: float = 1.0) -> list[list[int]]:
        """Batched :meth:`generate_tokens`: B rows draft+verify together with
        per-row acceptance (vmapped loop; weights read once per step for all
        rows). Greedy rows are token-identical to the single-row path; sampled
        rows use the per-row key stream ``fold_in(PRNGKey(seed), row)``."""
        _check_sampling(topk, top_p, temperature)
        cfg = self.model.cfg
        b = len(token_lists)
        ns = [len(t) for t in token_lists]
        assert b >= 1 and min(ns) >= 1
        n_max = max(ns)
        pad = min(-(-n_max // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        assert n_max <= pad, f"prompt too long for context {cfg.max_seq_len}"
        if max_tokens <= 0 or pad >= cfg.max_seq_len:
            return [list(t) for t in token_lists]
        prompt_bufs = np.zeros((b, pad), np.int32)  # RIGHT-padded rows
        for i, t in enumerate(token_lists):
            prompt_bufs[i, :ns[i]] = t
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1
        limits = np.minimum(np.asarray(ns, np.int64) + max_tokens,
                            cfg.max_seq_len).astype(np.int32)

        # the vmapped loop can't batch the decode kernel (per-row cache
        # positions): trace with the einsum attention path
        from dataclasses import replace

        cfg_x = replace(cfg, attn_impl="xla")
        dcfg_x = replace(self.draft_model.cfg, attn_impl="xla")
        if _is_greedy(topk, top_p):
            bufs, lengths = _speculative_generate_batch(
                self.model.params, cfg_x, self.draft_model.params, dcfg_x,
                jnp.asarray(prompt_bufs), jnp.asarray(ns, dtype=jnp.int32),
                jnp.asarray(limits), self.k, eos)
        else:
            bufs, lengths = _speculative_sample_generate_batch(
                self.model.params, cfg_x, self.draft_model.params, dcfg_x,
                jnp.asarray(prompt_bufs), jnp.asarray(ns, dtype=jnp.int32),
                jnp.asarray(limits), self.k, eos, jax.random.PRNGKey(seed),
                topk, top_p, temperature)
        bufs, lengths = np.asarray(bufs), np.asarray(lengths)
        outs = []
        for i in range(b):
            out = bufs[i, : lengths[i]]
            gen = out[ns[i]:]
            hits = np.nonzero(gen == eos)[0]
            if hits.size:
                out = out[: ns[i] + hits[0] + 1]
            outs.append(out.tolist())
        return outs
