"""Pipeline-parallel SERVING: stage-sharded KV-cached generation.

Completes the serving matrix next to tensor parallelism (parallel/serving.py):
a decoder LM whose layers don't fit one chip generates over a ``("pp",)``
mesh. Each rank owns one contiguous stage of ``n_layers / pp`` layers AND
that stage's KV caches — cache memory scales down with the stage count,
which is the point of pp serving (the reference has no distributed layer at
all, SURVEY.md §2.7 N3).

Schedule: single-stream greedy decode is inherently sequential across stages
(token t+1 needs token t through every layer), so each decode step runs
``n_stages`` ticks; activations hop rank→rank+1 conceptually, implemented
SPMD-style as compute-everywhere + a one-hot ``psum`` broadcast of the owning
rank's output (the same trick as parallel/pipeline.py's GPipe loop — a
``ppermute`` chain would serialize identically). Stage-local cache updates
are gated to the owning tick so garbage activations never touch a cache.
Throughput-oriented serving would interleave independent request groups
across ticks (the GPipe schedule in parallel/pipeline.py is exactly that
shape); this module demonstrates the memory-scaling and correctness story:
output is token-identical to the single-device generator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import transformer as tfm
from ..models.text.generator import PROMPT_BUCKET
from ..ops import layer_norm


def pp_param_pspecs(params) -> dict:
    """Decoder layers sharded over "pp" (leading stage axis added by
    :func:`stage_stack`); embeddings / final norm replicated."""
    def spec(path, leaf):
        s = jax.tree_util.keystr(path)
        return P("pp") if "['decoder']['layers']" in s else P()

    return jax.tree_util.tree_map_with_path(spec, params)


def stage_stack(params: dict, n_stages: int) -> dict:
    """(L, ...) layer-stacked decoder params -> (n_stages, L/pp, ...)."""
    def reshape(x):
        return x.reshape(n_stages, x.shape[0] // n_stages, *x.shape[1:])

    out = dict(params)
    out["decoder"] = dict(params["decoder"])
    out["decoder"]["layers"] = jax.tree.map(reshape, params["decoder"]["layers"])
    return out


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _pp_generate_body(params, prompt_buf, pad_lens, limit, eos_id, *, cfg, n_stages: int):
    """Greedy batched generation with stage-sharded layers; runs per-rank
    inside shard_map over ("pp",). Mirrors generator._generate_batch_body."""
    from ..models.text._decoder_lm import _final_hidden
    b, p_len = prompt_buf.shape
    lc = cfg.layer
    rank = lax.axis_index("pp")
    layers_per_stage = cfg.n_layers // n_stages
    pos_ids = jnp.clip(jnp.arange(p_len)[None, :] - pad_lens[:, None], 0, None)

    # THIS rank's stage caches only: cache HBM scales as 1/pp
    caches = tfm.make_kv_cache(layers_per_stage, (b,), lc.n_heads, cfg.max_seq_len,
                               lc.head_dim, dtype=params["token_embs"].dtype)
    stage_p = {"layers": jax.tree.map(lambda x: x[0], params["decoder"]["layers"])}

    def run_stages(x, caches, pos, pads):
        """x through all stages: every rank computes every tick; the owning
        rank's output is broadcast with a one-hot psum and only the owning
        tick's cache update is kept."""
        for s in range(n_stages):
            y, new_c = tfm.decoder_apply(stage_p, lc, x, self_caches=caches,
                                         pos=pos, pad_lens=pads)
            x = lax.psum(jnp.where(rank == s, y, jnp.zeros_like(y)), "pp")
            caches = _tree_where(rank == s, new_c, caches)
        return x, caches

    def head(x):
        x = _final_hidden(params, cfg, x)
        from ..ops.layers import dot_precision

        return jnp.matmul(x, params["token_embs"].astype(x.dtype).T,
                          precision=dot_precision(x))

    # prefill
    x = jnp.take(params["token_embs"], prompt_buf, axis=0)
    x = x + jnp.take(params["pos_embs"], pos_ids, axis=0).astype(x.dtype)
    x, caches = run_stages(x, caches, 0, pad_lens)
    logits = head(x)

    buf = jnp.zeros((b, cfg.max_seq_len), jnp.int32)
    buf = lax.dynamic_update_slice(buf, prompt_buf.astype(jnp.int32), (0, 0))
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    buf = buf.at[:, p_len].set(nxt)
    done = nxt == eos_id
    state = (buf, jnp.int32(p_len + 1), caches, done)

    def cond(s):
        _, pos, _, done = s
        return jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < limit)

    def body(s):
        buf, pos, caches, done = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        p_ids = (pos - 1 - pad_lens)[:, None]
        x = jnp.take(params["token_embs"], tok, axis=0)
        x = x + jnp.take(params["pos_embs"], p_ids, axis=0).astype(x.dtype)
        x, caches = run_stages(x, caches, pos - 1, pad_lens)
        nxt = jnp.argmax(head(x)[:, 0], axis=-1).astype(jnp.int32)
        nxt = jnp.where(done, jnp.int32(eos_id), nxt)
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos))
        return buf, pos + 1, caches, jnp.logical_or(done, nxt == eos_id)

    buf, length, _, done = lax.while_loop(cond, body, state)
    gen = buf[:, p_len:]
    generated = jnp.arange(gen.shape[1])[None, :] < (length - p_len)
    is_eos = jnp.logical_and(gen == eos_id, generated)
    lengths = jnp.where(jnp.any(is_eos, axis=1),
                        p_len + jnp.argmax(is_eos, axis=1) + 1, length)
    return buf, lengths


class PPDecoderGenerator:
    """Stage-sharded drop-in for ``DecoderGenerator.generate_tokens_batch``
    over a ``("pp",)`` mesh; token-identical to the single-device generator
    (tests/parallel/test_pp_serving.py)."""

    def __init__(self, model, tokenizer, mesh: Mesh) -> None:
        self.model = model
        self.tokenizer = tokenizer
        axes = dict(mesh.shape)
        assert set(axes) == {"pp"}, f'pp serving mesh needs a ("pp",) axis, got {tuple(axes)}'
        self.n_stages = axes["pp"]
        cfg = model.cfg
        assert cfg.n_layers % self.n_stages == 0, (
            f"{cfg.n_layers} layers not divisible by pp={self.n_stages}")

        staged = stage_stack(model.params, self.n_stages)
        pspecs = pp_param_pspecs(staged)
        self.params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), staged, pspecs)

        n_stages = self.n_stages

        def sharded(params, prompt_buf, pad_lens, limit, eos_id):
            fn = jax.shard_map(
                partial(_pp_generate_body, cfg=cfg, n_stages=n_stages),
                mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )
            return fn(params, prompt_buf, pad_lens, limit, eos_id)

        self._generate = jax.jit(sharded)

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100) -> list[list[int]]:
        cfg = self.model.cfg
        if max_tokens <= 0:
            return [list(ts) for ts in token_lists]
        max_n = max(len(ts) for ts in token_lists)
        pad = min(-(-max_n // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        assert max_n <= pad, f"prompt too long for context {cfg.max_seq_len}"
        if pad >= cfg.max_seq_len:
            return [list(ts) for ts in token_lists]
        b = len(token_lists)
        buf = np.zeros((b, pad), np.int32)
        pad_lens = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            pad_lens[i] = pad - len(ts)
            buf[i, pad_lens[i]:] = ts

        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1
        limit = min(pad + max_tokens, cfg.max_seq_len)
        out, lengths = self._generate(self.params, jnp.asarray(buf),
                                      jnp.asarray(pad_lens), limit, eos)
        out, lengths = np.asarray(out), np.asarray(lengths)
        return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(b)]
