"""2D tensor x pipeline parallel SERVING: stage- AND head-sharded generation.

Composes the two 1D serving stories (parallel/serving.py TP, parallel/
pp_serving.py PP) on one ``("pp", "tp")`` mesh — the layout a real
multi-host serving deployment uses when a model's layers don't fit one chip
(pp across hosts, DCN-friendly: one activation hop per stage) AND a single
layer's heads/MLP are sharded across the chips of each host (tp riding ICI:
two psums per layer). The reference has no distributed layer at all
(SURVEY.md §2.7 N3).

Sharding:
- decoder layers: leading stage axis over "pp" (``stage_stack``), then
  Megatron head sharding over "tp" within each stage — column-parallel
  q/k/v/fc1 kernels+biases split on the output dim, row-parallel o/fc2
  kernels split on the input dim and psum'd (transformer.reduce_linear via
  ``LayerConfig.tp_axis``).
- KV caches: stage-local AND head-sharded ``(B, Lmax, H*D/tp)`` per rank —
  cache HBM scales as ``1/(pp*tp)``.
- embeddings / final norm / logits: replicated (every rank computes the
  head; results are identical).

Schedule: as pp_serving.py — single-stream decode is sequential across
stages, so each step runs ``pp`` ticks with a one-hot ``psum`` broadcast of
the owning stage's output; within every tick the stage's layers run
tp-sharded. Output is token-identical to the single-device generator
(tests/parallel/test_tp_pp_serving.py).
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import transformer as tfm
from ..models.text.generator import PROMPT_BUCKET
from .pp_serving import _tree_where, stage_stack


def tp_pp_param_pspecs(staged_params) -> dict:
    """shard_map PartitionSpecs for stage-stacked decoder-LM params: layer
    leaves carry the leading "pp" stage axis plus the serving-TP column/row
    split (see parallel/serving.py:decoder_lm_serving_pspecs for why
    column-parallel biases shard WITH their kernels); embeddings and the
    final norm are replicated."""
    col = ("['q']", "['k']", "['v']", "['fc1']")
    row = ("['o']", "['fc2']")

    def spec(path, leaf):
        s = jax.tree_util.keystr(path)
        if "['decoder']['layers']" not in s:
            return P()
        if any(k in s for k in col):
            pad = (None,) * (leaf.ndim - 2)
            return P("pp", *pad, "tp")
        if any(k in s for k in row) and s.endswith("['w']"):
            pad = (None,) * (leaf.ndim - 3)
            return P("pp", *pad, "tp", None)
        return P("pp")

    return jax.tree_util.tree_map_with_path(spec, staged_params)


def _tp_pp_generate_body(params, prompt_buf, pad_lens, limit, eos_id, *,
                         cfg, n_stages: int):
    """Greedy batched generation, per-rank inside shard_map over ("pp","tp").

    Mirrors pp_serving._pp_generate_body with the stage layers running
    head-sharded (``cfg`` here is the tp-LOCAL config: local_heads set,
    tp_axis="tp" triggers the per-layer psums inside decoder_apply)."""
    from ..models.text._decoder_lm import _final_hidden
    b, p_len = prompt_buf.shape
    lc = cfg.layer  # tp-local layer config
    rank = lax.axis_index("pp")
    layers_per_stage = cfg.n_layers // n_stages
    pos_ids = jnp.clip(jnp.arange(p_len)[None, :] - pad_lens[:, None], 0, None)

    # THIS rank's caches: its stage's layers, its tp shard of the heads
    caches = tfm.make_kv_cache(layers_per_stage, (b,), lc.n_heads, cfg.max_seq_len,
                               lc.head_dim, dtype=params["token_embs"].dtype)
    stage_p = {"layers": jax.tree.map(lambda x: x[0], params["decoder"]["layers"])}

    def run_stages(x, caches, pos, pads):
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


class TPPPDecoderGenerator:
    """2D/3D stage+head(-and-batch)-sharded drop-in for
    ``generate_tokens_batch`` over a ``("pp", "tp")`` or ``("dp", "pp",
    "tp")`` mesh; token-identical to the single-device generator. With a
    "dp" axis, batch rows are additionally split across dp ranks (the full
    serving matrix: dp x pp x tp in one generator)."""

    def __init__(self, model, tokenizer, mesh: Mesh) -> None:
        self.model = model
        self.tokenizer = tokenizer
        axes = dict(mesh.shape)
        assert set(axes) in ({"pp", "tp"}, {"dp", "pp", "tp"}), (
            f'tp+pp serving mesh needs ("pp", "tp") or ("dp", "pp", "tp") axes, got {tuple(axes)}')
        self.n_stages, tp = axes["pp"], axes["tp"]
        self.dp = axes.get("dp", 1)
        has_dp = "dp" in axes
        cfg = model.cfg
        assert cfg.n_layers % self.n_stages == 0, (
            f"{cfg.n_layers} layers not divisible by pp={self.n_stages}")
        n_heads = cfg.layer.n_heads
        assert n_heads % tp == 0, f"{n_heads} heads not divisible by tp={tp}"
        cfg_local = replace(cfg, local_heads=n_heads // tp,
                            tp_axis="tp" if tp > 1 else None)

        staged = stage_stack(model.params, self.n_stages)
        pspecs = tp_pp_param_pspecs(staged)
        self.params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), staged, pspecs)

        n_stages = self.n_stages

        row_spec = P("dp") if has_dp else P()
        row2_spec = P("dp", None) if has_dp else P()

        def sharded(params, prompt_buf, pad_lens, limit, eos_id):
            fn = jax.shard_map(
                partial(_tp_pp_generate_body, cfg=cfg_local, n_stages=n_stages),
                mesh=mesh,
                in_specs=(pspecs, row2_spec, row_spec, P(), P()),
                out_specs=(row2_spec, row_spec),
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
        assert b % self.dp == 0, f"batch {b} must be divisible by dp={self.dp}"
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
