"""Expert-parallel SERVING: MoE decode with per-step all_to_all dispatch.

Completes the serving matrix next to tensor parallelism (parallel/serving.py)
and pipeline parallelism (parallel/pp_serving.py): a mixture-of-experts
decoder LM generates over an ``("ep",)`` mesh with

- the batch data-sharded over "ep" (each rank decodes B/n rows and owns those
  rows' KV caches — attention is per-row, so it needs no collective), and
- the expert weights expert-sharded over "ep"; every decode step routes each
  rank's tokens, exchanges capacity slots with an EXPLICIT
  ``lax.all_to_all``, runs the local experts' MLPs, and all_to_alls the
  results back (the same dispatch as training, parallel/train.py
  ``_moe_mlp_sparse_ep`` — there over the "tp" axis).

This is the deployment shape for sparse models: expert weights scale with
the mesh while per-token FLOPs stay top-1. The reference has no distributed
layer at all (SURVEY.md §2.7 N3). With ``capacity_factor >= n_experts``
nothing drops and generation is token-identical to the single-device
dense-dispatch oracle (tests/parallel/test_ep_serving.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import transformer as tfm
from ..ops import layer_norm
from ..utils import stack_layers


@dataclass(frozen=True)
class MoEDecoderConfig:
    """Tiny top-1 MoE decoder LM (demo-scale; the dispatch is the point)."""

    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    n_experts: int = 4
    expert_hidden: int = 256
    max_seq_len: int = 64
    # >= n_experts -> no capacity drops -> exactly equals dense dispatch
    capacity_factor: float | None = None

    @property
    def cf(self) -> float:
        return float(self.n_experts if self.capacity_factor is None else self.capacity_factor)

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.n_heads, pre_norm=True)


def moe_decoder_init(key, cfg: MoEDecoderConfig) -> dict:
    def block_init(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return {
            "sa_norm": tfm.ln_init(cfg.d_model),
            "sa": tfm.mha_init(k1, cfg.layer),
            "mlp_norm": tfm.ln_init(cfg.d_model),
            "router": tfm.linear_init(k2, cfg.d_model, cfg.n_experts),
            "w1": jax.random.normal(k3, (cfg.n_experts, cfg.d_model, cfg.expert_hidden)) * 0.02,
            "w2": jax.random.normal(k4, (cfg.n_experts, cfg.expert_hidden, cfg.d_model)) * 0.02,
        }

    keys = jax.random.split(key, cfg.n_layers + 2)
    return {
        "token_embs": jax.random.normal(keys[-2], (cfg.vocab_size, cfg.d_model)) * 0.02,
        "pos_embs": jax.random.normal(keys[-1], (cfg.max_seq_len, cfg.d_model)) * 0.02,
        "layers": stack_layers([block_init(keys[i]) for i in range(cfg.n_layers)]),
        "norm": tfm.ln_init(cfg.d_model),
    }


def _route(p, cfg: MoEDecoderConfig, flat):
    """Top-1 routing + capacity-slot dispatch matrix for (T, d) tokens."""
    t = flat.shape[0]
    e = cfg.n_experts
    cap = max(int(cfg.cf * t / e), 1)
    gates = jax.nn.softmax(tfm.linear(p["router"], flat), axis=-1)  # (T, E)
    top1 = jnp.argmax(gates, axis=-1)
    gate_val = jnp.take_along_axis(gates, top1[:, None], axis=1)[:, 0]
    onehot = jax.nn.one_hot(top1, e, dtype=jnp.int32)
    pos_in_expert = jnp.cumsum(onehot, axis=0) * onehot - 1
    slot = jnp.sum(pos_in_expert * onehot, axis=1)
    keep = slot < cap
    dispatch = (
        onehot.astype(flat.dtype)[:, :, None]
        * jax.nn.one_hot(jnp.where(keep, slot, 0), cap, dtype=flat.dtype)[:, None, :]
        * keep[:, None, None].astype(flat.dtype)
    )  # (T, E, C)
    return dispatch, gate_val


def _moe_mlp_dense(p, x, *, cfg: MoEDecoderConfig):
    """Single-device dense-dispatch oracle: every expert computes every token."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    dispatch, gate_val = _route(p, cfg, flat)
    expert_in = jnp.einsum("td,tec->ecd", flat, dispatch)
    h = jax.nn.gelu(jnp.einsum("ecd,edh->ech", expert_in, p["w1"].astype(x.dtype)),
                    approximate=False)
    out = jnp.einsum("ech,ehd->ecd", h, p["w2"].astype(x.dtype))
    combined = jnp.einsum("ecd,tec->td", out, dispatch)
    return (combined * gate_val[:, None]).reshape(b, s, d)


def _moe_mlp_ep(p, x, *, cfg: MoEDecoderConfig):
    """Expert-parallel MoE MLP; runs per-rank inside shard_map over "ep".

    ``p["w1"]``/``p["w2"]`` are the rank's LOCAL (E/n, ...) expert shards;
    ``x`` is the rank's local (B/n, S, d) activations. The token exchange is
    an explicit ``lax.all_to_all`` each way.
    """
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    dispatch, gate_val = _route(p, cfg, flat)
    expert_in = jnp.einsum("td,tec->ecd", flat, dispatch)  # (E, C, d)
    recv = lax.all_to_all(expert_in, "ep", split_axis=0, concat_axis=1, tiled=True)
    h = jax.nn.gelu(jnp.einsum("ecd,edh->ech", recv, p["w1"].astype(x.dtype)),
                    approximate=False)
    out = jnp.einsum("ech,ehd->ecd", h, p["w2"].astype(x.dtype))
    back = lax.all_to_all(out, "ep", split_axis=1, concat_axis=0, tiled=True)
    combined = jnp.einsum("ecd,tec->td", back, dispatch)
    return (combined * gate_val[:, None]).reshape(b, s, d)


def _forward(params, cfg: MoEDecoderConfig, tokens, pos_ids, caches, pos, pad_lens, moe_mlp):
    """(b, S) token chunk at cache slots [pos, pos+S) -> (logits, caches)."""
    x = jnp.take(params["token_embs"], tokens, axis=0)
    x = x + jnp.take(params["pos_embs"], pos_ids, axis=0).astype(x.dtype)
    lc = cfg.layer
    new_caches = []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        h = layer_norm(lp["sa_norm"], x)
        attn, new_c = tfm.mha_apply(lp["sa"], lc, h, causal=True, cache=caches[i],
                                    cache_pos=pos, pad_lens=pad_lens)
        x = x + attn
        new_caches.append(new_c)
        x = x + moe_mlp(lp, layer_norm(lp["mlp_norm"], x), cfg=cfg)
    x = layer_norm(params["norm"], x)
    logits = jnp.matmul(x, params["token_embs"].astype(x.dtype).T)
    return logits, new_caches


def _generate_body(params, prompt_buf, pad_lens, limit, eos_id, *,
                   cfg: MoEDecoderConfig, moe_mlp, ep: bool):
    """Greedy batched generation (mirrors generator._generate_batch_body).

    With ``ep=True`` this runs per-rank inside shard_map: the while_loop must
    stay in lockstep across ranks (every step carries an all_to_all), so the
    stop condition is the GLOBAL done count, psum'd in the body.
    """
    b, p_len = prompt_buf.shape
    lc = cfg.layer
    pos_ids = jnp.clip(jnp.arange(p_len)[None, :] - pad_lens[:, None], 0, None)
    caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, cfg.max_seq_len,
                               lc.head_dim, dtype=params["token_embs"].dtype, stacked=False)

    def n_done(done):
        local = jnp.sum(done.astype(jnp.int32))
        return lax.psum(local, "ep") if ep else local

    total = lax.psum(jnp.int32(b), "ep") if ep else jnp.int32(b)

    logits, caches = _forward(params, cfg, prompt_buf, pos_ids, caches, 0, pad_lens, moe_mlp)
    buf = jnp.zeros((b, cfg.max_seq_len), jnp.int32)
    buf = lax.dynamic_update_slice(buf, prompt_buf.astype(jnp.int32), (0, 0))
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    buf = buf.at[:, p_len].set(nxt)
    done = nxt == eos_id
    state = (buf, jnp.int32(p_len + 1), caches, done, n_done(done))

    def cond(s):
        _, pos, _, _, nd = s
        return jnp.logical_and(nd < total, pos < limit)

    def body(s):
        buf, pos, caches, done, _ = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        p_ids = (pos - 1 - pad_lens)[:, None]
        logits, caches = _forward(params, cfg, tok, p_ids, caches, pos - 1, pad_lens, moe_mlp)
        nxt = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
        nxt = jnp.where(done, jnp.int32(eos_id), nxt)
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos))
        done = jnp.logical_or(done, nxt == eos_id)
        return buf, pos + 1, caches, done, n_done(done)

    buf, length, _, _, _ = lax.while_loop(cond, body, state)
    gen = buf[:, p_len:]
    generated = jnp.arange(gen.shape[1])[None, :] < (length - p_len)
    is_eos = jnp.logical_and(gen == eos_id, generated)
    lengths = jnp.where(jnp.any(is_eos, axis=1),
                        p_len + jnp.argmax(is_eos, axis=1) + 1, length)
    return buf, lengths


def ep_param_pspecs(cfg: MoEDecoderConfig) -> dict:
    """Expert weights sharded over "ep" (axis 1 after the layer stack axis);
    everything else replicated."""
    block = {
        "sa_norm": {"scale": P(), "bias": P()},
        "sa": jax.tree.map(lambda _: P(), tfm.mha_init(jax.random.PRNGKey(0), cfg.layer)),
        "mlp_norm": {"scale": P(), "bias": P()},
        "router": {"w": P(), "b": P()},
        "w1": P(None, "ep"),
        "w2": P(None, "ep"),
    }
    return {"token_embs": P(), "pos_embs": P(), "layers": block,
            "norm": {"scale": P(), "bias": P()}}


class MoEDecoderGenerator:
    """Single-device greedy generator for the MoE decoder LM (dense-dispatch
    oracle for the EP path)."""

    def __init__(self, params, cfg: MoEDecoderConfig) -> None:
        self.params, self.cfg = params, cfg
        self._generate = jax.jit(partial(
            _generate_body, cfg=cfg, moe_mlp=_moe_mlp_dense, ep=False),
            static_argnames=("limit",))

    def generate_tokens_batch(self, token_lists, max_tokens: int = 16, eos_id: int = -1):
        buf, pad_lens, limit = _pack_prompts(token_lists, self.cfg, max_tokens)
        out, lengths = self._generate(self.params, jnp.asarray(buf),
                                      jnp.asarray(pad_lens), limit=limit, eos_id=eos_id)
        return _unpack(out, lengths, pad_lens)


class EPMoEGenerator:
    """Expert-parallel drop-in for :class:`MoEDecoderGenerator` over an
    ``("ep",)`` mesh: batch data-sharded, experts weight-sharded, explicit
    all_to_all dispatch each decode step. Token-identical to the dense
    single-device oracle when capacity_factor >= n_experts."""

    def __init__(self, params, cfg: MoEDecoderConfig, mesh: Mesh) -> None:
        axes = dict(mesh.shape)
        assert set(axes) == {"ep"}, f'EP serving mesh needs an ("ep",) axis, got {tuple(axes)}'
        n = axes["ep"]
        assert cfg.n_experts % n == 0, f"{cfg.n_experts} experts not divisible by ep={n}"
        self.cfg, self.n_ranks = cfg, n
        pspecs = ep_param_pspecs(cfg)
        self.params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, pspecs,
            is_leaf=lambda x: isinstance(x, jnp.ndarray))

        def sharded(params, prompt_buf, pad_lens, limit, eos_id):
            fn = jax.shard_map(
                partial(_generate_body, cfg=cfg, moe_mlp=_moe_mlp_ep, ep=True),
                mesh=mesh,
                in_specs=(pspecs, P("ep"), P("ep"), P(), P()),
                out_specs=(P("ep"), P("ep")),
                check_vma=False,
            )
            return fn(params, prompt_buf, pad_lens, limit, eos_id)

        self._generate = jax.jit(sharded, static_argnames=("limit",))

    def generate_tokens_batch(self, token_lists, max_tokens: int = 16, eos_id: int = -1):
        assert len(token_lists) % self.n_ranks == 0, (
            f"batch {len(token_lists)} not divisible by ep={self.n_ranks}")
        buf, pad_lens, limit = _pack_prompts(token_lists, self.cfg, max_tokens)
        out, lengths = self._generate(self.params, jnp.asarray(buf),
                                      jnp.asarray(pad_lens), limit=limit, eos_id=eos_id)
        return _unpack(out, lengths, pad_lens)


def _pack_prompts(token_lists, cfg: MoEDecoderConfig, max_tokens: int):
    """LEFT-pad prompts to a shared bucket (same packing as DecoderGenerator)."""
    bucket = 8
    max_n = max(len(ts) for ts in token_lists)
    pad = min(-(-max_n // bucket) * bucket, cfg.max_seq_len)
    assert max_n <= pad, f"prompt too long for context {cfg.max_seq_len}"
    b = len(token_lists)
    buf = np.zeros((b, pad), np.int32)
    pad_lens = np.zeros((b,), np.int32)
    for i, ts in enumerate(token_lists):
        pad_lens[i] = pad - len(ts)
        buf[i, pad_lens[i]:] = ts
    return buf, pad_lens, min(pad + max_tokens, cfg.max_seq_len)


def _unpack(out, lengths, pad_lens):
    out, lengths = np.asarray(out), np.asarray(lengths)
    return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(out.shape[0])]
