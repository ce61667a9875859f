"""Multi-parallel training step demo: dp + pp + tp + sp + ep on one mesh.

The reference is inference-only with no distributed layer; this module is the
scaling story (SURVEY.md §2.7 N3) exercised by ``__graft_entry__.py``'s
``dryrun_multichip``: a tiny MoE transformer LM trained with cross-entropy,
jitted over a ("dp", "pp", "tp") mesh with

- dp: batch sharding,
- pp: GPipe pipeline over stacked stage params (parallel/pipeline.py),
- tp: Megatron head/hidden sharding inside each block,
- sp: sequence-sharded activations at the norms (constraints on the "tp" axis),
- ep: MoE expert weights sharded along the expert dim over "tp", with tokens
  exchanged by an EXPLICIT shard_map ``lax.all_to_all`` (real expert
  parallelism — sharing the axis with attention TP is fine because the two
  uses are sequential within a block; see _moe_mlp_sparse_ep).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import transformer as tfm
from ..ops import layer_norm
from ..utils import stack_layers
from .pipeline import gpipe_apply


@dataclass(frozen=True)
class MoELMConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_stages: int = 2
    layers_per_stage: int = 2
    n_experts: int = 4
    expert_hidden: int = 256
    max_seq_len: int = 64
    # "ep": explicit shard_map all_to_all dispatch over the expert axis (real
    #       expert parallelism — the collective is emitted by construction);
    # "sparse": GShard capacity dispatch via one-hot einsums, XLA-partitioned
    #       (XLA chooses the collectives; measured to all-gather, not a2a);
    # "dense": every expert computes every token (E x FLOPs; parity oracle).
    moe_impl: str = "ep"
    capacity_factor: float = 2.0

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.n_heads)


def moe_lm_init(key, cfg: MoELMConfig) -> dict:
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

    keys = jax.random.split(key, cfg.n_stages * cfg.layers_per_stage + 2)
    stages = []
    for s in range(cfg.n_stages):
        layers = [block_init(keys[s * cfg.layers_per_stage + i]) for i in range(cfg.layers_per_stage)]
        stages.append(stack_layers(layers))
    return {
        "token_embs": jax.random.normal(keys[-2], (cfg.vocab_size, cfg.d_model)) * 0.02,
        "pos_embs": jax.random.normal(keys[-1], (cfg.max_seq_len, cfg.d_model)) * 0.02,
        "stages": stack_layers(stages),  # leading stage axis -> sharded over "pp"
        "norm": tfm.ln_init(cfg.d_model),
    }


def _moe_mlp(p, cfg: MoELMConfig, x):
    """Dense-dispatch top-1 MoE: every expert computes every token (E× FLOPs)."""
    gates = jax.nn.softmax(tfm.linear(p["router"], x), axis=-1)  # (mb, L, E)
    h = jnp.einsum("bld,edh->eblh", x, p["w1"].astype(x.dtype))
    h = jax.nn.gelu(h, approximate=False)
    out = jnp.einsum("eblh,ehd->ebld", h, p["w2"].astype(x.dtype))
    top1 = jnp.argmax(gates, axis=-1)  # (mb, L)
    onehot = jax.nn.one_hot(top1, cfg.n_experts, dtype=x.dtype)  # (mb, L, E)
    gate_val = jnp.sum(gates * onehot, axis=-1, keepdims=True)
    return jnp.einsum("ebld,ble->bld", out, onehot) * gate_val


def _moe_mlp_sparse(p, cfg: MoELMConfig, x):
    """GShard-style top-1 sparse dispatch with per-expert capacity.

    Tokens route to their expert through one-hot dispatch/combine einsums;
    under the "tp"-sharded expert dim XLA partitions these contractions into
    the all_to_all exchanges of real expert parallelism. Tokens beyond an
    expert's capacity are dropped (standard GShard semantics; with
    capacity_factor >= E the result equals the dense dispatch exactly)."""
    mb, l, d = x.shape
    e = cfg.n_experts
    tokens = mb * l
    capacity = int(cfg.capacity_factor * tokens / e)

    flat = x.reshape(tokens, d)
    gates = jax.nn.softmax(tfm.linear(p["router"], flat), axis=-1)  # (T, E)
    top1 = jnp.argmax(gates, axis=-1)  # (T,)
    gate_val = jnp.take_along_axis(gates, top1[:, None], axis=1)[:, 0]  # (T,)

    expert_onehot = jax.nn.one_hot(top1, e, dtype=jnp.int32)  # (T, E)
    # position of each token within its expert's queue
    pos_in_expert = jnp.cumsum(expert_onehot, axis=0) * expert_onehot - 1  # (T, E)
    slot = jnp.sum(pos_in_expert * expert_onehot, axis=1)  # (T,)
    keep = slot < capacity

    dispatch = (
        expert_onehot.astype(x.dtype)[:, :, None]
        * jax.nn.one_hot(jnp.where(keep, slot, 0), capacity, dtype=x.dtype)[:, None, :]
        * keep[:, None, None].astype(x.dtype)
    )  # (T, E, C)

    expert_in = jnp.einsum("td,tec->ecd", flat, dispatch)  # all_to_all under sharding
    h = jax.nn.gelu(jnp.einsum("ecd,edh->ech", expert_in, p["w1"].astype(x.dtype)), approximate=False)
    expert_out = jnp.einsum("ech,ehd->ecd", h, p["w2"].astype(x.dtype))
    combined = jnp.einsum("ecd,tec->td", expert_out, dispatch)  # return all_to_all
    return (combined * gate_val[:, None]).reshape(mb, l, d)


def _moe_mlp_sparse_ep(p, cfg: MoELMConfig, x, mesh: Mesh):
    """Top-1 MoE with EXPLICIT ``lax.all_to_all`` expert-parallel dispatch.

    Expert weights live sharded over the "tp" axis (param_pspecs); a nested
    shard_map goes manual over that axis so the token exchange is a real
    all_to_all written here, not a partitioning choice left to XLA (which, on
    the einsum formulation, all-gathers instead — see tests/parallel
    ``test_ep_emits_all_to_all``). Per rank: route the local (sequence-shard)
    tokens, pack per-expert capacity slots, all_to_all so each rank holds all
    ranks' slots for its E/n local experts, run the expert MLPs, all_to_all
    back, and combine. Capacity is per source rank (standard GShard drop
    semantics; with capacity_factor >= n_experts nothing drops and the result
    equals dense dispatch exactly).
    """
    am = jax.sharding.get_abstract_mesh()
    m = mesh if am.empty else am
    n = dict(m.shape)["tp"]
    moe_p = {"router": p["router"], "w1": p["w1"], "w2": p["w2"]}
    specs = {"router": P(), "w1": P("tp"), "w2": P("tp")}

    def local(lp, x_loc):
        mb, l_loc, d = x_loc.shape
        e = cfg.n_experts
        t_loc = mb * l_loc
        cap = max(int(cfg.capacity_factor * t_loc / e), 1)

        flat = x_loc.reshape(t_loc, d)
        gates = jax.nn.softmax(tfm.linear(lp["router"], flat), axis=-1)  # (T, E)
        top1 = jnp.argmax(gates, axis=-1)
        gate_val = jnp.take_along_axis(gates, top1[:, None], axis=1)[:, 0]
        onehot = jax.nn.one_hot(top1, e, dtype=jnp.int32)  # (T, E)
        pos_in_expert = jnp.cumsum(onehot, axis=0) * onehot - 1
        slot = jnp.sum(pos_in_expert * onehot, axis=1)
        keep = slot < cap
        dispatch = (
            onehot.astype(x_loc.dtype)[:, :, None]
            * jax.nn.one_hot(jnp.where(keep, slot, 0), cap, dtype=x_loc.dtype)[:, None, :]
            * keep[:, None, None].astype(x_loc.dtype)
        )  # (T, E, C)

        expert_in = jnp.einsum("td,tec->ecd", flat, dispatch)  # (E, C, d)
        recv = lax.all_to_all(expert_in, "tp", split_axis=0, concat_axis=1, tiled=True)  # (E/n, n*C, d)
        h = jax.nn.gelu(jnp.einsum("ecd,edh->ech", recv, lp["w1"].astype(x_loc.dtype)), approximate=False)
        out = jnp.einsum("ech,ehd->ecd", h, lp["w2"].astype(x_loc.dtype))
        back = lax.all_to_all(out, "tp", split_axis=1, concat_axis=0, tiled=True)  # (E, C, d)
        combined = jnp.einsum("ecd,tec->td", back, dispatch)
        return (combined * gate_val[:, None]).reshape(mb, l_loc, d)

    return jax.shard_map(local, mesh=m, in_specs=(specs, P(None, "tp", None)),
                         out_specs=P(None, "tp", None), axis_names={"tp"}, check_vma=False)(moe_p, x)


def _block(p, cfg: MoELMConfig, x, mesh: Mesh):
    # sequence parallelism: activations sequence-sharded over "tp" at the norms.
    # Use the context (abstract) mesh so the spec is valid both inside the
    # manual-pp shard_map region and outside it.
    am = jax.sharding.get_abstract_mesh()
    sp = NamedSharding(mesh if am.empty else am, P("dp", "tp", None))
    x = lax.with_sharding_constraint(x, sp)
    h = layer_norm(p["sa_norm"], x)
    x = x + tfm.mha_apply(p["sa"], cfg.layer, h, causal=True)
    x = lax.with_sharding_constraint(x, sp)
    h = layer_norm(p["mlp_norm"], x)
    if cfg.moe_impl == "ep":
        x = x + _moe_mlp_sparse_ep(p, cfg, h, mesh)
    elif cfg.moe_impl == "sparse":
        x = x + _moe_mlp_sparse(p, cfg, h)
    else:
        x = x + _moe_mlp(p, cfg, h)
    return x


def _stage_fn(cfg: MoELMConfig, mesh: Mesh):
    def fn(stage_params, x):
        def body(h, lp):
            return _block(lp, cfg, h, mesh), None

        x, _ = lax.scan(body, x, stage_params)
        return x

    return fn


def moe_lm_forward(params, cfg: MoELMConfig, tokens, mesh: Mesh, n_micro: int):
    """(B, L) tokens -> (B, L, V) logits through the pipelined stage stack."""
    b, l = tokens.shape
    x = jnp.take(params["token_embs"], tokens, axis=0) + params["pos_embs"][:l]
    x = x.reshape(n_micro, b // n_micro, l, cfg.d_model)
    x = gpipe_apply(_stage_fn(cfg, mesh), params["stages"], x, mesh, cfg.n_stages)
    x = x.reshape(b, l, cfg.d_model)
    x = layer_norm(params["norm"], x)
    return jnp.matmul(x, params["token_embs"].astype(x.dtype).T)


def param_pspecs(cfg: MoELMConfig) -> dict:
    """PartitionSpecs: pp on the stage axis, tp on head/hidden dims, ep on experts."""
    block = {
        "sa_norm": {"scale": P("pp"), "bias": P("pp")},  # stage-stacked small leaves
        "sa": {
            "q": {"w": P("pp", None, None, "tp"), "b": P("pp", None, "tp")},
            "k": {"w": P("pp", None, None, "tp"), "b": P("pp", None, "tp")},
            "v": {"w": P("pp", None, None, "tp"), "b": P("pp", None, "tp")},
            "o": {"w": P("pp", None, "tp", None), "b": P()},
        },
        "mlp_norm": {"scale": P("pp"), "bias": P("pp")},
        "router": {"w": P("pp"), "b": P("pp")},
        "w1": P("pp", None, "tp", None, None),  # expert parallelism (shares the "tp" axis)
        "w2": P("pp", None, "tp", None, None),
    }
    return {
        "token_embs": P(),
        "pos_embs": P(),
        "stages": block,
        "norm": {"scale": P(), "bias": P()},
    }


def make_train_step(cfg: MoELMConfig, mesh: Mesh, n_micro: int, lr: float = 1e-2):
    """Jitted SGD step over the mesh: (params, tokens) -> (params, loss)."""
    pspecs = param_pspecs(cfg)
    param_shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                                   is_leaf=lambda x: isinstance(x, P))
    data_sharding = NamedSharding(mesh, P("dp", None))

    def loss_fn(params, tokens):
        # forward the full (even) sequence and drop the last logit — the "ep"
        # MoE shard_map sequence-shards activations over "tp", which needs L
        # divisible by the axis size (L-1 from pre-shifting wouldn't be)
        logits = moe_lm_forward(params, cfg, tokens, mesh, n_micro)[:, :-1]
        labels = tokens[:, 1:]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)
        return jnp.mean(nll)

    def step(params, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
        params = jax.tree.map(lambda p, g: p - lr * g.astype(p.dtype), params, grads)
        return params, loss

    return jax.jit(step, in_shardings=(param_shardings, data_sharding),
                   out_shardings=(param_shardings, NamedSharding(mesh, P()))), param_shardings
