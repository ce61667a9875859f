"""Shared transformer core: MHA, MLP, encoder/decoder layers and stacks.

Functional re-design of the reference's shared blocks (reference
transformer.py:9-176): params are pytrees, layer stacks are ``lax.scan`` over
stacked per-layer params (one compiled layer body instead of n_layers inlined
copies), and attention goes through :func:`pytorch_models_tpu.ops.sdpa`.

Beyond the reference, decoder layers support a preallocated KV cache,
eliminating the reference's O(L²)-per-token full re-forward decode loops
(reference text/generator.py:23-24, text/t5.py:220-223). Caches are stored
**merged-head** — ``(B, L_max, H*D)`` per layer, the exact shape the K/V
projections produce — so the per-step write is one ``dynamic_update_slice``
with no head split. Single-position bf16 decode reads on the GPU go through
the Triton decode kernel (ops/decode_attention.py), which reads only each
row's valid prefix in place; the einsum path splits heads on read.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
from jax import lax

from .ops import ACT_FNS, layer_norm, linear, linear_init, ln_init, sdpa
from .utils import stack_layers


def resolve_heads(d_model: int, n_heads: int | None = None, head_dim: int | None = None) -> tuple[int, int]:
    """Head-count/dim inference exactly as the reference (transformer.py:20-26)."""
    if head_dim is None and n_heads is None:
        head_dim = 64
        n_heads = d_model // head_dim
    elif head_dim is None:
        head_dim = d_model // n_heads
    elif n_heads is None:
        n_heads = d_model // head_dim
    return n_heads, head_dim


@dataclass(frozen=True)
class LayerConfig:
    """Static hyperparameters of one encoder/decoder layer (ref transformer.py:70-121)."""

    d_model: int
    n_heads: int
    head_dim: int
    cross_attn: bool = False
    bias: bool = True
    mlp_ratio: float = 4.0
    act: str = "gelu"
    pre_norm: bool = True
    norm_eps: float = 1e-5
    attn_impl: str = "auto"
    # Set under shard_map for Megatron tensor parallelism: n_heads/head_dim
    # then describe the LOCAL shard, and the attention out-projection and MLP
    # fc2 all-reduce their row-sharded partial sums over this mesh axis.
    tp_axis: str | None = None

    @staticmethod
    def make(d_model, n_heads=None, head_dim=None, **kw) -> "LayerConfig":
        n_heads, head_dim = resolve_heads(d_model, n_heads, head_dim)
        return LayerConfig(d_model, n_heads, head_dim, **kw)

    def with_(self, **kw) -> "LayerConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Multi-head attention (ref transformer.py:9-53)
# ---------------------------------------------------------------------------


def mha_init(key, cfg: LayerConfig) -> dict:
    kq, kk, kv, ko = jax.random.split(key, 4)
    inner = cfg.n_heads * cfg.head_dim
    return {
        "q": linear_init(kq, cfg.d_model, inner, cfg.bias),
        "k": linear_init(kk, cfg.d_model, inner, cfg.bias),
        "v": linear_init(kv, cfg.d_model, inner, cfg.bias),
        "o": linear_init(ko, inner, cfg.d_model, cfg.bias),
    }


def split_heads(x: jnp.ndarray, n_heads: int, head_dim: int) -> jnp.ndarray:
    """(..., L, H*D) -> (..., H, L, D)"""
    x = x.reshape(*x.shape[:-1], n_heads, head_dim)
    return jnp.swapaxes(x, -2, -3)


def merge_heads(x: jnp.ndarray) -> jnp.ndarray:
    """(..., H, L, D) -> (..., L, H*D)"""
    x = jnp.swapaxes(x, -2, -3)
    return x.reshape(*x.shape[:-2], -1)


def reduce_linear(p: dict, x: jnp.ndarray, tp_axis: str | None) -> jnp.ndarray:
    """Row-parallel linear: x (.., k/tp) @ w (k/tp, n) -> psum over ``tp_axis``
    -> + bias. The bias is replicated and must be added AFTER the all-reduce
    (each rank adds it to the already-complete sum, consistently). With
    ``tp_axis=None`` this is exactly :func:`linear`."""
    if tp_axis is None:
        return linear(p, x)
    from .ops.layers import dot_precision

    out = jnp.matmul(x, p["w"].astype(x.dtype), precision=dot_precision(x))
    out = lax.psum(out, tp_axis)
    return out + p["b"].astype(x.dtype) if "b" in p else out


def mha_project_kv(p: dict, cfg: LayerConfig, kv: jnp.ndarray, valid_lens=None) -> dict:
    """Project ``kv`` (..., L, d) into a cross-attention cache.

    Returns ``{"k", "v", "len"}`` with merged-head (..., Lp, H*D) tensors,
    zero-padded to :func:`padded_cache_len` so the decode kernel can stream
    them in whole blocks, and ``len`` (..., ) the per-row count of valid
    memory positions (``valid_lens`` or the full L). Padded/invalid slots are
    masked by every read path.
    """
    length = kv.shape[-2]
    pad = padded_cache_len(length) - length
    if pad:
        widths = [(0, 0)] * (kv.ndim - 2) + [(0, pad), (0, 0)]
        kv_p = jnp.pad(kv, widths)
    else:
        kv_p = kv
    lens = jnp.full(kv.shape[:-2], length, jnp.int32) if valid_lens is None else (
        jnp.asarray(valid_lens, jnp.int32))
    return {"k": linear(p["k"], kv_p), "v": linear(p["v"], kv_p), "len": lens}


def _read_kv(cur: dict, dtype):
    """Full-precision K/V of one layer's cache view: int8 caches
    (ops/int8_kv.py) dequantize on read, others cast to the compute dtype."""
    if "ks" in cur:
        from .ops.int8_kv import dequantize

        return dequantize(cur["k"], cur["ks"], dtype), dequantize(cur["v"], cur["vs"], dtype)
    return cur["k"].astype(dtype), cur["v"].astype(dtype)


def mha_apply(
    p: dict,
    cfg: LayerConfig,
    q: jnp.ndarray,
    k: jnp.ndarray | None = None,
    v: jnp.ndarray | None = None,
    attn_bias: jnp.ndarray | None = None,
    causal: bool = False,
    cache: dict | None = None,
    cache_pos=None,
    cache_layer=None,
    pad_lens: jnp.ndarray | None = None,
):
    """Self- or cross-attention with optional additive bias / causal mask / KV cache.

    Defaulting mirrors the reference (k defaults to q, v to k;
    transformer.py:44-45). With ``cache`` and ``cache_pos`` given, new K/V for
    the query chunk are written at positions ``[pos, pos+S)`` and attention is
    masked to ``key_pos <= pos + i``; returns ``(out, new_cache)``. With
    ``cache`` but no ``cache_pos`` (cross-attention), the cache is used as-is;
    its ``len`` entry masks padded memory slots.

    Caches are merged-head (..., L, H*D) — see the module docstring — and may
    be int8 with per-key scales (``"ks"``/``"vs"``, ops/int8_kv.py), which
    dequantize on read. A single-position self-attention read of a long bf16
    cache with no bias goes to the Triton decode kernel on the GPU
    (ops/attention.py ``use_decode_kernel``); every other read is the masked
    einsum, which splits heads on read.

    ``pad_lens`` (B,) marks each batch row's left-pad length (batched
    left-aligned decode): cache positions ``< pad_lens[b]`` are masked. Kept
    separate from ``attn_bias`` so the decode kernel, which takes pad lengths
    natively, stays engaged for batched serving.
    """
    from .ops import attention as _attn

    k = q if k is None else k
    v = k if v is None else v

    if cache is not None:
        if cache_pos is not None:  # self-attention, KV-cached
            # cache-layer variant: leaves are the FULL layer-stacked array
            # (L, ..., Smax, H*D) — write only the new block at (layer, ...,
            # pos); a full per-layer slice write-back would move the whole
            # cache per step
            new_cache, cur = _write_cache(cache, linear(p["k"], k), linear(p["v"], v),
                                          cache_pos, cache_layer, cfg.tp_axis)
            ends = cache_pos + 1 + lax.broadcasted_iota(jnp.int32, (q.shape[-2], 1), 0)
        else:  # precomputed cross-attention K/V (merged + "len")
            new_cache, cur = None, cache
            lens = cache["len"]
            ends = lens[..., None, None, None] if lens.ndim else lens
        ck, cv = cur["k"], cur["v"]
        q_m = linear(p["q"], q)
        s, l_max = q.shape[-2], ck.shape[-2]
        hd = ck.shape[-1]
        if (s == 1 and cache_pos is not None and cfg.attn_impl != "xla"
                and "ks" not in cache and ck.dtype == q_m.dtype
                and _attn.use_decode_kernel(q_m.dtype, l_max, hd // cfg.n_heads,
                                            attn_bias is not None)):
            from .ops.decode_attention import decode_attention

            out = decode_attention(q_m, ck, cv, cache_pos + 1, cfg.n_heads, pad_lens)
        else:
            kf, vf = _read_kv(cur, q_m.dtype)
            qh = split_heads(q_m, cfg.n_heads, cfg.head_dim)
            kh = split_heads(kf, cfg.n_heads, cfg.head_dim)
            vh = split_heads(vf, cfg.n_heads, cfg.head_dim)
            # key j is visible to query row i iff j < ends[i] (causal prefix
            # for self-attention, the valid memory for cross-attention);
            # finite -1e30 (not -inf): a left-padded row's pad-region queries
            # see no valid keys and -inf would make their (discarded) softmax NaN
            key = jnp.arange(l_max)
            mask_bias = jnp.where(key < ends, 0.0, -1e30).astype(jnp.float32)
            if pad_lens is not None:
                pad_bias = jnp.where(key[None, :] >= pad_lens[:, None], 0.0, -1e30)
                mask_bias = mask_bias + pad_bias.astype(jnp.float32)[:, None, None, :]
            bias = mask_bias if attn_bias is None else attn_bias + mask_bias
            out = merge_heads(sdpa(qh, kh, vh, bias, causal, cfg.attn_impl))
        out = reduce_linear(p["o"], out, cfg.tp_axis)
        return out if new_cache is None else (out, new_cache)

    qh = split_heads(linear(p["q"], q), cfg.n_heads, cfg.head_dim)
    kh = split_heads(linear(p["k"], k), cfg.n_heads, cfg.head_dim)
    vh = split_heads(linear(p["v"], v), cfg.n_heads, cfg.head_dim)
    out = sdpa(qh, kh, vh, attn_bias, causal, cfg.attn_impl)
    return reduce_linear(p["o"], merge_heads(out), cfg.tp_axis)


# ---------------------------------------------------------------------------
# MLP (ref transformer.py:56-67)
# ---------------------------------------------------------------------------


def mlp_init(key, in_dim: int, hidden_dim: int) -> dict:
    k1, k2 = jax.random.split(key)
    return {"fc1": linear_init(k1, in_dim, hidden_dim), "fc2": linear_init(k2, hidden_dim, in_dim)}


def mlp_apply(p: dict, x: jnp.ndarray, act: str = "gelu", tp_axis: str | None = None) -> jnp.ndarray:
    return reduce_linear(p["fc2"], ACT_FNS[act](linear(p["fc1"], x)), tp_axis)


# ---------------------------------------------------------------------------
# Encoder / decoder layers (ref transformer.py:70-130)
# ---------------------------------------------------------------------------


def layer_init(key, cfg: LayerConfig) -> dict:
    ks = jax.random.split(key, 3)
    p = {
        "sa_norm": ln_init(cfg.d_model),
        "sa": mha_init(ks[0], cfg),
        "mlp_norm": ln_init(cfg.d_model),
        "mlp": mlp_init(ks[1], cfg.d_model, int(cfg.d_model * cfg.mlp_ratio)),
    }
    if cfg.cross_attn:
        p["ca_norm"] = ln_init(cfg.d_model)
        p["ca"] = mha_init(ks[2], cfg)
    return p


def encoder_layer_apply(p: dict, cfg: LayerConfig, x: jnp.ndarray, attn_bias=None) -> jnp.ndarray:
    """Bidirectional layer, pre- or post-norm (ref transformer.py:123-130)."""
    eps = cfg.norm_eps
    if cfg.pre_norm:
        x = x + mha_apply(p["sa"], cfg, layer_norm(p["sa_norm"], x, eps), attn_bias=attn_bias)
        x = x + mlp_apply(p["mlp"], layer_norm(p["mlp_norm"], x, eps), cfg.act, cfg.tp_axis)
    else:
        x = layer_norm(p["sa_norm"], x + mha_apply(p["sa"], cfg, x, attn_bias=attn_bias), eps)
        x = layer_norm(p["mlp_norm"], x + mlp_apply(p["mlp"], x, cfg.act, cfg.tp_axis), eps)
    return x


def _write_cache(cache, k_new, v_new, pos, cache_layer, tp_axis=None):
    """Write this chunk's merged-head K/V at ``pos`` (quantizing per key into
    an int8 cache, with the tp-pmaxed full-width scale under tensor
    parallelism). Returns ``(new_cache, layer_view)``: the view holds this
    layer's ``k``/``v`` (and int8 scales) to attend over."""
    if "ks" in cache:
        from .ops.int8_kv import quantize_rows

        k_new, ks = quantize_rows(k_new, tp_axis=tp_axis)
        v_new, vs = quantize_rows(v_new, tp_axis=tp_axis)
        new = {"k": k_new, "v": v_new, "ks": ks[..., 0], "vs": vs[..., 0]}
    else:
        new = {"k": k_new, "v": v_new}
    new_cache = dict(cache)
    for name, val in new.items():
        full = cache[name]
        tail = (pos, 0) if name in ("k", "v") else (pos,)
        start = (0,) * (full.ndim - len(tail)) + tail
        if cache_layer is not None:
            val, start = val[None], (cache_layer,) + start[1:]
        new_cache[name] = lax.dynamic_update_slice(full, val.astype(full.dtype), start)
    if cache_layer is None:
        return new_cache, new_cache
    view = {name: lax.dynamic_index_in_dim(new_cache[name], cache_layer, 0, keepdims=False)
            for name in new}
    return new_cache, view


def decoder_layer_apply(
    p: dict,
    cfg: LayerConfig,
    x: jnp.ndarray,
    memory: jnp.ndarray | None = None,
    self_cache: dict | None = None,
    cross_cache: dict | None = None,
    pos=None,
    attn_bias: jnp.ndarray | None = None,
    cache_layer=None,
    pad_lens: jnp.ndarray | None = None,
):
    """Causal self-attn [+ cross-attn] + MLP (ref transformer.py:96-105).

    ``attn_bias`` is an extra additive self-attention bias; ``pad_lens`` (B,)
    masks left-padded cache slots for batched decode (see mha_apply). Returns
    ``x`` (and the updated self-cache when one is given). With
    ``cache_layer``, ``self_cache`` holds the full layer-stacked cache and
    only this layer's block is touched.
    """
    eps = cfg.norm_eps
    cached = self_cache is not None

    def sa(h):
        if cached:
            return mha_apply(p["sa"], cfg, h, attn_bias=attn_bias, cache=self_cache, cache_pos=pos,
                             cache_layer=cache_layer, pad_lens=pad_lens)
        return mha_apply(p["sa"], cfg, h, attn_bias=attn_bias, causal=True), None

    def ca(h):
        if cross_cache is not None:
            return mha_apply(p["ca"], cfg, h, cache=cross_cache)
        return mha_apply(p["ca"], cfg, h, memory)

    if cfg.pre_norm:
        out, new_cache = sa(layer_norm(p["sa_norm"], x, eps))
        x = x + out
        if cfg.cross_attn:
            x = x + ca(layer_norm(p["ca_norm"], x, eps))
        x = x + mlp_apply(p["mlp"], layer_norm(p["mlp_norm"], x, eps), cfg.act, cfg.tp_axis)
    else:
        out, new_cache = sa(x)
        x = layer_norm(p["sa_norm"], x + out, eps)
        if cfg.cross_attn:
            x = layer_norm(p["ca_norm"], x + ca(x), eps)
        x = layer_norm(p["mlp_norm"], x + mlp_apply(p["mlp"], x, cfg.act, cfg.tp_axis), eps)
    return (x, new_cache) if cached else x


# ---------------------------------------------------------------------------
# Stacks (ref transformer.py:133-176) — lax.scan over stacked layer params
# ---------------------------------------------------------------------------


def encoder_init(key, n_layers: int, cfg: LayerConfig) -> dict:
    keys = jax.random.split(key, n_layers)
    return {"layers": stack_layers([layer_init(k, cfg) for k in keys])}


def encoder_apply(p: dict, cfg: LayerConfig, x: jnp.ndarray, attn_bias=None) -> jnp.ndarray:
    def body(h, lp):
        return encoder_layer_apply(lp, cfg, h, attn_bias), None

    x, _ = lax.scan(body, x, p["layers"])
    return x


def decoder_init(key, n_layers: int, cfg: LayerConfig) -> dict:
    keys = jax.random.split(key, n_layers)
    return {"layers": stack_layers([layer_init(k, cfg) for k in keys])}


def decoder_apply(
    p: dict,
    cfg: LayerConfig,
    x: jnp.ndarray,
    memory: jnp.ndarray | None = None,
    self_caches: dict | None = None,
    cross_caches: dict | None = None,
    pos=None,
    attn_bias: jnp.ndarray | None = None,
    pad_lens: jnp.ndarray | None = None,
):
    """Threaded decoder stack (ref transformer.py:173-176), optionally KV-cached.

    ``self_caches``/``cross_caches`` hold per-layer caches stacked along a
    leading layer axis; returns ``(x, new_self_caches)`` when caching.
    """
    if self_caches is None:
        def body(h, lp):
            return decoder_layer_apply(lp, cfg, h, memory, attn_bias=attn_bias), None

        x, _ = lax.scan(body, x, p["layers"])
        return x

    # A LIST of per-layer caches selects the unrolled decode path: each layer's
    # cache is updated in place and read directly by attention — no
    # dynamic_index copy of the layer slice (the stacked/scan path below pays
    # one extra cache read+write per step).
    if isinstance(self_caches, (list, tuple)):
        n_layers = len(self_caches)
        new_caches = []
        for i in range(n_layers):
            lp = jax.tree.map(lambda a: a[i], p["layers"])
            cc = None if cross_caches is None else jax.tree.map(lambda a: a[i], cross_caches)
            x, new_c = decoder_layer_apply(lp, cfg, x, memory, self_cache=self_caches[i], cross_cache=cc,
                                           pos=pos, attn_bias=attn_bias, pad_lens=pad_lens)
            new_caches.append(new_c)
        return x, new_caches

    # Stacked caches ride in the scan CARRY and are updated with a small
    # dynamic_update_slice: XLA aliases loop carries in place, whereas
    # emitting them as scan ys would copy the ENTIRE cache every decode step
    # (measured 5x decode slowdown at GPT-2's 1024 context).
    n_layers = jax.tree_util.tree_leaves(p["layers"])[0].shape[0]
    xs = (p["layers"], jnp.arange(n_layers)) if cross_caches is None else (
        p["layers"], jnp.arange(n_layers), cross_caches)

    def body(carry, inp):
        h, caches = carry
        if cross_caches is None:
            lp, idx = inp
            cc = None
        else:
            lp, idx, cc = inp
        h, caches = decoder_layer_apply(lp, cfg, h, memory, self_cache=caches, cross_cache=cc, pos=pos,
                                        attn_bias=attn_bias, cache_layer=idx, pad_lens=pad_lens)
        return (h, caches), None

    (x, new_caches), _ = lax.scan(body, (x, self_caches), xs)
    return x, new_caches


def padded_cache_len(max_len: int) -> int:
    """KV-cache lengths are rounded up to a 128 multiple, so the decode
    kernel (ops/decode_attention.py) streams them in whole key blocks.

    Slots beyond the true maximum are never attended (every read path masks
    by position).
    """
    return -(-max_len // 128) * 128


def make_kv_cache(n_layers: int, batch_shape: tuple, n_heads: int, max_len: int, head_dim: int, dtype=jnp.float32,
                  stacked: bool = True):
    """Preallocate a zeroed merged-head KV cache ``(*batch, Lp, H*D)`` per layer:
    stacked along the layer axis (scan path) or as a list of per-layer caches
    (unrolled decode path)."""
    shape = (*batch_shape, padded_cache_len(max_len), n_heads * head_dim)
    if stacked:
        full = (n_layers, *shape)
        return {"k": jnp.zeros(full, dtype), "v": jnp.zeros(full, dtype)}
    return [{"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)} for _ in range(n_layers)]


def precompute_cross_caches(p: dict, cfg: LayerConfig, memory: jnp.ndarray, valid_lens=None) -> dict:
    """Project encoder ``memory`` into every decoder layer's cross-attn K/V once.

    ``valid_lens`` (optional, (*batch,)) marks each row's count of valid
    memory positions (right-padded batches); defaults to the full length.
    """
    def body(carry, lp):
        return carry, mha_project_kv(lp["ca"], cfg, memory, valid_lens)

    _, caches = lax.scan(body, 0, p["layers"])
    return caches
