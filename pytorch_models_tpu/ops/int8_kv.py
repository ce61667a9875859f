"""int8 KV-cache storage: per-key symmetric int8 with f32 scales.

An opt-in serving mode (``ops.attention.USE_INT8_KV`` / ``USE_INT8_KV_CROSS``)
that halves the bytes a KV cache holds. Each cached key/value row (one
position of one batch row, over the full merged-head width) is quantized
symmetrically to int8 with one f32 scale. Attention dequantizes on read and
runs the ordinary masked path (transformer.py), so the attention math is the
bf16/fp32 path's; the only loss is the per-key rounding (~0.4% relative).

Cache layout: ``{"k", "v"}`` int8 of the bf16 cache's shape ``(..., L, H*D)``
plus ``{"ks", "vs"}`` f32 scales of shape ``(..., L)``. Unwritten slots are
zeros and quantize harmlessly (q = 0, scale 1/127).

Capability replaced: reference transformer.py:52 attention at decode shapes
(the reference has no decode path at all, text/generator.py:23-24).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def quantize_rows(x, axis: int = -1, tp_axis: str | None = None):
    """Symmetric per-row int8 quantization along ``axis``.

    Returns ``(x_q int8, scales f32)`` with ``scales`` keeping the reduced
    axis (size 1); all-zero rows get the harmless scale 1/127 (round-half-
    to-even, clip to [-127, 127]).

    ``tp_axis``: inside a shard_map whose ranks hold width shards of ``x``
    (tensor-parallel KV), the absmax pmaxes over the mesh axis so every rank
    quantizes with the FULL-width scale — bit-identical to a single device
    quantizing the unsharded row (parallel/cb_serving.py int8 pools).
    """
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=axis, keepdims=True)
    if tp_axis is not None:
        absmax = lax.pmax(absmax, tp_axis)
    scales = jnp.where(absmax == 0.0, 1.0, absmax) * (1.0 / 127.0)
    x_q = jnp.clip(jnp.round(x32 / scales), -127, 127).astype(jnp.int8)
    return x_q, scales


def dequantize(x_q, scales, dtype):
    """int8 ``(..., L, W)`` + f32 ``(..., L)`` scales -> ``dtype``."""
    return (x_q.astype(jnp.float32) * scales[..., None]).astype(dtype)


def quantize_kv(caches):
    """bf16/f32 ``{"k", "v", ...}`` caches (one dict, or a list of per-layer
    dicts) -> int8 caches with ``"ks"``/``"vs"`` scales; other keys (a cross
    cache's ``"len"``) pass through."""
    if isinstance(caches, (list, tuple)):
        return [quantize_kv(c) for c in caches]
    k_q, k_s = quantize_rows(caches["k"])
    v_q, v_s = quantize_rows(caches["v"])
    return dict(caches) | {"k": k_q, "v": v_q, "ks": k_s[..., 0], "vs": v_s[..., 0]}
