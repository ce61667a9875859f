"""Elementary functional layers over param pytrees.

Conventions (JAX-native, converters transpose from torch):
- Linear: ``{"w": (in, out), "b": (out,)}``; ``y = x @ w + b``.
- LayerNorm: ``{"scale": (d,), "bias": (d,)}``; eps inside sqrt like torch.
- Conv2d: HWIO kernel, NHWC data. Conv1d: (k, in, out) kernel, NLC data.

Activations mirror the reference's MLP table (transformer.py:60-65):
"gelu" is exact (erf) GELU like ``nn.GELU()``; "approximate_gelu" is tanh GELU.
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
from jax import lax


# bf16 serving substitutes tanh-GELU for exact erf-GELU: |tanh-GELU -
# erf-GELU| peaks at ~5e-4 near |x|=2 — an order below bf16's own rounding.
# Set False for bf16 runs that must match reference erf-GELU bit patterns;
# fp32 (the parity path) always keeps exact erf.
FAST_GELU_BF16: bool = True


def _gelu_exact(x):
    """Exact (erf) GELU; bf16 serving takes tanh-GELU when FAST_GELU_BF16."""
    if FAST_GELU_BF16 and x.dtype == jnp.bfloat16:
        return jax.nn.gelu(x, approximate=True)
    return jax.nn.gelu(x, approximate=False)


ACT_FNS = {
    "gelu": _gelu_exact,
    "approximate_gelu": lambda x: jax.nn.gelu(x, approximate=True),
    "relu": jax.nn.relu,
    "silu": jax.nn.silu,
    "identity": lambda x: x,
}


def dot_precision(x) -> lax.Precision:
    """HIGHEST for fp32 inputs (a GPU would otherwise run fp32 matmuls in
    TF32 and miss the ≤1e-3 parity target); DEFAULT for bf16 — the fast path."""
    return lax.Precision.HIGHEST if x.dtype == jnp.float32 else lax.Precision.DEFAULT


def linear_init(key, in_dim: int, out_dim: int, bias: bool = True) -> dict:
    """torch-style default init: U(-1/sqrt(in), 1/sqrt(in)) for weight and bias."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": jax.random.uniform(kw, (in_dim, out_dim), jnp.float32, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(kb, (out_dim,), jnp.float32, -bound, bound)
    return p


# w8a8 serving (opt-in): with int8-quantized weights AND this flag, linear()
# symmetric-quantizes activations per row and runs int8 x int8 -> int32 dots
# (int8 tensor-core peak is 2x bf16 on Hopper). Attention scores/softmax/norms
# stay bf16/fp32. Env A8_LINEAR=0/1 overrides at trace time for A/B sweeps.
# Engaged via model.quantize_int8() + this flag.
USE_A8_LINEAR = False


def use_a8_linear() -> bool:
    env = os.environ.get("A8_LINEAR")
    if env is not None:
        return env == "1"
    return USE_A8_LINEAR


def _a8_matmul(x: jnp.ndarray, wd: dict) -> jnp.ndarray:
    """x (..., d) float @ int8-dict weight -> (..., out) fp32: per-row dynamic
    activation quantization, exact int32 accumulation, one (row x col) rescale."""
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
    r_s = jnp.where(absmax == 0.0, 1.0, absmax) * (1.0 / 127.0)
    x_q = jnp.clip(jnp.round(x32 / r_s), -127, 127).astype(jnp.int8)
    d, out = wd["w_q"].shape[-2], wd["w_q"].shape[-1]
    acc = lax.dot_general(x_q.reshape(-1, d), wd["w_q"],
                          (((1,), (0,)), ((), ())),
                          preferred_element_type=jnp.int32)
    y = acc.reshape(x.shape[:-1] + (out,)).astype(jnp.float32)
    return y * r_s * wd["w_s"].astype(jnp.float32)


def linear(p: dict, x: jnp.ndarray) -> jnp.ndarray:
    # compute dtype follows the PARAMS (serving mode: bf16 params force bf16
    # compute even for fp32 inputs; fp32 params keep full precision)
    w = p["w"]
    if isinstance(w, dict):  # weight-only int8 (utils.params.quantize_tree_int8)
        if use_a8_linear():  # w8a8: int8 dots, bf16 result like the cast path
            y = _a8_matmul(x, w).astype(jnp.bfloat16)
            if "b" in p:
                y = y + p["b"].astype(y.dtype)
            return y
        w = w["w_q"].astype(jnp.bfloat16) * w["w_s"].astype(jnp.bfloat16)
    if jnp.issubdtype(x.dtype, jnp.floating) and x.dtype != w.dtype:
        x = x.astype(w.dtype)
    y = jnp.matmul(x, w, precision=dot_precision(x))
    if "b" in p:
        y = y + p["b"].astype(y.dtype)
    return y


def ln_init(dim: int) -> dict:
    return {"scale": jnp.ones((dim,), jnp.float32), "bias": jnp.zeros((dim,), jnp.float32)}


def layer_norm(p: dict | None, x: jnp.ndarray, eps: float = 1e-5, axis: int = -1) -> jnp.ndarray:
    """LayerNorm over ``axis`` in fp32 (torch semantics: biased variance, eps in sqrt)."""
    dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=axis, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=axis, keepdims=True)
    y = (x32 - mean) * lax.rsqrt(var + eps)
    if p is not None:
        shape = [1] * y.ndim
        shape[axis] = y.shape[axis]
        y = y * p["scale"].astype(jnp.float32).reshape(shape) + p["bias"].astype(jnp.float32).reshape(shape)
    return y.astype(dtype)


def conv2d_init(key, kh: int, kw_: int, in_ch: int, out_ch: int, bias: bool = True, groups: int = 1) -> dict:
    kw1, kb = jax.random.split(key)
    fan_in = kh * kw_ * in_ch // groups
    bound = 1.0 / math.sqrt(fan_in)
    p = {"w": jax.random.uniform(kw1, (kh, kw_, in_ch // groups, out_ch), jnp.float32, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(kb, (out_ch,), jnp.float32, -bound, bound)
    return p


def conv2d(
    p: dict,
    x: jnp.ndarray,
    stride: int | tuple[int, int] = 1,
    padding: str | int | tuple = 0,
    groups: int = 1,
    dilation: int | tuple[int, int] = 1,
) -> jnp.ndarray:
    """NHWC conv with an HWIO kernel; ``padding`` is an int/pair like torch, or 'SAME'."""
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(dilation, int):
        dilation = (dilation, dilation)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    elif isinstance(padding, tuple) and isinstance(padding[0], int):
        padding = ((padding[0], padding[0]), (padding[1], padding[1]))
    w = p["w"]
    if isinstance(w, dict):  # weight-only int8
        w = w["w_q"].astype(jnp.bfloat16) * w["w_s"].astype(jnp.bfloat16)
    if x.dtype != w.dtype:
        x = x.astype(w.dtype)
    y = lax.conv_general_dilated(
        x,
        w,
        window_strides=stride,
        padding=padding,
        rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
        precision=dot_precision(x),
    )
    if "b" in p:
        y = y + p["b"].astype(y.dtype)
    return y


def bn_init(dim: int) -> dict:
    return {
        "scale": jnp.ones((dim,), jnp.float32),
        "bias": jnp.zeros((dim,), jnp.float32),
        "mean": jnp.zeros((dim,), jnp.float32),
        "var": jnp.ones((dim,), jnp.float32),
    }


def batch_norm(p: dict, x: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """Inference BatchNorm over the channel-last axis using running stats."""
    scale = (p["scale"] * lax.rsqrt(p["var"] + eps)).astype(x.dtype)
    bias = (p["bias"] - p["mean"] * p["scale"] * lax.rsqrt(p["var"] + eps)).astype(x.dtype)
    return x * scale + bias


def max_pool2d(x: jnp.ndarray, window: int, stride: int, padding: int = 0) -> jnp.ndarray:
    """torch MaxPool2d on NHWC data (pads with -inf)."""
    pads = ((0, 0), (padding, padding), (padding, padding), (0, 0))
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, window, window, 1), (1, stride, stride, 1), pads)


def avg_pool2d(x: jnp.ndarray, window: int, stride: int | None = None) -> jnp.ndarray:
    """torch AvgPool2d (no padding) on NHWC data."""
    stride = stride or window
    summed = lax.reduce_window(x, 0.0, lax.add, (1, window, window, 1), (1, stride, stride, 1), "VALID")
    return summed / (window * window)


def conv1d_init(key, k: int, in_ch: int, out_ch: int, bias: bool = True, groups: int = 1) -> dict:
    kw1, kb = jax.random.split(key)
    fan_in = k * in_ch // groups
    bound = 1.0 / math.sqrt(fan_in)
    p = {"w": jax.random.uniform(kw1, (k, in_ch // groups, out_ch), jnp.float32, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(kb, (out_ch,), jnp.float32, -bound, bound)
    return p


def conv1d(
    p: dict,
    x: jnp.ndarray,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    groups: int = 1,
    dilation: int = 1,
) -> jnp.ndarray:
    """NLC conv with a (k, in, out) kernel; torch-style int padding or explicit pair."""
    if isinstance(padding, int):
        padding = (padding, padding)
    w = p["w"]
    if isinstance(w, dict):  # weight-only int8
        w = w["w_q"].astype(jnp.bfloat16) * w["w_s"].astype(jnp.bfloat16)
    if x.dtype != w.dtype:
        x = x.astype(w.dtype)
    y = lax.conv_general_dilated(
        x,
        w,
        window_strides=(stride,),
        padding=(padding,),
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=groups,
        precision=dot_precision(x),
    )
    if "b" in p:
        y = y + p["b"].astype(y.dtype)
    return y
