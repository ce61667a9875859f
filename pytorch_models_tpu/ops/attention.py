"""Scaled dot-product attention dispatch.

Replacement for the reference's single hot kernel,
``F.scaled_dot_product_attention`` (reference transformer.py:52). One entry
point serves every family: dense bidirectional (ViT/BERT), additive-bias
(MaxViT windows, T5 relative bias), causal (GPT/GPT-2/Whisper-dec), and
cross-attention (DETR/Whisper/T5-dec).

The head-split entry point (``sdpa``) is a single XLA einsum path; for
single-position self-attention decode over a long cache on the GPU,
transformer.py picks the Triton decode kernel (ops/decode_attention.py) via
:func:`use_decode_kernel`. Encoder and
prefill attention stay on the einsum path: on an H100 (400 W limit) it
measured faster in bf16 than ``jax.nn.dot_product_attention`` at ViT-B/16
(L=197, batch 128) and Whisper-base (L=1500, batch 16 and 1) — PERF.md.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


# int8 self-KV caches (ops/int8_kv.py): K/V stored as per-key symmetric int8
# (+ f32 scales) and dequantized on read. Halves the cache's bytes; opt-in
# because it changes numerics (per-key rounding). Read at TRACE time.
USE_INT8_KV: bool = False

# int8 CROSS-KV caches: whisper/T5 encoder caches are write-once per request
# (quantized at encode time), and legal for T5 too (its rel-pos bias applies
# to SELF attention only). Opt-in, read at trace time.
USE_INT8_KV_CROSS: bool = False


# the decode kernel pays by skipping the cache slots past each row's valid
# prefix; on an H100 it measured 1.7-1.8x faster end to end over GPT-2's
# 1024-slot cache, slower over Whisper's full-length cross memory, and
# between slower and 1.06x faster over Whisper's 128-slot self caches in
# short runs (PERF.md), so shorter caches stay on the einsum until a longer
# A/B decides
MIN_KERNEL_CACHE = 1024


def use_decode_kernel(dtype, cache_len: int, head_dim: int, has_bias: bool,
                      platform: str | None = None) -> bool:
    """Kernel choice for single-position SELF-attention decode over a
    merged-head cache: the Triton kernel on the GPU for bf16 caches of at
    least ``MIN_KERNEL_CACHE`` slots with no additive bias; everything else
    (fp32 parity runs, T5's rel-pos bias, short caches, the CPU) takes the
    masked einsum path. Cross-attention memory is valid end to end, so the
    kernel has nothing to skip there and it is never asked."""
    from .decode_attention import BLOCK_K

    platform = jax.default_backend() if platform is None else platform
    return (platform == "gpu" and jnp.dtype(dtype) == jnp.bfloat16 and not has_bias
            and cache_len >= MIN_KERNEL_CACHE and cache_len % BLOCK_K == 0
            and head_dim in (16, 32, 64, 128, 256))


def sdpa(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    attn_bias: jnp.ndarray | None = None,
    causal: bool = False,
    impl: str = "auto",
) -> jnp.ndarray:
    """Attention over ``(..., n_heads, L, head_dim)`` tensors.

    ``attn_bias`` is an additive mask/bias broadcastable to ``(..., H, Lq, Lk)``.
    ``causal`` masks key positions ``j > i`` (top-left aligned, torch semantics).
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown attention impl {impl!r} (expected 'auto' or 'xla')")
    return _sdpa_xla(q, k, v, attn_bias, causal)


def _sdpa_xla(q, k, v, attn_bias, causal):
    from .layers import dot_precision

    prec = dot_precision(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # fp32 inputs: fp32 softmax (parity). bf16 serving: keep scores in bf16 —
    # the fp32 upcast doubles the memory traffic of the (.., Lq, Lk) score
    # tensor, which dominates encoder attention time at these lengths.
    acc_dtype = jnp.float32 if q.dtype == jnp.float32 else q.dtype
    logits = jnp.einsum("...qd,...kd->...qk", q, k, precision=prec).astype(acc_dtype)
    logits = logits * jnp.asarray(scale, acc_dtype)
    if attn_bias is not None:
        logits = logits + attn_bias.astype(acc_dtype)
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        row = jax.lax.broadcasted_iota(jnp.int32, (lq, lk), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (lq, lk), 1)
        logits = jnp.where(col <= row, logits, jnp.asarray(-jnp.inf, acc_dtype))
    if acc_dtype == jnp.float32:
        probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    else:
        # bf16 serving: scores stay bf16 but the normalization accumulates in
        # fp32 — a bf16 sum over 1024+ terms carries ~3-significant-digit
        # error. The fp32 intermediates fuse away in XLA.
        m = jnp.max(logits, axis=-1, keepdims=True)
        e = jnp.exp(logits - m)
        denom = jnp.sum(e.astype(jnp.float32), axis=-1, keepdims=True)
        probs = (e.astype(jnp.float32) / denom).astype(q.dtype)
    return jnp.einsum("...qk,...kd->...qd", probs, v, precision=prec)
