"""Pallas (Triton route) decode attention over a merged-head KV cache.

Single-position queries (one new token per batch row) attend to a
preallocated cache ``(B, L, H*D)`` — the exact layout the K/V projections
produce. The masked einsum path (transformer.py) splits heads and reads the
WHOLE preallocated cache every step; at GPT-2-small batch 32 with a 640-slot
cache that is ~755 MB of K/V per step against ~340 MB for the valid prefix.
This kernel reads only the keys in ``[pad_lens[b], ends[b])``.

Design (split-K flash decoding, after the Triton decode kernel shipped with
JAX in ``jax/experimental/pallas/ops/gpu/decode_attention.py``, which is NOT
called here: its ``gqa`` swaps the cache's axes on every call, a full-cache
copy):

- grid ``(B, H, S)``: one program per (batch row, head, key split). Block
  specs slice the merged-head cache in place — head ``h`` is the lane range
  ``[h*D, (h+1)*D)`` — so nothing is transposed or copied. (Programs that
  each take a group of heads, for longer contiguous rows, measured slower
  at GPT-2's decode shape: PERF.md.)
- each program loops over ``block_k``-key blocks of its split, but only the
  blocks that intersect ``[pad, end)``: the loop bounds are dynamic, so the
  bytes read follow the true prefix length, not the preallocated maximum.
- per block: scores are a ``(block_k, D)`` multiply-reduce (one query row
  per head: no matrix unit to fill), fp32 online softmax, ``p @ V`` likewise.
- S is chosen from the static shapes: 1 when the (row, head) programs
  alone fill the card (the kernel then writes the normalised output), more
  at small batch, where the S partial results (unnormalised output, running
  max, running sum) are combined in XLA.

``interpret=True`` runs the same kernel in the Pallas interpreter on the CPU
(tests only); on the card it is always compiled through Triton.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30

BLOCK_K = 32  # keys per loop step; caches are whole multiples of it
# programs for two waves over an H100's 132 SMs: below this the key axis splits
MIN_PROGRAMS = 264


def num_splits(b: int, n_heads: int, l_max: int, block_k: int = BLOCK_K) -> int:
    """Key splits per (row, head): the fewest that reach ``MIN_PROGRAMS``
    programs, capped at one block per split and divisible into the cache."""
    n_blocks = l_max // block_k
    s = max(1, min(n_blocks, -(-MIN_PROGRAMS // (b * n_heads))))
    while n_blocks % s:
        s -= 1
    return s


def _kernel(ends_ref, pads_ref, q_ref, k_ref, v_ref, *out_refs, block_k: int,
            split_len: int, scale: float):
    """``out_refs``: the normalised output (one split), or the split's
    unnormalised output, running max and running sum (several splits)."""
    split0 = pl.program_id(2) * split_len
    lo = jnp.maximum(pads_ref[...] - split0, 0)  # split-local valid range
    hi = jnp.minimum(ends_ref[...] - split0, split_len)
    q = q_ref[...].astype(jnp.float32) * scale  # (D,)

    def body(i, carry):
        m, l, acc = carry
        start = pl.multiple_of(i * block_k, block_k)
        idx = start + jnp.arange(block_k)
        valid = (idx >= lo) & (idx < hi)
        k = k_ref[pl.ds(start, block_k), :].astype(jnp.float32)  # (block_k, D)
        s = jnp.where(valid, jnp.sum(k * q[None, :], axis=1), NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s))
        p = jnp.where(valid, jnp.exp(s - m_new), 0.0)
        alpha = jnp.exp(m - m_new)
        v = v_ref[pl.ds(start, block_k), :].astype(jnp.float32)
        acc = acc * alpha + jnp.sum(p[:, None] * v, axis=0)
        return m_new, l * alpha + jnp.sum(p), acc

    init = (jnp.float32(NEG_INF), jnp.float32(0.0), jnp.zeros(q.shape, jnp.float32))
    m, l, acc = lax.fori_loop(lo // block_k, pl.cdiv(hi, block_k), body, init)
    if len(out_refs) == 1:  # an empty row (l == 0) returns zeros
        out_refs[0][...] = (acc / jnp.where(l == 0.0, 1.0, l)).astype(out_refs[0].dtype)
        return
    o_ref, m_ref, l_ref = out_refs
    o_ref[...] = acc
    m_ref[...] = m
    l_ref[...] = l


@functools.partial(jax.jit, static_argnames=("n_heads", "block_k", "interpret"))
def decode_attention(q, k_cache, v_cache, ends, n_heads: int, pad_lens=None,
                     block_k: int = BLOCK_K, interpret: bool = False):
    """q: (B, 1, H*D); k_cache/v_cache: (B, L, H*D); ends: scalar or (B,) int.

    Attention over cache positions ``[pad_lens[b], ends[b])`` per batch row;
    returns the (B, 1, H*D) merged-head context (feed straight to the
    out-projection). ``L`` must be a multiple of ``block_k``; slots in the
    valid range must already hold this step's K/V. Unbatched ``(1, H*D)``
    inputs are promoted. For self-attention decode at position ``pos`` pass
    ``ends = pos + 1``; a row whose range is empty returns zeros.
    """
    unbatched = q.ndim == 2
    if unbatched:
        q, k_cache, v_cache = q[None], k_cache[None], v_cache[None]
    b, lq, hd = q.shape
    l_max = k_cache.shape[-2]
    d = hd // n_heads
    if lq != 1 or hd % n_heads:
        raise ValueError(f"decode attention takes one query per row, got q {q.shape}")
    if l_max % block_k:
        raise ValueError(f"cache length {l_max} is not a multiple of block_k={block_k}")
    s = num_splits(b, n_heads, l_max, block_k)
    split_len = l_max // s

    ends_arr = jnp.broadcast_to(jnp.asarray(ends, jnp.int32).reshape(-1), (b,))
    pad_arr = (jnp.zeros((b,), jnp.int32) if pad_lens is None
               else jnp.broadcast_to(jnp.asarray(pad_lens, jnp.int32).reshape(-1), (b,)))

    row = pl.BlockSpec((None,), lambda i, h, j: (i,))
    part = pl.BlockSpec((None, None, None), lambda i, h, j: (i, j, h))
    if s == 1:
        out_specs = pl.BlockSpec((None, None, d), lambda i, h, j: (i, 0, h))
        out_shape = jax.ShapeDtypeStruct((b, 1, hd), q.dtype)
    else:
        out_specs = [pl.BlockSpec((None, None, d), lambda i, h, j: (i, j, h)), part, part]
        out_shape = [jax.ShapeDtypeStruct((b, s, hd), jnp.float32),
                     jax.ShapeDtypeStruct((b, s, n_heads), jnp.float32),
                     jax.ShapeDtypeStruct((b, s, n_heads), jnp.float32)]
    outs = pl.pallas_call(
        functools.partial(_kernel, block_k=block_k, split_len=split_len,
                          scale=1.0 / math.sqrt(d)),
        grid=(b, n_heads, s),
        in_specs=[
            row,
            row,
            pl.BlockSpec((None, None, d), lambda i, h, j: (i, 0, h)),
            pl.BlockSpec((None, split_len, d), lambda i, h, j: (i, j, h)),
            pl.BlockSpec((None, split_len, d), lambda i, h, j: (i, j, h)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="decode_attention",
    )(ends_arr, pad_arr, q, k_cache, v_cache)
    if s == 1:
        return outs[0] if unbatched else outs

    # combine the key splits (flash-decoding's second pass)
    o, m, l = outs
    m_max = jnp.max(m, axis=1, keepdims=True)  # (B, 1, H)
    corr = jnp.exp(m - m_max)  # (B, S, H); empty splits carry l = 0, o = 0
    l_tot = jnp.sum(l * corr, axis=1)  # (B, H)
    o = jnp.sum(o.reshape(b, s, n_heads, d) * corr[..., None], axis=1)
    o = o / jnp.where(l_tot == 0.0, 1.0, l_tot)[..., None]
    out = o.reshape(b, 1, hd).astype(q.dtype)
    return out[0] if unbatched else out
