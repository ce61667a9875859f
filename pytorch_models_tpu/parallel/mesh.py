"""Device mesh construction for SPMD execution.

The reference is single-process with no distributed layer (SURVEY.md §2.7 N3);
this is the JAX equivalent: a named ``jax.sharding.Mesh`` whose axes
carry data ("dp"), pipeline ("pp"), and tensor ("tp") parallelism. Sequence
parallelism reuses the "tp" axis (Megatron-style), expert parallelism
shards the expert dim over "tp" as well (see parallel/train.py).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def _factor3(n: int) -> tuple[int, int, int]:
    """Split n devices into (dp, pp, tp): tp ≤ 2 on the innermost
    axis, then pp ≤ 2, remainder to dp — so 8 devices exercise all three axes.
    Devices are taken in plain order: the cards of one host are joined all to
    all, so no axis needs a faster link."""
    def largest_pow2_divisor(x: int, cap: int) -> int:
        d = 1
        while d * 2 <= cap and x % (d * 2) == 0:
            d *= 2
        return d

    tp = largest_pow2_divisor(n, 2)
    rem = n // tp
    pp = largest_pow2_divisor(rem, 2)
    dp = rem // pp
    return dp, pp, tp


def make_mesh(n_devices: int | None = None, shape: tuple[int, ...] | None = None,
              axes: tuple[str, ...] = ("dp", "pp", "tp")) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if shape is None:
        assert axes == ("dp", "pp", "tp")
        shape = _factor3(n)
    grid = np.asarray(devices[:n]).reshape(shape)
    return Mesh(grid, axes)
