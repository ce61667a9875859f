"""Attention micro-benchmark on the card: each kernel choice against its rival.

Usage (on a GPU host): python tools/attn_bench.py

- Encoder attention on merged-head (B, L, H*D) projections, bf16: the einsum
  path (split heads -> ``_sdpa_xla`` -> merge) against
  ``jax.nn.dot_product_attention`` (XLA may hand it to cuDNN).
- Decode attention, bf16, one query per row against a preallocated cache:
  the masked einsum over the whole cache against the Triton decode kernel
  (ops/decode_attention.py), which reads only the valid prefix. Each case
  first checks the kernel against the fp32 einsum reference. Decode calls
  are timed as 200 iterations of one on-device loop, so host dispatch is not
  in the number.

Prints one line per case with ms/call (median of 5 timed runs, each ended by
``block_until_ready``) and the card's name and power limit.
"""

import math
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from pytorch_models_tpu.ops.attention import _sdpa_xla
from pytorch_models_tpu.ops.decode_attention import decode_attention

# (name, B, H, L, D)
ENCODER_SHAPES = [
    ("vit_b16", 128, 12, 197, 64),
    ("whisper_enc_b16", 16, 8, 1500, 64),
    ("whisper_enc_b1", 1, 8, 1500, 64),
]
# (name, B, H, cache L, valid end, D): the end-to-end decode shapes
DECODE_SHAPES = [
    ("gpt2_b32_self", 32, 12, 1024, 288, 64),
    ("gpt2_b1_self", 1, 12, 1024, 288, 64),
    ("whisper_b16_self", 16, 8, 128, 36, 64),
    ("whisper_b16_cross", 16, 8, 1536, 1500, 64),
]
N_CALLS = 20
N_LOOP = 200


def timed_ms(fn, *args):
    jax.block_until_ready(fn(*args))  # compile + warm
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(N_CALLS):
            out = fn(*args)
        jax.block_until_ready(out)
        runs.append((time.perf_counter() - t0) / N_CALLS * 1e3)
    return float(np.median(runs))


def loop_ms(fn, q, k, v, ends):
    """Device ms per call of ``fn`` inside one jitted loop (each iteration's
    query depends on the last output, so calls cannot overlap or hoist)."""
    @jax.jit
    def loop(q, k, v, ends):
        def body(i, qq):
            return qq + fn(qq, k, v, ends).astype(qq.dtype) * qq.dtype.type(1e-3)
        return jax.lax.fori_loop(0, N_LOOP, body, q)

    jax.block_until_ready(loop(q, k, v, ends))
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(q, k, v, ends))
        runs.append((time.perf_counter() - t0) / N_LOOP * 1e3)
    return float(np.median(runs))


def split(x, h):
    return jnp.swapaxes(x.reshape(*x.shape[:-1], h, -1), -2, -3)


def merge(x):
    x = jnp.swapaxes(x, -2, -3)
    return x.reshape(*x.shape[:-2], -1)


def encoder_einsum(q, k, v, h):
    return merge(_sdpa_xla(split(q, h), split(k, h), split(v, h), None, False))


def encoder_dpa(q, k, v, h):
    b, l, hd = q.shape
    shp = (b, l, h, hd // h)
    out = jax.nn.dot_product_attention(q.reshape(shp), k.reshape(shp), v.reshape(shp))
    return out.reshape(b, l, hd)


def decode_einsum(q, k, v, ends, h):
    """The masked per-op path of transformer.mha_apply at S=1."""
    l_max = k.shape[1]
    bias = jnp.where(jnp.arange(l_max)[None, :] < ends[:, None], 0.0, -1e30)
    out = _sdpa_xla(split(q, h), split(k, h), split(v, h),
                    bias[:, None, None, :].astype(jnp.float32), False)
    return merge(out)


def main():
    dev = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device {dev.platform} {dev.device_kind} | {smi}", flush=True)
    r = np.random.default_rng(0)

    for name, b, h, l, d in ENCODER_SHAPES:
        q, k, v = (jnp.asarray(r.standard_normal((b, l, h * d)), jnp.bfloat16) for _ in range(3))
        ein = jax.jit(encoder_einsum, static_argnums=3)
        dpa = jax.jit(encoder_dpa, static_argnums=3)
        diff = float(jnp.max(jnp.abs(ein(q, k, v, h).astype(jnp.float32)
                                     - dpa(q, k, v, h).astype(jnp.float32))))
        flops = 4 * b * h * l * l * d
        t_e, t_d = timed_ms(ein, q, k, v, h), timed_ms(dpa, q, k, v, h)
        print(f"encoder {name}: einsum {t_e:.4f} ms ({flops / t_e / 1e9:.1f} TF/s)  "
              f"dot_product_attention {t_d:.4f} ms ({flops / t_d / 1e9:.1f} TF/s)  "
              f"max|diff| {diff:.3e}", flush=True)

    for name, b, h, l, end, d in DECODE_SHAPES:
        q = jnp.asarray(r.standard_normal((b, 1, h * d)), jnp.bfloat16)
        k, v = (jnp.asarray(r.standard_normal((b, l, h * d)), jnp.bfloat16) for _ in range(2))
        ends = jnp.full((b,), end, jnp.int32)
        with jax.default_matmul_precision("highest"):
            want = decode_einsum(q.astype(jnp.float32), k.astype(jnp.float32),
                                 v.astype(jnp.float32), ends, h)
        ker = lambda q, k, v, e: decode_attention(q, k, v, e, h)
        diff = float(jnp.max(jnp.abs(jax.jit(ker)(q, k, v, ends).astype(jnp.float32) - want)))
        assert diff < 2e-2 and math.isfinite(diff), (name, diff)
        valid_bytes = 2 * b * end * h * d * 2
        t_e = loop_ms(lambda *a: decode_einsum(*a, h), q, k, v, ends)
        t_k = loop_ms(ker, q, k, v, ends)
        print(f"decode {name}: einsum {t_e:.4f} ms  triton {t_k:.4f} ms "
              f"({valid_bytes / (t_k * 1e-3) / 1e9:.0f} GB/s of valid K/V)  "
              f"max|diff| vs fp32 {diff:.3e} (tol 2e-2)", flush=True)


if __name__ == "__main__":
    main()
