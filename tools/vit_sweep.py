"""ViT-B/16 batch sweep with slope timing (device loops at two iteration
counts; the difference cancels the fixed per-call dispatch cost).

Run: python tools/vit_sweep.py [batch ...]   (default 128 192 256)
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from pytorch_models_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(".")


def depth_slope(batch=128):
    """Time ViT-B/16 at depth 12 vs 6: slope = ms/layer, intercept = stem +
    final-norm + pooler + head (all the non-layer work)."""
    import dataclasses

    from pytorch_models_tpu.models.image.vit import ViT, vit_apply
    from pytorch_models_tpu.utils.params import cast_tree

    n1, n2 = 10, 40
    x = None
    times = {}
    for depth in (6, 12):
        model = ViT.from_google("B/16_augreg")
        params = cast_tree(model.params, jnp.bfloat16)
        cfg = model.cfg
        if depth != cfg.n_layers:
            params = dict(params)
            params["encoder"] = jax.tree.map(lambda a: a[:depth], params["encoder"])
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if x is None:
            x = jnp.asarray(np.random.default_rng(0).standard_normal(
                (batch, 3, 224, 224)), jnp.bfloat16)

        ts = {}
        for n in (n1, n2):
            @jax.jit
            def loop(p, v, n=n, cfg=cfg):
                def body(i, acc):
                    vi = v + i.astype(v.dtype) * v.dtype.type(1e-6)
                    return acc + vit_apply(p, cfg, vi).astype(jnp.float32).sum()
                return jax.lax.fori_loop(0, n, body, jnp.float32(0))
            float(loop(params, x))
            t0 = time.perf_counter()
            float(loop(params, x))
            ts[n] = time.perf_counter() - t0
        times[depth] = (ts[n2] - ts[n1]) / (n2 - n1) * 1e3
        print(f"depth {depth}: {times[depth]:.2f} ms/forward", flush=True)
    per_layer = (times[12] - times[6]) / 6
    print(f"per-layer {per_layer:.3f} ms; non-layer intercept "
          f"{times[12] - 12 * per_layer:.3f} ms", flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "depth":
        depth_slope()
        return
    batches = [int(a) for a in sys.argv[1:]] or [128, 192, 256]
    from bench import vit_flops_per_image
    from pytorch_models_tpu.models.image.vit import ViT, vit_apply
    from pytorch_models_tpu.utils.params import cast_tree

    model = ViT.from_google("B/16_augreg")
    params = cast_tree(model.params, jnp.bfloat16)
    cfg = model.cfg
    flops = vit_flops_per_image()
    peak = 197e12

    n1, n2 = 10, 40
    for batch in batches:
        x = jnp.asarray(np.random.default_rng(0).standard_normal(
            (batch, 3, 224, 224)), jnp.bfloat16)

        def make_loop(n_iters):
            @jax.jit
            def loop(p, v):
                def body(i, acc):
                    vi = v + i.astype(v.dtype) * v.dtype.type(1e-6)
                    return acc + vit_apply(p, cfg, vi).astype(jnp.float32).sum()
                return jax.lax.fori_loop(0, n_iters, body, jnp.float32(0))
            return loop

        ts = {}
        for n in (n1, n2):
            loop = make_loop(n)
            float(loop(params, x))
            t0 = time.perf_counter()
            float(loop(params, x))
            ts[n] = time.perf_counter() - t0
        ips = batch * (n2 - n1) / (ts[n2] - ts[n1])
        print(f"batch {batch}: {ips:,.0f} img/s  (MFU {ips * flops / peak:.1%})",
              flush=True)


if __name__ == "__main__":
    main()
