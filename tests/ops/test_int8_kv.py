"""int8 KV caches (ops/int8_kv.py): per-key int8 storage, dequantized on read.

Cached decode through ``transformer.mha_apply`` over an int8 cache must equal
fp32 attention over the dequantized cache (the attention math is the plain
masked path's), and stay close to full-precision attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import pytorch_models_tpu.transformer as tfm
from pytorch_models_tpu.ops.int8_kv import dequantize, quantize_kv, quantize_rows

L_MAX = 256
H, D = 4, 32
HD = H * D


def _layer(seed=0):
    cfg = tfm.LayerConfig.make(HD, n_heads=H)
    return cfg, tfm.mha_init(jax.random.PRNGKey(seed), cfg)


def _np_attend(q_m, k, v, lo, hi):
    """fp64 per-head attention of one query row over keys [lo, hi)."""
    q_m, k, v = (np.asarray(a, np.float64) for a in (q_m, k, v))
    out = np.zeros(HD)
    for h in range(H):
        sl = slice(h * D, (h + 1) * D)
        s = k[lo:hi, sl] @ q_m[sl] / np.sqrt(D)
        w = np.exp(s - s.max())
        out[sl] = (w / w.sum()) @ v[lo:hi, sl]
    return out


def _lin(p, x):
    return np.asarray(x, np.float64) @ np.asarray(p["w"], np.float64) + np.asarray(p["b"], np.float64)


def _decode(b, pos, pads, seed):
    """One int8-cached decode step at ``pos`` over a prefilled, quantized
    cache; returns (out, new_cache, x, params)."""
    r = np.random.default_rng(seed)
    cfg, p = _layer(seed)
    prefix = jnp.asarray(r.standard_normal((b, L_MAX, HD)), jnp.float32)
    cache = quantize_kv({"k": prefix, "v": prefix[:, ::-1]})
    x = jnp.asarray(r.standard_normal((b, 1, HD)), jnp.float32)
    pads = None if pads is None else jnp.asarray(pads, jnp.int32)
    out, new = tfm.mha_apply(p, cfg, x, cache=cache, cache_pos=pos, pad_lens=pads)
    return out, new, x, p


@pytest.mark.parametrize("b,pos,pads", [
    (1, 0, None),
    (1, 199, [7]),
    (3, 189, [0, 5, 130]),
    (8, 99, None),
    (16, 139, [0] * 8 + [3] * 8),
])
def test_int8_decode_matches_dequantized_oracle(b, pos, pads):
    out, new, x, p = _decode(b, pos, pads, seed=b)
    k = np.asarray(dequantize(new["k"], new["ks"], jnp.float32))
    v = np.asarray(dequantize(new["v"], new["vs"], jnp.float32))
    q_m = _lin(p["q"], x[:, 0])
    for row in range(b):
        lo = 0 if pads is None else pads[row]
        ctx = _np_attend(q_m[row], k[row], v[row], lo, pos + 1)
        np.testing.assert_allclose(np.asarray(out[row, 0]), _lin(p["o"], ctx),
                                   rtol=1e-4, atol=1e-4)


def test_close_to_full_precision():
    """Quantization noise end to end: the int8 cache's decode output stays
    within a few percent of the same step over the fp32 cache."""
    b, pos = 8, 200
    r = np.random.default_rng(3)
    cfg, p = _layer(3)
    prefix = jnp.asarray(r.standard_normal((b, L_MAX, HD)), jnp.float32)
    x = jnp.asarray(r.standard_normal((b, 1, HD)), jnp.float32)
    full = {"k": prefix, "v": prefix * 0.5}
    got, _ = tfm.mha_apply(p, cfg, x, cache=quantize_kv(full), cache_pos=pos)
    want, _ = tfm.mha_apply(p, cfg, x, cache=full, cache_pos=pos)
    err = np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err < 0.04, err


def test_write_matches_prefill():
    """Writing positions one step at a time into an int8 cache gives the same
    state as quantizing a prefilled cache (per-key quantization is
    position-local)."""
    b = 4
    r = np.random.default_rng(11)
    k = jnp.asarray(r.standard_normal((b, 8, HD)), jnp.float32)
    v = jnp.asarray(r.standard_normal((b, 8, HD)), jnp.float32)
    zeros = jnp.zeros((b, L_MAX, HD), jnp.float32)
    a = quantize_kv({"k": zeros.at[:, :8].set(k), "v": zeros.at[:, :8].set(v)})
    state = quantize_kv({"k": zeros, "v": zeros})
    for pos in range(8):
        state, _ = tfm._write_cache(state, k[:, pos:pos + 1], v[:, pos:pos + 1], pos, None)
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(np.asarray(a[name]), np.asarray(state[name]))


def test_quantize_rows_zero_rows():
    """All-zero rows quantize to 0 with a harmless finite positive scale."""
    x = jnp.zeros((2, 3, HD))
    x_q, s = quantize_rows(x)
    assert x_q.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(x_q), 0)
    assert (np.asarray(s) > 0).all() and np.isfinite(np.asarray(s)).all()


def test_empty_range_rows_no_cur():
    """Cross-attention over an int8 cache: a row with no valid memory (an
    unadmitted pool slot) stays finite, the others match the dequantized
    oracle."""
    b = 2
    r = np.random.default_rng(5)
    cfg, p = _layer(5)
    mem = jnp.asarray(r.standard_normal((b, 100, HD)), jnp.float32)
    cross = quantize_kv(tfm.mha_project_kv(p, cfg, mem, valid_lens=jnp.asarray([64, 0])))
    x = jnp.asarray(r.standard_normal((b, 1, HD)), jnp.float32)
    out = np.asarray(tfm.mha_apply(p, cfg, x, cache=cross))
    assert np.isfinite(out).all()
    k = np.asarray(dequantize(cross["k"], cross["ks"], jnp.float32))
    v = np.asarray(dequantize(cross["v"], cross["vs"], jnp.float32))
    ctx = _np_attend(_lin(p["q"], x[0, 0]), k[0], v[0], 0, 64)
    np.testing.assert_allclose(out[0, 0], _lin(p["o"], ctx), rtol=1e-4, atol=1e-4)


def test_quantize_rows_tp_matches_full_width():
    """Under tensor parallelism each rank quantizes its width shard with the
    pmaxed full-width scale: the shards reassemble the single-device result."""
    x = jnp.asarray(np.random.default_rng(7).standard_normal((3, 5, HD)), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    fn = jax.shard_map(lambda a: quantize_rows(a, tp_axis="tp"), mesh=mesh,
                       in_specs=P(None, None, "tp"), out_specs=(P(None, None, "tp"), P()),
                       check_vma=False)
    q_tp, s_tp = fn(x)
    q_1, s_1 = quantize_rows(x)
    np.testing.assert_array_equal(np.asarray(q_tp), np.asarray(q_1))
    np.testing.assert_array_equal(np.asarray(s_tp), np.asarray(s_1))
