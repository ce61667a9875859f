"""Test env: force CPU JAX with 8 virtual devices (sharding tests), expose the
mounted PyTorch reference as the numerical oracle (SURVEY.md §4).

Tests marked ``gpu`` need the card and skip here; ``chip_smoke.py`` runs the
same checks as phases on the GPU.
"""

import functools
import os
import sys

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# Must run before any JAX backend initialization: the suite is a CPU suite
# whatever accelerator the host has.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REFERENCE_PATH = os.environ.get("REFERENCE_PATH", "/root/reference")
if os.path.isdir(REFERENCE_PATH) and REFERENCE_PATH not in sys.path:
    sys.path.insert(0, REFERENCE_PATH)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the card")


@pytest.fixture
def decode_kernel_interpret(monkeypatch):
    """Route every eligible single-position decode read through the Triton
    decode kernel (ops/decode_attention.py) in Pallas interpret mode — the
    CPU stand-in for the card, where the dispatch picks it for bf16 caches.
    Yields a dict whose ``"traces"`` counts kernel traces, so a test can
    assert the kernel really ran."""
    from pytorch_models_tpu.ops import attention, decode_attention as da

    calls = {"traces": 0}
    kernel = da.decode_attention

    def traced(*args, **kw):
        calls["traces"] += 1
        return kernel(*args, interpret=True, **kw)

    monkeypatch.setattr(attention, "use_decode_kernel",
                        lambda dtype, cache_len, head_dim, has_bias, platform=None:
                        not has_bias and cache_len % da.BLOCK_K == 0)
    monkeypatch.setattr(da, "decode_attention", functools.wraps(kernel)(traced))
    jax.clear_caches()
    yield calls
    jax.clear_caches()


@pytest.fixture
def int8_modes(monkeypatch):
    """``int8_modes(self_kv, cross_kv)`` turns the int8 KV serving modes on
    for one test and returns a dict whose ``"n"`` counts dequantizing reads
    (ops/int8_kv.py), so a test can assert the int8 caches were really read."""
    from pytorch_models_tpu.ops import attention, int8_kv

    reads = {"n": 0}
    dequantize = int8_kv.dequantize

    def counted(*args):
        reads["n"] += 1
        return dequantize(*args)

    monkeypatch.setattr(int8_kv, "dequantize", counted)

    def on(self_kv=False, cross_kv=False):
        monkeypatch.setattr(attention, "USE_INT8_KV", self_kv)
        monkeypatch.setattr(attention, "USE_INT8_KV_CROSS", cross_kv)
        jax.clear_caches()
        return reads

    yield on
    jax.clear_caches()
