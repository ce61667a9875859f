"""The repo's entry scripts and their environment: compile-cache placement,
the benchmark's device table, chip_smoke.py off the card, and a main path
that needs none of the optional heavy packages."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(code_or_args, cwd=ROOT, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}, **(env_extra or {}))
    args = code_or_args if isinstance(code_or_args, list) else [
        sys.executable, "-c", textwrap.dedent(code_or_args)]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


# ---------------------------------------------------------------- compile cache


def test_compile_cache_defaults_to_checkout(tmp_path, monkeypatch):
    from pytorch_models_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache(tmp_path)
        assert path == str(tmp_path.resolve() / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_environment(tmp_path, monkeypatch):
    from pytorch_models_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "outside"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache(tmp_path) == str(tmp_path / "outside")
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_directory_receives_programs(tmp_path, env_set):
    """A compiled program lands in ``$JAX_COMPILATION_CACHE_DIR`` when set,
    else in ``<root>/.jax_cache``; never in both."""
    outside = tmp_path / "outside"
    env = {"JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(outside)
    res = _run(f"""
        import jax, jax.numpy as jnp
        from pytorch_models_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache({str(tmp_path)!r})
        jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()
    """, env_extra=env, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert res.returncode == 0, res.stderr
    used, unused = (outside, tmp_path / ".jax_cache") if env_set else (tmp_path / ".jax_cache", outside)
    assert used.is_dir() and any(used.iterdir())
    assert not unused.exists()


# ---------------------------------------------------------------- bench.py


@pytest.mark.parametrize("kind,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("cpu", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_bench_device_table(kind, peaks):
    import bench

    if peaks is None:
        with pytest.raises(ValueError, match="no published peaks"):
            bench.device_peaks(kind)
    else:
        assert bench.device_peaks(kind) == peaks


# ---------------------------------------------------------------- chip_smoke.py


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Off the card (and in a directory holding only the script) it exits
    non-zero and prints no result line."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run([sys.executable, "chip_smoke.py"], cwd=cwd, drop=("PYTHONPATH",))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# ---------------------------------------------------------------- dependencies


def test_main_path_without_optional_packages():
    """Importing the package and running a tiny forward needs none of orbax,
    tensorstore, requests, torch or flax (pretrained-weight and checkpoint
    helpers import them lazily)."""
    res = _run("""
        import sys
        BLOCKED = ("orbax", "tensorstore", "requests", "torch", "flax")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import pytorch_models_tpu
        from pytorch_models_tpu.audio2text import Whisper, WhisperGenerator
        from pytorch_models_tpu.image import ViT
        from pytorch_models_tpu.text import GPT2, DecoderGenerator, T5Model

        GPT2.vocab_size, GPT2.max_seq_len = 64, 128
        class Tok:
            eos_token_id = -1
        out = DecoderGenerator(GPT2(1, 64), Tok()).generate_tokens([1, 2, 3], max_tokens=3)
        assert len(out) == 6
        assert ViT(1, 64, 2, 16, img_size=32)(np.zeros((1, 3, 32, 32), np.float32)).shape == (1, 64)
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("ok")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
