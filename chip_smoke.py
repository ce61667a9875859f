"""Smoke run of the main serving paths on one NVIDIA GPU (``--four``: the
tensor-parallel GPT-2 path on four).

Usage, from the repo root on a GPU host:

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: TP generators vs single device

Models run at their full published widths with random weights from fixed
seeds (no network). Every phase checks its result against the repo's plain
path run in fp32 on the same card under ``jax.default_matmul_precision
("highest")`` (an fp32 matmul otherwise runs in TF32) and prints one line:
its diff, the tolerance, compile seconds, steady-state ms and the process's
``peak_bytes_in_use``. Generation is checked token by token: each generated
token's fp32 logit may trail the fp32 argmax at that position (teacher-forced
over the generated sequence) by at most ``tol`` standard deviations of that
position's fp32 logits; the diff printed is the largest such margin. No phase
catches its own failure: any mismatch raises and the script exits non-zero.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# tolerances, in fp32-logit standard deviations (generation) or absolute
# units of outputs of order one (dense): bf16 keeps ~3 significant digits
GEN_TOL_BF16 = 0.25
GEN_TOL_INT8 = 0.5  # int8 weights / activations / KV add per-row rounding
DENSE_TOL = 5e-2
KERNEL_TOL = 2e-2

GPT2_PROMPT_LEN, GPT2_NEW = 32, 64
WHISPER_INIT = [50258, 50259, 50359, 50363]  # <|sot|><|en|><|transcribe|><|notimestamps|>
WHISPER_NEW = 32
T5_ENC_LEN, T5_NEW = 64, 32


class _Tok:
    """Token-level generators read only ``eos_token_id``; -1 never stops."""

    eos_token_id = -1


def _peak_bytes(dev=None):
    import jax

    dev = dev or jax.devices()[0]
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)


def _timed(fn, reps=2):
    """(result, first-call seconds incl. compile, steady ms = median of
    ``reps`` further calls; 0 when there are none)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        runs.append((time.perf_counter() - t0) * 1e3)
    return out, first, float(np.median(runs)) if runs else 0.0


def report(name, diff, tol, compile_s, steady_ms, **extra):
    more = "".join(f" {k}={v}" for k, v in extra.items())
    print(f"phase {name}: diff={diff:.4g} tol={tol:g} compile_s={compile_s:.2f} "
          f"steady_ms={steady_ms:.2f} peak_bytes_in_use={_peak_bytes()}{more}", flush=True)
    if not (math.isfinite(diff) and diff <= tol):
        raise AssertionError(f"phase {name}: diff {diff} exceeds tolerance {tol}")


def gen_margin(logits, seqs, starts, ends=None):
    """Largest normalised margin over generated positions: for each token
    ``seqs[b, t]`` with ``starts[b] <= t < ends[b]``, (fp32 max logit -
    fp32 logit of the token) / std of the logits at position t-1."""
    import jax.numpy as jnp

    lg = logits[:, :-1].astype(jnp.float32)
    tok = jnp.asarray(seqs)[:, 1:]
    chosen = jnp.take_along_axis(lg, tok[..., None], axis=-1)[..., 0]
    margin = (jnp.max(lg, axis=-1) - chosen) / jnp.std(lg, axis=-1)
    t = jnp.arange(1, seqs.shape[1])[None, :]
    ends = jnp.full((seqs.shape[0],), seqs.shape[1]) if ends is None else jnp.asarray(ends)
    gen = (t >= jnp.asarray(starts)[:, None]) & (t < ends[:, None])
    return float(jnp.max(jnp.where(gen, margin, 0.0))), int(jnp.sum(gen & (margin > 0)))


def _lm_margin(m32, rows, starts):
    """Decoder-LM generations (token lists) vs the fp32 uncached forward."""
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.text._decoder_lm import decoder_lm_apply

    width = max(len(r) for r in rows)
    seqs = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        seqs[i, :len(r)] = r  # right pad: causal, never read by real positions
    with jax.default_matmul_precision("highest"):
        logits = decoder_lm_apply(m32.params, m32.cfg, jnp.asarray(seqs))
    return gen_margin(logits, seqs, starts, [len(r) for r in rows])


# ---------------------------------------------------------------- phases


def phase_vit():
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.image import ViT

    m32 = ViT.from_google("B/16_augreg")
    m16 = ViT.from_google("B/16_augreg").to_bf16()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((128, 3, 224, 224)), jnp.float32)
    out, first, steady = _timed(lambda: m16(x.astype(jnp.bfloat16)))
    with jax.default_matmul_precision("highest"):
        ref = m32(x)
    diff = float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref)))
    report("vit_b16_b128_bf16", diff, DENSE_TOL * float(jnp.max(jnp.abs(ref))), first, steady,
           out_shape=tuple(out.shape))
    assert out.shape == (128, m16.cfg.d_model)


def phase_gpt2():
    from pytorch_models_tpu.models.text import GPT2, ContinuousBatchingGenerator, DecoderGenerator

    m32, m16 = GPT2(12, 768), GPT2(12, 768).to_bf16()
    r = np.random.default_rng(1)
    prompts = r.integers(0, 50257, (32, GPT2_PROMPT_LEN)).tolist()
    gen = DecoderGenerator(m16, _Tok())
    outs, first, steady = _timed(lambda: gen.generate_tokens_batch(prompts, max_tokens=GPT2_NEW))
    assert all(len(o) == GPT2_PROMPT_LEN + GPT2_NEW for o in outs)
    margin, n_off = _lm_margin(m32, outs, [GPT2_PROMPT_LEN] * 32)
    report("gpt2_batch32_bf16", margin, GEN_TOL_BF16, first, steady,
           tok_per_s=round(32 * GPT2_NEW / (steady / 1e3), 1), off_argmax=n_off)

    # continuous batching: 8 requests of mixed prompt lengths and budgets
    reqs = [r.integers(0, 50257, n).tolist() for n in (5, 40, 17, 64, 9, 33, 1, 22)]
    budgets = [24, 8, 40, 16, 31, 12, 20, 28]
    cb = ContinuousBatchingGenerator(m16, _Tok(), batch_size=4, check_every=8)
    outs, first, steady = _timed(lambda: cb.generate_tokens_many(reqs, budgets), reps=1)
    assert [len(o) for o in outs] == [len(q) + m for q, m in zip(reqs, budgets)]
    margin, n_off = _lm_margin(m32, outs, [len(q) for q in reqs])
    report("gpt2_continuous_8req_bf16", margin, GEN_TOL_BF16, first, steady, off_argmax=n_off)

    # token identity with the plain generator at the same dtype (fp32)
    import jax

    with jax.default_matmul_precision("highest"):
        cb32 = ContinuousBatchingGenerator(m32, _Tok(), batch_size=4, check_every=8)
        pool, first, steady = _timed(lambda: cb32.generate_tokens_many(reqs, budgets), reps=0)
        plain = DecoderGenerator(m32, _Tok())
        want = [plain.generate_tokens(q, max_tokens=m) for q, m in zip(reqs, budgets)]
    mismatched = sum(a != b for a, b in zip(pool, want))
    report("gpt2_continuous_vs_plain_fp32", float(mismatched), 0, first, 0.0)


def _whisper_ref_margin(m32, mels, seqs):
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.audio2text.whisper import whisper_decode, whisper_encode

    with jax.default_matmul_precision("highest"):
        memory = whisper_encode(m32.params, m32.cfg, mels)
        logits = whisper_decode(m32.params, m32.cfg, jnp.asarray(seqs), memory)
    return gen_margin(logits, np.asarray(seqs), [len(WHISPER_INIT)] * len(seqs))


def phase_whisper():
    import jax.numpy as jnp

    from pytorch_models_tpu.models.audio2text.whisper import (
        Whisper,
        WhisperGenerator,
        WhisperPreprocessor,
    )

    m32, m16 = Whisper.from_openai("base"), Whisper.from_openai("base").to_bf16()
    gen = WhisperGenerator(m16)
    max_tokens = len(WHISPER_INIT) + WHISPER_NEW
    audios = jnp.asarray(np.random.default_rng(2).standard_normal((16, 30 * 16_000)) * 0.1,
                         jnp.float32)
    mels = WhisperPreprocessor("base")(audios)

    out, first, steady = _timed(
        lambda: gen.transcribe_tokens(audios[0], WHISPER_INIT, -1, max_tokens=max_tokens))
    assert len(out) == max_tokens
    margin, n_off = _whisper_ref_margin(m32, mels[:1], np.asarray([out]))
    report("whisper_base_b1_bf16", margin, GEN_TOL_BF16, first, steady,
           rtf=round(30.0 / (steady / 1e3), 1), off_argmax=n_off)

    outs, first, steady = _timed(
        lambda: gen.transcribe_tokens_batch(audios, WHISPER_INIT, -1, max_tokens=max_tokens))
    assert all(len(o) == max_tokens for o in outs)
    margin, n_off = _whisper_ref_margin(m32, mels, np.asarray(outs))
    report("whisper_base_b16_bf16", margin, GEN_TOL_BF16, first, steady,
           rtf=round(16 * 30.0 / (steady / 1e3), 1), off_argmax=n_off)


def phase_t5():
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.text.t5 import SIZES, T5Generator, T5Model, t5_decode, t5_encode

    m32 = T5Model(32128, *SIZES["base"])
    m16 = T5Model(32128, *SIZES["base"]).to_bf16()
    gen = T5Generator(model=m16, tokenizer=object())
    prompts = np.random.default_rng(3).integers(2, 32128, (32, T5_ENC_LEN))
    outs, first, steady = _timed(
        lambda: gen.generate_tokens_batch(prompts.tolist(), T5_NEW + 1, 0, -1))
    assert all(len(o) == T5_NEW + 1 and o[0] == 0 for o in outs)
    seqs = np.asarray(outs, np.int32)
    with jax.default_matmul_precision("highest"):
        memory = t5_encode(m32.params, m32.cfg, jnp.asarray(prompts, jnp.int32))
        logits = t5_decode(m32.params, m32.cfg, jnp.asarray(seqs), memory)
    margin, n_off = gen_margin(logits, seqs, [1] * 32)
    report("t5_base_b32_bf16", margin, GEN_TOL_BF16, first, steady,
           tok_per_s=round(32 * T5_NEW / (steady / 1e3), 1), off_argmax=n_off)


def phase_kernel_parity():
    """The Triton decode kernel at the widths it serves vs the fp32 einsum
    reference over the same bf16 inputs."""
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.ops.attention import _sdpa_xla
    from pytorch_models_tpu.ops.decode_attention import decode_attention

    def split(x, h):
        return jnp.swapaxes(x.reshape(*x.shape[:-1], h, -1), -2, -3)

    r = np.random.default_rng(4)
    # (name, B, H, cache L, valid [pad, end) per row): GPT-2-small's decode
    # width, where the dispatch uses the kernel (ops.attention.use_decode_kernel)
    cases = [("gpt2_b32", 32, 12, 1024, 0, 96), ("gpt2_b32_left_padded", 32, 12, 1024, 17, 96),
             ("gpt2_b32_full_cache", 32, 12, 1024, 0, 1024), ("gpt2_b1_split_k", 1, 12, 1024, 0, 600)]
    for name, b, h, l, pad, end in cases:
        q = jnp.asarray(r.standard_normal((b, 1, h * 64)), jnp.bfloat16)
        k, v = (jnp.asarray(r.standard_normal((b, l, h * 64)), jnp.bfloat16) for _ in range(2))
        pads = jnp.full((b,), pad, jnp.int32)
        fn = jax.jit(lambda q, k, v: decode_attention(q, k, v, end, h, pads))
        out, first, steady = _timed(lambda: fn(q, k, v), reps=5)
        key = jnp.arange(l)
        bias = jnp.where((key >= pad) & (key < end), 0.0, -1e30).astype(jnp.float32)
        with jax.default_matmul_precision("highest"):
            want = _sdpa_xla(*(split(x.astype(jnp.float32), h) for x in (q, k, v)),
                             bias[None, None, None, :], False)
        want = jnp.swapaxes(want, 1, 2).reshape(b, 1, h * 64)
        diff = float(jnp.max(jnp.abs(out.astype(jnp.float32) - want)))
        report(f"decode_kernel_{name}", diff, KERNEL_TOL, first, steady)


def phase_opt_in_modes():
    """Weight-only int8, w8a8 linears and the int8-KV pool each compile and
    answer a few requests (checked like the bf16 generations, with the
    looser int8 tolerance)."""
    import jax

    from pytorch_models_tpu.models.text import GPT2, ContinuousBatchingGenerator, DecoderGenerator
    from pytorch_models_tpu.ops import attention, layers

    m32 = GPT2(12, 768)
    r = np.random.default_rng(5)
    prompts = r.integers(0, 50257, (8, 16)).tolist()

    def run(name, model, make):
        gen = make(model)
        outs, first, steady = _timed(gen, reps=1)
        margin, n_off = _lm_margin(m32, outs, [16] * len(outs))
        report(name, margin, GEN_TOL_INT8, first, steady, off_argmax=n_off)

    int8 = GPT2(12, 768).to_bf16().quantize_int8()
    run("gpt2_int8_weights", int8,
        lambda m: lambda: DecoderGenerator(m, _Tok()).generate_tokens_batch(prompts, max_tokens=16))
    layers.USE_A8_LINEAR = True
    jax.clear_caches()
    try:
        run("gpt2_w8a8", int8,
            lambda m: lambda: DecoderGenerator(m, _Tok()).generate_tokens_batch(prompts, max_tokens=16))
    finally:
        layers.USE_A8_LINEAR = False
        jax.clear_caches()
    attention.USE_INT8_KV = True
    try:
        cb = lambda m: lambda: ContinuousBatchingGenerator(m, _Tok(), batch_size=4).generate_tokens_many(
            prompts, [16] * len(prompts))
        run("gpt2_int8_kv_pool", GPT2(12, 768).to_bf16(), cb)
    finally:
        attention.USE_INT8_KV = False
        jax.clear_caches()


def phase_four():
    """TP generators (GPT-2-small, 12 heads over 4 cards), each checked like
    the one-card generations against the single-device fp32 forward; token
    agreement with the single-device bf16 generator is reported too (bf16
    psums sum in another order, so near-ties may flip)."""
    import jax

    from pytorch_models_tpu.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu.parallel import make_mesh
    from pytorch_models_tpu.parallel.cb_serving import TPContinuousBatchingGenerator
    from pytorch_models_tpu.parallel.serving import TPDecoderGenerator

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    m32, m16 = GPT2(12, 768), GPT2(12, 768).to_bf16()
    r = np.random.default_rng(6)
    prompts = r.integers(0, 50257, (32, GPT2_PROMPT_LEN)).tolist()
    reqs = [r.integers(0, 50257, n).tolist() for n in (5, 40, 17, 64, 9, 33, 1, 22)]
    budgets = [24, 8, 40, 16, 31, 12, 20, 28]
    single = DecoderGenerator(m16, _Tok()).generate_tokens_batch(prompts, max_tokens=GPT2_NEW)

    gen = TPDecoderGenerator(m16, _Tok(), make_mesh(4, shape=(1, 4), axes=("dp", "tp")))
    outs, first, steady = _timed(lambda: gen.generate_tokens_batch(prompts, max_tokens=GPT2_NEW))
    margin, n_off = _lm_margin(m32, outs, [GPT2_PROMPT_LEN] * 32)
    report("tp4_gpt2_batch32_bf16", margin, GEN_TOL_BF16, first, steady,
           tok_per_s=round(32 * GPT2_NEW / (steady / 1e3), 1), off_argmax=n_off,
           rows_equal_single_device=sum(a == b for a, b in zip(outs, single)))

    cb = TPContinuousBatchingGenerator(m16, _Tok(), make_mesh(4, shape=(4,), axes=("tp",)),
                                       batch_size=4, check_every=8)
    outs, first, steady = _timed(lambda: cb.generate_tokens_many(reqs, budgets), reps=1)
    assert [len(o) for o in outs] == [len(q) + m for q, m in zip(reqs, budgets)]
    margin, n_off = _lm_margin(m32, outs, [len(q) for q in reqs])
    report("tp4_gpt2_continuous_bf16", margin, GEN_TOL_BF16, first, steady, off_argmax=n_off)
    for d in devs[:4]:
        print(f"card {d.id} ({d.device_kind}): peak_bytes_in_use={_peak_bytes(d)}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card tensor-parallel path")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); nothing to check",
              file=sys.stderr)
        return 1

    from pytorch_models_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache(Path(__file__).resolve().parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {dev.device_kind} x{len(jax.devices())}, jax {jax.__version__}, "
          f"compile cache {cache}", flush=True)
    print(smi.splitlines()[0], flush=True)

    if args.four:
        phase_four()
        count = 4
    else:
        for phase in (phase_vit, phase_gpt2, phase_whisper, phase_t5, phase_kernel_parity,
                      phase_opt_in_modes):
            phase()
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
