"""End-to-end A/B of the Triton decode kernel against the masked einsum path.

Usage (on a GPU host): python tools/decode_ab.py [rounds] [gpt2|whisper ...]

Runs, in one process on one card, GPT-2-small batched greedy decode (batch
32, 32-token prompts, 512 new tokens — bench.py's shape) and Whisper-base
batch-16 transcription (64 tokens), each with decode attention as shipped
(the kernel over GPT-2's 1024-slot cache) against the einsum path
(``attn_impl="xla"``), alternating shipped, einsum, einsum, shipped per
round. Whisper's 128-slot self caches fall below
``ops.attention.MIN_KERNEL_CACHE``, so Whisper also runs with that limit
lifted ("kernel-forced") to show what the kernel would do there. Prints
every run's tokens/sec or real-time factor, then the medians, with the
card's name and power limit.
"""

import subprocess
import sys
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from pytorch_models_tpu.models.audio2text.whisper import Whisper, WhisperGenerator
from pytorch_models_tpu.models.text import GPT2
from pytorch_models_tpu.models.text.generator import _generate_batch
from pytorch_models_tpu.ops import attention


def gpt2_runner(impl):
    """A run() closure over an ahead-of-time compiled generation program, so
    later layout changes and cache clears cannot retrace it."""
    model = GPT2(12, 768).to_bf16()
    cfg = replace(model.cfg, attn_impl=impl)
    batch, prompt_len, new = 32, 32, 512
    buf = jnp.ones((batch, prompt_len), jnp.int32)
    pad = jnp.zeros((batch,), jnp.int32)
    fn = jax.jit(lambda p, b, pl_, k: _generate_batch(p, cfg, b, pl_, prompt_len + new, 1, -1, k))
    args = (model.params, buf, pad, jax.random.PRNGKey(0))
    compiled = fn.lower(*args).compile()
    jax.block_until_ready(compiled(*args))

    def run():
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        return batch * new / (time.perf_counter() - t0)
    return run


def whisper_runner(impl):
    model = Whisper.from_openai("base").to_bf16()
    model.cfg = replace(model.cfg, attn_impl=impl)
    gen = WhisperGenerator(model)
    audios = jnp.asarray(np.random.default_rng(0).standard_normal((16, 30 * 16_000)) * 0.1,
                         jnp.float32)
    init = jnp.asarray([50258, 50259, 50359, 50363], jnp.int32)
    fn = jax.jit(lambda p, a, i: gen._transcribe_full_batch(p, a, 4 + 64, i, -1))
    args = (model.params, audios, init)
    compiled = fn.lower(*args).compile()
    jax.block_until_ready(compiled(*args))

    def run():
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        return 16 * 30.0 / (time.perf_counter() - t0)
    return run


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    models = sys.argv[2:] or ["gpt2", "whisper"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device {jax.devices()[0].device_kind} | {smi}", flush=True)
    for name, make, unit, force in (("gpt2_b32_decode", gpt2_runner, "tok/s", False),
                                    ("whisper_b16", whisper_runner, "x realtime", True)):
        if name.split("_")[0] not in models:
            continue
        runners = {"einsum": make("xla"), "shipped": make("auto")}
        if force:
            limit, attention.MIN_KERNEL_CACHE = attention.MIN_KERNEL_CACHE, 0
            try:
                runners["kernel-forced"] = make("auto")
            finally:
                attention.MIN_KERNEL_CACHE = limit
        res = {k: [] for k in runners}
        for _ in range(rounds):
            for k in runners:
                if k != "einsum":
                    for impl in (k, "einsum", "einsum", k):
                        res[impl].append(runners[impl]())
        for impl, vals in res.items():
            print(f"{name} {impl}: median {np.median(vals):.1f} {unit} "
                  f"[{' '.join(f'{v:.1f}' for v in vals)}]", flush=True)


if __name__ == "__main__":
    main()
