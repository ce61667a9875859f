"""Speculative-decoding speed bracket on the GPU (B=1 GPT-2-small).

Random weights give a meaningless acceptance rate, so this measures the two
ends of the bracket that pure mechanics determine:
  plain    — production single-stream greedy (batch of 1)
  spec a=1 — draft == target: every chunk accepts all k drafts (upper bound)
  spec a~0 — 2-layer random draft: ~every chunk accepts 0 (overhead floor)
Real-model throughput lands between the ends by acceptance rate:
tok/s(a) ~ (1 + a*k) / t_iter.

Run: python tools/spec_bench.py [k] [new_tokens]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from pytorch_models_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(".")


def timeit(name, fn, args, n_tok, reps=4):
    out = fn(*args)
    np.asarray(jax.tree.leaves(out)[0])
    t0 = time.perf_counter()
    out = [fn(*args) for _ in range(reps)][-1]
    np.asarray(jax.tree.leaves(out)[0])
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:10s} {dt*1e3:7.1f} ms  ->  {n_tok/dt:8,.0f} tok/s", flush=True)
    return dt


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    new_tokens = int(sys.argv[2]) if len(sys.argv) > 2 else 128

    from pytorch_models_tpu.models.text import GPT2
    from pytorch_models_tpu.models.text.generator import _generate_batch
    from pytorch_models_tpu.models.text.speculative import (
        _speculative_generate,
        _speculative_generate_stats,
        truncate_decoder_lm,
    )

    target = GPT2(12, 768).to_bf16()
    draft = GPT2(2, 768).to_bf16()
    cfg = target.cfg

    prompt = [1] * 8
    n = len(prompt)
    pad = 64
    prompt_buf = np.zeros((pad,), np.int32)
    prompt_buf[:n] = prompt
    limit = n + new_tokens
    print(f"gpt2-small B=1, k={k}, {new_tokens} new tokens", flush=True)

    # plain: production batch of 1
    bbuf = jnp.asarray(prompt_buf[None])
    pads = jnp.asarray([pad - n], jnp.int32)
    key = jax.random.PRNGKey(0)
    plain_args = (target.params, cfg, bbuf, pads, pad + new_tokens, 1, -1, key)
    t_plain = timeit("plain", _generate_batch, plain_args, new_tokens)

    pb = jnp.asarray(prompt_buf)
    for name, dm in (("spec a=1", target), ("spec a~0", draft)):
        args = (target.params, cfg, dm.params, dm.cfg, pb, n, limit, k, -1)
        timeit(name, _speculative_generate, args, new_tokens)

    # ---- REAL operating points: honest drafts built from the target's own
    # stack (truncate_decoder_lm). Acceptance is MEASURED from the loop's
    # iteration count; token identity vs plain greedy is asserted.
    plain_toks = np.asarray(_generate_batch(*plain_args)[0])[0]
    for n_draft in (2, 4, 6):
        dp, dc = truncate_decoder_lm(target.params, cfg, n_draft)
        args = (target.params, cfg, dp, dc, pb, n, limit, k, -1)
        buf, length, n_iters = _speculative_generate_stats(*args)
        buf, length, n_iters = np.asarray(buf), int(length), int(n_iters)
        emitted = length - (n + 1)  # tokens the LOOP produced (pos0 = n+1)
        a = (emitted / max(n_iters, 1) - 1) / k
        assert (buf[:length] == plain_toks[:length]).all(), \
            f"truncated-{n_draft} spec output diverged from plain greedy"
        dt = timeit(f"trunc-{n_draft}", _speculative_generate_stats, args, new_tokens)
        print(f"           acceptance {a:.2f} ({n_iters} iters for {emitted} tok)"
              f"  speedup vs plain {t_plain/dt:.2f}x", flush=True)


if __name__ == "__main__":
    main()
