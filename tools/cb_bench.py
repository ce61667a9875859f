"""Continuous vs static batching on the GPU (GPT-2-small, bf16).

Workload: requests with mixed generation budgets. Static batching decodes
cohorts of B and waits for each cohort's longest row; continuous batching
admits the next request the moment a slot frees (modulo check_every).
The win is the parked-slot area: sum(max_b - b_i) over each static cohort.

Besides wall clock, prints the DECOMPOSITION the ledger needs: device work
(slot-steps), useful-token occupancy (ServingStats), host interactions
(scheduling points + admissions), so the host's per-interaction cost can be
separated from the scheduling win.

Run: python tools/cb_bench.py [pool_B] [n_requests]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from pytorch_models_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(".")


class _Tok:
    eos_token_id = -1  # random weights: run to budget (worst case for CB)

    def encode(self, s):
        return [1] * 8

    def decode(self, ids):
        return " ".join(map(str, ids))


def main():
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n_req = int(sys.argv[2]) if len(sys.argv) > 2 else 32

    from pytorch_models_tpu.models.text import ContinuousBatchingGenerator, DecoderGenerator, GPT2

    model = GPT2(12, 768).to_bf16()
    tok = _Tok()
    r = np.random.default_rng(0)
    prompts = [[int(x) for x in r.integers(0, 50_000, (8,))] for _ in range(n_req)]
    budgets = [int(x) for x in r.integers(32, 257, (n_req,))]
    total_gen = sum(budgets)
    # static slot-step accounting: each cohort of B runs to its max budget
    static_steps = sum(max(budgets[i: i + b]) for i in range(0, n_req, b))
    static_slot_steps = static_steps * b
    print(f"gpt2-small bf16, pool B={b}, {n_req} requests, budgets 32-256 "
          f"(sum {total_gen}); static slot-steps {static_slot_steps} "
          f"({total_gen / static_slot_steps:.0%} useful)", flush=True)

    # --- static: cohorts of B, per-cohort budget = max over the cohort
    static_gen = DecoderGenerator(model, tok)

    def run_static():
        outs = []
        for i in range(0, n_req, b):
            sl = slice(i, i + b)
            outs += static_gen.generate_tokens_batch(prompts[sl], max(budgets[sl]))
        return outs

    def timed(name, fn, extra=""):
        fn()  # compile
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        print(f"{name:14s} {dt:6.2f} s  ->  {total_gen/dt:8,.0f} useful tok/s{extra()}",
              flush=True)
        return dt

    timed("static", run_static, lambda: "")

    # --- continuous, check_every sweep (scheduling granularity vs host
    # interaction count; each engine reuses the same compiled programs)
    for ce in (16, 32, 64, 128):
        cb = ContinuousBatchingGenerator(model, tok, batch_size=b,
                                         prompt_bucket=64, check_every=ce)

        def run_cb():
            return cb.generate_tokens_many(prompts, budgets)

        def stats():
            s = cb.last_stats
            return (f"   [ce={ce}: occ {s.occupancy:.0%}, slot-steps {s.slot_steps}, "
                    f"{s.scheduling_points} syncs, {s.admissions} admits, "
                    f"{s.epoch_resets} resets]")

        timed(f"continuous/{ce}", run_cb, stats)


if __name__ == "__main__":
    main()
