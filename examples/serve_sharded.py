"""The sharded serving matrix on an 8-virtual-device CPU mesh.

Run with:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 EXAMPLES_CPU=1 \
        python examples/serve_sharded.py

Every generator here produces output token-identical to the single-device
DecoderGenerator — sharding is an execution detail, never a numerics change.
On a multi-GPU host the same code runs over a mesh of the cards.
"""

import sys

sys.path.insert(0, ".")
from examples._common import setup  # noqa: E402

setup(__doc__)

import jax  # noqa: E402

assert len(jax.devices()) >= 8, (
    "run with XLA_FLAGS=--xla_force_host_platform_device_count=8 EXAMPLES_CPU=1")

from pytorch_models_tpu.models.text import GPT2, DecoderGenerator  # noqa: E402
from pytorch_models_tpu.parallel import (  # noqa: E402
    PPDecoderGenerator,
    TPContinuousBatchingGenerator,
    TPDecoderGenerator,
    TPPPDecoderGenerator,
    TPSpeculativeGenerator,
    make_mesh,
)


class Tok:
    eos_token_id = None


GPT2.vocab_size, GPT2.max_seq_len = 512, 256
model = GPT2(n_layers=4, d_model=256)  # 4 heads
draft = GPT2(n_layers=2, d_model=256, rng=7)
prompts = [[5, 6, 7], [9] * 12, [11, 12], [3] * 7]

ref = DecoderGenerator(model, Tok()).generate_tokens_batch(prompts, max_tokens=8)
print("single-device reference lens:", [len(r) for r in ref])

tp = TPDecoderGenerator(model, Tok(), make_mesh(8, (2, 4), ("dp", "tp")))
assert tp.generate_tokens_batch(prompts, max_tokens=8) == ref
print("dp x tp (2x4):        token-identical")

pp = PPDecoderGenerator(model, Tok(), make_mesh(4, (4,), ("pp",)))
assert pp.generate_tokens_batch(prompts, max_tokens=8) == ref
print("pp (4 stages):        token-identical")

tppp = TPPPDecoderGenerator(model, Tok(), make_mesh(8, (2, 2, 2), ("dp", "pp", "tp")))
assert tppp.generate_tokens_batch(prompts, max_tokens=8) == ref
print("dp x pp x tp (2x2x2): token-identical")

spec = TPSpeculativeGenerator(model, draft, Tok(), make_mesh(4, (4,), ("tp",)), k=4)
assert spec.generate_tokens(prompts[0], max_tokens=8) == ref[0]
print("tp speculative:       token-identical")

cb = TPContinuousBatchingGenerator(model, Tok(), make_mesh(4, (4,), ("tp",)),
                                   batch_size=2, prompt_bucket=16, check_every=4)
assert cb.generate_tokens_many(prompts, 8) == [
    DecoderGenerator(model, Tok()).generate_tokens(p, max_tokens=8) for p in prompts]
print("tp continuous batch:  token-identical per request")

# prefix caching: the system prompt is forwarded once, its KV pasted per slot
sys_prompt = [2, 7, 1, 8]
assert cb.generate_tokens_many(prompts, 8, shared_prefix=sys_prompt) == [
    DecoderGenerator(model, Tok()).generate_tokens(sys_prompt + p, max_tokens=8)
    for p in prompts]
print("tp prefix caching:    token-identical per request")

# schedule-invariant sampling: request r's stream depends only on (seed, r)
samp = cb.generate_tokens_many(prompts, 8, topk=4, temperature=0.9, seed=1)
solo = TPContinuousBatchingGenerator(model, Tok(), make_mesh(4, (4,), ("tp",)),
                                     batch_size=1, prompt_bucket=16, check_every=1)
assert samp == solo.generate_tokens_many(prompts, 8, topk=4, temperature=0.9, seed=1)
print("tp sampled serving:   schedule-invariant streams")
