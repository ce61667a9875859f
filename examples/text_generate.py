"""GPT-2 text generation: greedy, nucleus sampling, batching, best-of-n
parallel sampling, beam search, speculative decoding, and scoring.

With --pretrained this uses the real GPT-2 weights + the native BPE
tokenizer and prints text; otherwise random weights + a toy tokenizer show
the API shape without network access.
"""

import sys

sys.path.insert(0, ".")
from examples._common import setup  # noqa: E402

args = setup(__doc__)

from pytorch_models_tpu.text import (  # noqa: E402
    GPT2,
    DecoderGenerator,
    SpeculativeDecoderGenerator,
)

if args.pretrained:
    from pytorch_models_tpu.models.text.tokenizer import GPT2Tokenizer

    model = GPT2.from_hf("gpt2", pretrained=True).to_bf16()
    tok = GPT2Tokenizer.from_hf()
else:
    class tok:  # toy tokenizer: bytes in, token ids out
        eos_token_id = None
        encode = staticmethod(lambda s: [b % 200 for b in s.encode()])
        decode = staticmethod(lambda ids: " ".join(map(str, ids)))

    model = GPT2(n_layers=4, d_model=256)

gen = DecoderGenerator(model, tok)
prompt = "The Pallas kernel"

print("greedy:      ", gen.generate(prompt, max_tokens=24))
print("nucleus:     ", gen.generate(prompt, max_tokens=24, topk=50, top_p=0.9,
                                    temperature=0.8, seed=1))
print("batched:     ", gen.generate_batch([prompt, "GPUs are"], max_tokens=16))
# best-of-n: ONE prefill, KV cache fanned out to n sample rows
print("best-of-3:   ", gen.generate_samples(prompt, n=3, max_tokens=16,
                                            topk=40, seed=2))
print("beam (w=4):  ", gen.beam_search(prompt, max_tokens=24, beam_width=4))

# speculative decoding: a small draft proposes k tokens, the target verifies
# them in one chunked forward — token-identical to plain greedy for ANY draft
draft = GPT2(n_layers=2, d_model=256) if not args.pretrained else \
    GPT2.from_hf("gpt2", pretrained=True).to_bf16()  # stand-in draft
spec = SpeculativeDecoderGenerator(model, draft, tok, k=4)
print("speculative: ", spec.generate(prompt, max_tokens=24))

print("perplexity:  ", gen.perplexity(prompt))
