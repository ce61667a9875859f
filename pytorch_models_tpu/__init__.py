"""pytorch_models_tpu — JAX re-implementation of gau-nernst/pytorch-models for NVIDIA GPUs.

A functional, pytree-first inference library: every model is a frozen-dataclass
config + `init(rng, cfg) -> params` + jitted `apply(params, cfg, x) -> y`, wrapped
in a thin class that keeps the reference's public API surface
(`ViT.from_google("B/16_augreg", pretrained=True)`, `model(x)`, …).

Design (see SURVEY.md §7):
- layer stacks are `lax.scan` over stacked per-layer params (one compiled body),
- attention is an XLA einsum path, plus a Pallas-Triton decode kernel for
  single-position self-attention over long KV caches on the GPU,
- convolutions run NHWC/NLC via `lax.conv_general_dilated`,
- autoregressive decode is a fixed-shape jitted step over a preallocated KV cache
  (the reference re-forwards the whole prefix per token, text/generator.py:23-24).
"""

__version__ = "0.1.0"
