"""Model-class conveniences for drop-in compatibility with the reference API."""


class InferenceModel:
    """Mixin giving the torch-style no-op mode switches (models here are
    always inference-mode pure functions) plus serving-dtype casts."""

    def eval(self):
        return self

    def train(self, mode: bool = True):
        raise NotImplementedError("training is not supported (matches the reference, README.md:9)")

    def to_bf16(self):
        """Cast floating params to bfloat16 — the serving fast path."""
        import jax.numpy as jnp

        from .params import cast_tree

        self.params = cast_tree(self.params, jnp.bfloat16)
        return self

    def to_fp32(self):
        import jax.numpy as jnp

        from .params import cast_tree

        self.params = cast_tree(self.params, jnp.float32)
        return self

    def save(self, path: str):
        """Persist the converted param pytree as an orbax checkpoint."""
        from .serialization import save_params

        save_params(path, self.params)
        return self

    def load(self, path: str):
        from .serialization import load_params

        self.params = load_params(path)
        return self

    def quantize_int8(self):
        """Weight-only int8 serving mode (linear kernels; ~0.3% weight error).

        Halves weight HBM traffic — targets decode, which is weight-bandwidth
        bound. Embeddings/norms/convs stay in their current dtype."""
        from .params import quantize_tree_int8

        self.params = quantize_tree_int8(self.params)
        return self
