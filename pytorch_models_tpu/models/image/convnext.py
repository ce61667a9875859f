"""ConvNeXt (reference pytorch_models/image/convnext.py).

Stem Conv(4,4)+LN → 4 stages of [downsample LN+Conv(2,2) for stages>0, then
blocks: depthwise 7×7 conv → LN → Linear×4 → GELU → Linear, layer-scale γ]
→ GAP → LN (ref convnext.py:17-66). The reference fights NCHW with ``Permute``
modules (convnext.py:8-14); here everything is NHWC end-to-end, XLA's
native conv layout. Per-stage blocks run as one ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm, linear
from ...ops.layers import conv2d, conv2d_init
from ...utils import StateDict, hub_download, stack_layers
from pytorch_models_tpu.utils.module import InferenceModel

NORM_EPS = 1e-6
EXPANSION = 4  # ref convnext.py:18

# ref convnext.py:70-81
VARIANTS = dict(
    atto=(40, (2, 2, 6, 2)),
    femto=(48, (2, 2, 6, 2)),
    pico=(64, (2, 2, 6, 2)),
    nano=(80, (2, 2, 8, 2)),
    tiny=(96, (3, 3, 9, 3)),
    small=(96, (3, 3, 27, 3)),
    base=(128, (3, 3, 27, 3)),
    large=(192, (3, 3, 27, 3)),
    xlarge=(256, (3, 3, 27, 3)),
    huge=(352, (3, 3, 27, 3)),
)


@dataclass(frozen=True)
class ConvNeXtConfig:
    d_model: int
    depths: tuple[int, ...]


def _block_init(key, d: int) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "dwconv": conv2d_init(k1, 7, 7, d, d, groups=d),
        "norm": tfm.ln_init(d),
        "pwconv1": tfm.linear_init(k2, d, d * EXPANSION),
        "pwconv2": tfm.linear_init(k3, d * EXPANSION, d),
        "gamma": jnp.full((d,), 1e-6, jnp.float32),
    }


def convnext_init(key, cfg: ConvNeXtConfig) -> dict:
    d = cfg.d_model
    keys = jax.random.split(key, sum(cfg.depths) + len(cfg.depths) + 1)
    ki = iter(keys)
    p: dict = {"stem": {"conv": conv2d_init(next(ki), 4, 4, 3, d), "norm": tfm.ln_init(d)}}
    stages = []
    for stage_idx, depth in enumerate(cfg.depths):
        stage: dict = {}
        if stage_idx > 0:
            stage["downsample"] = {"norm": tfm.ln_init(d), "conv": conv2d_init(next(ki), 2, 2, d, d * 2)}
            d *= 2
        stage["blocks"] = stack_layers([_block_init(next(ki), d) for _ in range(depth)])
        stages.append(stage)
    p["stages"] = stages
    p["norm"] = tfm.ln_init(d)
    return p


def _block(p: dict, x: jnp.ndarray) -> jnp.ndarray:
    """ConvNeXt block with layer-scale γ residual (ref convnext.py:33-34)."""
    h = conv2d(p["dwconv"], x, padding=3, groups=x.shape[-1])
    h = layer_norm(p["norm"], h, NORM_EPS)
    h = linear(p["pwconv2"], ACT_FNS["gelu"](linear(p["pwconv1"], h)))
    return x + h * p["gamma"].astype(x.dtype)


@partial(jax.jit, static_argnums=1)
def convnext_apply(params: dict, cfg: ConvNeXtConfig, imgs: jnp.ndarray) -> jnp.ndarray:
    x = jnp.transpose(imgs, (0, 2, 3, 1))
    x = conv2d(params["stem"]["conv"], x, stride=4)
    x = layer_norm(params["stem"]["norm"], x, NORM_EPS)
    for stage in params["stages"]:
        if "downsample" in stage:
            x = layer_norm(stage["downsample"]["norm"], x, NORM_EPS)
            x = conv2d(stage["downsample"]["conv"], x, stride=2)

        def body(h, bp):
            return _block(bp, h), None

        x, _ = jax.lax.scan(body, x, stage["blocks"])
    x = x.mean(axis=(1, 2))  # GAP (ref convnext.py:65)
    return layer_norm(params["norm"], x, NORM_EPS)


class ConvNeXt(InferenceModel):
    def __init__(self, d_model: int, depths: tuple[int, ...], norm_eps: float = 1e-6, v2: bool = False, rng: int = 0):
        assert not v2, "ConvNeXt-V2 GRN is not supported (matches reference behavior)"
        self.cfg = ConvNeXtConfig(d_model, tuple(depths))
        self.params = convnext_init(jax.random.PRNGKey(rng), self.cfg)

    def __call__(self, imgs) -> jnp.ndarray:
        return convnext_apply(self.params, self.cfg, jnp.asarray(imgs))

    @staticmethod
    def from_facebook(variant: str, *, pretrained: bool = False) -> "ConvNeXt":
        d_model, depths = VARIANTS[variant]
        m = ConvNeXt(d_model, depths)
        if pretrained:
            from ...utils.torch_ckpt import load_torch_checkpoint

            url = f"https://dl.fbaipublicfiles.com/convnext/convnext_{variant}_22k_224.pth"
            m.load_facebook_state_dict(load_torch_checkpoint(hub_download(url))["model"])
        return m

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """Key map per reference convnext.py:91-117 (downsample_layers.N / stages.N.M)."""
        sd = StateDict(state_dict)
        p: dict = {
            "stem": {"conv": sd.pop_conv2d("downsample_layers.0.0"), "norm": sd.pop_ln("downsample_layers.0.1")}
        }
        stages = []
        for stage_idx, depth in enumerate(self.cfg.depths):
            stage: dict = {}
            if stage_idx > 0:
                stage["downsample"] = {
                    "norm": sd.pop_ln(f"downsample_layers.{stage_idx}.0"),
                    "conv": sd.pop_conv2d(f"downsample_layers.{stage_idx}.1"),
                }
            blocks = []
            for b in range(depth):
                pfx = f"stages.{stage_idx}.{b}"
                blocks.append(
                    {
                        "dwconv": sd.pop_conv2d(f"{pfx}.dwconv"),
                        "norm": sd.pop_ln(f"{pfx}.norm"),
                        "pwconv1": sd.pop_linear(f"{pfx}.pwconv1"),
                        "pwconv2": sd.pop_linear(f"{pfx}.pwconv2"),
                        "gamma": sd.pop(f"{pfx}.gamma"),
                    }
                )
            stage["blocks"] = stack_layers([jax.tree.map(jnp.asarray, b) for b in blocks])
            stages.append(stage)
        p["stages"] = stages
        p["norm"] = sd.pop_ln("norm")
        # pretrained checkpoints ship a classifier head this model doesn't include
        sd.pop("head.weight", None)
        sd.pop("head.bias", None)
        sd.finalize()
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), p)
