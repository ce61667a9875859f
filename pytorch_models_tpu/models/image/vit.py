"""ViT — Vision Transformer (AugReg / SigLIP / DeiT-3 / DINO / DINOv2 weights).

JAX re-implementation with the capabilities of the reference
``pytorch_models/image/vit.py`` (class at vit.py:48, poolers at vit.py:20-43,
loaders at vit.py:96-306): patch-embed conv (NHWC) → +learned PE →
optional cls token → pre-norm Encoder (lax.scan) → LayerNorm → pooler.

Public API mirrors the reference: ``ViT.from_google("B/16_augreg",
pretrained=True)``, ``model(imgs)`` with NCHW images, ``resize_pe(size)``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ... import transformer as tfm
from ...ops import layer_norm, linear
from ...ops.layers import conv2d, conv2d_init
from ...utils import StateDict, hub_download, stack_layers
from ...utils.params import to_np
from pytorch_models_tpu.utils.module import InferenceModel

NORM_EPS = 1e-6  # ref vit.py:49

# tag -> (n_layers, d_model, n_heads); ref vit.py:106-113
SIZES = dict(
    Ti=(12, 192, 3),
    S=(12, 384, 6),
    M=(12, 512, 8),
    B=(12, 768, 12),
    L=(24, 1024, 16),
    H=(32, 1280, 16),
)


@dataclass(frozen=True)
class ViTConfig:
    n_layers: int
    d_model: int
    n_heads: int
    patch_size: int
    img_size: int = 224
    cls_token: bool = True
    pool_type: str = "cls_token"

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.n_heads, norm_eps=NORM_EPS)


def vit_init(key, cfg: ViTConfig) -> dict:
    assert cfg.img_size % cfg.patch_size == 0
    ks = jax.random.split(key, 4)
    n_patches = (cfg.img_size // cfg.patch_size) ** 2
    p = {
        "patch_embed": conv2d_init(ks[0], cfg.patch_size, cfg.patch_size, 3, cfg.d_model),
        "pe": jnp.zeros((1, n_patches, cfg.d_model), jnp.float32),
        "encoder": tfm.encoder_init(ks[1], cfg.n_layers, cfg.layer),
        "norm": tfm.ln_init(cfg.d_model),
    }
    if cfg.cls_token:
        p["cls_token"] = jnp.zeros((1, 1, cfg.d_model), jnp.float32)
    if cfg.pool_type == "mha":
        pool_cfg = cfg.layer
        p["pooler"] = {
            "probe": jnp.zeros((1, 1, cfg.d_model), jnp.float32),
            "attn": tfm.mha_init(ks[2], pool_cfg),
            "norm": tfm.ln_init(cfg.d_model),
            "mlp": tfm.mlp_init(ks[3], cfg.d_model, cfg.d_model * 4),
        }
    return p


def _pool(p: dict, cfg: ViTConfig, x: jnp.ndarray) -> jnp.ndarray:
    """Poolers: cls_token / gap / mha probe (ref vit.py:20-43)."""
    if cfg.pool_type == "cls_token":
        return x[:, 0]
    if cfg.pool_type == "gap":
        return x.mean(axis=1)
    pp = p["pooler"]
    probe = jnp.broadcast_to(pp["probe"].astype(x.dtype), (x.shape[0], 1, cfg.d_model))
    out = tfm.mha_apply(pp["attn"], cfg.layer, probe, x)[:, 0]
    return out + tfm.mlp_apply(pp["mlp"], layer_norm(pp["norm"], out, NORM_EPS))


@partial(jax.jit, static_argnums=1)
def vit_apply(params: dict, cfg: ViTConfig, imgs: jnp.ndarray) -> jnp.ndarray:
    """Forward (ref vit.py:77-85). ``imgs``: (N, 3, H, W) like the reference."""
    x = jnp.transpose(imgs, (0, 2, 3, 1))  # NCHW -> NHWC (channels-last conv layout)
    x = conv2d(params["patch_embed"], x, stride=cfg.patch_size)
    x = x.reshape(x.shape[0], -1, cfg.d_model)  # (N, H*W, C), row-major like torch flatten
    x = x + params["pe"].astype(x.dtype)
    if "cls_token" in params:
        cls = jnp.broadcast_to(params["cls_token"].astype(x.dtype), (x.shape[0], 1, cfg.d_model))
        x = jnp.concatenate([cls, x], axis=1)
    x = tfm.encoder_apply(params["encoder"], cfg.layer, x)
    x = layer_norm(params["norm"], x, NORM_EPS)
    return _pool(params, cfg, x)


class ViT(InferenceModel):
    """Thin stateful wrapper keeping the reference's public surface (vit.py:48-94)."""

    def __init__(
        self,
        n_layers: int,
        d_model: int,
        n_heads: int,
        patch_size: int,
        img_size: int = 224,
        cls_token: bool = True,
        pool_type: str = "cls_token",
        dropout: float = 0.0,  # accepted for API parity; inference-only
        rng: int = 0,
    ) -> None:
        self.cfg = ViTConfig(n_layers, d_model, n_heads, patch_size, img_size, cls_token, pool_type)
        self.params = vit_init(jax.random.PRNGKey(rng), self.cfg)

    def __call__(self, imgs) -> jnp.ndarray:
        return vit_apply(self.params, self.cfg, jnp.asarray(imgs))

    def resize_pe(self, size: int, interpolation_mode: str = "bicubic") -> None:
        """Bicubic-resample the learned PE grid for a new input size (ref vit.py:87-94)."""
        pe = self.params["pe"]
        old = int(round(pe.shape[1] ** 0.5))
        new = size // self.cfg.patch_size
        grid = pe.reshape(1, old, old, self.cfg.d_model)
        grid = jax.image.resize(grid, (1, new, new, self.cfg.d_model), method=interpolation_mode)
        self.params["pe"] = grid.reshape(1, new * new, self.cfg.d_model)
        self.cfg = replace(self.cfg, img_size=new * self.cfg.patch_size)

    # ------------------------------------------------------------------
    # Google checkpoints: AugReg + SigLIP Flax .npz (ref vit.py:96-200)
    # ------------------------------------------------------------------

    @staticmethod
    def from_google(model_tag: str, *, pretrained: bool = False, **kwargs) -> "ViT":
        model_tag, _, weights = model_tag.partition("_")
        weights = weights or "augreg"
        size, patch_size = model_tag.split("/")
        n_layers, d_model, n_heads = SIZES[size]

        _kwargs = dict()
        if weights == "siglip":
            _kwargs.update(cls_token=False, pool_type="mha")
        m = ViT(n_layers, d_model, n_heads, int(patch_size), **_kwargs, **kwargs)

        if pretrained:
            if weights == "augreg":
                ckpt = {
                    "Ti/16": "Ti_16-i21k-300ep-lr_0.001-aug_none-wd_0.03-do_0.0-sd_0.0.npz",
                    "S/32": "S_32-i21k-300ep-lr_0.001-aug_none-wd_0.1-do_0.0-sd_0.0.npz",
                    "S/16": "S_16-i21k-300ep-lr_0.001-aug_light1-wd_0.03-do_0.0-sd_0.0.npz",
                    "B/32": "B_32-i21k-300ep-lr_0.001-aug_light1-wd_0.1-do_0.0-sd_0.0.npz",
                    "B/16": "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0.npz",
                    "L/16": "L_16-i21k-300ep-lr_0.001-aug_strong1-wd_0.1-do_0.0-sd_0.0.npz",
                }[model_tag]
                path = hub_download(f"https://storage.googleapis.com/vit_models/augreg/{ckpt}")
                m.load_flax_ckpt(dict(np.load(path)))
            elif weights == "siglip":
                img_size = kwargs.get("img_size", 224)
                ckpt = {
                    ("B/16", 224): "webli_en_b16_224_63724782.npz",
                    ("B/16", 256): "webli_en_b16_256_60500360.npz",
                    ("B/16", 384): "webli_en_b16_384_68578854.npz",
                    ("B/16", 512): "webli_en_b16_512_68580893.npz",
                    ("L/16", 256): "webli_en_l16_256_60552751.npz",
                    ("L/16", 384): "webli_en_l16_384_63634585.npz",
                }[(model_tag, img_size)]
                path = hub_download(f"https://storage.googleapis.com/big_vision/siglip/{ckpt}")
                m.load_flax_ckpt(dict(np.load(path)), big_vision=True, prefix="params/img/")
            else:
                raise ValueError(f"Unsupported weights={weights}")
        return m

    def load_flax_ckpt(self, ckpt: dict, *, big_vision: bool = False, prefix: str = "") -> None:
        """Convert a Flax .npz param dict into our pytree (ref vit.py:151-200).

        big_vision checkpoints use different intra-block module names and no
        cls-token slot in the position embedding (ref vit.py:152-167,174-179).
        """
        if big_vision:
            mha_norm, mha, mlp_norm, mlp = "LayerNorm_0", "MultiHeadDotProductAttention_0", "LayerNorm_1", "MlpBlock_0"
        else:
            mha_norm, mha, mlp_norm, mlp = "LayerNorm_0", "MultiHeadDotProductAttention_1", "LayerNorm_2", "MlpBlock_3"

        sd = StateDict({k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)})
        cfg, d = self.cfg, self.cfg.d_model
        p: dict = {}

        def flax_linear(pfx: str) -> dict:
            w = sd.pop(f"{pfx}/kernel")  # qkv kernels are (d, H, hd) -> (d, H*hd)
            return {"w": w.reshape(w.shape[0], -1) if w.ndim > 2 else w, "b": sd.pop(f"{pfx}/bias").reshape(-1)}

        def flax_out_linear(pfx: str) -> dict:  # (H, hd, d) -> (H*hd, d)
            return {"w": sd.pop(f"{pfx}/kernel").reshape(-1, d), "b": sd.pop(f"{pfx}/bias").reshape(-1)}

        def flax_ln(pfx: str) -> dict:
            return {"scale": sd.pop(f"{pfx}/scale"), "bias": sd.pop(f"{pfx}/bias")}

        def flax_mha(pfx: str) -> dict:
            return {
                "q": flax_linear(f"{pfx}/query"),
                "k": flax_linear(f"{pfx}/key"),
                "v": flax_linear(f"{pfx}/value"),
                "o": flax_out_linear(f"{pfx}/out"),
            }

        if cfg.cls_token:
            cls = sd.pop("cls").astype(np.float32)
        if big_vision:
            p["pe"] = sd.pop("pos_embedding")
        else:
            pe = sd.pop("Transformer/posembed_input/pos_embedding")
            cls = cls + pe[:, 0]  # fold the PE cls slot into the token (ref vit.py:178)
            p["pe"] = pe[:, 1:]
        if cfg.cls_token:
            p["cls_token"] = cls
        p["patch_embed"] = {"w": sd.pop("embedding/kernel"), "b": sd.pop("embedding/bias")}
        p["norm"] = flax_ln("Transformer/encoder_norm")

        layers = []
        for i in range(cfg.n_layers):
            blk = f"Transformer/encoderblock_{i}"
            layers.append(
                {
                    "sa_norm": flax_ln(f"{blk}/{mha_norm}"),
                    "sa": flax_mha(f"{blk}/{mha}"),
                    "mlp_norm": flax_ln(f"{blk}/{mlp_norm}"),
                    "mlp": {"fc1": flax_linear(f"{blk}/{mlp}/Dense_0"), "fc2": flax_linear(f"{blk}/{mlp}/Dense_1")},
                }
            )
        p["encoder"] = {"layers": stack_layers([jax.tree.map(jnp.asarray, l) for l in layers])}

        if cfg.pool_type == "mha":  # big_vision only (ref vit.py:192-197)
            p["pooler"] = {
                "probe": sd.pop("MAPHead_0/probe"),
                "attn": flax_mha("MAPHead_0/MultiHeadDotProductAttention_0"),
                "norm": flax_ln("MAPHead_0/LayerNorm_0"),
                "mlp": {
                    "fc1": flax_linear("MAPHead_0/MlpBlock_0/Dense_0"),
                    "fc2": flax_linear("MAPHead_0/MlpBlock_0/Dense_1"),
                },
            }
        sd.finalize()
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), p)

    # ------------------------------------------------------------------
    # Facebook checkpoints: DeiT-3 / DINO / DINOv2 (ref vit.py:202-306)
    # ------------------------------------------------------------------

    @staticmethod
    def from_facebook(model_tag: str, *, pretrained: bool = False, **kwargs) -> "ViT":
        model_tag, _, weights = model_tag.partition("_")
        weights = weights or "deit3"
        size, patch_size = model_tag.split("/")
        patch_size = int(patch_size)

        if weights == "deit3":
            kwargs["img_size"] = kwargs.get("img_size", 224)
            _size = dict(S="small", M="medium", B="base", L="large", H="huge")[size]
            url = f"https://dl.fbaipublicfiles.com/deit/deit_3_{_size}_{kwargs['img_size']}_21k.pth"
        elif weights == "dino":
            kwargs["img_size"] = kwargs.get("img_size", 224)
            _size = dict(S="small", B="base")[size]
            _tag = f"dino_deit{_size}{patch_size}_pretrain"
            url = f"https://dl.fbaipublicfiles.com/dino/{_tag}/{_tag}.pth"
        elif weights == "dinov2":
            kwargs["img_size"] = kwargs.get("img_size", 518)
            _tag = f"dinov2_vit{size.lower()}{patch_size}"
            url = f"https://dl.fbaipublicfiles.com/dinov2/{_tag}/{_tag}_pretrain.pth"
        else:
            raise ValueError(f"Unsupported {weights}")

        n_layers, d_model, n_heads = SIZES[size]
        m = ViT(n_layers, d_model, n_heads, patch_size, **kwargs)

        if pretrained:
            # checkpoint-availability asserts as the reference (ref vit.py:241-247)
            allowed = {"deit3": (16,), "dino": (16, 8), "dinov2": (14,)}[weights]
            assert patch_size in allowed, f"{weights} checkpoints only exist for patch_size {allowed}"
            from ...utils.torch_ckpt import load_torch_checkpoint

            state_dict = load_torch_checkpoint(hub_download(url))
            if "model" in state_dict:
                state_dict = state_dict["model"]
            m.load_facebook_state_dict(state_dict)
        return m

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """Convert timm-style keys (fused qkv, LayerScale) into our pytree.

        Mirrors the reference's tricks (vit.py:257-306): fused-qkv 3-way split,
        folding LayerScale γ into the out-proj / fc2 weights, slicing the PE to
        the patch grid and adding any extra PE slot into the cls token.
        """
        sd = StateDict(state_dict)
        cfg = self.cfg
        p: dict = {"patch_embed": sd.pop_conv2d("patch_embed.proj")}

        pe = sd.pop("pos_embed").astype(np.float32)
        n_patches = (cfg.img_size // cfg.patch_size) ** 2
        p["pe"] = pe[:, -n_patches:]
        cls = sd.pop("cls_token").astype(np.float32)
        if pe.shape[1] > n_patches:
            cls = cls + pe[:, 0]
        p["cls_token"] = cls
        p["norm"] = sd.pop_ln("norm")

        layers = []
        for i in range(cfg.n_layers):
            pfx = f"blocks.{i}"
            qkv_w = np.split(sd.pop(f"{pfx}.attn.qkv.weight").astype(np.float32), 3, axis=0)
            qkv_b = np.split(sd.pop(f"{pfx}.attn.qkv.bias").astype(np.float32), 3, axis=0)
            out = sd.pop_linear(f"{pfx}.attn.proj")
            out = {"w": out["w"].astype(np.float32), "b": out["b"].astype(np.float32)}
            g1 = sd.pop(f"{pfx}.gamma_1", None)  # deit3
            if g1 is None:
                g1 = sd.pop(f"{pfx}.ls1.gamma", None)  # dinov2
            if g1 is not None:
                out["w"] = out["w"] * g1[None, :]
                out["b"] = out["b"] * g1
            mlp = {"fc1": sd.pop_linear(f"{pfx}.mlp.fc1"), "fc2": sd.pop_linear(f"{pfx}.mlp.fc2")}
            g2 = sd.pop(f"{pfx}.gamma_2", None)
            if g2 is None:
                g2 = sd.pop(f"{pfx}.ls2.gamma", None)
            if g2 is not None:
                mlp["fc2"] = {"w": mlp["fc2"]["w"] * g2[None, :], "b": mlp["fc2"]["b"] * g2}
            layers.append(
                {
                    "sa_norm": sd.pop_ln(f"{pfx}.norm1"),
                    "sa": {
                        "q": {"w": qkv_w[0].T, "b": qkv_b[0]},
                        "k": {"w": qkv_w[1].T, "b": qkv_b[1]},
                        "v": {"w": qkv_w[2].T, "b": qkv_b[2]},
                        "o": out,
                    },
                    "mlp_norm": sd.pop_ln(f"{pfx}.norm2"),
                    "mlp": mlp,
                }
            )
        p["encoder"] = {"layers": stack_layers([jax.tree.map(jnp.asarray, l) for l in layers])}
        # known-extra keys we do not model: dinov2's mask_token, deit3's
        # classifier head (the reference leftover-prints these, vit.py:306)
        for extra in ("mask_token", "head.weight", "head.bias"):
            sd.pop(extra, None)
        sd.finalize()
        self.params = jax.tree.map(lambda x: jnp.asarray(to_np(x), jnp.float32), p)
