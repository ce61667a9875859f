"""Cached HTTP download of pretrained checkpoints.

Equivalent of the reference's ``torch_hub_download`` (utils.py:6-16),
without a torch dependency: files are cached under
``$PYTORCH_MODELS_TPU_CACHE`` (default ``~/.cache/pytorch_models_tpu``) and the
download is skipped when the file already exists.
"""

from __future__ import annotations

import os
from pathlib import Path


def cache_dir(subdir: str = "") -> Path:
    root = Path(os.environ.get("PYTORCH_MODELS_TPU_CACHE", Path.home() / ".cache" / "pytorch_models_tpu"))
    d = root / subdir if subdir else root
    d.mkdir(parents=True, exist_ok=True)
    return d


def hub_download(url: str, subdir: str = "", file_name: str | None = None) -> str:
    """Download ``url`` into the local cache (skipping if present); return the path.

    ``file_name`` overrides the cached name — required for HF checkpoints,
    which are all served as ``pytorch_model.bin`` and would otherwise collide
    (the reference passes file_name=model_tag for the same reason, bert.py:69).
    """
    save_path = cache_dir(subdir) / (file_name or url.rstrip("/").split("/")[-1])
    if save_path.exists():
        return str(save_path)

    import requests  # local import: only needed on a cache miss

    tmp = save_path.with_suffix(save_path.suffix + ".part")
    with requests.get(url, stream=True, timeout=60) as r:
        r.raise_for_status()
        with open(tmp, "wb") as f:
            for chunk in r.iter_content(chunk_size=1 << 20):
                f.write(chunk)
    os.replace(tmp, save_path)
    return str(save_path)


def load_hf_checkpoint(model_tag: str) -> dict:
    """Fetch + read an HF checkpoint: ``pytorch_model.bin`` first (what the
    reference reads, bert.py:68), falling back to ``model.safetensors``
    (modern repos often ship only that)."""
    import requests

    base = f"https://huggingface.co/{model_tag}/resolve/main"
    safe_name = model_tag.replace("/", "_")
    try:
        path = hub_download(f"{base}/pytorch_model.bin", file_name=safe_name + ".bin")
    except requests.HTTPError as e:
        if e.response is None or e.response.status_code != 404:
            raise  # real failure: do not mask it with a second download
        path = hub_download(f"{base}/model.safetensors", file_name=safe_name + ".safetensors")
        from .safetensors import load_safetensors

        return load_safetensors(path)
    from .torch_ckpt import load_torch_checkpoint

    return load_torch_checkpoint(path)
