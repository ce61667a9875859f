"""Native param-pytree checkpointing via orbax.

The reference's only persistence is caching converted checkpoints as torch
files (reference text/t5.py:261-263, 329-331). Here converted pytrees can be
saved once and re-loaded without the source checkpoint or converter —
orbax is JAX's native checkpoint format (sharding-aware, async-capable).
"""

from __future__ import annotations

import os

import jax


def save_params(path: str, params) -> None:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.PyTreeCheckpointer()
    ckptr.save(path, params)


def load_params(path: str):
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    return ckptr.restore(os.path.abspath(path))


def load_params_sharded(path: str, shardings):
    """Restore a checkpoint DIRECTLY onto device shardings.

    ``shardings``: a pytree of ``jax.sharding.Sharding`` (e.g. NamedSharding
    per leaf, same structure as the checkpointed params — build with
    ``jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs)``). Each leaf is
    read from disk straight into its device shards: no host-RAM full
    materialization, which is what makes multi-chip serving restores of
    models larger than one host's memory possible (the sharded-restore
    counterpart to parallel/serving.py's ``device_put`` of in-memory trees).
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path)
    # PyTreeCheckpointer.metadata wraps the param tree (StepMetadata ->
    # TreeMetadata.tree in current orbax; older versions return it bare)
    meta = getattr(getattr(meta, "item_metadata", meta), "tree", meta)

    def arg(sharding, m):
        return ocp.ArrayRestoreArgs(sharding=sharding, global_shape=m.shape,
                                    dtype=m.dtype)

    restore_args = jax.tree.map(arg, shardings, meta)
    return ckptr.restore(path, restore_args=restore_args)

