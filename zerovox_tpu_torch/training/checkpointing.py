"""Native checkpoints: the JAX package's `checkpoints/NNNN.msgpack` format.

A checkpoint is flax's msgpack of a variable tree (`utils/msgpack_codec.py`
writes the same bytes as `flax.serialization.msgpack_serialize`), written to
`path.tmp` and renamed over `path`, with its metadata in `path.json`. The
acoustic model's tree is `weights.to_jax_variables` of its state_dict, so
either package reads the other's files. The full train state for resuming
is `Trainer.save_train_state` (torch.save), the counterpart of the JAX
package's orbax checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from zerovox_tpu_torch.utils.msgpack_codec import packb, unpackb


def _host_tree(tree):
    """Every leaf as a numpy array (torch tensors copied to the host), as
    the JAX package's `jax.tree.map(np.asarray, ...)` does."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_native_checkpoint(path, variables: dict, meta: dict | None = None) -> None:
    blob = packb(_host_tree(variables))
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    if meta is not None:
        with open(str(path) + ".json", "w") as f:
            json.dump(meta, f)


def load_native_checkpoint(path) -> dict:
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_checkpoint_meta(path) -> dict | None:
    meta_path = str(path) + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None
