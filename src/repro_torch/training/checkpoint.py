"""Checkpointing: parameter trees saved and loaded as ``.npz`` archives.

Port of ``repro/training/checkpoint.py``, in its format: an ``np.savez``
archive whose keys are the '/'-joined tree paths, and beside it
``<archive>.json`` holding ``{"manifest": {path: {"shape", "dtype"}},
"metadata": {...}}``. So the reference's loaders read what the port writes
(``RankingPredictor.load`` included), and the port reads the reference's
files through ``bridge``.

bf16 leaves are written as the reference's archives hold them: the 2-byte
bf16 bits as numpy void (``V2``), with manifest dtype ``"bfloat16"``;
``bridge.to_tensor`` reads them back bit for bit. (The reference cannot load
its own bf16 archives: ``jnp.asarray`` has no cast from void.)

One deliberate difference: the manifest always lands at ``<archive>.json``
with the archive's ``.npz`` suffix, where the reference writes
``<path>.json`` and so, for a path without the suffix, a manifest its own
predictor loader does not find.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.bridge import flatten, to_tensor, unflatten

Tree = Dict[str, Any]


def _archive(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_checkpoint(path: str, tree: Tree,
                    metadata: Optional[dict] = None) -> None:
    npz = _archive(path)
    os.makedirs(os.path.dirname(npz) or ".", exist_ok=True)
    flat = flatten(tree)
    np.savez(npz, **{k: _to_numpy(v) for k, v in flat.items()})
    manifest = {k: {"shape": list(v.shape),
                    "dtype": str(v.dtype).removeprefix("torch.")}
                for k, v in flat.items()}
    with open(npz + ".json", "w") as f:
        json.dump({"manifest": manifest, "metadata": metadata or {}}, f,
                  indent=1)


def load_checkpoint(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like``: each leaf on its device and in
    its dtype (shapes must match)."""
    with np.load(_archive(path)) as data:
        flat_like = flatten(like)
        missing = set(flat_like) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        out = {}
        for key, leaf in flat_like.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            out[key] = to_tensor(arr, leaf.device).to(leaf.dtype)
    return unflatten(out)
