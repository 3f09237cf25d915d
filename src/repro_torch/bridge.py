"""Bridge reference parameters into the port's tensors.

The reference's parameters are pytrees whose leaves are addressed by
'/'-joined tree paths (``repro/training/checkpoint.py``: ``"embed"``,
``"layers/attn/wq"``, ...); layer leaves keep their leading ``num_layers``
axis. This module turns such a flat ``{path: numpy array}`` mapping into the
port's nested dicts of tensors, and reads the ``.npz`` checkpoints that
``save_checkpoint`` (and so ``RankingPredictor.save``) writes, with numpy
alone.

bf16 leaves need care: the reference saves them through ``ml_dtypes``, and
``np.load`` returns them as 2-byte void (``|V2``), with or without
``ml_dtypes`` installed. Their bits are read as int16 and viewed as
``torch.bfloat16``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Any]


def to_tensor(arr: np.ndarray, device: DeviceLike = "cuda") -> torch.Tensor:
    """One leaf as a tensor on ``device``; 2-byte void leaves are bf16."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(resolve_device(device))


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": leaf}}`` -> ``{"a/b": leaf}``, keys in sorted order at
    every level: the reference's leaf order (``jax.tree_util`` sorts dict
    keys), so sums over leaves add in the same order."""
    flat: Dict[str, Any] = {}
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, Mapping):
            flat.update(flatten(node, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = node
    return flat


def unflatten(flat: Mapping[str, Any]) -> Tree:
    """``{"a/b/c": leaf}`` -> ``{"a": {"b": {"c": leaf}}}``."""
    tree: Tree = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def params_from_flat(flat: Mapping[str, np.ndarray],
                     device: DeviceLike = "cuda") -> Tree:
    """Flat ``{path: numpy array}`` -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return unflatten({key: to_tensor(arr, dev) for key, arr in flat.items()})


def load_npz(path: str, device: DeviceLike = "cuda"
             ) -> Tuple[Tree, Dict[str, Any]]:
    """Read a reference checkpoint: ``(params, metadata)``.

    ``path`` names the ``.npz`` archive (the suffix may be left off, as the
    reference's loader allows); the JSON manifest beside it
    (``<archive>.json``) supplies the metadata."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with open(npz + ".json") as f:
        meta = json.load(f).get("metadata", {})
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_flat(flat, device), meta
