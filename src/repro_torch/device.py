"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` (a bare ``"cuda"`` resolved to the
    current card's index); raises when it names CUDA and no card is
    visible. Nothing falls back to the CPU: callers that want the
    CPU (the tests) pass ``device="cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:      # "cuda" means the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
