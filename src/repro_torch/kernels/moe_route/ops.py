"""Each MoE slot's place within its expert: the CUDA kernel's wrapper and
its plain version.

``slot_positions(gate_idx, E)`` counts, for every routed slot of a group,
the earlier slots of that group routed to the same expert, in slot-major
order (slot j of token t at j*T + t): the place that capacity compares and
that lays out the expert rows in ``models.moe._dispatch``. It replaces no
TPU kernel: the JAX package counts the places with a one-hot ``cumsum``
left to XLA (``apply_moe`` in ``repro/models/moe.py``), which the plain
version repeats over all the slots at once. On the card that one-hot's
scan runs along a dimension that is not the innermost, one thread per
(group, expert) walking every slot in turn; the kernel
(``kernels/csrc/moe_slots.cu``; its source note says what bounds it and
how) gives each group one block and each slot one thread.

On a CPU or ``meta`` tensor (a shape-only trace) the wrapper computes the
plain version; on a CUDA tensor it launches the kernel or raises, as on
any other device. ``slot_positions.launches`` counts kernel launches, and
nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_EXPERTS = 1024   # the kernel's running counts in shared memory


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("moe_slots")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_slot_positions.argtypes = [p, p, i, i, i, i, ll, ll, p]
    lib.moe_slot_positions.restype = i
    return lib


def slot_positions_plain(gate_idx: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """gate_idx: (G, T, k) integer experts -> (G, k*T) int64 places."""
    g, tg, k = gate_idx.shape
    expert = gate_idx.transpose(1, 2).reshape(g, k * tg)
    onehot = F.one_hot(expert, num_experts)
    return ((onehot.cumsum(1) - 1) * onehot).sum(-1)


def slot_positions(gate_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """gate_idx: (G, T, k) int64, the router's experts, each in
    ``[0, num_experts)`` -> pos (G, k*T) int64: slot j of token t at
    ``j*T + t`` holds the number of earlier slots of its group routed to
    its expert. The innermost dimension must be contiguous; a view of
    the router's sorted indices is read where it lies. On the card
    ``num_experts`` is at most ``MAX_EXPERTS``, and a slot whose expert
    lies outside the range reads -1."""
    if build.plain_device(gate_idx):
        return slot_positions_plain(gate_idx, num_experts)
    what = "slot_positions"
    if gate_idx.dim() != 3 or gate_idx.dtype != torch.int64:
        raise ValueError(f"{what}: gate_idx must be (G, T, k) int64, got "
                         f"{tuple(gate_idx.shape)} {gate_idx.dtype}")
    if not gate_idx.is_cuda:
        raise ValueError(f"{what}: gate_idx must be a CUDA tensor, got "
                         f"{gate_idx.device}")
    if gate_idx.stride(2) != 1 and gate_idx.shape[2] > 1:
        raise ValueError(f"{what}: gate_idx's innermost dimension must be "
                         f"contiguous")
    if not 1 <= num_experts <= MAX_EXPERTS:
        raise ValueError(f"{what}: num_experts={num_experts} is outside the "
                         f"kernel's 1..{MAX_EXPERTS}")
    g, tg, k = gate_idx.shape
    pos = torch.empty(g, k * tg, dtype=torch.int64, device=gate_idx.device)
    if pos.numel() == 0:
        return pos
    lib = _lib()
    code = lib.moe_slot_positions(
        gate_idx.data_ptr(), pos.data_ptr(), g, tg, k, num_experts,
        gate_idx.stride(0), gate_idx.stride(1),
        build.current_stream(gate_idx.device))
    build.check_launch(lib, code, what)
    slot_positions.launches += 1
    return pos


slot_positions.launches = 0
