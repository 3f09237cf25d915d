"""Production meshes over a placeholder process group, and the H100's
datasheet constants for the roofline.

Port of ``repro/launch/mesh.py``. The reference lowers each program for 256
or 512 placeholder host devices; the port traces it once on ``meta``
tensors under DTensor over a *fake* process group of as many ranks in one
process, whose collectives move nothing. A process group is global to the
process, so it lives inside :func:`placeholder_world`, which destroys it on
exit; the mesh functions are called inside it. Importing this module
touches no process-group state.

  single-pod : (data=16, model=16)            256 ranks
  multi-pod  : (pod=2, data=16, model=16)     512 ranks
"""
from __future__ import annotations

import logging
import math
from contextlib import contextmanager
from typing import Iterator, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The mesh's device type: the traced tensors live on ``meta``, and a fake
# group pairs with the host's device type.
MESH_DEVICE = "cpu"

SINGLE_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = ((16, 16),
                                                       ("data", "model"))
MULTI_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = (
    (2, 16, 16), ("pod", "data", "model"))


@contextmanager
def placeholder_world(n: int) -> Iterator[None]:
    """A fake process group of ``n`` ranks (this process is rank 0) for the
    duration of the block: meshes and DTensors over it trace, and its
    collectives return at once, moving nothing. Refuses to nest in (or
    replace) a group that is already there."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("placeholder_world: a process group already "
                           "exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    # DTensor's warnings about collectives (an all-to-all replaced on a
    # host mesh, all-reduces issued one mesh dim at a time) concern real
    # groups; over a fake one they only bury the caller's own output
    quiet = logging.getLogger("torch.distributed.tensor")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        yield
    finally:
        quiet.setLevel(level)
        dist.destroy_process_group()


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of a production mesh."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``; inside :func:`placeholder_world` of 256 or 512 ranks."""
    shape, axes = production_shape(multi_pod)
    return _mesh(shape, axes)


def make_cpu_mesh(model: int = 1) -> DeviceMesh:
    """The degenerate (1, model) mesh, inside :func:`placeholder_world` of
    ``model`` ranks."""
    return _mesh((1, max(model, 1)), ("data", "model"))


def _mesh(shape, axes) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs a process group of {n} "
                           f"ranks: call it inside placeholder_world({n})")
    return init_device_mesh(MESH_DEVICE, shape, mesh_dim_names=axes)


# NVIDIA H100 SXM5 80GB constants for the roofline (per card). Datasheet
# figures, not measured.
HW = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: BF16 Tensor Core
    # 1,979 TFLOP/s *with sparsity*, so 989.4e12 dense.
    "peak_flops_bf16": 989e12,     # FLOP/s
    # Same datasheet, SXM5: GPU memory bandwidth 3.35 TB/s.
    "hbm_bandwidth": 3.35e12,      # B/s
    # A 16-wide model axis spans two 8-GPU HGX H100 nodes, so its ring
    # crosses the inter-node network: one ConnectX-7 NDR InfiniBand port per
    # GPU, 400 Gb/s = 50e9 B/s (NVIDIA DGX H100 user guide, networking).
    # Within a node NVLink 4 gives 450e9 B/s a direction (900 GB/s
    # bidirectional, H100 datasheet); a ring runs at its slowest link.
    "link_bandwidth": 50e9,        # B/s a direction
}
