"""Traced-step analysis: collective accounting and roofline terms.

Port of ``repro/launch/analysis.py``. The roofline is *derived from one
traced step*, not measured: ``launch/cost.py`` counts per-device FLOPs,
bytes, collective bytes and peak live memory on each rank's local shards,
and :class:`Roofline` divides them by the H100's datasheet rates
(``launch/mesh.py``'s ``HW``). ``collective_bytes`` is the reference's
reader of HLO text, kept for JAX-produced text.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.launch.mesh import HW

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# e.g. "%all-gather.3 = bf16[2,128,64]{2,1,0} all-gather(" — also matches
# tuple results "( bf16[..], bf16[..] ) all-reduce("
_LINE_RE = re.compile(
    r"=\s*(?P<shapes>[^=]*?)\s(?P<op>" + "|".join(COLLECTIVE_OPS) + r")\(")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-device payload bytes by collective kind (output-shape convention;
    all-reduce counted 2× — ring RS+AG)."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    for m in _LINE_RE.finditer(hlo_text):
        op = m.group("op")
        b = _shape_bytes(m.group("shapes"))
        out[op] += 2 * b if op == "all-reduce" else b
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0           # 6·N(_active)·D useful FLOPs (global)
    useful_fraction: float = 0.0       # model_flops / (flops_per_device·n)
    memory_gb_per_device: Optional[float] = None

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops_per_device / HW["peak_flops_bf16"]
        self.t_memory = self.bytes_per_device / HW["hbm_bandwidth"]
        self.t_collective = (self.collective_bytes_per_device
                             / HW["link_bandwidth"])
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops_per_device * self.n_devices
        self.useful_fraction = (self.model_flops / total) if total else 0.0
        return self

    @property
    def t_bound(self) -> float:
        """The roofline's least step time: its largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def asdict(self) -> dict:
        return asdict(self)

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:9s} "
                f"C={self.t_compute * 1e3:9.3f}ms "
                f"M={self.t_memory * 1e3:9.3f}ms "
                f"N={self.t_collective * 1e3:9.3f}ms "
                f"-> {self.bottleneck:10s} useful={self.useful_fraction:6.1%}")


def analyze(cost, *, arch: str, shape: str, mesh_name: str,
            n_devices: int, model_flops: float) -> Roofline:
    """The roofline of one traced step's ``launch.cost.StepCost``: its
    per-device FLOPs, bytes (an eager step's, unfused), collectives and
    peak live bytes (the port's counterpart of XLA's memory analysis)."""
    colls = {k: int(v) for k, v in cost.collectives.items()}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        collective_bytes_per_device=float(sum(colls.values())),
        collectives=colls, model_flops=model_flops,
        memory_gb_per_device=cost.peak_bytes / 1e9,
    ).finalize()


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE); decode counts D = batch tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq
