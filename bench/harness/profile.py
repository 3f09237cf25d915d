"""Reading a ``torch.profiler`` slice: device busy time, kernels by name,
and the longest idle gaps named by what the host was doing.

The raw events of the session (``kineto_results.events()``) are read once;
``key_averages()`` builds the profiler's event tree and takes minutes over
a serving slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Slice:
    """What one profiled slice holds: device intervals (ns), device time
    and calls by kernel name, host spans (ns) and the slice's wall."""
    window_s: float
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    host: List[Tuple[int, int, str, bool]] = field(default_factory=list)
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Union of the device intervals."""
        total, end = 0, None
        for s, e, _ in sorted(self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernel_s(self, part: str) -> Tuple[float, int]:
        """Device seconds and calls of kernels whose name holds ``part``."""
        t = n = 0
        for name, (s, c) in self.by_name.items():
            if part in name:
                t += s
                n += c
        return t, n

    def top_ops(self, n: int = 10) -> List[List]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[_short(name), s] for name, (s, _c) in rows]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between device intervals, each named by the
        benchmark's span and the innermost host operator across its
        middle."""
        ivs = sorted(self.device)
        gaps, end = [], None
        for s, e, _ in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            spans = [h for h in self.host if h[0] <= mid <= h[1]]
            user = [h for h in spans if h[3]]
            ops = [h for h in spans if not h[3]]
            name = min(user, key=lambda h: h[1] - h[0])[2] if user \
                else "host"
            if ops:
                name += " > " + min(ops, key=lambda h: h[1] - h[0])[2]
            out.append([_short(name), (b - a) / 1e9])
        return out


def _short(name: str, most: int = 120) -> str:
    """A kernel's name without its template arguments' bulk."""
    return name if len(name) <= most else name[:most - 3] + "..."


def read(prof, window_s: float) -> Slice:
    """The slice of a stopped ``torch.profiler.profile`` session."""
    from torch.autograd import DeviceType

    sl = Slice(window_s=window_s)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            sl.host.append((e.start_ns(), e.end_ns(), e.name(),
                            e.is_user_annotation()))
        elif not e.is_user_annotation():
            sl.device.append((e.start_ns(), e.end_ns(), e.name()))
            t, c = sl.by_name.get(e.name(), (0.0, 0))
            sl.by_name[e.name()] = (t + e.duration_ns() / 1e9, c + 1)
    return sl
