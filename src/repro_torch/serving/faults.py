"""Serving faults: the subset of the reference faults module that the
serving core needs (:class:`ReplicaCrashed`, raised by a core that is down).

The definition is a verbatim copy of ``repro/serving/faults.py``; fault
schedules and injected scorer faults are not part of this port yet.
"""
from __future__ import annotations


class ReplicaCrashed(RuntimeError):
    """A serving-core replica died: raised by the fault hook at the
    scheduled step, and by every probe/tick on a core whose ``inject_crash``
    flag is set — the router treats any of these as replica death."""
