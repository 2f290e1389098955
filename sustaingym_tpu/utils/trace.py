"""Reduction of a ``jax.profiler`` trace to device busy/idle time and the
operations that take it.

    summary = device_summary("runs/profile")

reads the newest ``*.xplane.pb`` under the directory and, for every plane
whose name starts with ``plane_prefix`` (``/device:GPU`` by default),
takes the union of the event intervals on its stream lines as busy time.
The idle share is 1 - busy / span, where span runs from the first device
event to the last one of the trace. Operations are grouped by event name.
"""
from __future__ import annotations

import glob
import os

__all__ = ["latest_xplane", "device_summary"]


def latest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _union_ns(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_summary(trace_dir: str, plane_prefix: str = "/device:GPU",
                   top: int = 10) -> dict:
    """Busy time, span, idle share and top operations per device plane,
    summed over planes (see module docstring)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(latest_xplane(trace_dir))
    planes = [p for p in data.planes if p.name.startswith(plane_prefix)]
    busy = span = 0.0
    by_op: dict[str, float] = {}
    line_names: set[str] = set()
    for plane in planes:
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        intervals = []
        for line in streams or lines:
            line_names.add(line.name)
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                by_op[ev.name] = by_op.get(ev.name, 0.0) + ev.duration_ns
        if intervals:
            busy += _union_ns(intervals)
            span += (max(e for _, e in intervals)
                     - min(s for s, _ in intervals))
    op_total = sum(by_op.values()) or 1.0
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "planes": [p.name for p in planes],
        "lines": sorted(line_names),
        "busy_ns": busy,
        "span_ns": span,
        "idle_share": (1.0 - busy / span) if span else None,
        "top_ops": [{"name": name[:120], "ns": ns, "share": ns / op_total}
                    for name, ns in ranked],
    }
