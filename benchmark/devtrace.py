"""Reading a ``torch.profiler`` profile held in memory: the device's
activities in the traced window, their union, and the breakdown.

Nothing is exported: the profile's events are read once and reduced to
(name, start, end) tuples of device activities (kernels, copies, sets)
and the host's solve spans, in seconds on the profiler's clock.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

WINDOW_SPAN = "bench.window"
SOLVE_SPAN = "bench.solve"

Interval = Tuple[str, float, float]


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device activities, host spans named bench.*) of a finished profile.
    A device activity is any event on the card that is not a user
    annotation: kernels, copies and sets."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((name, start, end))
        elif name.startswith("bench."):
            spans.append((name, start, end))
    return device, spans


def clip(device: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]


def union(device: Iterable[Interval]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for _, s, e in sorted(device, key=lambda t: t[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(device: Iterable[Interval]) -> float:
    return sum(e - s for s, e in union(device))


def stage_spans(solve_spans: List[Interval], stages: List[Dict[str, float]]) -> List[Interval]:
    """Host stages laid end to end from each solve's start: route, probe,
    solve, polish (``AutoResult.stage_seconds``, in its order); the rest
    of the solve's span is its return."""
    out = []
    for (_, s, e), secs in zip(solve_spans, stages):
        t = s
        for key, dur in secs.items():
            out.append((key, t, min(t + dur, e)))
            t += dur
        if t < e:
            out.append(("return", t, e))
    return out


def label(t: float, spans: List[Interval]) -> str:
    for name, s, e in spans:
        if s <= t < e:
            return name
    return "between solves"


def breakdown(device: List[Interval], lo: float, hi: float, spans: List[Interval],
              top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps, each named by the host stage its midpoint falls in."""
    per: Dict[str, float] = {}
    for n, s, e in device:
        key = short_name(n)
        per[key] = per.get(key, 0.0) + (e - s)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    t = lo
    for s, e in union(device) + [(hi, hi)]:
        if s > t:
            gaps.append((label((t + s) / 2, spans), s - t))
        t = max(t, e)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps[:top]]}


def window_of(spans: List[Interval]) -> Optional[Tuple[float, float]]:
    for name, s, e in spans:
        if name == WINDOW_SPAN:
            return s, e
    return None
