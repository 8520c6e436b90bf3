"""Device time by the program span that launched it, read from a
``torch.profiler`` profile held in memory.

The program marks its pieces with ``ca_lanczos.<name>`` ranges on the
profiler's clock (``ca_lanczos_tpu_torch.utils.spans``).  Each device
activity (kernel, copy, set: the selection of ``devtrace.events``) is
matched by its correlation id to the CUDA runtime or driver call that
launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``,
...), and belongs to the program spans open on that call's thread when it
was made: by launch, never by where the activity itself ran, since the host
runs ahead of the card.  An activity launched under no program span is
``outside``.  Idle gaps of the card are named by the innermost program
span open at their midpoint.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

from benchmark import devtrace

PREFIX = "ca_lanczos."
OUTSIDE = "outside"
LAUNCH = re.compile(r"cu(da)?[A-Z]")  # the names of CUDA runtime and driver calls

Span = Tuple[str, float, float, int]  # name without the prefix, start, end, thread
Path = Tuple[str, ...]  # the spans open at a launch, outermost first


@dataclasses.dataclass
class Trace:
    spans: List[Span]
    device: List[devtrace.Interval]  # devtrace.events' list, in its order
    launches: List[Optional[Tuple[float, int]]]  # each activity's launch: (start, thread)


def collect(prof) -> Trace:
    """The program spans, the device activities and each one's launch."""
    spans, device, corr, launch_at = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((name, start, end))
                corr.append(e.correlation_id())
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, end, e.device_resource_id()))
        elif LAUNCH.match(name):
            launch_at[e.correlation_id()] = (start, e.device_resource_id())
    return Trace(spans=spans, device=device, launches=[launch_at.get(c) for c in corr])


class _Timeline:
    """The stack of program spans open at any time, thread by thread."""

    def __init__(self, spans: Iterable[Span]):
        by_thread: Dict[int, List[Span]] = {}
        for s in spans:
            by_thread.setdefault(s[3], []).append(s)
        self.threads = {tid: self._segments(ss) for tid, ss in by_thread.items()}

    @staticmethod
    def _segments(spans: List[Span]):
        marks = []
        for i, (_, s, e, _) in enumerate(spans):
            marks.append((s, 1, -e, i))
            marks.append((e, 0, 0, i))  # at a tie a span closes before the next opens
        marks.sort()
        times: List[float] = []
        stacks: List[Tuple[Span, ...]] = []
        open_: List[int] = []
        for t, opens, _, i in marks:
            if opens:
                open_.append(i)
            else:
                open_.remove(i)
            stack = tuple(spans[j] for j in open_)
            if times and times[-1] == t:
                stacks[-1] = stack
            else:
                times.append(t)
                stacks.append(stack)
        return times, stacks

    def stack(self, t: float, thread: int) -> Tuple[Span, ...]:
        times, stacks = self.threads.get(thread, ((), ()))
        i = bisect.bisect_right(times, t) - 1
        return stacks[i] if i >= 0 else ()

    def innermost(self, t: float) -> Optional[Span]:
        """The latest-opened span open at ``t`` on any thread."""
        open_ = [st[-1] for st in (self.stack(t, tid) for tid in self.threads) if st]
        return max(open_, key=lambda s: s[1]) if open_ else None


def attribute(trace: Trace, lo: float, hi: float) -> Dict[Path, float]:
    """Device seconds in the window [lo, hi] (each activity clipped to it,
    as ``devtrace.clip``) by the path of program spans open at its
    launch; () holds what was launched outside them, or whose launch the
    profile does not hold."""
    line = _Timeline(trace.spans)
    out: Dict[Path, float] = {}
    for (_, s, e), launch in zip(trace.device, trace.launches):
        if e <= lo or s >= hi:
            continue
        path: Path = ()
        if launch is not None:
            path = tuple(sp[0] for sp in line.stack(*launch))
        out[path] = out.get(path, 0.0) + min(e, hi) - max(s, lo)
    return out


def launched_under(attr: Dict[Path, float], *names: str) -> float:
    """Device seconds launched while any span named in ``names`` was open."""
    return sum(v for path, v in attr.items() if any(n in path for n in names))


def by_stage(attr: Dict[Path, float]) -> Dict[str, float]:
    """Device seconds by the span one below the outermost (a stage of
    ``solve_auto``), the outermost where none is below it, or ``outside``."""
    out: Dict[str, float] = {}
    for path, v in attr.items():
        key = path[1] if len(path) > 1 else (path[0] if path else OUTSIDE)
        out[key] = out.get(key, 0.0) + v
    return out


def idle_gaps(trace: Trace, lo: float, hi: float, fallback: List[devtrace.Interval],
              top: int = 10) -> List[list]:
    """The ``top`` longest stretches of the window with nothing on the
    device, each named by the innermost program span open at its midpoint
    ("between solves" in none); without program spans, by ``fallback``'s
    intervals (``devtrace.stage_spans``) as ``devtrace.breakdown`` names them."""
    gaps = []
    t = lo
    for s, e in devtrace.union(devtrace.clip(trace.device, lo, hi)) + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    line = _Timeline(trace.spans)
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        if trace.spans:
            span = line.innermost(mid)
            name = span[0] if span is not None else "between solves"
        else:
            name = devtrace.label(mid, fallback)
        out.append([name, e - s])
    return out
