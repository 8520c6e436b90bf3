"""Device time by the launching span (``benchmark/spantrace.py``) on a
synthetic profile, and the ``polish_prep_s`` reader."""

import sys
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from benchmark import devtrace, harness, spantrace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MAIN, OTHER = 7001, 7002  # host threads
S = 1_000_000_000  # ns a second


class Ev:
    """The methods of a profile event that the readers call."""

    def __init__(self, name, start, dur, kind, thread=MAIN, corr=0, linked=0):
        self._name, self._start, self._dur, self._kind = name, start, dur, kind
        self._thread, self._corr, self._linked = thread, corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return DeviceType.CUDA if self._kind in ("kernel", "gpu_user_annotation") else DeviceType.CPU

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_resource_id(self):
        return self._thread


class Prof:
    def __init__(self, evs):
        self.profiler = self
        self.kineto_results = self
        self._evs = evs

    def events(self):
        return list(self._evs)


def span(name, start, end, thread=MAIN):
    return Ev("ca_lanczos." + name, start, end - start, "user_annotation", thread)


def launch(corr, at, thread=MAIN):
    return Ev("cudaLaunchKernel", at, 5, "cuda_runtime", thread, corr=corr)


def kernel(name, corr, start, end):
    return Ev(name, start, end - start, "kernel", corr=corr, linked=10_000 + corr)


def solve_profile():
    """One solve_auto from 0 to 100 s: route [0, 10), probe [10, 12),
    solve [12, 60) with one cycle holding orth [20, 30), polish [60, 100)
    with its prep [60, 90); then the harness's own work."""
    return [
        Ev("bench.window", 0, 120 * S, "user_annotation"),
        span("solve_auto", 0, 100 * S),
        span("route", 0, 10 * S), span("probe", 10 * S, 12 * S),
        span("solve", 12 * S, 60 * S), span("solve.cycle", 15 * S, 50 * S),
        span("solve.orth", 20 * S, 30 * S),
        span("polish", 60 * S, 100 * S), span("polish.prep", 60 * S, 90 * S),
        # launched in the orth span at 25 s, runs 40-44 s (inside no orth span)
        launch(1, 25 * S), kernel("trsm", 1, 40 * S, 44 * S),
        # launched in the cycle, outside the orth span; runs in the orth span's time
        launch(2, 16 * S), kernel("gemm", 2, 21 * S, 22 * S),
        # launched by the polish after its prep
        launch(3, 95 * S), kernel("dia", 3, 95 * S, 97 * S),
        # the harness after the call: outside every span
        launch(4, 105 * S), kernel("keep", 4, 105 * S, 106 * S),
        # a program span on another thread does not hold this thread's launch
        span("polish.orth", 104 * S, 110 * S, thread=OTHER),
        # what record_function leaves on the device: no work
        Ev("ca_lanczos.solve.orth", 40 * S, 4 * S, "gpu_user_annotation"),
    ]


def test_device_list_is_devtraces():
    prof = Prof(solve_profile())
    tr = spantrace.collect(prof)
    device, _ = devtrace.events(prof)
    assert tr.device == device
    assert [n for n, _, _ in tr.device] == ["trsm", "gemm", "dia", "keep"]  # no annotation


def test_attribution_by_launch():
    tr = spantrace.collect(Prof(solve_profile()))
    attr = spantrace.attribute(tr, 0.0, 120.0)
    assert attr == pytest.approx({
        ("solve_auto", "solve", "solve.cycle", "solve.orth"): 4.0,
        ("solve_auto", "solve", "solve.cycle"): 1.0,
        ("solve_auto", "polish"): 2.0,
        (): 1.0,
    })
    assert spantrace.launched_under(attr, "solve.orth") == pytest.approx(4.0)
    assert spantrace.launched_under(attr, "solve") == pytest.approx(5.0)
    assert spantrace.launched_under(attr, "solve.orth", "polish.orth") == pytest.approx(4.0)
    assert spantrace.by_stage(attr) == pytest.approx({"solve": 5.0, "polish": 2.0,
                                                      spantrace.OUTSIDE: 1.0})
    # every activity once: the stages and outside sum to the window's device seconds
    total = sum(e - s for _, s, e in devtrace.clip(tr.device, 0.0, 120.0))
    assert sum(spantrace.by_stage(attr).values()) == pytest.approx(total)


def test_attribution_clips_to_the_window_and_keeps_unmatched_outside():
    evs = solve_profile() + [kernel("orphan", 99, 41 * S, 42 * S)]  # no launch in the profile
    tr = spantrace.collect(Prof(evs))
    attr = spantrace.attribute(tr, 41.0, 96.0)
    # trsm clipped to 41-44 s, dia to 95-96 s, gemm and keep outside the window
    assert attr == pytest.approx({("solve_auto", "solve", "solve.cycle", "solve.orth"): 3.0,
                                  ("solve_auto", "polish"): 1.0, (): 1.0})


def test_idle_gaps_named_by_the_innermost_span():
    tr = spantrace.collect(Prof(solve_profile()))
    gaps = spantrace.idle_gaps(tr, 0.0, 120.0, fallback=[], top=3)
    # idle: 0-21 (midpoint 10.5: probe), 22-40 (31: solve.cycle, orth closed at 30),
    # 44-95 (69.5: polish.prep), 97-105 (101: after solve_auto), 106-120 (113: after
    # the other thread's span too)
    assert gaps == [["polish.prep", pytest.approx(51.0)], ["probe", pytest.approx(21.0)],
                    ["solve.cycle", pytest.approx(18.0)]]
    rest = spantrace.idle_gaps(tr, 0.0, 120.0, fallback=[], top=5)[3:]
    assert rest == [["between solves", pytest.approx(14.0)], ["between solves", pytest.approx(8.0)]]


def test_idle_gaps_fall_back_without_program_spans():
    evs = [e for e in solve_profile() if not e.name().startswith("ca_lanczos.")
           or e.device_type() == DeviceType.CUDA]
    tr = spantrace.collect(Prof(evs))
    assert tr.spans == []
    stages = devtrace.stage_spans([("bench.solve", 0.0, 100.0)],
                                  [{"route": 10.0, "probe": 2.0, "solve": 48.0, "polish": 40.0}])
    gaps = spantrace.idle_gaps(tr, 0.0, 120.0, fallback=stages, top=3)
    assert gaps == [["polish", pytest.approx(51.0)], ["probe", pytest.approx(21.0)],
                    ["solve", pytest.approx(18.0)]]
    attr = spantrace.attribute(tr, 0.0, 120.0)
    assert attr == pytest.approx({(): 8.0})  # nothing is launched under a program span


def run_with(solves):
    return harness.Run(setup_s=0, window_s=1, solves=solves, peak_bytes=0, traffic={})


def test_polish_prep_reads_the_programs_span_seconds(monkeypatch):
    from ca_lanczos_tpu_torch.utils import spans

    read = harness.load_module(METRICS / "polish_prep_s.py").read
    monkeypatch.setattr(spans, "SECONDS", {})
    assert read(run_with([{}, {}])) is None  # no span recorded: nothing to read
    monkeypatch.setattr(spans, "SECONDS", {"polish.prep": 9.0, "polish": 20.0})
    assert read(run_with([{}, {}])) == pytest.approx(4.5)
    assert read(run_with([])) is None
    monkeypatch.setitem(sys.modules, "ca_lanczos_tpu_torch.utils.spans", None)
    assert read(run_with([{}, {}])) is None  # a program without the spans module
