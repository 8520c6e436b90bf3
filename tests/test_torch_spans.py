"""PyTorch port: the ``ca_lanczos.*`` spans inside ``solve_auto``
(``utils.spans``).  With no profiler recording, ``span`` is one shared
no-op and a solve under a CPU profile gives the same bits as one without;
under the profile the spans of one call nest as the host call stack does:
one ``solve_auto``, its four stages in order, one ``solve.cycle`` per
restart and one ``polish.pass`` per polish pass, each piece inside its
stage."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from ca_lanczos_tpu_torch.config import LanczosConfig
from ca_lanczos_tpu_torch.harness.auto import solve_auto
from ca_lanczos_tpu_torch.utils import spans

STAGES = ["route", "probe", "solve", "polish"]
POLISH = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(n=3000):
    d = np.linspace(1.0, 90.0, n)
    d[-5:] = np.linspace(95.0, 100.0, 5)
    off = np.random.default_rng(0).standard_normal(n - 1) * 1e-3
    return sp.diags([off, d, off], [-1, 0, 1], format="csr")


def _solve(engine):
    a = _chain()
    return solve_auto(a, np.ones(a.shape[0]), 32, LanczosConfig(n_wanted=4, s=8, tol=1e-8),
                      engine=engine, polish=POLISH, over_lock=2, prefer="dia", device="cpu")


def _spans(prof):
    """(name without the prefix, start, end) of the profile's program spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            out.append((e.name()[len(spans.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda t: t[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    before = dict(spans.SECONDS)
    assert spans.span("solve") is spans.span("polish.prep", 3)
    with spans.span("solve"):
        pass
    assert spans.SECONDS == before


def test_stage_times_and_syncs_nothing_on_the_cpu():
    times = {}
    with spans.stage("probe", times, "cpu"):
        pass
    assert list(times) == ["probe"] and times["probe"] >= 0.0


@pytest.mark.parametrize("engine", ["fused", "host"])
def test_spans_nest_and_change_no_bit(engine):
    plain = _solve(engine)
    assert set(plain.stage_seconds) == set(STAGES)
    spans.SECONDS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _solve(engine)
    assert np.array_equal(plain.eigs, traced.eigs)
    assert torch.equal(plain.Q_conv, traced.Q_conv)
    assert list(traced.stage_seconds) == STAGES

    got = _spans(prof)
    names = [s[0] for s in got]
    calls = [s for s in got if s[0] == "solve_auto"]
    assert len(calls) == 1
    stages = [s for s in got if s[0] in STAGES]
    assert [s[0] for s in stages] == STAGES  # once each, in order
    assert all(_inside(s, calls[0]) for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    by_stage = dict((s[0], s) for s in stages)

    def within(name, stage):
        inner = [s for s in got if s[0] == name]
        assert inner and all(_inside(s, by_stage[stage]) for s in inner), name
        return inner

    within("route.build", "route")
    assert len(within("route.copy", "route")) == 2  # the operator, then r
    cycles = within("solve.cycle", "solve")
    assert len(cycles) == traced.n_restarts
    assert within("solve.rung", "solve")
    orth = within("solve.orth", "solve")
    assert all(any(_inside(o, c) for c in cycles) for o in orth)
    if engine == "fused":
        assert len(within("solve.wait", "solve")) == traced.n_restarts
        assert len(within("solve.bootstrap", "solve")) == 1
        assert len(within("solve.ritz", "solve")) == traced.n_restarts
        assert len(within("solve.refine", "solve")) == 1
        assert len(within("solve.powers", "solve")) == len(orth)
    assert len(within("polish.prep", "polish")) == 1
    passes = within("polish.pass", "polish")
    assert len(passes) == POLISH
    for name in ("polish.orth", "polish.rr"):
        assert all(any(_inside(s, p) for p in passes) for s in within(name, "polish"))
    assert names.count("polish.rr") == POLISH
    assert set(spans.SECONDS) == set(names)
    assert 0.0 < spans.SECONDS["polish.prep"] <= spans.SECONDS["polish"]
