"""Seconds of solve_auto's probe stage (``AutoResult.stage_seconds["probe"]``),
mean over the window's solves."""

from benchmark.yardstick import mean_stage


def read(run):
    return mean_stage(run, "probe")
