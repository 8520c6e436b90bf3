"""Seconds of solve_auto's polish stage (``AutoResult.stage_seconds["polish"]``),
mean over the window's solves."""

from benchmark.yardstick import mean_stage


def read(run):
    return mean_stage(run, "polish")
