"""Seconds of solve_auto's solve stage (``AutoResult.stage_seconds["solve"]``),
mean over the window's solves."""

from benchmark.yardstick import mean_stage


def read(run):
    return mean_stage(run, "solve")
