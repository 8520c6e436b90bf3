"""Seconds of solve_auto's route stage (``AutoResult.stage_seconds["route"]``),
mean over the window's solves."""

from benchmark.yardstick import mean_stage


def read(run):
    return mean_stage(run, "route")
