"""Seconds from the start of the process to the start of the window:
imports, loading (or building) the kernels, the matrix, the warm-up."""


def read(run):
    return run.setup_s
