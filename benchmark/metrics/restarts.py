"""Restart cycles of each solve (``AutoResult.n_restarts``), mean over the window."""


def read(run):
    if not run.solves:
        return None
    return sum(s["n_restarts"] for s in run.solves) / len(run.solves)
