"""Wall seconds of the window over the solve_auto calls completed in it
(host clock, read after the device is synchronised)."""


def read(run):
    if not run.solves:
        return None
    return run.window_s / len(run.solves)
