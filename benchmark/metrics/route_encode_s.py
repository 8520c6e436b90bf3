"""Host seconds of the PELL route's encode (the program's ``route.encode``
span in ``ops.formats.make_operator``: ``PellMatrix.encode`` builds the
planes on the host, before ``route.copy`` moves them to the card), mean
over the window's solves.  The program sums each span's seconds while a
profiler records (``ca_lanczos_tpu_torch.utils.spans.SECONDS``), so in
the traced run this is the window alone; a program without the span
reads nothing."""


def read(run):
    try:
        from ca_lanczos_tpu_torch.utils.spans import SECONDS
    except ImportError:
        return None
    if not run.solves or "route.encode" not in SECONDS:
        return None
    return SECONDS["route.encode"] / len(run.solves)
