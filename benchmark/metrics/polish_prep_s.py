"""Host seconds of the polish's f64 operator build (the program's
``polish.prep`` span in ``harness.auto._polish_block``: the f64 DIA
planes from the raw matrix, and their copy to the card), mean over the
window's solves.  The program sums each span's seconds while a profiler
records (``ca_lanczos_tpu_torch.utils.spans.SECONDS``), so in the traced
run this is the window alone; a program without the span reads nothing."""


def read(run):
    try:
        from ca_lanczos_tpu_torch.utils.spans import SECONDS
    except ImportError:
        return None
    if not run.solves or "polish.prep" not in SECONDS:
        return None
    return SECONDS["polish.prep"] / len(run.solves)
