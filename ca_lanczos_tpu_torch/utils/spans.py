"""Named spans inside the solve, on the ``torch.profiler`` clock.

``span(name)`` marks a piece of the program as ``ca_lanczos.<name>`` in a
profile, the clock its device activities carry, so a trace reads device
time by the span that launched it.  With no profiler recording it costs
one C call and returns a shared no-op context.  ``stage`` is a span that
also times a ``solve_auto`` stage into the caller's ``stage_seconds``.

While a profiler records, each span's host seconds are also summed into
``SECONDS`` by name (process-wide, as ``ops.cuda_spmv.LAUNCHES`` counts
launches): the trace's span totals without reading the trace.

The module imports nothing of the package, so every layer can use it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "ca_lanczos."
SECONDS: Dict[str, float] = {}

_OFF = contextlib.nullcontext()


class _Span(torch.profiler.record_function):
    def __init__(self, name: str, args: Optional[str]):
        super().__init__(PREFIX + name, args)
        self.key = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        SECONDS[self.key] = SECONDS.get(self.key, 0.0) + time.perf_counter() - self.t0


def span(name: str, args=None):
    """A ``ca_lanczos.<name>`` range in the profile that is recording (with
    ``args`` as its string), or a no-op when none is."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, None if args is None else str(args))


@contextlib.contextmanager
def stage(name: str, times: Dict[str, float], device) -> Iterator[None]:
    """``span(name)`` that ends by synchronising ``device`` (when it is a
    CUDA device) and writes the host seconds up to then into
    ``times[name]``."""
    device = torch.device(device)
    t0 = time.perf_counter()
    with span(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    times[name] = time.perf_counter() - t0
