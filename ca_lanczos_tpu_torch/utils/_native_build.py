"""Content-addressed host builds of the repo's native helpers.

Counterpart of ``ca_lanczos_tpu/utils/_native_build.py``.  A source under
``native/`` at the root of the checkout is compiled with ``g++`` into
``build/native/lib<stem>.<sha8>.so`` (``build/`` is git-ignored), named
by a hash of the source text and the flags, so an edited source never
loads a stale binary.  The binaries beside the sources in ``native/`` are
never loaded.  A missing source or a failed compile returns None (the
caller decides whether that is an error).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"


def build_native(src: Path, flags: Sequence[str]) -> Optional[Path]:
    """Compile ``src`` to ``build/native/lib<stem>.<sha8>.so`` once per
    (source, flags) hash; returns the library path, or None."""
    src = Path(src)
    if not src.is_file():
        return None
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:8]
    so = BUILD_DIR / f"lib{src.stem}.{h}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so
