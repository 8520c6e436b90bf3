"""Content-addressed host builds of the repo's native helpers.

Counterpart of ``ca_lanczos_tpu/utils/_native_build.py``.  A source (under
``native/`` at the root of the checkout, or the port's own under
``ca_lanczos_tpu_torch/csrc/``) is compiled with ``g++`` into
``build/native/lib<stem>.<sha8>.so`` (``build/`` is git-ignored), named
by a hash of the source text and the flags, so an edited source never
loads a stale binary.  The binaries beside the sources in ``native/`` are
never loaded.  A missing source or a failed compile raises
``RuntimeError`` with the compiler's message; a caller that has a
fallback catches it.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"


def build_native(src: Path, flags: Sequence[str]) -> Path:
    """Compile ``src`` to ``build/native/lib<stem>.<sha8>.so`` once per
    (source, flags) hash; returns the library path."""
    src = Path(src)
    if not src.is_file():
        raise RuntimeError(f"native source {src} not found")
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:8]
    so = BUILD_DIR / f"lib{src.stem}.{h}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{e.stderr}") from e
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so
