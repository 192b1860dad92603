"""Native (C++) host components and their build-on-demand loader.

The counterpart of wtf_tpu/native/: the mangle engine (`mangle.cc`, the
host mutator of fuzz/native_mutator.py), the crash-dump parser
(`kdmp.cc`, the fast path of snapshot/kdmp.py) and the bench's host
interpreter (`bochsref.cc`, bound by native/bochsref.py), byte-identical
copies of the JAX package's sources.  Binaries build with g++ into
`wtf_tpu_torch/_build/` at first use.  Every native component has a
pure-Python fallback, so the package still works without a compiler: the
native path is the fast path, not a hard dependency.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).parent
_BUILD = _DIR.parent / "_build"


def build_library(name: str, sources: list[str],
                  extra_flags: Optional[list[str]] = None) -> Optional[Path]:
    """Compile `sources` (relative to native/) into _build/lib<name>.so;
    returns the path, a cached build, or None when no compiler exists.
    Rebuilds when any source is newer than the binary.  The library is
    written under a private name and renamed into place, so processes
    building at once never load a half-written file."""
    out = _BUILD / f"lib{name}.so"
    srcs = [_DIR / s for s in sources]
    if out.exists() and all(
            s.stat().st_mtime <= out.stat().st_mtime for s in srcs):
        return out
    _BUILD.mkdir(exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           *(extra_flags or []),
           *[str(s) for s in srcs], "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out
