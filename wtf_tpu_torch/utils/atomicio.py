"""Atomic file writes: the ONE torn-file-proof persistence helper.

A campaign killed mid-write must never leave a half-written coverage
file, crash testcase, corpus entry, or checkpoint behind — every
persistence path that survives a restart routes through here
(dist/server coverage + crash saves, fuzz/corpus outputs, the
wtf_tpu/resume checkpoints).  The recipe is the classic
tmp + fsync + rename: `os.replace` is atomic on POSIX, so readers see
either the old file or the complete new one, never a torn middle.

Chaos seam: `wtf_tpu/testing/faultinject` installs `_WRITE_FAULT` to
inject deterministic ENOSPC/OSError failures at the write boundary —
the recovery paths above are exercised against *this* function, not a
mock of it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional

# fault-injection hook (wtf_tpu/testing/faultinject): called with the
# destination path before any byte is written; may raise OSError
_WRITE_FAULT: Optional[Callable] = None


def atomic_write_bytes(path, data: bytes, fsync: bool = True) -> None:
    """Write `data` to `path` atomically (tmp + fsync + rename).  On any
    failure the destination is untouched and the tmp file is removed."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if _WRITE_FAULT is not None:
        _WRITE_FAULT(path)
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    if fsync:
        _fsync_dir(path.parent)


def atomic_write_text(path, text: str, fsync: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def _fsync_dir(directory: Path) -> None:
    """Best-effort directory fsync so the rename itself is durable (a
    power cut after the file fsync but before the dirent lands would
    otherwise resurrect the old file)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # e.g. platforms that can't open directories
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
