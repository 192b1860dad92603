"""Trace writers: rip, cov (unique rip), tenet.

Formats match the reference so its downstream tooling works unchanged:
  rip    one hex RIP per executed instruction
         (bochscpu_backend.cc:507-519; fed to the external `symbolizer`)
  cov    one hex RIP per FIRST execution (unique rips)
  tenet  per-instruction register deltas + memory accesses for the Tenet
         trace explorer (DumpTenetDelta, bochscpu_backend.cc:1215-1323):
         'reg=0x..,reg=0x..' changed registers (full set on the first
         line), ',mr=0xADDR:HEXBYTES' / ',mw=...' per access.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

# reference dump order (DumpTenetDelta): note rbx/rcx swapped vs x86
# encoding order, rip last
_TENET_REGS = ("rax", "rbx", "rcx", "rdx", "rbp", "rsp", "rsi", "rdi",
               "r8", "r9", "r10", "r11", "r12", "r13", "r14", "r15", "rip")


class TraceWriter:
    """Base: owns the file handle, context-manager lifetime, and explicit
    flush.  A crashed run's trace is usually the one that matters —
    `flush()` lets long-running callers checkpoint buffered lines, and
    `with` guarantees the tail reaches disk even when the run raises."""

    def __init__(self, path):
        self._fh = open(Path(path), "w")

    def flush(self) -> None:
        if not self._fh.closed:
            self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class RipTraceWriter(TraceWriter):
    def on_step(self, rip: int) -> None:
        self._fh.write(f"{rip:#x}\n")


class CovTraceWriter(TraceWriter):
    def __init__(self, path):
        super().__init__(path)
        self._seen = set()

    def on_step(self, rip: int) -> None:
        if rip not in self._seen:
            self._seen.add(rip)
            self._fh.write(f"{rip:#x}\n")


class TenetTraceWriter(TraceWriter):
    """Register+memory delta lines.  Call on_step AFTER each instruction
    with the post-state registers and that instruction's accesses."""

    def __init__(self, path):
        super().__init__(path)
        self._prev: Optional[Dict[str, int]] = None

    def on_step(self, regs: Dict[str, int],
                accesses: List[Tuple[str, int, bytes]] = ()) -> None:
        parts = []
        force = self._prev is None
        for name in _TENET_REGS:
            value = regs[name]
            if force or value != self._prev.get(name):
                parts.append(f"{name}={value:#x}")
        line = ",".join(parts)
        for kind, addr, data in accesses:
            line += f",{kind}={addr:#x}:{data.hex().upper()}"
        if line:
            self._fh.write(line + "\n")
        self._prev = dict(regs)
