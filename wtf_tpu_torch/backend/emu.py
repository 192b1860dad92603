"""EmuBackend: the oracle CPU behind the Backend contract.

Plays the role bochscpu plays in the reference (slowest, fully
deterministic, precise — README.md:7) *and* the fake-backend test seam
SURVEY.md §4 calls for: the whole harness/fuzz/distribution plane runs on
it without a TPU in sight.  One guest, one lane.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Set

from wtf_tpu_torch.backend.base import Backend, BreakpointHandler
from wtf_tpu_torch.core.results import (
    Cr3Change, Crash, Ok, TestcaseResult, Timedout,
)
from wtf_tpu_torch.cpu.emu import (
    DivideError, EmuCpu, EmuMem, GuestCrash, MemFault, UnsupportedInsn,
)
from wtf_tpu_torch.cpu.interrupts import (
    VEC_DE, VEC_PF, DeliveryFailed, deliver_page_fault,
)
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch import telemetry
from wtf_tpu_torch.telemetry import Registry, StatsDict
from wtf_tpu_torch.utils.hashing import splitmix64


class EmuBackend(Backend):
    def __init__(self, snapshot: Snapshot, limit: int = 0,
                 deliver_exceptions: Optional[bool] = None,
                 registry: Optional[Registry] = None, events=None):
        self.snapshot = snapshot
        self.symbols = snapshot.symbols
        self.limit = limit
        self.registry, self.events = telemetry.resolve(
            registry=registry, events=events)
        # Guest exception delivery through the snapshot's IDT (auto: on
        # exactly when the snapshot carries one) — see cpu/interrupts.py.
        if deliver_exceptions is None:
            deliver_exceptions = snapshot.cpu.idtr.limit > 0
        self.deliver_exceptions = deliver_exceptions
        self.breakpoints: Dict[int, BreakpointHandler] = {}
        self.cpu: Optional[EmuCpu] = None
        self._stop_result: Optional[TestcaseResult] = None
        self._run_cov: Set[int] = set()
        self._aggregate_cov: Set[int] = set()
        self._last_new: Set[int] = set()
        self._trace_file = None
        self._trace_type = None
        self.stats = StatsDict(self.registry, "backend",
                               fields=("runs", "instructions"))

    # -- lifecycle ---------------------------------------------------------
    def initialize(self) -> None:
        self.cpu = EmuCpu(EmuMem(self.snapshot.physmem), self.snapshot.cpu)

    def run(self) -> TestcaseResult:
        assert self.cpu is not None, "initialize() first"
        cpu = self.cpu
        self._stop_result = None
        self._run_cov = set()
        skip_rip = None  # one-shot bp suppression after handler resume
        result: TestcaseResult
        writer = None
        tenet = False
        if self._trace_file is not None:
            from wtf_tpu_torch.trace import (
                CovTraceWriter, RipTraceWriter, TenetTraceWriter,
            )

            cls = {"rip": RipTraceWriter, "cov": CovTraceWriter,
                   "tenet": TenetTraceWriter}[self._trace_type]
            writer = cls(self._trace_file)
            tenet = self._trace_type == "tenet"
        try:
            while True:
                if self.limit and cpu.icount >= self.limit:
                    result = Timedout()
                    break
                rip = cpu.rip
                if rip in self.breakpoints and rip != skip_rip:
                    skip_rip = rip
                    self.breakpoints[rip](self)
                    if self._stop_result is not None:
                        result = self._stop_result
                        break
                    if cpu.rip != rip:
                        skip_rip = None
                    continue
                skip_rip = None
                self._run_cov.add(rip)
                if writer is not None and not tenet:
                    writer.on_step(rip)
                if tenet:
                    cpu.access_log = []
                try:
                    cpu.step()
                except GuestCrash as e:
                    result = Crash(f"crash-int-{e.rip:#x}")
                    break
                except MemFault as e:
                    if self._deliver(VEC_PF, fault=e):
                        continue  # guest services the fault and retries
                    # execute-refinement: a fault on the fetch address is an
                    # exec A/V (reference refines A/Vs into read/write/
                    # execute, crash_detection_umode.cc:104-121)
                    if e.gva == rip and not e.write:
                        kind = "execute"
                    else:
                        kind = "write" if e.write else "read"
                    result = Crash(f"crash-{kind}-{e.gva:#x}")
                    break
                except DivideError:
                    if self._deliver(VEC_DE):
                        continue
                    result = Crash(f"crash-de-{rip:#x}")
                    break
                except UnsupportedInsn as e:
                    result = Crash(f"crash-unsupported-{e.rip:#x}")
                    break
                if tenet:
                    self._tenet_step(writer)
                if cpu.cr3_event is not None:
                    if cpu.cr3_event != self.snapshot.cpu.cr3:
                        result = Cr3Change()
                        break
                    cpu.cr3_event = None
        finally:
            if writer is not None:
                writer.close()
            cpu.access_log = None
            self._trace_file = None
        self.stats["runs"] += 1
        self.stats["instructions"] += cpu.icount
        # coverage merge (reference: per-run set union into the aggregate,
        # LastNewCoverage = the delta, bochscpu_backend.cc:497-505)
        self._last_new = self._run_cov - self._aggregate_cov
        self._aggregate_cov |= self._last_new
        return result

    def _deliver(self, vector: int, fault: Optional[MemFault] = None) -> bool:
        """Try to vector a hardware fault through the guest IDT
        (cpu/interrupts.py); False keeps the pre-delivery terminal-crash
        behavior (no IDT, absent gate, or the delivery itself faulted —
        the double-fault analog)."""
        if not self.deliver_exceptions:
            return False
        cpu = self.cpu
        try:
            if vector == VEC_PF:
                def reads(g):
                    try:
                        cpu.translate(g, write=False)
                        return True
                    except MemFault:
                        return False

                deliver_page_fault(cpu, fault.gva, fault.write, reads)
            else:
                cpu.deliver_exception(vector)
        except (DeliveryFailed, MemFault):
            return False
        return True

    def inject_exception(self, vector: int, error_code: int = 0,
                         cr2: Optional[int] = None) -> None:
        self.cpu.deliver_exception(vector, error_code, cr2)

    def _tenet_step(self, writer) -> None:
        """Post-instruction tenet delta: registers + the step's accesses
        (data fetched post-insn like the reference, bochscpu:1276-1289)."""
        cpu = self.cpu
        accesses, cpu.access_log = cpu.access_log, None
        regs = {name: cpu.gpr[i] for i, name in enumerate(
            ("rax", "rcx", "rdx", "rbx", "rsp", "rbp", "rsi", "rdi",
             "r8", "r9", "r10", "r11", "r12", "r13", "r14", "r15"))}
        regs["rip"] = cpu.rip
        resolved = []
        for kind, gva, size in accesses or ():
            try:
                data = cpu.virt_read(gva, min(size, 64))
            except MemFault:
                continue  # e.g. the faulting access of a crashing insn
            resolved.append((kind, gva, data))
        writer.on_step(regs, resolved)

    def restore(self) -> None:
        self.cpu.restore()

    def stop(self, result: TestcaseResult) -> None:
        self._stop_result = result

    # -- registers ---------------------------------------------------------
    def get_reg(self, idx: int) -> int:
        return self.cpu.gpr[idx]

    def set_reg(self, idx: int, value: int) -> None:
        self.cpu.gpr[idx] = value & (1 << 64) - 1

    def get_xmm(self, idx: int) -> int:
        lo, hi = self.cpu.xmm[idx]
        return lo | (hi << 64)

    def set_xmm(self, idx: int, value: int) -> None:
        self.cpu.xmm[idx] = [value & (1 << 64) - 1, (value >> 64) & (1 << 64) - 1]

    def get_rip(self) -> int:
        return self.cpu.rip

    def set_rip(self, value: int) -> None:
        self.cpu.rip = value & (1 << 64) - 1

    def get_rflags(self) -> int:
        return self.cpu.rflags

    def get_icount(self) -> int:
        return self.cpu.icount

    # -- memory ------------------------------------------------------------
    def virt_translate(self, gva: int, write: bool = False) -> int:
        return self.cpu.translate(gva, write)

    def virt_read(self, gva: int, size: int) -> bytes:
        return self.cpu.virt_read(gva, size)

    def virt_write(self, gva: int, data: bytes) -> None:
        self.cpu.virt_write(gva, data, enforce=False)

    # -- breakpoints -------------------------------------------------------
    def set_breakpoint(self, gva: int, handler: BreakpointHandler) -> None:
        self.breakpoints[gva] = handler

    # -- coverage ----------------------------------------------------------
    def last_new_coverage(self) -> Set[int]:
        return set(self._last_new)

    def aggregate_coverage(self) -> Set[int]:
        """All RIPs covered so far this campaign (feeds the .cov-file
        coverage report, reference coverage.cov aggregate README.md:166)."""
        return set(self._aggregate_cov)

    def revoke_last_new_coverage(self) -> None:
        # reference client revokes after a timeout so flaky paths don't
        # enter the corpus (client.cc:122-125)
        self._aggregate_cov -= self._last_new
        self._last_new = set()

    # -- misc ---------------------------------------------------------------
    def rdrand(self) -> int:
        self.cpu.rdrand_state = splitmix64(self.cpu.rdrand_state)
        return self.cpu.rdrand_state

    def set_trace_file(self, path, trace_type: str) -> None:
        if trace_type not in ("rip", "cov", "tenet"):
            raise ValueError(f"unsupported trace type {trace_type!r}")
        self._trace_file = Path(path)
        self._trace_type = trace_type

    def print_run_stats(self) -> None:
        print(f"[emu] runs={self.stats['runs']} "
              f"instructions={self.stats['instructions']}")
