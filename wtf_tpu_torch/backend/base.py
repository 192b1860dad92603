"""The Backend contract (reference `Backend_t`, src/wtf/backend.h:161-596).

Pure-virtual surface the reference defines: Initialize / Run / Restore /
Stop / SetLimit / GetReg / SetReg / Rdrand / PrintRunStats / SetTraceFile /
SetBreakpoint / VirtTranslate / VirtRead / VirtWrite(Dirty) /
LastNewCoverage / RevokeLastNewCoverage — plus the non-virtual conveniences
implemented once over those (backend.cc:129-332): register shortcuts,
Windows-x64 argument accessors, SimulateReturnFromFunction, SaveCrash.

Semantic deltas from the reference, by design:
  - `run()` here takes no buffer: testcase insertion is the target's job
    (targets.insert_testcase writes guest memory through this API before
    run), matching the actual call order in RunTestcaseAndRestore
    (client.cc:88-180) while keeping the batch backend free to insert a
    whole batch at once.
  - breakpoint handlers receive the backend positionally (`handler(backend)`)
    exactly like the reference's `BreakpointHandler_t` (backend.h:110);
    on the batch backend the backend object is temporarily *lane-bound*
    during dispatch.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, List, Optional, Set

from wtf_tpu_torch.core.results import Crash, TestcaseResult

BreakpointHandler = Callable[["Backend"], None]

# x86 register indices in encoding order (core.cpustate.GPR_NAMES):
# rax rcx rdx rbx rsp rbp rsi rdi r8..r15
_REG_IDX = {
    "rax": 0, "rcx": 1, "rdx": 2, "rbx": 3, "rsp": 4, "rbp": 5,
    "rsi": 6, "rdi": 7, "r8": 8, "r9": 9, "r10": 10, "r11": 11,
    "r12": 12, "r13": 13, "r14": 14, "r15": 15,
}


class Backend(abc.ABC):
    """One guest execution engine.  Register accessors operate on the
    *current* lane (the only lane for EmuBackend; the bound lane during
    batch dispatch for TpuBackend)."""

    # -- lifecycle (backend.h:171-199) -----------------------------------
    @abc.abstractmethod
    def initialize(self) -> None:
        """Build the execution engine around the snapshot (VM construction
        in the reference; device upload + machine allocation here)."""

    @abc.abstractmethod
    def run(self) -> TestcaseResult:
        """Execute until a stop condition; testcase already inserted."""

    @abc.abstractmethod
    def restore(self) -> None:
        """Roll back registers + dirty memory to the snapshot."""

    @abc.abstractmethod
    def stop(self, result: TestcaseResult) -> None:
        """Terminate the current testcase with `result` (callable from
        breakpoint handlers, like backend.h:191)."""

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    # -- registers (backend.h:205-206 + shortcuts backend.cc:241-307) ----
    @abc.abstractmethod
    def get_reg(self, idx: int) -> int: ...

    def get_xmm(self, idx: int) -> int:
        """128-bit XMM read (reference GetReg covers vector regs too,
        bochscpu_backend.cc:1124-1190)."""
        raise NotImplementedError

    def set_xmm(self, idx: int, value: int) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def set_reg(self, idx: int, value: int) -> None: ...

    @abc.abstractmethod
    def get_rip(self) -> int: ...

    @abc.abstractmethod
    def set_rip(self, value: int) -> None: ...

    def get_rflags(self) -> int:
        """Current-lane RFLAGS (triage introspection: the vbreak capture
        snapshots it alongside the GPR file)."""
        raise NotImplementedError

    def get_icount(self) -> int:
        """Instructions retired by the current lane this run (triage
        introspection; 0-based at insert time)."""
        raise NotImplementedError

    def __getattr__(self, name):
        # rax()/rcx()/... accessor-mutator shortcuts (backend.cc:241-307)
        if name in _REG_IDX:
            idx = _REG_IDX[name]

            def accessor(value: Optional[int] = None):
                if value is None:
                    return self.get_reg(idx)
                self.set_reg(idx, value)

            return accessor
        raise AttributeError(name)

    def rip(self, value: Optional[int] = None):
        if value is None:
            return self.get_rip()
        self.set_rip(value)

    @property
    def current_lane(self) -> int:
        """The lane this backend's accessors currently address (always 0
        for single-lane backends; the bound lane during batch dispatch).
        Harness state that is per-guest (file tables, handle tables) must
        be keyed by this."""
        return 0

    # -- memory (backend.h:248-261, backend.cc:30-127) --------------------
    @abc.abstractmethod
    def virt_read(self, gva: int, size: int) -> bytes: ...

    @abc.abstractmethod
    def virt_write(self, gva: int, data: bytes) -> None:
        """Host-initiated guest write; always dirty-tracked (the overlay
        design makes every write dirty by construction, preserving the
        reference's VirtWriteDirty contract, backend.cc:91-127)."""

    def virt_write_dirty(self, gva: int, data: bytes) -> None:
        self.virt_write(gva, data)

    def virt_translate(self, gva: int, write: bool = False) -> int:
        """GVA -> GPA through the current lane's page tables (reference
        backend.h:248; harnesses use it for page-boundary placement).
        Raises the backend's fault type on non-present/non-writable."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement virt_translate")

    def phys_translate(self, gpa: int) -> int:
        """GPA -> backing offset (the reference returns a host pointer,
        backend.h:255; page-granular identity here)."""
        return gpa

    def inject_exception(self, vector: int, error_code: int = 0,
                         cr2: Optional[int] = None) -> None:
        """Vector an exception through the guest IDT on the current lane
        (reference `bochscpu_cpu_set_exception`, bochscpu_backend.cc:995-998
        / KVM event injection, kvm_backend.cc:2019-2042).  Raises the
        delivery error when the snapshot's IDT cannot service it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement inject_exception")

    def page_faults_memory_if_needed(self, gva: int, size: int) -> bool:
        """Reference PageFaultsMemoryIfNeeded (backend.h:261,
        bochscpu_backend.cc:917-999): when part of [gva, gva+size) is not
        yet paged in (lazy VirtualAlloc-style PTEs), inject a #PF so the
        GUEST kernel pages it in, and return True — the calling breakpoint
        handler must then return and let the guest run; the breakpoint
        re-fires at the retried instruction and the range is probed again
        (one page faulted in per round, exactly the reference's dance).
        Returns False when the whole range is mapped and the host may
        write it directly."""
        from wtf_tpu_torch.cpu.emu import MemFault
        from wtf_tpu_torch.cpu.interrupts import PF_ERR_U, PF_ERR_W
        from wtf_tpu_torch.interp.runner import HostFault

        page = 0x1000
        gva_end = gva + max(size, 1)
        pos = gva & ~(page - 1)
        page_to_fault = None
        while pos < gva_end:
            try:
                self.virt_translate(pos, write=True)
            except (MemFault, HostFault):
                page_to_fault = pos
                break
            pos += page
        if page_to_fault is None:
            return False
        # ErrorWrite | ErrorUser, like the reference's synthetic fault
        # (bochscpu_backend.cc:993-998)
        self.inject_exception(14, PF_ERR_W | PF_ERR_U, cr2=page_to_fault)
        return True

    def virt_read_u64(self, gva: int) -> int:
        return int.from_bytes(self.virt_read(gva, 8), "little")

    def virt_read_u32(self, gva: int) -> int:
        return int.from_bytes(self.virt_read(gva, 4), "little")

    def virt_write_u64(self, gva: int, value: int) -> None:
        self.virt_write(gva, (value & (1 << 64) - 1).to_bytes(8, "little"))

    def virt_read_string(self, gva: int, max_len: int = 1024) -> str:
        """NUL-terminated ASCII read (helper for harness logging)."""
        out = bytearray()
        while len(out) < max_len:
            byte = self.virt_read(gva + len(out), 1)
            if byte == b"\x00":
                break
            out += byte
        return out.decode("latin-1")

    # -- breakpoints (backend.h:231, backend.cc:214-239) ------------------
    @abc.abstractmethod
    def set_breakpoint(self, gva: int, handler: BreakpointHandler) -> None: ...

    def set_breakpoint_by_symbol(self, symbol: str,
                                 handler: BreakpointHandler) -> None:
        """Resolve `module!symbol` through the snapshot's symbol store
        (reference SetBreakpoint(const char*), backend.cc:214-239)."""
        addr = self.symbols.get(symbol)
        if addr is None:
            raise KeyError(f"symbol {symbol!r} not in symbol store")
        self.set_breakpoint(addr, handler)

    def set_breakpoint_if_symbol(self, symbol: str,
                                 handler: BreakpointHandler) -> bool:
        """set_breakpoint_by_symbol, but skip-on-missing: hook sets
        register detections only for symbols the snapshot carries (the
        reference behaves the same for e.g. verifier hooks on targets
        without app verifier, crash_detection_umode.cc:154-164)."""
        addr = self.symbols.get(symbol)
        if addr is None:
            return False
        self.set_breakpoint(addr, handler)
        return True

    # -- coverage (backend.h:583-589) --------------------------------------
    @abc.abstractmethod
    def last_new_coverage(self) -> Set[int]: ...

    @abc.abstractmethod
    def revoke_last_new_coverage(self) -> None: ...

    # -- determinism (backend.h:212) ---------------------------------------
    @abc.abstractmethod
    def rdrand(self) -> int:
        """Next value of the deterministic rdrand chain (reference keeps a
        Blake3-chained seed, bochscpu_backend.cc:874-885)."""

    # -- conveniences (backend.cc:129-212) ---------------------------------
    def simulate_return_from_function(self, return_value: int = 0) -> bool:
        """Pop the saved return address and return `return_value` in rax
        (backend.cc:129-147) — the NOP-a-function harness primitive."""
        self.set_reg(0, return_value)
        stack = self.get_reg(4)
        saved = self.virt_read_u64(stack)
        self.set_reg(4, stack + 8)
        self.set_rip(saved)
        return True

    def get_arg_address(self, idx: int) -> int:
        if idx <= 3:
            raise ValueError(
                "args 0-3 live in rcx/rdx/r8/r9; they have no address")
        return self.get_reg(4) + 8 + idx * 8

    def get_arg(self, idx: int) -> int:
        """Windows-x64 calling convention argument (backend.cc:178-192)."""
        if idx == 0:
            return self.get_reg(1)
        if idx == 1:
            return self.get_reg(2)
        if idx == 2:
            return self.get_reg(8)
        if idx == 3:
            return self.get_reg(9)
        return self.virt_read_u64(self.get_arg_address(idx))

    def save_crash(self, exception_address: int, exception_kind: str) -> None:
        """Name + stop like the reference's SaveCrash (backend.cc:204-212):
        the name becomes the on-disk filename under crashes/."""
        self.stop(Crash(f"crash-{exception_kind}-{exception_address:#x}"))

    def print_registers(self) -> None:
        """Windbg-style register dump of the current lane (reference
        PrintRegisters, backend.cc:309-332) — the harness-debugging aid
        breakpoint handlers reach for."""
        rows = (("rax", "rbx", "rcx"), ("rdx", "rsi", "rdi"),
                ("rip", "rsp", "rbp"), ("r8", "r9", "r10"),
                ("r11", "r12", "r13"), ("r14", "r15"))
        for row in rows:
            print(" ".join(
                f"{name:>3}={(self.rip() if name == 'rip' else getattr(self, name)()):016x}"
                for name in row))


    # -- batch facade ------------------------------------------------------
    def run_batch(self, insert: List[bytes], target) -> List[TestcaseResult]:
        """Run a list of testcases; returns one result each.

        Single-lane backends iterate the reference's canonical per-testcase
        sequence (client.cc:88-180: InsertTestcase -> Run -> Restore),
        restoring between testcases; the batch backend overrides this with
        one device dispatch for the whole list.  The final restore is the
        caller's (fuzz loop's) responsibility either way."""
        results: List[TestcaseResult] = []
        self._batch_new: List[bool] = []
        for i, data in enumerate(insert):
            if i > 0:
                target.restore()
                self.restore()
            target.insert_testcase(self, data)
            result = self.run()
            if isinstance(result, type(None)):
                raise AssertionError("run() returned None")
            from wtf_tpu_torch.core.results import Timedout
            if isinstance(result, Timedout):
                self.revoke_last_new_coverage()
                self._batch_new.append(False)
            else:
                self._batch_new.append(bool(self.last_new_coverage()))
            results.append(result)
        return results

    def lane_found_new_coverage(self, lane: int) -> bool:
        return self._batch_new[lane]

    # -- misc --------------------------------------------------------------
    def set_trace_file(self, path, trace_type: str) -> None:
        """Arrange for a rip/cov trace of the next run (reference
        backend.h:224); implemented by backends that support it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement tracing")

    def print_run_stats(self) -> None:
        pass


def guard_guest_faults(handler: BreakpointHandler) -> BreakpointHandler:
    """Wrap a breakpoint handler that dereferences guest-controlled
    pointers: a bad pointer must fail the TESTCASE (as the real kernel
    would A/V probing a syscall argument), not escape and abort the
    campaign."""
    from wtf_tpu_torch.cpu.emu import MemFault
    from wtf_tpu_torch.interp.runner import HostFault

    def wrapped(backend):
        try:
            handler(backend)
        except (MemFault, HostFault) as e:
            kind = "write" if getattr(e, "write", False) else "read"
            backend.save_crash(getattr(e, "gva", 0), kind)
    return wrapped
