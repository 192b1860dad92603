"""Crash-detection hook sets: turn guest failure sites into named crashes.

Adaptation of the reference's detection layer
(crash_detection_umode.cc:20-167 + the hevd harness's kernel hooks,
fuzzer_hevd.cc:114-139) to this framework's symbol-driven breakpoints:

  setup_kernel_crash_detection    bugcheck-analog routine -> named crash
                                  with the bugcheck code + args (the
                                  nt!KeBugCheck2 hook, fuzzer_hevd.cc:114)
  setup_usermode_crash_detection  exception-dispatch-analog routine ->
                                  parse the guest EXCEPTION_RECORD, filter
                                  debug-print/C++ exceptions, refine A/V
                                  into read/write/execute, stop w/ named
                                  crash (RtlDispatchException hook,
                                  crash_detection_umode.cc:53-129);
                                  plus stack-cookie (KiRaiseSecurityCheck-
                                  Failure :141) and verifier (:154) analogs

Symbols are looked up in the backend's snapshot symbol store; hooks for
absent symbols are skipped (the reference behaves the same on targets
without app verifier loaded).

Crash naming convention shared with the backends' intrinsic detections:
  crash-bugcheck-<code>-<arg0>   kernel bugcheck
  crash-<read|write|execute>-<addr>   access violation (refined)
  crash-<pretty>-<addr>          other exception codes (nt.py names)
"""

from __future__ import annotations

from wtf_tpu_torch.backend.base import guard_guest_faults
from wtf_tpu_torch.core import nt
from wtf_tpu_torch.core.results import Crash, Timedout

# Symbol names the hook sets look for (targets alias their own routines
# to these in their symbol stores, like real snapshots carry the Windows
# names the reference hooks).
SYM_BUGCHECK = "nt!KeBugCheck2"
SYM_DISPATCH_EXCEPTION = "ntdll!RtlDispatchException"
SYM_SECURITY_CHECK = "ntdll!KiRaiseSecurityCheckFailure"
SYM_VERIFIER_STOP = "verifier!VerifierStopMessage"
SYM_PERF_INTERRUPT = "hal!HalpPerfInterrupt"


def setup_kernel_crash_detection(backend) -> None:
    """Kernel-mode hook set (the hevd harness's detections)."""

    def on_bugcheck(b) -> None:
        # Windows x64 ABI: rcx = bugcheck code, rdx/r8/r9 = args
        # (fuzzer_hevd.cc:114-128 formats the same tuple)
        code = b.get_reg(1) & 0xFFFFFFFF       # rcx
        arg0 = b.get_reg(2)                    # rdx
        b.stop(Crash(f"crash-bugcheck-{code:#x}-{arg0:#x}"))

    backend.set_breakpoint_if_symbol(SYM_BUGCHECK, on_bugcheck)
    backend.set_breakpoint_if_symbol(SYM_PERF_INTERRUPT,
                                     lambda b: b.stop(Timedout()))


def setup_usermode_crash_detection(backend) -> None:
    """User-mode hook set (SetupUsermodeCrashDetectionHooks)."""

    def on_dispatch_exception(b) -> None:
        # rcx = &EXCEPTION_RECORD (crash_detection_umode.cc:53)
        record_ptr = b.get_reg(1)
        raw = b.virt_read(record_ptr, nt.ExceptionRecord.SIZE)
        record = nt.ExceptionRecord.parse(raw)
        # C++ throws and debug prints are not bugs; let the guest's own
        # handler run them (crash_detection_umode.cc:76-100)
        if record.code in (nt.DBG_PRINTEXCEPTION_C,
                           nt.DBG_PRINTEXCEPTION_WIDE_C,
                           nt.CPP_EH_EXCEPTION):
            return
        if record.code == nt.EXCEPTION_ACCESS_VIOLATION:
            kind = record.av_kind() or "av"
            addr = record.parameters[1] if len(record.parameters) > 1 else 0
            b.save_crash(addr, kind)
            return
        b.save_crash(record.address, nt.exception_code_to_str(record.code))

    def on_security_check(b) -> None:
        # stack cookie failure == __fastfail -> stack-buffer-overrun
        # (crash_detection_umode.cc:141-152)
        b.save_crash(b.get_rip(), "stack-buffer-overrun")

    def on_verifier_stop(b) -> None:
        b.save_crash(b.get_rip(), "heap-corruption")

    # the record pointer is guest-controlled: a corrupt rcx names a crash
    # instead of escaping the dispatch (guard_guest_faults)
    backend.set_breakpoint_if_symbol(
        SYM_DISPATCH_EXCEPTION, guard_guest_faults(on_dispatch_exception))
    backend.set_breakpoint_if_symbol(SYM_SECURITY_CHECK, on_security_check)
    backend.set_breakpoint_if_symbol(SYM_VERIFIER_STOP, on_verifier_stop)
