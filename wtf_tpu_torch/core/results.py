"""Testcase result variants.

Equivalent of the reference's `TestcaseResult_t = std::variant<Ok_t, Timedout_t,
Cr3Change_t, Crash_t>` (reference src/wtf/backend.h:12-31).  A crash carries a
name used as the on-disk filename under crashes/ (server.h:861-877).

These also define the integer status codes the interpreter keeps per lane on
device; `StatusCode` is the device-side encoding, the dataclasses are the
host-side API objects.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union


class StatusCode(enum.IntEnum):
    """Per-lane execution status, kept as int32 on device."""

    RUNNING = 0
    OK = 1          # a stop breakpoint ended the testcase cleanly
    TIMEDOUT = 2    # instruction limit reached
    CR3_CHANGE = 3  # context switch detected (cr3 write != snapshot cr3)
    CRASH = 4       # guest crashed (fault, bugcheck, harness-detected)
    BREAKPOINT = 5  # paused at a breakpoint awaiting host servicing
    UNSUPPORTED = 6 # interpreter hit an unimplemented instruction
    PAGE_FAULT = 7  # translation fault.  When the snapshot carries an IDT
                    # the host delivers it through the guest kernel
                    # (cpu/interrupts.py) and the lane resumes; otherwise
                    # (or on delivery failure) it is terminal and surfaces
                    # as a memory-access crash
    NEED_DECODE = 8   # rip not in the uop table; host must decode + resume
    SMC = 9           # lane's code bytes diverge from the shared decode cache
    OVERLAY_FULL = 10 # lane ran out of dirty-page overlay slots
    DIVIDE_ERROR = 11 # #DE (div by zero / quotient overflow)
    HARD_ERROR = 12   # terminal: instruction unsupported even by the host
                      # oracle, or other unrecoverable servicing failure
                      # (details in Runner.lane_errors)
    NEEDS_XLA = 13    # fused Pallas fast path parked the lane BEFORE
                      # executing (instruction outside the hot integer
                      # subset, armed breakpoint, or dirty/diverged code
                      # bytes); state is untouched and the runner resumes
                      # it on the XLA chunk path — never escapes the
                      # runner's fused ladder (interp/pstep.py)


# Statuses the device can set that the host run loop must service before the
# lane can make further progress (vs. terminal testcase outcomes).
# PAGE_FAULT/DIVIDE_ERROR are conditionally serviceable on top of these:
# with guest exception delivery enabled they resume through the IDT
# (interp/runner.py), otherwise they are terminal.
SERVICEABLE = (
    StatusCode.NEED_DECODE,
    StatusCode.BREAKPOINT,
    StatusCode.SMC,
    StatusCode.UNSUPPORTED,
)


@dataclasses.dataclass(frozen=True)
class Ok:
    def __str__(self) -> str:
        return "ok"


@dataclasses.dataclass(frozen=True)
class Timedout:
    def __str__(self) -> str:
        return "timedout"


@dataclasses.dataclass(frozen=True)
class Cr3Change:
    def __str__(self) -> str:
        return "cr3change"


@dataclasses.dataclass(frozen=True)
class Crash:
    """A crash with an optional name; named crashes get saved to disk
    (reference backend.cc:204-212 SaveCrash / server.h:861-877)."""

    name: Optional[str] = None

    def __str__(self) -> str:
        return f"crash({self.name or '?'})"


@dataclasses.dataclass(frozen=True)
class OverlayFull:
    """The lane ran out of dirty-page overlay slots — a resource limit of
    THIS framework (no reference analog: its VMs have all of guest RAM).
    Not a finding: excluded from crashes/ and from the coverage merge (the
    run executed on truncated memory); campaign loops requeue the
    testcase so it still gets an honest execution."""

    def __str__(self) -> str:
        return "overlay-full"


TestcaseResult = Union[Ok, Timedout, Cr3Change, Crash, OverlayFull]


def is_crash(result: TestcaseResult) -> bool:
    return isinstance(result, Crash)
