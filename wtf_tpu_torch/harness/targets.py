"""Target registry: how fuzzing campaigns plug user harness code in.

Mirror of the reference's `Target_t` (src/wtf/targets.h:14-48): a named
bundle of callbacks —

  init(backend)                  one-time setup after backend init: register
                                 breakpoints, patch guest code, map files
                                 (e.g. fuzzer_hevd.cc:61-142)
  insert_testcase(backend, data) write one testcase into guest memory /
                                 registers (fuzzer_hevd.cc:20-59); called
                                 per lane on the batch backend
  restore()                      roll back harness-side state per testcase
                                 (fs handle tables etc.)
  create_mutator(rng, max_len)   optional structure-aware mutator
                                 (fuzzer_tlv_server.cc:204-365); None =
                                 campaign default (honggfuzz-style mangle)
  snapshot()                     optional snapshot factory for self-
                                 contained synthetic targets (the reference
                                 loads user-supplied crash dumps instead,
                                 wtf.cc:127-129)
  device_insert                  optional DeviceInsertSpec: the declarative
                                 equivalent of insert_testcase for the
                                 device-resident mutation path (wtf_tpu/
                                 devmut) — where the bytes land and which
                                 registers carry pointer/length, so the
                                 whole insertion can be one in-graph
                                 overlay/register update per batch

Constructing a Target self-registers it (reference targets.cc:11-22); the
CLI looks targets up by --name (wtf.cc:378-383).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class DeviceInsertSpec:
    """Declarative testcase-insertion contract for targets whose
    insert_testcase is "write the bytes at a fixed GVA, put the pointer
    and length in registers" (the fuzzer_hevd.cc:20-59 shape).  The
    devmangle path (wtf_tpu/devmut) uses it to fuse insertion into the
    device program; the imperative insert_testcase remains the host
    path's contract and MUST stay semantically equivalent."""

    gva: int                 # where testcase bytes land (page-aligned)
    max_len: int             # region capacity in bytes
    len_gpr: int = 2         # GPR index receiving the byte length (rdx)
    ptr_gpr: int = 6         # GPR index receiving the buffer GVA (rsi)
    # Declarative stop breakpoint (the megachunk path, fuzz/megachunk.py):
    # when set, the target PROMISES its init() arms exactly
    # `set_breakpoint(finish_gva, lambda b: b.stop(Ok()))` at this rip,
    # so the in-graph window may rewrite BREAKPOINT@finish_gva -> OK
    # without a host round-trip.  Targets with richer handlers leave it
    # None; their batches fall back to host breakpoint dispatch.
    finish_gva: Optional[int] = None


@dataclasses.dataclass
class Target:
    name: str
    init: Callable = lambda backend: True
    insert_testcase: Callable = lambda backend, data: True
    restore: Callable = lambda: True
    create_mutator: Optional[Callable] = None
    snapshot: Optional[Callable] = None
    device_insert: Optional[DeviceInsertSpec] = None

    def __post_init__(self):
        Targets.instance().register(self)


class Targets:
    """Singleton registry (reference Targets_t, targets.cc:11-22)."""

    _instance: Optional["Targets"] = None

    def __init__(self):
        self._targets: Dict[str, Target] = {}

    @classmethod
    def instance(cls) -> "Targets":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register(self, target: Target) -> None:
        if target.name in self._targets:
            raise ValueError(f"target {target.name!r} already registered")
        self._targets[target.name] = target

    def get(self, name: str) -> Target:
        target = self._targets.get(name)
        if target is None:
            raise KeyError(
                f"unknown target {name!r}; known: {sorted(self._targets)}")
        return target

    def names(self):
        return sorted(self._targets)


def register_target(**kwargs) -> Target:
    return Target(**kwargs)


def load_builtin_targets() -> None:
    """Import the in-tree demo target modules so their self-registration
    runs (the reference compiles fuzzer_*.cc into the binary; our
    equivalent is importing the harness modules).  demo_pe registers
    whether or not its DLL is present; `demo_pe.available()` says if it
    can build its snapshot."""
    from wtf_tpu_torch.harness import (  # noqa: F401
        demo_fs, demo_ioctl, demo_kernel, demo_maze, demo_pe, demo_spin,
        demo_tlv, demo_usermode,
    )
