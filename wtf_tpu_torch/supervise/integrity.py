"""Machine-state integrity: invariant predicates and a digest fold.

The counterpart of wtf_tpu/supervise/integrity.py, written over the
port's planes.  A corrupted lane (a flipped bit in device memory, a
wrong kernel, scripted chaos) must be caught BEFORE its batch is
harvested: a poisoned status would crash `StatusCode(int(...))` in result
mapping, and poisoned coverage planes would credit edges that were never
executed.  The check is a handful of lane-parallel elementwise ops and
two small reductions:

  status    in [RUNNING .. NEEDS_XLA]: every value StatusCode can map
  rip       canonical: bits 63..47 of the int64 rip all zero or all one,
            i.e. `rip >> 47` (arithmetic) is 0 or -1 — except on a lane
            stopped before a successful fetch at its rip (NEED_DECODE,
            PAGE_FAULT, TIMEDOUT): a guest that jumps to a wild address
            leaves rip there, and the lane is a decode miss to service,
            a crash to report (`crash-execute-<rip>`) or a timeout, not
            a corrupted lane.  The JAX package's check flags such lanes,
            so a supervised campaign that meets one replays its batch
            and at the third time quarantines the lane (ROADMAP C)
  overlay   0 <= count <= capacity AND count == #allocated rows
            (pfn >= 0): a corrupt count would tear the restore
  ctr       fused-retired <= total-retired, compared as u32 (CTR_FUSED
            counts a subset of CTR_INSTR by construction)

The digest is the JAX package's lane-mixed wraparound-sum fold over the
same planes, bit for bit: each product and the sum are taken mod 2**32.
torch on the CPU has no uint32 arithmetic, so the fold runs in int64
with `& 0xFFFFFFFF` after every product and after the sum (a product of
two values below 2**32 may wrap int64; its low 32 bits are still right).

`poison_machine` / `mask_idle` are the write-side helpers: scripted
corruption for the chaos harness, and the idle mask that parks
quarantined lanes (status=OK: never stepped, never harvested).  Both
update the planes in place, as every device seam of the port does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.interp.machine import CTR_FUSED, CTR_INSTR, Machine

_STATUS_MAX = max(int(s) for s in StatusCode)
_U32 = 0xFFFFFFFF

# the status value scripted poison writes: far outside StatusCode, and
# recognizable in a debugger dump
POISON_STATUS = 77
POISON_RIP_HI = 0x00DEAD00

# the JAX fold's odd multipliers
_MIX_RIP_HI = 0x9E3779B9
_MIX_STATUS = 0x85EBCA6B
_MIX_INSTR = 0xC2B2AE35


def check_machine(machine: Machine) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bad bool[L], digest int64 scalar holding the u32 value) for the
    live machine — device tensors; the caller fences and reads back."""
    status = machine.status.long()
    ok = (status >= 0) & (status <= _STATUS_MAX)
    hi = machine.rip >> 47
    unfetched = ((status == int(StatusCode.NEED_DECODE))
                 | (status == int(StatusCode.PAGE_FAULT))
                 | (status == int(StatusCode.TIMEDOUT)))
    ok &= (hi == 0) | (hi == -1) | unfetched
    ov = machine.overlay
    allocated = (ov.pfn >= 0).sum(dim=1)
    count = ov.count.long()
    ok &= (count >= 0) & (count <= ov.capacity) & (allocated == count)
    instr = machine.ctr[:, CTR_INSTR].long() & _U32
    ok &= (machine.ctr[:, CTR_FUSED].long() & _U32) <= instr
    rip_lo = machine.rip & _U32
    rip_hi = (machine.rip >> 32) & _U32
    mix = (rip_lo
           ^ ((rip_hi * _MIX_RIP_HI) & _U32)
           ^ (((status & _U32) * _MIX_STATUS) & _U32)
           ^ ((instr * _MIX_INSTR) & _U32))
    digest = mix.sum() & _U32
    return ~ok, digest


def poison_machine(machine: Machine, lane: int) -> Machine:
    """Scripted corruption (chaos harness), in place: an out-of-range
    status AND a non-canonical rip on one lane — either predicate alone
    catches it.  Returns the machine."""
    lane = int(lane)
    machine.status[lane] = POISON_STATUS
    machine.rip[lane] = (machine.rip[lane] & _U32) | (POISON_RIP_HI << 32)
    return machine


def poison_output(out, lane: int):
    """Apply scripted poison to a dispatch output: the Machine itself, or
    a result carrying one under `.machine` (the megachunk window's)."""
    if isinstance(out, Machine):
        return poison_machine(out, lane)
    machine = getattr(out, "machine", None)
    if isinstance(machine, Machine):
        poison_machine(machine, lane)
    return out  # non-machine seam: faultinject slides poison off these


def mask_idle(machine: Machine, mask) -> Machine:
    """Park `mask` lanes idle the way the batch paths already treat
    untasked lanes, in place: status=OK (terminal — never stepped by the
    run loop, excluded from harvest by the caller's include mask)."""
    mask_t = torch.as_tensor(np.asarray(mask, dtype=bool),
                             device=machine.device)
    machine.status.copy_(torch.where(
        mask_t, int(StatusCode.OK), machine.status).to(torch.int32))
    return machine
