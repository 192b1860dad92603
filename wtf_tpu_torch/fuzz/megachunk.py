"""The megachunk: a whole multi-batch fuzz window in one call.

The counterpart of wtf_tpu/fuzz/megachunk.py (`_make_body`, `make_megachunk`).
The batch-at-a-time device loop (fuzz/loop.py `_run_one_batch_device`)
consults the host between every phase of every batch.  The window folds,
per batch,

    restore -> devmut generate -> device insert -> run to quiescence ->
    finish-breakpoint rewrite -> prefix-credit coverage merge

over up to `n_batches` batches, so the host's per-batch work collapses to
the status pull and the harvest of crash and new-coverage lanes.  The JAX
package compiles the window into one program; here it is a loop on the
host over tensor code that stays on the device: the host reads one
"any lane RUNNING" flag per quiesce round and one three-flag tensor per
batch (need service, non-clean terminal, new coverage), nothing per lane.
The window returns early exactly when the host is needed:

  * a batch ends with a SERVICEABLE lane (decode miss, SMC, oracle
    fallback, a non-finish breakpoint, a deliverable fault): the machine
    comes back mid-batch and the ordinary Runner.run servicing loop
    finishes that batch;
  * a batch finds NEW COVERAGE: the window runs at most ONE more batch
    and stops, so the host folds the finds into the corpus slab before
    any batch entitled to see them is generated;
  * a batch has a NON-CLEAN terminal (crash/fault/overlay-full): the
    window stops right there, so the machine the host reads for crash
    naming and bucketing is exactly that batch's final state.

Slab schedule (the prelaunch lag, preserved exactly): batch k samples the
slab with finds from batches <= k-2.  The window takes TWO slab views —
`slab_first` for its first batch, `slab_rest` (the current host slab) for
the batches after — and the find-stop rule guarantees no batch inside a
window needs a newer one.  `slab_first` is the view the harvest pinned
just before the previous window's final batch's corpus adds
(DevMangleMutator.snapshot_entitled_slab).

The finish-breakpoint rewrite is the declarative form of the stop handler
(`b.stop(Ok())`) a target plants at its return address: a lane parked at
BREAKPOINT with rip == `DeviceInsertSpec.finish_gva` becomes OK, exactly
what the host handler does (the breakpointed instruction never executes).

Two quiesce engines: with `fused` each round is one launch of the fused
step kernel (K1, interp/pstep.py) for up to `fused_k` instructions per
lane, then the precise resume leg for the lanes it parked; without it,
precise steps until no lane is RUNNING.  Both retire every instruction
bit-exactly, so the results are the same.

Device decode (the `dd` operands, interp/devdec.py): a quiesce that leaves
NEED_DECODE lanes is followed by service rounds — blocks computed against
the round-start table, the commit in lane order, the lanes' deltas
applied, a re-quiesce with the same engine — until no unparked lane is
NEED_DECODE.  The window then carries the table with the published rows
to its next batch and returns it with the live count and the service
stats; parked lanes stay NEED_DECODE, so the host service finishes them.

The machine is updated in place (the JAX window donates it).  Not carried
yet: the mesh window and its all-gathered service (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Tuple

import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.devmut.engine import generate
from wtf_tpu_torch.interp import devdec
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.interp import pstep
from wtf_tpu_torch.interp.machine import (
    CTR_MEM_FAULT, N_CTRS, machine_restore,
)
from wtf_tpu_torch.interp.runner import device_insert_impl
from wtf_tpu_torch.interp.step import run_steps
from wtf_tpu_torch.meshrun.reduce import merge_coverage

_RUNNING = int(StatusCode.RUNNING)
_OK = int(StatusCode.OK)
_TIMEDOUT = int(StatusCode.TIMEDOUT)
_CR3 = int(StatusCode.CR3_CHANGE)
_OVF = int(StatusCode.OVERLAY_FULL)
_BP = int(StatusCode.BREAKPOINT)
_ND = int(StatusCode.NEED_DECODE)

# statuses the host servicing loop owns; PAGE_FAULT/DIVIDE_ERROR join
# when the campaign delivers guest exceptions (runner.deliver_exceptions)
SERVICEABLE_BASE = (int(StatusCode.NEED_DECODE), int(StatusCode.SMC),
                    int(StatusCode.UNSUPPORTED), int(StatusCode.BREAKPOINT))
SERVICEABLE_DELIVER = SERVICEABLE_BASE + (int(StatusCode.PAGE_FAULT),
                                          int(StatusCode.DIVIDE_ERROR))

# rip sentinel for "no declarative finish breakpoint": odd, so never the
# rip of an armed breakpoint
NO_FINISH = 1


@dataclasses.dataclass
class MegaSnap:
    """One batch's generated testcases, kept for the last two processed
    batches so crash/new-coverage lanes' bytes can be fetched."""

    words: torch.Tensor       # int32[L, W] (u32 bits)
    lens: torch.Tensor        # int32[L]


@dataclasses.dataclass
class MegaOut:
    agg_cov: torch.Tensor
    agg_edge: torch.Tensor
    batches: int              # COMPLETED batches this window
    incomplete: bool          # the machine is mid-batch `batches`
    statuses: torch.Tensor    # int32[B, L]; -1 = batch not completed
    new_flags: torch.Tensor   # bool[B, L] per-batch new-coverage credit
    ctr_sums: torch.Tensor    # int64[B, N_CTRS] per-batch counter totals
                              # (u64 sums, two's complement)
    new_words: torch.Tensor   # int32[cov_w] last completed batch's delta
    prev: MegaSnap
    cur: MegaSnap
    # step-engine rounds over the window: [precise sweeps, K1 launches]
    # (service re-quiesces included)
    engine_rounds: Tuple[int, int]
    # device decode (the inputs when the window runs without it): the
    # table with the device-published rows, its live count (-1 without),
    # the stats (serviced lanes, published entries, parked lanes, service
    # rounds) and the K1 launches of the service re-quiesces
    tab: object
    count: int
    dd_stats: Tuple[int, int, int, int]
    service_k1: int


def quiesce_fused(tab, image, m, limit: int, fused_k: int,
                  resume_steps: int, spans) -> Tuple[int, int]:
    """The fused quiesce: K1 is the step engine, the precise step only the
    park-resume leg, until no lane is RUNNING.  Terminates for the reason
    the ladder does: every round retires >= 1 instruction per RUNNING lane
    and a nonzero instruction budget bounds the rest.  Returns (precise
    sweeps, K1 launches)."""
    sweeps = launches = 0
    while bool((m.status == _RUNNING).any()):
        with spans.span("fused-step") as sp:
            pstep.fused_step(tab, image, m, limit, fused_k)
            sp.fence(m.status)
        with spans.span("device-step") as sp:
            sweeps += pstep.fused_resume(tab, image, m, limit, resume_steps)
            sp.fence(m.status)
        launches += 1
    return sweeps, launches


def quiesce_ladder(tab, image, m, limit: int, spans) -> Tuple[int, int]:
    """The precise step until no lane is RUNNING (decode misses,
    breakpoints and terminals all leave RUNNING; the nonzero instruction
    budget bounds the rest).  Returns (precise sweeps, 0)."""
    with spans.span("device-step") as sp:
        sweeps = run_steps(tab, image, m, limit, sys.maxsize)
        sp.fence(m.status)
    return sweeps, 0


def service(tab, count: int, image, m, bp_keys: torch.Tensor, n_bp: int,
            quiesce, spans):
    """Device-decode service rounds after a quiesce (the JAX window's
    `service`): compute every needy lane's block against the round-start
    table, commit the blocks in lane order, apply the lanes' deltas
    (status; on a fetch fault fault_gva, fault_write = 0 and one
    CTR_MEM_FAULT) and re-quiesce with `quiesce(tab)`.  Stops when no
    unparked lane is NEED_DECODE.  Returns (tab, count, [serviced,
    published, parked, rounds], (precise sweeps, K1 launches) of the
    re-quiesces)."""
    capacity = tab.meta_i32.shape[0]
    parked = torch.zeros_like(m.status, dtype=torch.bool)
    stats = [0, 0, 0, 0]
    sweeps = launches = 0
    while bool(((m.status == _ND) & ~parked).any()):
        with spans.span("devdec-service") as sp:
            blocks = devdec.compute_blocks(tab, image, m, bp_keys, n_bp)
            out = devdec.commit_blocks(tab, count, blocks, m.status,
                                       capacity)
            m.status.copy_(out.status)
            fm = out.fault_mask
            m.fault_gva.copy_(torch.where(fm, out.fault_gva, m.fault_gva))
            m.fault_write.copy_(torch.where(fm, 0, m.fault_write))
            m.ctr[:, CTR_MEM_FAULT] += out.mem_fault_inc
            sp.fence(m.status)
        tab, count = out.tab, out.count
        parked |= out.parked
        stats = [a + b for a, b in zip(stats, out.stats + (1,))]
        sw, ln = quiesce(tab)
        sweeps, launches = sweeps + sw, launches + ln
    return tab, count, stats, (sweeps, launches)


def window(tab, image, machine, template, slab_first: Tuple,
           slab_rest: Tuple, seeds: torch.Tensor, pfns: torch.Tensor,
           gva: int, finish: int, limit: int, n_batches: int,
           agg_cov: torch.Tensor, agg_edge: torch.Tensor, spans, dd=None,
           *, max_batches: int, len_gpr: int, ptr_gpr: int, rounds: int,
           deliver: bool, fused: bool, fused_k: int,
           fused_resume_steps: int) -> MegaOut:
    """Run one window of up to `n_batches` (<= max_batches) batches on
    `machine`, in place.  `seeds` is int64[max_batches, L] (the absolute
    batch indices' lane seeds); slabs are (data, lens, cumw) triples;
    `spans` records each phase (fenced).  `dd` is the runner's
    `devdec_operands()`: None without device decode, else (live cache
    count, pending-breakpoint keys, their live length)."""
    n_lanes = machine.n_lanes
    dev = machine.device
    B = max_batches
    serviceable = torch.tensor(
        SERVICEABLE_DELIVER if deliver else SERVICEABLE_BASE, device=dev)
    finish_t = torch.tensor(I.s64(finish), device=dev)
    statuses = torch.full((B, n_lanes), -1, dtype=torch.int32, device=dev)
    flags = torch.zeros((B, n_lanes), dtype=torch.bool, device=dev)
    ctr_sums = torch.zeros((B, N_CTRS), dtype=torch.int64, device=dev)
    new_words = torch.zeros_like(agg_cov)
    empty = MegaSnap(words=torch.zeros((n_lanes, slab_first[0].shape[1]),
                                       dtype=torch.int32, device=dev),
                     lens=torch.zeros(n_lanes, dtype=torch.int32,
                                      device=dev))
    prev = cur = empty
    b, incomplete, find_b = 0, False, B
    sweeps = launches = 0
    count, dd_stats, service_k1 = -1, (0, 0, 0, 0), 0
    if dd is not None:
        count, bp_keys, n_bp = dd
    m = machine

    def quiesce(tab):
        if fused:
            return quiesce_fused(tab, image, m, limit, fused_k,
                                 fused_resume_steps, spans)
        return quiesce_ladder(tab, image, m, limit, spans)

    while b < n_batches:
        data, lens_s, cumw = slab_first if b == 0 else slab_rest
        with spans.span("overlay-restore") as sp:
            machine_restore(m, template)
            sp.fence(m.status)
        with spans.span("generate") as sp:
            words, lens = generate(data, lens_s, cumw, seeds[b], rounds)
            sp.fence(lens)
        with spans.span("insert") as sp:
            device_insert_impl(m, words, lens, pfns, gva, len_gpr, ptr_gpr)
            sp.fence(m.status)
        sw, ln = quiesce(tab)
        sweeps, launches = sweeps + sw, launches + ln
        if dd is not None:
            tab, count, st, (sw, ln) = service(tab, count, image, m,
                                               bp_keys, n_bp, quiesce, spans)
            dd_stats = tuple(a + c for a, c in zip(dd_stats, st))
            sweeps, launches = sweeps + sw, launches + ln
            service_k1 += ln
        with spans.span("merge"):
            # declarative stop: BREAKPOINT at the finish rip == the host
            # handler's stop(Ok()) — pre-execution, so no icount or
            # coverage for the breakpointed instruction
            st = torch.where((m.status == _BP) & (m.rip == finish_t), _OK,
                             m.status).to(torch.int32)
            m.status.copy_(st)
            include = (st != _TIMEDOUT) & (st != _OVF)
            agg_c2, agg_e2, new_lane, new_w = merge_coverage(
                agg_cov, agg_edge, m.cov, m.edge, include)
            clean = (st == _OK) | (st == _TIMEDOUT) | (st == _CR3)
            # the batch's three loop-control flags in one read
            need_service, bad, found = torch.stack([
                torch.isin(st, serviceable).any(), (~clean).any(),
                new_lane.any()]).tolist()
        complete = not need_service
        if complete:
            agg_cov, agg_edge, new_words = agg_c2, agg_e2, new_w
            statuses[b] = st
            flags[b] = new_lane
            ctr_sums[b] = (m.ctr.long() & 0xFFFFFFFF).sum(0)
        prev, cur = cur, MegaSnap(words=words, lens=lens)
        if complete and found and find_b >= B:
            find_b = b
        # find-stop: after a new-coverage find at batch j the window may
        # run j+1 (its slab view is still entitled) and must then return
        # so the host folds the finds before j+2 generates; a non-clean
        # terminal stops at once so the live machine stays that batch's
        # final state for crash naming and bucketing
        stop = need_service or (complete and (bad or b > find_b))
        b += complete
        incomplete = incomplete or need_service
        if stop:
            break
    return MegaOut(agg_cov=agg_cov, agg_edge=agg_edge, batches=b,
                   incomplete=incomplete, statuses=statuses,
                   new_flags=flags, ctr_sums=ctr_sums, new_words=new_words,
                   prev=prev, cur=cur, engine_rounds=(sweeps, launches),
                   tab=tab, count=count, dd_stats=dd_stats,
                   service_k1=service_k1)


def make_megachunk(max_batches: int, len_gpr: int, ptr_gpr: int,
                   rounds: int, deliver: bool, fused: bool = False,
                   fused_k: int = 32, fused_resume_steps: int = 1):
    """The single-device window for one insert ABI and step engine:
    (tab, image, machine, template, slab_first, slab_rest, seeds, pfns,
    gva, finish, limit, n_batches, agg_cov, agg_edge, spans, dd) ->
    MegaOut."""
    return functools.partial(
        window, max_batches=max_batches, len_gpr=len_gpr, ptr_gpr=ptr_gpr,
        rounds=rounds, deliver=deliver, fused=fused, fused_k=fused_k,
        fused_resume_steps=fused_resume_steps)
