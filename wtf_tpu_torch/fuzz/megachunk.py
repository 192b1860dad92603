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

The mesh window (`make_mesh_megachunk`, the JAX package's shard_map
form) runs the same body per shard of a lane mesh (meshrun/): restore,
generate over the shard's slice of the seed stream, insert and quiesce act
on each shard's own lanes (the quiesce's loop condition is shard-local,
so each shard takes the K1 rounds its lanes need), while every decision
of the batch — need service, non-clean terminal, new coverage, another
service round — is one read of every shard's flags (across processes on
a multi-process mesh), so all shards take the same batches.  The merge is
the mesh merge (meshrun/reduce.make_mesh_merge), the counter totals and
the engine rounds are sums over the shards, and the device-decode service
gathers every shard's blocks and statuses in global lane order for ONE
commit, whose table is copied to each distinct device and whose per-lane
outputs each shard takes at its own lane span — so the table's slot order
and the coverage bits it indexes are those of the single-device window.
A single device is the mesh of one shard with the plain merge.

The machine is updated in place (the JAX window donates it): K1, the
restore and the insert write its planes where they lie, and the planes the
precise step binds anew are copied back into their storage when the window
ends, so every plane keeps its storage across a window.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.devmut.engine import generate
from wtf_tpu_torch.interp import devdec
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.interp.machine import (
    CTR_MEM_FAULT, N_CTRS, Machine, machine_restore,
)
from wtf_tpu_torch.interp.runner import device_insert_impl
from wtf_tpu_torch.meshrun.executor import fence_each, quiesce_shards
from wtf_tpu_torch.meshrun.mesh import (
    LaneMesh, gather_lanes, gather_processes, replicate,
)
from wtf_tpu_torch.meshrun.reduce import (
    gather_shards, make_mesh_merge, merge_coverage,
)

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
    # step-engine rounds over the window, summed over the shards:
    # [precise sweeps, K1 launches] (service re-quiesces included)
    engine_rounds: Tuple[int, int]
    # device decode (the inputs when the window runs without it): the
    # table with the device-published rows, its live count (-1 without),
    # the stats (serviced lanes, published entries, parked lanes, service
    # rounds) and the K1 launches of the service re-quiesces
    tab: object
    count: int
    dd_stats: Tuple[int, int, int, int]
    service_k1: int
    # the machine the window ran on, in place (what scripted poison
    # corrupts, as on the JAX window's output)
    machine: object = None
    # K1 launches per shard of this process, in shard order
    shard_k1: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Lanes:
    """Where a window's lanes live: the shards of `mesh` (one shard for
    a single device), each with its machine, template and image, and
    the batch merge over them."""

    mesh: LaneMesh
    machines: list
    templates: list
    images: list
    merge: object   # (agg_cov, agg_edge, covs, edges, includes) ->
                    # (agg_cov', agg_edge', new_lanes, new_words)

    @property
    def bounds(self):
        """Global (lo, hi) lane span of each local shard."""
        n = sum(m.n_lanes for m in self.machines) * self.mesh.world
        return self.mesh.bounds(n)

    def any(self, flags: List[torch.Tensor]) -> list:
        """Per shard a bool vector of k flags -> k Python bools, each
        OR-ed over every shard of the mesh: one host read (the JAX
        window's `any_fn`, a pmax over the lane axis)."""
        return gather_shards(flags, self.mesh).any(0).tolist()


_REGISTER_PLANES = tuple(f.name for f in dataclasses.fields(Machine)
                         if f.name != "overlay")


def _keep_storage(m: Machine, held: dict) -> None:
    """Copy each plane `m` bound anew since `held` was taken back into
    the held tensor, and bind that again."""
    for name, t in held.items():
        now = getattr(m, name)
        if now is not t:
            t.copy_(now)
            setattr(m, name, t)


def _merge_one(agg_cov, agg_edge, covs, edges, includes):
    agg_c, agg_e, new_lane, new_w = merge_coverage(
        agg_cov, agg_edge, covs[0], edges[0], includes[0])
    return agg_c, agg_e, [new_lane], new_w


def service(tabs, count: int, lanes: _Lanes, bp_keys, n_bp: int, quiesce,
            spans):
    """Device-decode service rounds after a quiesce (the JAX window's
    `service`): every shard computes its needy lanes' blocks against the
    round-start table; the blocks and statuses of every shard, gathered
    in global lane order, go through ONE commit; each shard applies its
    lane span of the commit's deltas (status; on a fetch fault fault_gva,
    fault_write = 0 and one CTR_MEM_FAULT), the new table is copied to
    each distinct device, and the shards re-quiesce with `quiesce(tabs)`.
    Stops when no unparked lane of any shard is NEED_DECODE.  Returns
    (tabs, count, [serviced, published, parked, rounds], (precise sweeps,
    K1 launches per shard) of the re-quiesces)."""
    mesh, ms = lanes.mesh, lanes.machines
    dev0 = mesh.devices[0]
    capacity = tabs[dev0].meta_i32.shape[0]
    parked = [torch.zeros_like(m.status, dtype=torch.bool) for m in ms]
    stats = [0, 0, 0, 0]
    sweeps, launches = 0, [0] * len(ms)
    while lanes.any([((m.status == _ND) & ~p).any()[None]
                     for m, p in zip(ms, parked)])[0]:
        with spans.span("devdec-service") as sp:
            blocks = []
            for i, m in enumerate(ms):
                with mesh.scope(i):
                    blocks.append(devdec.compute_blocks(
                        tabs[m.device], lanes.images[i], m,
                        bp_keys[m.device], n_bp))
            out = devdec.commit_blocks(
                tabs[dev0], count,
                devdec.LaneBlock(*(gather_lanes(f, mesh)
                                   for f in zip(*blocks))),
                gather_lanes([m.status for m in ms], mesh), capacity)
            # the commit's per-lane outputs are in global lane order:
            # each shard takes its own span
            for i, (m, (lo, hi)) in enumerate(zip(ms, lanes.bounds)):
                part = slice(lo, hi)
                fm = out.fault_mask[part].to(m.device)
                m.status.copy_(out.status[part])
                m.fault_gva.copy_(torch.where(
                    fm, out.fault_gva[part].to(m.device), m.fault_gva))
                m.fault_write.copy_(torch.where(fm, 0, m.fault_write))
                m.ctr[:, CTR_MEM_FAULT] += out.mem_fault_inc[part].to(
                    m.device)
                parked[i] |= out.parked[part].to(m.device)
            fence_each(sp, [m.status for m in ms])
        tabs, count = replicate(out.tab, mesh), out.count
        stats = [a + b for a, b in zip(stats, out.stats + (1,))]
        sw, ln = quiesce(tabs)
        sweeps += sw
        launches = [a + b for a, b in zip(launches, ln)]
    return tabs, count, stats, (sweeps, launches)


def window(tab, image, machine, template, slab_first, slab_rest, seeds,
           pfns: torch.Tensor, gva: int, finish: int, limit: int,
           n_batches: int, agg_cov: torch.Tensor, agg_edge: torch.Tensor,
           spans, dd=None, *, max_batches: int, len_gpr: int, ptr_gpr: int,
           rounds: int, deliver: bool, fused: bool, fused_k: int,
           fused_resume_steps: int, mesh: LaneMesh = None) -> MegaOut:
    """Run one window of up to `n_batches` (<= max_batches) batches, in
    place.  `seeds` is int64[max_batches, L] (the absolute batch indices'
    lane seeds); slabs are (data, lens, cumw) triples; `spans` records
    each phase (fenced).  `dd` is the runner's `devdec_operands()`: None
    without device decode, else (live cache count, pending-breakpoint
    keys, their live length).

    With `mesh` the operands arrive placed for it (MeshRunner): `tab` and
    the slabs are {device: value} for each distinct device, `image` the
    list of per-shard images, `machine` and `template` MeshMachines (the
    shards are their `.shards`), `seeds` the list of per-shard
    int64[max_batches, L_shard] slices."""
    if mesh is None:
        dev = machine.device
        lanes = _Lanes(LaneMesh([dev]), [machine], [template], [image],
                       _merge_one)
        tabs = {dev: tab}
        slab_first, slab_rest = {dev: slab_first}, {dev: slab_rest}
        seeds = [seeds]
    else:
        lanes = _Lanes(mesh, machine.shards, template.shards, list(image),
                       make_mesh_merge(mesh))
        tabs = tab
    mesh, ms, ts = lanes.mesh, lanes.machines, lanes.templates
    dev0 = mesh.devices[0]
    B = max_batches
    consts = replicate((torch.tensor(SERVICEABLE_DELIVER if deliver
                                     else SERVICEABLE_BASE),
                        torch.tensor(I.s64(finish)), pfns), mesh)
    statuses = [torch.full((B, m.n_lanes), -1, dtype=torch.int32,
                           device=m.device) for m in ms]
    flags = [torch.zeros((B, m.n_lanes), dtype=torch.bool, device=m.device)
             for m in ms]
    # this process's shards' per-batch counter totals (u64 sums, two's
    # complement); the processes' are summed at the end of the window
    ctr_sums = torch.zeros((B, N_CTRS), dtype=torch.int64, device=dev0)
    new_words = torch.zeros_like(agg_cov)
    empty = [(torch.zeros((m.n_lanes, next(iter(slab_first.values()))[0]
                           .shape[1]), dtype=torch.int32, device=m.device),
              torch.zeros(m.n_lanes, dtype=torch.int32, device=m.device))
             for m in ms]
    prev = cur = empty
    b, incomplete, find_b = 0, False, B
    sweeps, shard_k1, service_k1 = 0, [0] * len(ms), 0
    count, dd_stats = -1, (0, 0, 0, 0)
    if dd is not None:
        count, bp_keys, n_bp = dd
        bp_keys = replicate(bp_keys, mesh)

    held = [{n: getattr(m, n) for n in _REGISTER_PLANES} for m in ms]

    def quiesce(tabs):
        return quiesce_shards(tabs, lanes.images, ms, limit, mesh, spans,
                              fused_k if fused else None,
                              fused_resume_steps)

    while b < n_batches:
        slab = slab_first if b == 0 else slab_rest
        with spans.span("overlay-restore") as sp:
            for i, (m, t) in enumerate(zip(ms, ts)):
                with mesh.scope(i):
                    machine_restore(m, t)
            fence_each(sp, [m.status for m in ms])
        with spans.span("generate") as sp:
            gen = []
            for i, m in enumerate(ms):
                data, lens_s, cumw = slab[m.device]
                with mesh.scope(i):
                    gen.append(generate(data, lens_s, cumw, seeds[i][b],
                                        rounds))
            fence_each(sp, [g[1] for g in gen])
        with spans.span("insert") as sp:
            for i, (m, (words, lens)) in enumerate(zip(ms, gen)):
                with mesh.scope(i):
                    device_insert_impl(m, words, lens, consts[m.device][2],
                                       gva, len_gpr, ptr_gpr)
            fence_each(sp, [m.status for m in ms])
        sw, ln = quiesce(tabs)
        sweeps += sw
        shard_k1 = [a + c for a, c in zip(shard_k1, ln)]
        if dd is not None:
            tabs, count, st, (sw, ln) = service(tabs, count, lanes, bp_keys,
                                                n_bp, quiesce, spans)
            dd_stats = tuple(a + c for a, c in zip(dd_stats, st))
            sweeps += sw
            shard_k1 = [a + c for a, c in zip(shard_k1, ln)]
            service_k1 += sum(ln)
        with spans.span("merge"):
            sts, includes, local = [], [], []
            for m in ms:
                serviceable, finish_t, _ = consts[m.device]
                # declarative stop: BREAKPOINT at the finish rip == the
                # host handler's stop(Ok()) — pre-execution, so no icount
                # or coverage for the breakpointed instruction
                st = torch.where((m.status == _BP) & (m.rip == finish_t),
                                 _OK, m.status).to(torch.int32)
                m.status.copy_(st)
                sts.append(st)
                includes.append((st != _TIMEDOUT) & (st != _OVF))
                clean = (st == _OK) | (st == _TIMEDOUT) | (st == _CR3)
                local.append(torch.stack([torch.isin(st, serviceable).any(),
                                          (~clean).any()]))
            agg_c2, agg_e2, new_lanes, new_w = lanes.merge(
                agg_cov, agg_edge, [m.cov for m in ms],
                [m.edge for m in ms], includes)
            # the batch's three loop-control flags, over every shard, in
            # one read
            need_service, bad, found = lanes.any([
                torch.cat([f, n.any()[None]])
                for f, n in zip(local, new_lanes)])
        complete = not need_service
        if complete:
            agg_cov, agg_edge, new_words = agg_c2, agg_e2, new_w
            for i, m in enumerate(ms):
                statuses[i][b] = sts[i]
                flags[i][b] = new_lanes[i]
                ctr_sums[b] += (m.ctr.long() & 0xFFFFFFFF).sum(0).to(dev0)
        prev, cur = cur, gen
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
    for m, h in zip(ms, held):
        _keep_storage(m, h)

    def lane_major(parts):
        """Per-shard [B, L_shard] -> [B, L] of every lane of the mesh."""
        return gather_lanes([p.T for p in parts], mesh).T

    def snap(per_shard):
        return MegaSnap(words=gather_lanes([w for w, _ in per_shard], mesh),
                        lens=gather_lanes([n for _, n in per_shard], mesh))

    totals = gather_processes(
        torch.tensor([[sweeps, sum(shard_k1), service_k1]]), mesh).sum(0)
    sweeps, launches, service_k1 = (int(x) for x in totals)
    return MegaOut(agg_cov=agg_cov, agg_edge=agg_edge, batches=b,
                   incomplete=incomplete, statuses=lane_major(statuses),
                   new_flags=lane_major(flags),
                   ctr_sums=gather_processes(ctr_sums[None], mesh).sum(0),
                   new_words=new_words, prev=snap(prev), cur=snap(cur),
                   engine_rounds=(sweeps, launches), tab=tabs[dev0],
                   count=count, dd_stats=dd_stats, service_k1=service_k1,
                   machine=machine, shard_k1=shard_k1)


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


def make_mesh_megachunk(max_batches: int, len_gpr: int, ptr_gpr: int,
                        rounds: int, deliver: bool, mesh: LaneMesh,
                        fused: bool = False, fused_k: int = 32,
                        fused_resume_steps: int = 1):
    """The window per shard of `mesh`, with the same signature, its
    operands placed by MeshRunner.megachunk_place (see `window`); device
    decode rides on the `dd` operands, as on one device."""
    return functools.partial(
        window, max_batches=max_batches, len_gpr=len_gpr, ptr_gpr=ptr_gpr,
        rounds=rounds, deliver=deliver, fused=fused, fused_k=fused_k,
        fused_resume_steps=fused_resume_steps, mesh=mesh)
