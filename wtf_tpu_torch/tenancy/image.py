"""The stacked image table: many snapshots behind one dispatch operand.

The counterpart of wtf_tpu/tenancy/image.py.  Every tenant's `PhysMem`
packs into ONE device image:

  pages        all tenants' present pages concatenated behind the shared
               zero page (slot 0), total row count padded to a power of
               two (the same padding policy as PhysMem.from_pages);
  frame_table  one pfn->slot row per tenant, padded to a COMMON page
               span (the max of the tenants' spans) — absent/padded pfns
               resolve to slot 0, the shared zero page, preserving the
               reference's zero-fill semantics per tenant;
  tenant       the per-lane row selector (int32[L]) — which base image a
               lane interprets against.

Heterogeneity is thereby pure DATA: the step and the fused kernel see one
pages tensor, one [T, span] table and one selector vector; the kernel
picks the lane's row (`tenant * nframes`) and tags its decode-cache probe
key with the tenant (`uoptable.tag_key`).

`build_batch_state` also concatenates per-tenant Machine batches (each
lane initialized from its tenant's CpuState — per-lane cr3/rip/MSRs are
already per-lane state, so the heterogeneous machine needs no new
fields) and returns the host-side routing tables the Runner's servicing
loop uses (per-lane PhysMem / CpuState).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from wtf_tpu_torch.interp.machine import Machine, machine_init
from wtf_tpu_torch.mem.overlay import DirtyOverlay, overlay_init
from wtf_tpu_torch.mem.physmem import MemImage, PAGE_WORDS, _next_pow2

MAX_TENANTS = 1 << 15  # the tag_key tenant field (bits 48..62)


def stack_images(physmems: Sequence, device="cpu") -> MemImage:
    """Pack tenants' PhysMems into one stacked MemImage on `device`
    (tenant=None — the caller attaches the per-lane selector)."""
    if not physmems:
        raise ValueError("stack_images needs at least one tenant image")
    if len(physmems) > MAX_TENANTS:
        raise ValueError(f"{len(physmems)} tenants exceed the "
                         f"{MAX_TENANTS} tag-key limit")
    span = max(pm.frame_table.shape[-1] for pm in physmems)
    tables = np.zeros((len(physmems), span), dtype=np.int32)
    bodies: List[np.ndarray] = []
    cur = 1  # slot 0 stays the shared zero page
    for t, pm in enumerate(physmems):
        body = pm.pages[1:]                            # drop its zero page
        tbl = pm.frame_table[0]                        # [span_t]
        tables[t, :tbl.shape[0]] = np.where(tbl != 0, tbl + (cur - 1), 0)
        bodies.append(body)
        cur += body.shape[0]
    total = _next_pow2(cur)
    stacked = np.zeros((total, PAGE_WORDS), dtype=np.uint64)
    pos = 1
    for body in bodies:
        stacked[pos:pos + body.shape[0]] = body
        pos += body.shape[0]
    return MemImage(pages=torch.from_numpy(stacked.view(np.int64)).to(device),
                    frame_table=torch.from_numpy(tables).to(device))


def _concat_machines(machines: Sequence[Machine]) -> Machine:
    if len(machines) == 1:
        return machines[0]
    kw = {f.name: torch.cat([getattr(m, f.name) for m in machines])
          for f in dataclasses.fields(Machine) if f.name != "overlay"}
    ov = {f.name: torch.cat([getattr(m.overlay, f.name) for m in machines])
          for f in dataclasses.fields(DirtyOverlay)}
    return Machine(**kw, overlay=DirtyOverlay(**ov))


@dataclasses.dataclass
class BatchState:
    """What a heterogeneous Runner dispatches and routes with."""

    image: MemImage            # stacked, tenant selector populated
    machine: Machine           # per-tenant lane blocks concatenated
    template: Machine          # pristine restore template, same layout
    tenant_of_lane: np.ndarray  # int32[L]
    physmems: List            # per-tenant PhysMem (host reads)
    cpus: List                # per-tenant CpuState (oracle / delivery)


def build_batch_state(tenants: Sequence, n_lanes: int, uop_capacity: int,
                      overlay_slots: int, edge_bits: int,
                      device="cpu") -> BatchState:
    """Build the heterogeneous batch from a tenant table.

    `tenants` is a sequence of objects with `.snapshot` (a loaded
    Snapshot) and `.lanes` (the tenant's lane quota); lane ranges are
    assigned in table order and must fit the batch (unplaced trailing
    lanes idle)."""
    quotas = [int(t.lanes) for t in tenants]
    if any(q <= 0 for q in quotas):
        raise ValueError(f"tenant lane quotas must be positive: {quotas}")
    if sum(quotas) > n_lanes:
        raise ValueError(
            f"tenant quotas {quotas} sum to {sum(quotas)} but the batch "
            f"has only {n_lanes} lanes")
    physmems = [t.snapshot.physmem for t in tenants]
    cpus = [t.snapshot.cpu for t in tenants]
    image = stack_images(physmems, device)
    tenant_of_lane = np.repeat(
        np.arange(len(tenants), dtype=np.int32), quotas)
    rows = [(t.snapshot.cpu, q) for t, q in zip(tenants, quotas)]
    pad = n_lanes - sum(quotas)
    if pad:
        # unplaced trailing lanes idle (the backend marks them OK before
        # every run); they carry tenant 0's state so no extra image rows
        tenant_of_lane = np.concatenate(
            [tenant_of_lane, np.zeros(pad, dtype=np.int32)])
        rows.append((tenants[0].snapshot.cpu, pad))
    # the per-tenant blocks are built without overlay rows, and the batch
    # gets ONE fresh overlay (its initial state is tenant-independent), so
    # no transient copy of the [L, slots, words] planes is made
    template = _concat_machines([
        machine_init(cpu, q, uop_capacity, 0, edge_bits, device)
        for cpu, q in rows])
    machine = template.clone()
    machine.overlay = overlay_init(n_lanes, overlay_slots, device)
    return BatchState(
        image=dataclasses.replace(
            image, tenant=torch.from_numpy(tenant_of_lane).to(device)),
        machine=machine,
        template=template,
        tenant_of_lane=tenant_of_lane,
        physmems=physmems,
        cpus=cpus,
    )
