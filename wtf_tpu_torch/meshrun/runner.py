"""MeshRunner: the Runner with its lane axis split over a lane mesh.

The counterpart of wtf_tpu/meshrun/runner.py.  One MeshRunner is one
snapshot on every shard of the mesh: `n_lanes` in all, `n_lanes /
mesh.global_size` per shard.  The host servicing loop, the decode cache,
the oracle fallback, breakpoint dispatch, the fused round and telemetry
are the base Runner's; the subclass re-points the device seams:

  * the per-shard Machines (`shards`, views of the machine the base
    Runner built where a shard lies on its device) are the truth; the
    image, the decode table and the devmut slab are copied once per
    distinct device, the image's `tenant` row cut with the lanes;
  * `machine` is a MeshMachine: the host seams (the per-chunk status
    read, HostView, the backend's result and coverage reads, the
    supervisor's integrity check) read planes gathered on the first
    shard's device, and their writes scatter back before the next device
    work on the shards — never inside a fused round;
  * the chunk, K1 and the resume leg run through the mesh executors
    (meshrun/executor.py): per shard, with shard-local early exit, and
    the chunk and the resume leg leave the mesh's merged cov/edge
    bitmaps for `merged_coverage()`;
  * push's page writes, the device insert and the restore act per shard
    on the shard's own lanes;
  * on a multi-process mesh (meshrun/mesh.init_multihost) `n_lanes` is
    the global batch: every process runs this same host loop on the
    same gathered planes, and holds only its own shards' lanes;
  * the devmut generator runs per shard over the shard's slice of the
    lane-seed stream (the same per-lane program, so the byte stream is
    the single-device one);
  * device counters fold per shard (`device.shard_instructions{i}`) on
    top of the merged `device.*` view, and K1's dispatches count per
    shard (`device.shard_fused_dispatches{i}`: kernel launches on a
    card, plain-version calls on the CPU).

  * the megachunk window runs per shard (fuzz/megachunk.py
    `make_mesh_megachunk`), its operands placed by `megachunk_place`:
    the slabs copied once per distinct device and slab version, the
    seed stream cut with the lanes; K1's launches inside it count per
    shard too;
  * with `device_decode`, the window's service commits every shard's
    blocks at once, and the host service's code windows are gathered per
    shard on the shard's lanes (`_code_windows`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wtf_tpu_torch.interp.machine import CTR_INSTR, Machine, machine_restore
from wtf_tpu_torch.interp.runner import (
    Runner, _apply_page_writes, device_insert_impl,
)
from wtf_tpu_torch.meshrun.executor import (
    make_mesh_chunk, make_mesh_fused, make_mesh_resume,
)
from wtf_tpu_torch.meshrun.mesh import (
    LaneMesh, MeshMachine, gather_processes, lane_sharding, make_mesh,
    replicate, shard_image, shard_machine, split_lanes,
)


class MeshRunner(Runner):
    """Runner whose batch spans a LaneMesh over the lane axis."""

    def __init__(self, snapshot, n_lanes: int, mesh: Optional[LaneMesh] = None,
                 mesh_devices: Optional[int] = None, device="cuda",
                 **kwargs):
        self.mesh = mesh if mesh is not None else make_mesh(mesh_devices,
                                                            device)
        if n_lanes % self.mesh.global_size:
            raise ValueError(
                f"n_lanes={n_lanes} does not divide over the "
                f"{self.mesh.global_size}-shard mesh — the lane axis "
                f"shards evenly (lanes_per_shard x shards)")
        super().__init__(snapshot, n_lanes, device=self.mesh.devices[0],
                         **kwargs)
        self.shards: List[Machine] = shard_machine(self.machine, self.mesh)
        self._templates = shard_machine(self.template, self.mesh)
        self.images = shard_image(self.image, self.mesh)
        self.machine = MeshMachine(self.shards, self.mesh)
        self.template = MeshMachine(self._templates, self.mesh)
        self._tab_src = None
        self._tab_repl: Dict = {}
        self._slab_src = None
        self._slab_repl: Dict = {}
        self._merged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._k1_live: Optional[List[bool]] = None

    @property
    def lanes_per_shard(self) -> int:
        return self.n_lanes // self.mesh.global_size

    def _locate(self, lane: int) -> Optional[Tuple[int, int]]:
        """(local shard, lane within it) of a global lane; None where
        another process holds it."""
        s, local = divmod(lane, self.lanes_per_shard)
        s -= self.mesh.first_shard
        return (s, local) if 0 <= s < self.mesh.size else None

    @contextmanager
    def _on_shards(self):
        """Device work on the shards: host writes into gathered planes
        land first, and the gathers it makes stale are dropped after."""
        self.machine.flush()
        try:
            yield
        finally:
            self.machine.drop()

    # -- dispatch surface --------------------------------------------------
    def device_tab(self):
        """The decode table on every distinct device of the mesh, copied
        again only when the cache's device table changed."""
        tab = self.cache.device(self.device)
        if tab is not self._tab_src:  # cache.device() memoizes when clean
            self._tab_src = tab
            self._tab_repl = replicate(tab, self.mesh)
        return self._tab_repl

    def _chunk(self, tab, size: int):
        with self._on_shards():
            _, cov, edge = make_mesh_chunk(size, self.mesh)(
                tab, self.images, self.shards, self.limit)
            self._merged = (cov, edge)
        return self.machine

    def _k1(self, tab) -> Machine:
        """K1 on every shard with a RUNNING lane; which shards it ran on
        is kept for the resume leg that follows."""
        with self._on_shards():
            self._k1_live = make_mesh_fused(self.fused_k, self.mesh)(
                tab, self.images, self.shards, self.limit)
        self._count_k1([int(x) for x in self._k1_live])
        return self.machine

    def _count_k1(self, per_shard) -> None:
        by_shard = self.registry.counter("device.shard_fused_dispatches")
        for s, n in enumerate(per_shard):
            if n:
                by_shard.labels(str(self.mesh.first_shard + s)).inc(n)

    def _resume_leg(self, tab) -> Machine:
        with self._on_shards():
            _, cov, edge = make_mesh_resume(self.fused_resume_steps,
                                            self.mesh)(
                tab, self.images, self.shards, self.limit, self._k1_live)
            self._merged = (cov, edge)
        return self.machine

    def megachunk_callable(self, max_batches: int, len_gpr: int,
                           ptr_gpr: int, rounds: int):
        """The megachunk window per shard (fuzz/megachunk.py
        `make_mesh_megachunk`) behind the single-device window's
        signature: it runs on the shards and their images whatever
        machine and image the caller passes, with host writes into
        gathered planes landed first and the gathers it makes stale
        dropped after."""
        from wtf_tpu_torch.fuzz.megachunk import make_mesh_megachunk

        fn = make_mesh_megachunk(max_batches, len_gpr, ptr_gpr, rounds,
                                 deliver=self.deliver_exceptions,
                                 mesh=self.mesh,
                                 fused=bool(self.fused_enabled),
                                 fused_k=self.fused_k,
                                 fused_resume_steps=self.fused_resume_steps)

        def run(tab, _image, _machine, _template, *operands):
            with self._on_shards():
                out = fn(tab, self.images, self.machine, self.template,
                         *operands)
            self._merged = None
            self._count_k1(out.shard_k1)
            return out

        return run

    def megachunk_place(self, slab_first, slab_rest, seeds):
        """One window's operands placed for the shards: the slabs copied
        once per distinct device and per slab version (shared with
        `devmut_generate`'s copy), the seed stream [B, L] cut with the
        lanes."""
        if slab_rest[0] is not self._slab_src:
            self._slab_src = slab_rest[0]
            self._slab_repl = replicate(slab_rest, self.mesh)
        rest = self._slab_repl
        first = (rest if slab_first[0] is slab_rest[0]
                 else replicate(slab_first, self.mesh))
        cut = [seeds[:, lo:hi].to(d)
               for d, lo, hi in lane_sharding(self.mesh, seeds.shape[1])]
        return first, rest, cut

    def _code_windows(self, rips: torch.Tensor, idx: torch.Tensor):
        """The host decode service's code windows (devdec.gather_windows)
        per shard, for the asked lanes it holds; on a multi-process mesh
        each process fills its own lanes' rows and one all-gather hands
        every process every row."""
        from wtf_tpu_torch.interp import devdec

        self.machine.flush()
        dev = self.device
        k = idx.shape[0]
        rows = torch.zeros((k, 18), dtype=torch.int64, device=dev)
        idx_h = idx.cpu()
        for s, (lo, hi) in enumerate(self.mesh.bounds(self.n_lanes)):
            sel = ((idx_h >= lo) & (idx_h < hi)).nonzero()[:, 0]
            if not len(sel):
                continue
            m = self.shards[s]
            with self.mesh.scope(s):
                win, fault, pfn0, pfn14 = devdec.gather_windows(
                    self.images[s], m.overlay, m.cr3,
                    rips[lo:hi].to(m.device), (idx_h[sel] - lo).to(m.device))
            rows[sel.to(dev)] = torch.cat(
                [win.long(), fault.long()[:, None], pfn0.long()[:, None],
                 pfn14.long()[:, None]], 1).to(dev)
        if self.mesh.world > 1:
            owner = idx_h // (self.n_lanes // self.mesh.world)
            rows = gather_processes(rows[None], self.mesh)[
                owner.to(dev), torch.arange(k, device=dev)]
        return (rows[:, :15].to(torch.uint8), rows[:, 15].bool(),
                rows[:, 16].to(torch.int32), rows[:, 17].to(torch.int32))

    # -- host write seams: per shard, on the shard's lanes ---------------
    def overlay_row(self, lane: int, slot: int):
        """The row from the shard that holds the lane.  Every process asks
        for the same row (one host loop), so on a multi-process mesh the
        owner's copy is all-gathered — one row, never the plane."""
        # another process's lane: any row of the same shape stands in
        s, local = self._locate(lane) or (0, 0)
        ov = self.shards[s].overlay
        row = [ov.data[local, slot], ov.valid[local, slot]]
        if self.mesh.world > 1:
            owner = lane // (self.n_lanes // self.mesh.world)
            row = [gather_processes(t[None], self.mesh)[owner] for t in row]
        return tuple(t.cpu().numpy() for t in row)

    def _apply_pages(self, items) -> None:
        by_shard: Dict[int, list] = {}
        for lane, pfn, page in items:
            where = self._locate(lane)
            if where is not None:
                by_shard.setdefault(where[0], []).append(
                    (where[1], pfn, page))
        with self._on_shards():
            for s, local_items in by_shard.items():
                with self.mesh.scope(s):
                    _apply_page_writes(self.shards[s], local_items)

    def _insert(self, words, lens, pfns, gva, len_gpr, ptr_gpr,
                active=None) -> Machine:
        pfns_on = replicate(pfns, self.mesh)
        cut = [split_lanes(t, self.mesh) if t is not None
               else [None] * self.mesh.size for t in (words, lens, active)]
        with self._on_shards():
            for s, m in enumerate(self.shards):
                with self.mesh.scope(s):
                    device_insert_impl(m, cut[0][s], cut[1][s],
                                       pfns_on[m.device], gva, len_gpr,
                                       ptr_gpr, cut[2][s])
        return self.machine

    def _restore_machine(self) -> None:
        self.machine.drop()  # a restore overwrites every plane
        for s, (m, t) in enumerate(zip(self.shards, self._templates)):
            with self.mesh.scope(s):
                machine_restore(m, t)
        self._merged = None

    # -- the merged coverage of the last chunk ----------------------------
    def merged_coverage(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(cov, edge) bitmaps OR-merged across every lane of every shard
        as of the last dispatched chunk or resume leg — two [words] reads,
        never a [lanes, words] gather.  None before the first chunk of a
        run (or right after restore)."""
        if self._merged is None:
            return None
        return tuple(t.cpu().numpy() for t in self._merged)

    # -- devmut seam ------------------------------------------------------
    def devmut_generate(self, rounds: int, data, lens, cumw, seeds):
        """The devmut batch generated per shard: the corpus slab copied
        once per distinct device and per slab VERSION (DeviceCorpus.arrays
        returns the same tensors until an add dirties the slab), the seed
        stream cut with the lanes; the testcases of every shard (of every
        process) come back as one batch on the first shard's device."""
        from wtf_tpu_torch.devmut.engine import generate

        if data is not self._slab_src:
            self._slab_src = data
            self._slab_repl = replicate((data, lens, cumw), self.mesh)
        outs = []
        for s, part in enumerate(split_lanes(seeds, self.mesh)):
            d, n, c = self._slab_repl[part.device]
            with self.mesh.scope(s):
                outs.append(generate(d, n, c, part, rounds))
        return tuple(gather_processes(torch.cat(
            [o[i].to(self.device) for o in outs]), self.mesh)
            for i in (0, 1))

    # -- telemetry --------------------------------------------------------
    def fold_device_counters(self) -> np.ndarray:
        """The merged `device.*` fold (base class) plus the per-shard view
        `device.shard_instructions{<shard>}`: the counters that show a
        cold or straggling shard.  Shard i owns lanes [i*L/S,
        (i+1)*L/S)."""
        ctr = super().fold_device_counters()
        per = ctr.reshape(self.mesh.global_size, self.lanes_per_shard,
                          ctr.shape[1]).sum(axis=1, dtype=np.uint64)
        by_shard = self.registry.counter("device.shard_instructions")
        for s in range(self.mesh.global_size):
            by_shard.labels(str(s)).inc(int(per[s, CTR_INSTR]))
        return ctr
