"""MeshBackend: a whole lane mesh behind the one-logical-backend seam.

The counterpart of wtf_tpu/meshrun/backend.py.  `FuzzLoop`, the dist
clients, triage, the CLI commands and every target module see an ordinary
batched backend whose lane count happens to be `lanes_per_shard x
shards` — the reference's process-per-core fan-out collapsed into one
process driving every shard.  Its deltas over GpuBackend, all behind
existing seams:

  * the runner is a MeshRunner (per-shard machines, the image and the
    decode table copied once per distinct device, the mesh executors);
  * the batch coverage merge (`_merge_lanes`) is the mesh merge
    (meshrun/reduce.make_mesh_merge): the same prefix-credit core per
    shard, the aggregates copied to each distinct device for it and
    kept on the first shard's — per batch, the bytes that cross shards
    are the [shards, words] union gather and nothing else;
  * the gauges `mesh.devices` / `mesh.lanes_per_shard` and the per-shard
    counters `device.shard_instructions` (MeshRunner.fold_device_counters)
    join the telemetry registry.

`mesh_devices` picks the mesh (make_mesh: N cards, N shards of the CPU;
0 = every visible device); `mesh=` passes a LaneMesh built by the caller
instead: one whose shards share a card, or the multi-process mesh of
`init_multihost` (`campaign --coordinator`), where `n_lanes` is the
global batch and every process drives this same backend.  The megachunk
window runs per shard behind GpuBackend.run_megachunk's seams (the
runner's `megachunk_callable` and `megachunk_place`): its merged
aggregates land on the first shard's device, and the device-decode
harvest and the `devdec.*`, `megachunk.*` and `device.fused_window_*`
counters are read once per window, for the whole mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wtf_tpu_torch.backend.gpu import GpuBackend, alias_bytes
from wtf_tpu_torch.meshrun.mesh import (
    LaneMesh, gather_processes, make_mesh, split_lanes,
)
from wtf_tpu_torch.meshrun.reduce import make_mesh_merge
from wtf_tpu_torch.meshrun.runner import MeshRunner


class MeshBackend(GpuBackend):
    """GpuBackend whose batch spans a lane mesh (CLI: --mesh-devices)."""

    def __init__(self, snapshot, n_lanes: int = 64,
                 mesh_devices: Optional[int] = None,
                 mesh: Optional[LaneMesh] = None, **kwargs):
        super().__init__(snapshot, n_lanes=n_lanes, **kwargs)
        self._mesh_devices = mesh_devices or None
        self._given_mesh = mesh
        self.mesh: Optional[LaneMesh] = None
        self._mesh_merge = None

    def initialize(self) -> None:
        self.mesh = (self._given_mesh if self._given_mesh is not None
                     else make_mesh(self._mesh_devices,
                                    self._runner_kwargs.get("device",
                                                            "cuda")))
        kwargs = {k: v for k, v in self._runner_kwargs.items()
                  if k != "device"}
        self.runner = MeshRunner(self.snapshot, self.n_lanes,
                                 mesh=self.mesh, registry=self.registry,
                                 events=self.events,
                                 supervisor=self.supervisor, **kwargs)
        first = self.runner.shards[0]
        self._agg_cov = torch.zeros_like(first.cov[0])
        self._agg_edge = torch.zeros_like(first.edge[0])
        self._mesh_merge = make_mesh_merge(self.mesh)
        self.registry.gauge("mesh.devices").set(self.mesh.global_size)
        self.registry.gauge("mesh.lanes_per_shard").set(
            self.runner.lanes_per_shard)

    def _merge_lanes(self, agg_cov, agg_edge, keep: np.ndarray):
        runner = self.runner
        runner.machine.flush()
        shards = runner.shards
        include = split_lanes(torch.from_numpy(keep).to(runner.device),
                              self.mesh)
        agg_cov, agg_edge, new_lanes, new_words = self._mesh_merge(
            agg_cov, agg_edge, [m.cov for m in shards],
            [m.edge for m in shards], include)
        new_lane = gather_processes(
            torch.cat([n.to(runner.device) for n in new_lanes]), self.mesh)
        return (agg_cov, agg_edge, new_lane.cpu().numpy(),
                new_words.cpu().numpy().view(np.uint32))

    def _fused_alias_bytes(self) -> int:
        """The 13 planes' bytes of every lane of the mesh, from the
        shards' shapes (never a gather of the planes)."""
        return self.mesh.world * sum(alias_bytes(m)
                                     for m in self.runner.shards)

    def print_run_stats(self) -> None:
        super().print_run_stats()
        mesh = self.mesh
        where = (f", {mesh.world} processes" if mesh.world > 1 else "")
        print(f"[gpu] mesh: {mesh.global_size} shards x "
              f"{self.runner.lanes_per_shard} lanes/shard on "
              f"{', '.join(str(d) for d in mesh.distinct)}{where}")
