"""meshrun: a lane mesh behind one logical backend.

The counterpart of wtf_tpu/meshrun.  Machine state has a leading lane
axis, so the campaign shards as data parallelism: lanes-per-shard x
shards is one batch.

  mesh.py      LaneMesh (ordered shard devices, a device may repeat),
               make_mesh, init_multihost (torch.distributed over gloo),
               placement helpers and MeshMachine (the gathered host view
               of the per-shard machines)
  reduce.py    the batch merge and the OR-reduce family: merge_coverage,
               or_reduce_lanes, bitplane_or, make_mesh_merge (one
               all-gather of per-shard unions per merge)
  executor.py  the chunk, K1 and resume-leg executors, run per shard, and
               the megachunk window's per-shard quiesce
  runner.py    MeshRunner: the host servicing loop over a sharded batch,
               and the megachunk window per shard (fuzz/megachunk.py)
  backend.py   MeshBackend: the one-logical-backend seam the fuzz loop,
               dist clients, triage and CLI drive (`--mesh-devices N`)

Imports resolve lazily (PEP 562), so the single-device backend can pull
the merge without importing the runner stack.
"""

from __future__ import annotations

_EXPORTS = {
    "LaneMesh": "mesh",
    "MeshMachine": "mesh",
    "make_mesh": "mesh",
    "init_multihost": "mesh",
    "lane_sharding": "mesh",
    "shard_machine": "mesh",
    "shard_image": "mesh",
    "replicate": "mesh",
    "gather_lanes": "mesh",
    "or_reduce_lanes": "reduce",
    "merged_coverage": "reduce",
    "merge_coverage": "reduce",
    "bitplane_or": "reduce",
    "mesh_merge_local": "reduce",
    "make_mesh_merge": "reduce",
    "make_mesh_chunk": "executor",
    "make_mesh_fused": "executor",
    "make_mesh_resume": "executor",
    "resume_shards": "executor",
    "quiesce_shards": "executor",
    "MeshRunner": "runner",
    "MeshBackend": "backend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
