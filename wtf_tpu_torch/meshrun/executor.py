"""The mesh executors: the single-device dispatch units, run per shard.

The counterpart of wtf_tpu/meshrun/executor.py, where `shard_map` runs
one program per device.  Here each executor runs the port's
single-device function on each shard's own tensors, in shard order,
with the shard's card current (`LaneMesh.scope`):

  make_mesh_chunk   `run_steps` per shard: its early exit is shard-local
                    (a shard stops stepping once none of ITS lanes runs)
  make_mesh_fused   `pstep.fused_step` (K1) per shard over the shard's
                    local lanes; a shard with no RUNNING lane is skipped
  make_mesh_resume  `pstep.fused_resume` per shard, for the shards K1 ran
                    on (only they can hold parked lanes)
  quiesce_shards    the megachunk window's quiesce (fuzz/megachunk.py):
                    K1 rounds (make_mesh_fused) and their resume legs, or
                    precise steps, until no lane of any shard runs; its
                    loop condition is shard-local, so each shard takes
                    exactly the rounds its own lanes need

The chunk and resume executors end with the merged cov/edge bitmaps of
the whole mesh (`_chunk_with_coverage`): each shard's lane OR, then one
cross-shard OR (`bitplane_or`), so reading the batch's union never
gathers the [lanes, words] planes.  Machine state never crosses shards.

Arguments: `tab` is the decode table replicated per device ({device:
UopTable}, meshrun/mesh.replicate), `images` one MemImage per shard
(meshrun/mesh.shard_image: the tenant row cut with the lanes), `shards`
the per-shard Machines, updated in place.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.meshrun.reduce import bitplane_or, or_reduce_lanes

_RUNNING = int(StatusCode.RUNNING)


def shards_with(shards, status: int = _RUNNING) -> List[bool]:
    """Per shard: does any of its lanes hold `status`?  One host read
    (per distinct device)."""
    flags = [(m.status == status).any() for m in shards]
    dev = shards[0].device
    return [bool(x) for x in torch.stack([f.to(dev) for f in flags]).cpu()]


def _chunk_with_coverage(body, mesh):
    """Wrap a body over the shards (tab, images, shards, limit, ...) so
    the executor also returns the mesh's merged cov/edge bitmaps."""

    def run(tab, images, shards, limit, *args):
        body(tab, images, shards, limit, *args)
        merged = bitplane_or([torch.cat([or_reduce_lanes(m.cov),
                                         or_reduce_lanes(m.edge)])
                              for m in shards], mesh)
        wc = shards[0].cov.shape[1]
        return shards, merged[:wc], merged[wc:]

    return run


def make_mesh_chunk(n_steps: int, mesh):
    """(tab, images, shards, limit) -> (shards, merged_cov, merged_edge):
    up to `n_steps` precise steps on each shard."""
    from wtf_tpu_torch.interp.step import run_steps

    def body(tab, images, shards, limit):
        for i, m in enumerate(shards):
            with mesh.scope(i):
                run_steps(tab[m.device], images[i], m, limit, n_steps)

    return _chunk_with_coverage(body, mesh)


def make_mesh_fused(k_steps: int, mesh):
    """(tab, images, shards, limit, live=None) -> [bool per shard]: K1
    for up to `k_steps` hot instructions per lane on every shard with a
    RUNNING lane (or on the `live` ones the caller read); returns which
    shards it launched on."""
    from wtf_tpu_torch.interp import pstep

    def run(tab, images, shards, limit,
            live: Optional[List[bool]] = None):
        if live is None:
            live = shards_with(shards)
        for i, m in enumerate(shards):
            if live[i]:
                with mesh.scope(i):
                    pstep.fused_step(tab[m.device], images[i], m, limit,
                                     k_steps)
        return live

    return run


def resume_shards(tab, images, shards, limit, n_steps: int, mesh,
                  live: Optional[List[bool]] = None) -> int:
    """The fused round's precise resume leg on the `live` shards (default:
    those holding a parked lane); returns the precise sweeps summed over
    them."""
    from wtf_tpu_torch.interp import pstep

    if live is None:
        live = shards_with(shards, int(StatusCode.NEEDS_XLA))
    sweeps = 0
    for i, m in enumerate(shards):
        if live[i]:
            with mesh.scope(i):
                sweeps += pstep.fused_resume(tab[m.device], images[i], m,
                                             limit, n_steps)
    return sweeps


def make_mesh_resume(n_steps: int, mesh):
    """(tab, images, shards, limit, live=None) -> (shards, merged_cov,
    merged_edge): `resume_shards` with the merged bitmaps."""

    def body(tab, images, shards, limit,
             live: Optional[List[bool]] = None):
        resume_shards(tab, images, shards, limit, n_steps, mesh, live)

    return _chunk_with_coverage(body, mesh)


def fence_each(sp, tensors) -> None:
    """Fence span `sp` on one of `tensors` per distinct device."""
    for t in {t.device: t for t in tensors}.values():
        sp.fence(t)


def quiesce_shards(tab, images, shards, limit, mesh, spans,
                   fused_k: Optional[int] = None,
                   resume_steps: int = 1) -> Tuple[int, List[int]]:
    """Run every shard until none of its lanes is RUNNING (decode misses,
    breakpoints and terminals all leave RUNNING; the nonzero instruction
    budget bounds the rest).  With `fused_k` each round is K1 on the
    shards that still run (make_mesh_fused, one host read for all of
    them), then the precise resume leg on the same shards; without it,
    precise steps per shard.  Returns (precise sweeps summed over the
    shards, K1 launches per shard)."""
    from wtf_tpu_torch.interp.step import run_steps

    launches = [0] * len(shards)
    sweeps = 0
    if fused_k is None:
        with spans.span("device-step") as sp:
            for i, m in enumerate(shards):
                with mesh.scope(i):
                    sweeps += run_steps(tab[m.device], images[i], m, limit,
                                        sys.maxsize)
            fence_each(sp, [m.status for m in shards])
        return sweeps, launches
    k1 = make_mesh_fused(fused_k, mesh)
    while True:
        live = shards_with(shards)
        if not any(live):
            return sweeps, launches
        with spans.span("fused-step") as sp:
            k1(tab, images, shards, limit, live)
            fence_each(sp, [m.status for m in shards])
        with spans.span("device-step") as sp:
            sweeps += resume_shards(tab, images, shards, limit,
                                    resume_steps, mesh, live)
            fence_each(sp, [m.status for m in shards])
        launches = [n + bool(x) for n, x in zip(launches, live)]
