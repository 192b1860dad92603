"""Elastic campaigns: reshard a live campaign onto a different device
count without losing a bit.

A copy of wtf_tpu/fleet/elastic.py, imports rewritten.  Why it is nearly
free: campaign checkpoints (wtf_tpu_torch/resume) are placement-free —
coverage bitmaps, the decode cache, devmut slab views and RNG state, none
of which mention a mesh — and the devmut stream does not depend on the
shard count.  So moving a running campaign from 1 device to 8
decomposes into machinery that already exists:

  1. the in-loop policy hook (`FuzzLoop.reshard_policy`) fires at a
     batch boundary: the loop checkpoints and returns with `reshard_to`
     set
  2. `run_elastic` rebuilds the campaign against the new `--mesh-devices`
     count and restores the checkpoint — a bit-identical resume never
     pinned a placement
  3. the campaign continues; coverage, crash buckets and corpus end
     byte-identical to the uninterrupted run

`run_elastic` is the in-process loop; `fleet reshard`
(wtf_tpu_torch/cli.py) is the operator's one-step version: validate a
checkpoint, re-place, resume — what a campaign stopped by the
supervisor's bottom rung (supervise/supervisor.py `reshard_request`)
continues with.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)


class ScheduledReshard:
    """Reshard policy from a fixed plan {batch_index: device_count} —
    the deterministic policy the parity tests use.  A
    production autoscaler is the same shape: any callable(loop) ->
    Optional[int] consulted at batch boundaries."""

    def __init__(self, plan: Dict[int, int]):
        self.plan = dict(plan)
        self.fired = []

    def __call__(self, loop) -> Optional[int]:
        want = self.plan.pop(loop.batches_done, None)
        if want is not None:
            self.fired.append((loop.batches_done, want))
        return want


def placement_of(loop) -> Optional[int]:
    """The device count a loop currently runs on (None = single)."""
    mesh = getattr(loop.backend, "mesh", None)
    return getattr(mesh, "size", None)


def validate_placement(state: dict, mesh_devices: Optional[int]) -> None:
    """A checkpoint re-places onto `mesh_devices` iff the TOTAL lane
    count divides: lanes are the stream identity (devmut seeds key on
    lane index), lanes per shard is the free variable."""
    lanes = state.get("config", {}).get("lanes")
    if mesh_devices and lanes and lanes % mesh_devices:
        raise ValueError(
            f"cannot reshard: checkpoint has {lanes} lanes, not divisible "
            f"by --mesh-devices {mesh_devices} (the lane count is the "
            f"stream identity and must stay fixed; lanes per shard is what "
            f"resharding changes)")


def run_elastic(build_loop: Callable, runs: int, checkpoint_dir,
                policy=None, start_devices: Optional[int] = None,
                resume: bool = False, print_stats: bool = False):
    """Drive one campaign across placements until its run budget is
    spent.  `build_loop(mesh_devices)` must return a FRESH FuzzLoop
    (backend initialized, target init, seeds loaded) for that placement;
    everything that matters restores from the checkpoint.  Returns the
    final loop (stats, corpus, coverage all live on it)."""
    from wtf_tpu_torch.resume import load_campaign, restore_campaign

    checkpoint_dir = Path(checkpoint_dir)
    devices = start_devices
    restoring = resume
    loop = None
    while True:
        loop = build_loop(devices)
        loop.checkpoint_dir = checkpoint_dir
        loop.reshard_policy = policy
        if restoring:
            state, _ = load_campaign(checkpoint_dir)
            validate_placement(state, devices)
            batch = restore_campaign(loop, state, checkpoint_dir)
            log.info("resharded onto %s device(s) at batch %d",
                     devices or 1, batch)
        loop.fuzz(runs, print_stats=print_stats)
        if loop.reshard_to is None:
            return loop
        devices = loop.reshard_to
        restoring = True


def describe_checkpoint(directory) -> dict:
    """Operator summary of a checkpoint dir (the `fleet reshard`
    preflight): config, progress, corpus size — raises CheckpointError
    on a torn/unusable pair like any resume would."""
    from wtf_tpu_torch.resume import load_campaign

    state, fell_back = load_campaign(directory)
    return {
        "config": state.get("config", {}),
        "batches": state.get("batches", 0),
        "corpus": len(state.get("corpus_manifest", [])),
        "crash_buckets": len(state.get("crash_buckets", [])),
        "fell_back": fell_back,
    }
