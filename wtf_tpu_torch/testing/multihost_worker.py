"""One process of a multi-process lane mesh: join, run one mesh chunk,
report the merged coverage.

The counterpart of tests/multihost_worker.py.  Each process joins
torch.distributed through `init_multihost` (gloo), builds the global
batch (`--lanes` per process, the same host value in every process) and
keeps its `--shards` shards of it on `--device`, runs one mesh chunk of
demo_tlv — the precise chunk (`make_mesh_chunk`) or, with `--fused`, one
fused round (K1 per shard, then the resume leg) — and prints one JSON
line whose merged-coverage digest every process must agree on: the
cross-shard OR of the chunk all-gathers across the processes.  With
`--merge-seed N` it then runs the mesh batch merge (`make_mesh_merge`:
the exclusive prefix credit across processes) on `merge_case(N)`'s
bitmaps and reports its result; with `--rows`, a MeshRunner over the
global batch is seeded (each page write lands on the lane's owner) and
every lane's input is read back through a fresh HostView (the owner's
overlay row all-gathered); with `--window N`, a demo_tlv devmangle
campaign of megachunk windows of N batches runs over the global batch
and its fingerprint is reported; `--device-decode` adds the window's
decode service (every process's blocks go through one commit) and the
same campaign batch at a time, whose host decode service gathers the
missing lanes' code windows from their owners.

    python -m wtf_tpu_torch.testing.multihost_worker \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id 0 \\
        --device cpu --shards 4 --lanes 8

Lane g of the global batch runs the first 4 + (g % 3) * 5 bytes of the
payload, as the JAX package's mesh tests seed theirs.  `run_mesh_chunk`
and `run_mesh_merge` are the same work in-process on any LaneMesh (the
one-process reference).
"""

from __future__ import annotations

import argparse
import json
import sys

PAYLOAD = b"\x01\x02AB\x03\x08CCCCCCCC"
# tests/test_meshrun.py's runner geometry
RUNNER = dict(uop_capacity=1 << 10, edge_bits=12, chunk_steps=8)


def seed_runner(runner) -> None:
    """Warm the decode cache and give lane i its payload prefix."""
    import numpy as np

    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.interp.runner import warm_decode_cache

    warm_decode_cache(runner, demo_tlv.TARGET, PAYLOAD, limit=4096)
    view = runner.view()
    for lane in range(runner.n_lanes):
        data = PAYLOAD[:4 + (lane % 3) * 5]
        view.virt_write(lane, demo_tlv.INPUT_GVA, data)
        view.r["gpr"][lane, 2] = np.uint64(len(data))
    runner.push(view)


def run_mesh_chunk(mesh, lanes: int, overlay_slots: int = 16,
                   fused: bool = False, steps: int = 8, limit: int = 500,
                   fused_k: int = 32) -> dict:
    """Build the global batch (`lanes` per process) on the mesh's first
    device, keep this process's shards of it and run one mesh chunk;
    returns the report (every number global across the processes)."""
    import numpy as np
    import torch

    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.meshrun import (
        make_mesh_chunk, make_mesh_fused, make_mesh_resume, replicate,
        shard_image, shard_machine,
    )
    from wtf_tpu_torch.meshrun.reduce import gather_shards

    dev = mesh.devices[0]
    runner = Runner(demo_tlv.build_snapshot(), n_lanes=lanes * mesh.world,
                    overlay_slots=overlay_slots, device=dev,
                    fused_step="on" if fused else "off", **RUNNER)
    seed_runner(runner)
    shards = shard_machine(runner.machine, mesh)
    tab = replicate(runner.cache.device(dev), mesh)
    images = shard_image(runner.image, mesh)
    launches = pstep.LAUNCHES["fused_step"]
    if fused:
        live = make_mesh_fused(fused_k, mesh)(tab, images, shards, limit)
        _, cov, _ = make_mesh_resume(1, mesh)(tab, images, shards, limit,
                                              live)
    else:
        _, cov, _ = make_mesh_chunk(steps, mesh)(tab, images, shards, limit)
    launches = pstep.LAUNCHES["fused_step"] - launches
    icount = gather_shards([m.icount for m in shards], mesh)
    cov = cov.cpu().numpy().view(np.uint32).astype(np.uint64)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {
        "pid": mesh.rank,
        "devices": mesh.global_size,
        "lanes": lanes * mesh.world,
        "instructions": int(icount.sum()),
        "min_lane_icount": int(icount.min()),
        "k1_launches": launches,
        "cov_words_set": int((cov != 0).sum()),
        "cov_digest": hex(int(np.bitwise_xor.reduce(
            cov * np.arange(1, len(cov) + 1, dtype=np.uint64)))),
    }


def run_mesh_rows(mesh, lanes: int, overlay_slots: int = 16) -> dict:
    """A MeshRunner of `lanes` per process seeded as `seed_runner` does,
    then every lane's input read back through a fresh HostView; returns
    whether each lane reads its own payload prefix, and their digest."""
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.meshrun import MeshRunner
    from wtf_tpu_torch.utils.hashing import hex_digest

    runner = MeshRunner(demo_tlv.build_snapshot(), lanes * mesh.world,
                        mesh=mesh, overlay_slots=overlay_slots, **RUNNER)
    seed_runner(runner)
    view = runner.view()
    got = [view.virt_read(lane, demo_tlv.INPUT_GVA, len(PAYLOAD))
           for lane in range(runner.n_lanes)]
    return {"rows_ok": all(g.startswith(PAYLOAD[:4 + (lane % 3) * 5])
                           for lane, g in enumerate(got)),
            "rows_digest": hex_digest(b"".join(got))}


def run_mesh_window(mesh, lanes: int, megachunk: int, runs: int,
                    device_decode: bool = False,
                    fused: bool = True) -> dict:
    """A demo_tlv devmangle campaign (limit 20,000, seed 0x5EED, 16
    overlay slots) of `runs` testcases through megachunk windows of
    `megachunk` batches (0: batch at a time) on the mesh, `lanes` per
    process; returns its fingerprint (every value the same in each
    process of a multi-process mesh)."""
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign
    from wtf_tpu_torch.utils.hashing import hex_digest

    loop = build_tlv_campaign(n_lanes=lanes * mesh.world,
                              mutator="devmangle", limit=20_000,
                              seed=0x5EED, chunk_steps=128, overlay_slots=16,
                              megachunk=megachunk, mesh=mesh,
                              device=mesh.devices[0],
                              fused_step="on" if fused else "off",
                              device_decode=device_decode)
    loop.fuzz(runs)
    cov, edge = loop.backend.coverage_state()
    reg = loop.registry
    entries = loop.backend.runner.cache.checkpoint_entries()
    return {"cov_edge": hex_digest(cov.tobytes() + edge.tobytes()),
            "corpus": [hex_digest(d) for d in loop.corpus],
            "crashes": sorted(loop.crash_names),
            "testcases": loop.stats.testcases,
            "entries": hex_digest(repr(list(entries)).encode()),
            "counters": {n: reg.counter(n).value for n in (
                "megachunk.windows", "device.fused_window_rounds",
                "device.fused_window_xla_steps", "devdec.published",
                "devdec.service_rounds", "devdec.crosscheck_mismatches")},
            "code_windows": loop.backend.runner.stats[
                "decode_windows_gathered"]}


def merge_case(seed: int, n_lanes: int):
    """Seeded bitmaps for the batch merge, as numpy uint32: (agg_cov
    [24], agg_edge [40], cov [L, 24], edge [L, 40], include bool[L]),
    with rows repeated within and across shards (the prefix credit must
    tell them apart) and lanes masked out."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 1 << 32, (n_lanes, 24), dtype=np.uint32)
    cov &= rng.integers(0, 1 << 32, cov.shape, dtype=np.uint32)
    edge = rng.integers(0, 1 << 32, (n_lanes, 40), dtype=np.uint32)
    for dst, src in ((3, 1), (n_lanes - 2, 2), (n_lanes // 2 + 1, 0)):
        cov[dst], edge[dst] = cov[src], edge[src]
    agg_cov = cov[5] & rng.integers(0, 1 << 32, 24, dtype=np.uint32)
    agg_edge = edge[4] & rng.integers(0, 1 << 32, 40, dtype=np.uint32)
    include = rng.random(n_lanes) > 0.2
    include[2] = False
    return agg_cov, agg_edge, cov, edge, include


def run_mesh_merge(mesh, case) -> dict:
    """`make_mesh_merge` on `case` (merge_case's global bitmaps, every
    process holding the same), each process's shards merging their
    lanes; returns the merged result as hex and lists."""
    import numpy as np
    import torch

    from wtf_tpu_torch.meshrun import make_mesh_merge
    from wtf_tpu_torch.meshrun.mesh import gather_processes, split_lanes

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))

    agg_cov, agg_edge, cov, edge, include = case
    agg_c, agg_e, new_lanes, new_words = make_mesh_merge(mesh)(
        t(agg_cov), t(agg_edge), split_lanes(t(cov), mesh),
        split_lanes(t(edge), mesh),
        split_lanes(torch.from_numpy(include), mesh))
    new_lane = gather_processes(torch.cat(new_lanes), mesh)
    return {"agg_cov": agg_c.cpu().numpy().tobytes().hex(),
            "agg_edge": agg_e.cpu().numpy().tobytes().hex(),
            "new_lane": new_lane.cpu().numpy().astype(int).tolist(),
            "new_words": new_words.cpu().numpy().tobytes().hex()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=1,
                    help="this process's shards, all on --device")
    ap.add_argument("--lanes", type=int, default=16,
                    help="this process's lanes (split over its shards)")
    ap.add_argument("--overlay-slots", type=int, default=16)
    ap.add_argument("--fused", action="store_true",
                    help="one fused round (K1 per shard, then the resume "
                         "leg) instead of the precise chunk")
    ap.add_argument("--limit", type=int, default=500)
    ap.add_argument("--merge-seed", type=int, default=None,
                    help="also run the mesh batch merge on merge_case(N)")
    ap.add_argument("--rows", action="store_true",
                    help="also read every lane's input back through a "
                         "MeshRunner's HostView")
    ap.add_argument("--window", type=int, default=0, metavar="N",
                    help="also run a campaign of megachunk windows of N "
                         "batches over the global batch (3 batches)")
    ap.add_argument("--device-decode", action="store_true",
                    help="that campaign with device decode")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from wtf_tpu_torch.device import resolve_device
    from wtf_tpu_torch.meshrun import init_multihost

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev)
    mesh = init_multihost(coordinator=args.coordinator,
                          num_processes=args.num_processes,
                          process_id=args.process_id,
                          devices=[dev] * args.shards)
    try:
        report = run_mesh_chunk(mesh, args.lanes, args.overlay_slots,
                                fused=args.fused, limit=args.limit)
        if args.merge_seed is not None:
            report["merge"] = run_mesh_merge(mesh, merge_case(
                args.merge_seed, args.lanes * mesh.world))
        if args.rows:
            report.update(run_mesh_rows(mesh, args.lanes,
                                        args.overlay_slots))
        if args.window:
            runs = 3 * args.lanes * mesh.world
            report["window"] = run_mesh_window(
                mesh, args.lanes, args.window, runs, args.device_decode)
            if args.device_decode:
                report["host_decode"] = run_mesh_window(
                    mesh, args.lanes, 0, runs, True)
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
