"""CLI entry point: `python -m wtf_tpu_torch {run|campaign|snapshot}`.

The counterpart of wtf_tpu/cli.py for the subcommands this slice carries,
with the JAX package's flag names and meanings for the subset it supports
plus `--device`:

  run       replay an input file or directory on the device batch (lane 0),
            optionally writing a rip/cov/tenet trace through the oracle
  campaign  the single-process fuzz loop over one device batch, with the
            host mutators or the device one (--mutator devmangle), batch
            at a time or in multi-batch windows (--megachunk N)
  snapshot  convert a snapshot between mem.npz and a Windows crash dump
            (mem.dmp, bitmap or full)

`run` and `campaign` run on a CUDA device by default (`--device cuda`)
and raise when there is none; `--device cpu` runs the plain PyTorch
versions of the kernels on the CPU.  `--fused-step on|auto` drives the fused step kernel
(interp/pstep.py); on a CUDA device both raise when it cannot be built.
`--device-decode` services decode-cache misses on the device
(interp/devdec.py).  `--state DIR` loads the snapshot from DIR (mem.npz or
mem.dmp, regs.json, symbol-store.json) instead of the target's factory.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys
from pathlib import Path
from typing import List, Optional

from wtf_tpu_torch.config import TargetPaths
from wtf_tpu_torch.core.results import Crash
from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
from wtf_tpu_torch.telemetry import NULL, Registry

TRACE_TYPES = ("rip", "cov", "tenet")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--name", required=True, help="registered target name")
    p.add_argument("--target", type=Path, default=None,
                   help="target root dir (inputs/outputs/crashes/state "
                        "default underneath, wtf.cc:48-68)")
    p.add_argument("--state", type=Path, default=None,
                   help="snapshot dir (mem.npz or mem.dmp + regs.json); "
                        "defaults to <target>/state, else the target's "
                        "own snapshot factory")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device), "
                        "cuda:N, or cpu")
    p.add_argument("--fused-step", choices=("off", "auto", "on"),
                   default="off",
                   help="fused step kernel (interp/pstep.py): up to "
                        "--fused-k hot instructions per lane per launch, "
                        "parked lanes resuming on the precise step.  auto "
                        "= on for a CUDA device, off on the CPU")
    p.add_argument("--fused-k", type=int, default=32,
                   help="instructions per lane per fused launch")
    p.add_argument("--device-decode", action="store_true",
                   help="device-resident x86 decode (interp/devdec.py): "
                        "megachunk windows service decode-cache misses on "
                        "the device (page-walked fetch, batched decode, "
                        "publish-order slot reservation), parking only "
                        "encodings outside its subset for the host; host "
                        "service rounds fetch the missing code windows in "
                        "one device pass; the host decoder cross-checks "
                        "every device-published entry at harvest")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="wtf_tpu_torch",
        description="snapshot fuzzer on a batched x86-64 interpreter "
                    "(PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="subcommand", required=True)

    run = sub.add_parser("run", help="replay testcases / write traces")
    _add_common(run)
    run.add_argument("--input", type=Path, required=True,
                     help="testcase file or directory")
    run.add_argument("--limit", type=int, default=0,
                     help="instruction budget per testcase (0 = none)")
    run.add_argument("--runs", type=int, default=1,
                     help="times to run each testcase")
    run.add_argument("--trace-path", type=Path, default=None,
                     help="file (single input) or dir to write traces")
    run.add_argument("--trace-type", choices=TRACE_TYPES, default="rip")
    run.add_argument("--lanes", type=int, default=4)

    camp = sub.add_parser(
        "campaign", help="single-process fuzz loop over one device batch")
    _add_common(camp)
    camp.add_argument("--limit", type=int, default=0)
    camp.add_argument("--runs", type=int, required=True,
                      help="testcase budget (> 0)")
    camp.add_argument("--max_len", type=int, default=1024 * 1024)
    camp.add_argument("--seed", type=int, default=0)
    camp.add_argument("--lanes", type=int, default=64)
    camp.add_argument("--mutator", choices=("auto", "devmangle"),
                      default="auto",
                      help="mutation engine: auto = the target's custom "
                           "mutator, else the host mangle engine. "
                           "devmangle = the device-resident engine "
                           "(wtf_tpu_torch/devmut): the whole batch is "
                           "generated on the device from the corpus slab "
                           "(a target with a DeviceInsertSpec only)")
    camp.add_argument("--megachunk", type=int, default=0, metavar="N",
                      help="multi-batch windows (wtf_tpu_torch/fuzz/"
                           "megachunk): fold up to N whole batches — "
                           "restore, devmut generation, insert, the run "
                           "to quiescence, the coverage merge — into one "
                           "call that stays on the device, so per-batch "
                           "host work collapses to the status pull and "
                           "find harvest.  Needs --mutator devmangle and "
                           "a nonzero --limit; 0 = off")

    snap = sub.add_parser(
        "snapshot", help="convert snapshots between formats")
    snap.add_argument("--state", type=Path, required=True,
                      help="input state dir (mem.npz or mem.dmp + regs.json)")
    snap.add_argument("--out", type=Path, required=True,
                      help="output state dir")
    snap.add_argument("--format", choices=("npz", "dmp-bmp", "dmp-full"),
                      default="npz")
    return parser


def _lookup_target(name: str):
    load_builtin_targets()
    return Targets.instance().get(name)


def build_backend(target, args, registry: Registry):
    """The GpuBackend of one invocation, initialized and target-armed."""
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.snapshot.loader import load_snapshot

    paths = TargetPaths(target=args.target, state=args.state).resolve()
    with registry.spans.span("snapshot-load"):
        if paths.state and Path(paths.state).exists():
            snapshot = load_snapshot(paths.state)
        elif target.snapshot is not None:
            snapshot = target.snapshot()
        else:
            raise SystemExit(f"target {target.name!r} has no snapshot "
                             f"factory and no --state dir was given")
    backend = GpuBackend(snapshot, n_lanes=args.lanes, limit=args.limit,
                         registry=registry, events=NULL, device=args.device,
                         fused_step=args.fused_step, fused_k=args.fused_k,
                         device_decode=args.device_decode)
    with registry.spans.span("init"):
        backend.initialize()
    target.init(backend)
    return backend, paths


@dataclasses.dataclass
class ReplayRun:
    path: Path
    result: object      # TestcaseResult
    coverage: set       # new coverage rips
    rip: int            # lane 0 at the end of a device run
    icount: int


def replay(args):
    """`run`: every input through lane 0 of the device batch, in the
    reference's RunTestcaseAndRestore order (client.cc:88-180).  Returns
    (backend, [ReplayRun])."""
    from wtf_tpu_torch.core.results import Timedout

    target = _lookup_target(args.name)
    backend, _ = build_backend(target, args, Registry())
    inputs: List[Path] = (
        sorted(p for p in args.input.iterdir() if p.is_file())
        if args.input.is_dir() else [args.input])
    trace_dir = args.trace_path if args.trace_path and len(inputs) > 1 \
        else None
    if trace_dir:
        trace_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for path in inputs:
        data = path.read_bytes()
        for _ in range(max(args.runs, 1)):
            if args.trace_path:
                backend.set_trace_file(
                    trace_dir / f"{path.name}.trace" if trace_dir
                    else args.trace_path, args.trace_type)
            target.insert_testcase(backend, data)
            result = backend.run()
            if isinstance(result, Timedout):
                backend.revoke_last_new_coverage()  # client.cc:122-125
            m = backend.runner.machine
            runs.append(ReplayRun(path, result, backend.last_new_coverage(),
                                  int(m.rip[0]) & (1 << 64) - 1,
                                  int(m.icount[0])))
            target.restore()
            backend.restore()
    return backend, runs


def cmd_run(args) -> int:
    backend, runs = replay(args)
    crashes = 0
    for run in runs:
        crashes += isinstance(run.result, Crash)
        print(f"{run.path.name}: {run.result} (|cov| = {len(run.coverage)})")
    backend.print_run_stats()
    return 0 if crashes == 0 else 2


def mutator_for(target, rng: random.Random, max_len: int):
    """The host mutator of `--mutator auto` (wtf_tpu/cli.py `_mutator_for`):
    the target's own, else the native mangle engine, else (no g++) the
    Python one."""
    from wtf_tpu_torch.fuzz.native_mutator import best_mangle_mutator

    if target.create_mutator is not None:
        return target.create_mutator(rng, max_len)
    return best_mangle_mutator(rng, max_len)


def campaign(args):
    """`campaign`: seed the corpus, build the mutator from --seed, and run
    the fuzz loop for --runs testcases.  Returns the FuzzLoop."""
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import create_mutator

    if args.runs <= 0:
        raise SystemExit("--runs must be > 0 (the minset mode of --runs 0 "
                         "is not carried by wtf_tpu_torch yet)")
    target = _lookup_target(args.name)
    registry = Registry()
    backend, paths = build_backend(target, args, registry)
    rng = random.Random(args.seed or None)
    if paths.inputs and Path(paths.inputs).is_dir():
        corpus = Corpus.load_dir(paths.inputs, rng=rng,
                                 outputs_dir=paths.outputs)
    else:
        corpus = Corpus(outputs_dir=paths.outputs, rng=rng)
    if args.mutator == "devmangle":
        mutator = create_mutator("devmangle", rng, args.max_len)
    else:
        mutator = mutator_for(target, rng, args.max_len)
    loop = FuzzLoop(backend, target, mutator, corpus,
                    crashes_dir=paths.crashes, registry=registry,
                    megachunk=args.megachunk)
    loop.fuzz(runs=args.runs, print_stats=True)
    return loop


def cmd_campaign(args) -> int:
    loop = campaign(args)
    print(loop.stats.line(len(loop.corpus), loop._coverage()))
    loop.backend.print_run_stats()
    return 0 if loop.stats.crashes == 0 else 2


def cmd_snapshot(args) -> int:
    """Format conversion: npz <-> Windows crash dump both ways."""
    import json

    import numpy as np

    from wtf_tpu_torch.snapshot.kdmp import write_kdmp
    from wtf_tpu_torch.snapshot.loader import (
        dump_cpu_state_json, load_snapshot,
    )

    snap = load_snapshot(args.state)
    args.out.mkdir(parents=True, exist_ok=True)
    table = snap.physmem.frame_table[0]
    if args.format == "npz":
        snap.save_raw(args.out)
    else:
        page_data = snap.physmem.pages.view(np.uint8)
        pages = {int(pfn): page_data[int(table[pfn])].tobytes()
                 for pfn in np.nonzero(table)[0]}
        write_kdmp(args.out / "mem.dmp", pages,
                   dump_type="bmp" if args.format == "dmp-bmp" else "full",
                   dtb=snap.cpu.cr3, cpu=snap.cpu)
        (args.out / "regs.json").write_text(dump_cpu_state_json(snap.cpu))
        (args.out / "symbol-store.json").write_text(json.dumps(
            {k: hex(v) for k, v in snap.symbols.items()}, indent=1))
    n_pages = int((table != 0).sum())
    print(f"wrote {args.format} snapshot ({n_pages} pages) to {args.out}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"run": cmd_run, "campaign": cmd_campaign,
            "snapshot": cmd_snapshot}[args.subcommand](args)


def console_main() -> None:
    sys.exit(main())


if __name__ == "__main__":
    console_main()
