"""CLI entry point: `python -m wtf_tpu_torch {run|campaign}`.

The counterpart of wtf_tpu/cli.py for the subcommands this slice carries,
with the JAX package's flag names and meanings for the subset it supports
plus `--device`:

  run       replay an input file or directory on the device batch (lane 0),
            optionally writing a rip/cov/tenet trace through the oracle
  campaign  the single-process fuzz loop over one device batch

Both run on a CUDA device by default (`--device cuda`) and raise when
there is none; `--device cpu` runs the plain PyTorch versions of the
kernels on the CPU.  `--fused-step on|auto` drives the fused step kernel
(interp/pstep.py); on a CUDA device both raise when it cannot be built.
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
    return parser


def _lookup_target(name: str):
    load_builtin_targets()
    return Targets.instance().get(name)


def build_backend(target, args, registry: Registry):
    """The GpuBackend of one invocation, initialized and target-armed."""
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.snapshot.loader import load_snapshot

    paths = TargetPaths(target=args.target).resolve()
    if paths.state and Path(paths.state).exists():
        snapshot = load_snapshot(paths.state)
    elif target.snapshot is not None:
        snapshot = target.snapshot()
    else:
        raise SystemExit(f"target {target.name!r} has no snapshot factory "
                         f"and no state dir was given")
    backend = GpuBackend(snapshot, n_lanes=args.lanes, limit=args.limit,
                         registry=registry, events=NULL, device=args.device,
                         fused_step=args.fused_step, fused_k=args.fused_k)
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


def campaign(args):
    """`campaign`: seed the corpus, build the mutator from --seed, and run
    the fuzz loop for --runs testcases.  Returns the FuzzLoop."""
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import MangleMutator

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
    mutator = (target.create_mutator(rng, args.max_len)
               if target.create_mutator is not None
               else MangleMutator(rng, args.max_len))
    loop = FuzzLoop(backend, target, mutator, corpus,
                    crashes_dir=paths.crashes, registry=registry)
    loop.fuzz(runs=args.runs, print_stats=True)
    return loop


def cmd_campaign(args) -> int:
    loop = campaign(args)
    print(loop.stats.line(len(loop.corpus), loop._coverage()))
    loop.backend.print_run_stats()
    return 0 if loop.stats.crashes == 0 else 2


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"run": cmd_run, "campaign": cmd_campaign}[args.subcommand](args)


def console_main() -> None:
    sys.exit(main())


if __name__ == "__main__":
    console_main()
