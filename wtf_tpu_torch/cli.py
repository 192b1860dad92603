"""CLI entry point: `python -m wtf_tpu_torch {run|campaign|sched|triage|fuzz|
master|fleet|status|lint|snapshot}`.

The counterpart of wtf_tpu/cli.py for the single-device subcommands and the
master/client plane, with the JAX package's flag names and meanings for the
subset it supports plus `--device`:

  run       replay an input file or directory on the device batch (lane 0),
            optionally writing a rip/cov/tenet trace through the oracle;
            `--coverage DIR` counts the listed basic blocks hit
  campaign  the single-process fuzz loop over one device batch, with the
            host mutators or the device one (--mutator devmangle), batch
            at a time or in multi-batch windows (--megachunk N);
            `--runs 0` is the minset: replay inputs/ (and any prior
            outputs/) once and leave outputs/ holding exactly the
            coverage-increasing subset
  sched     the multi-tenant scheduler (wtf_tpu_torch/tenancy): a jobs
            table placed onto one device batch by priority and lane
            quota, each job a campaign on its own lane range of a stacked
            multi-snapshot image, preempted through per-tenant checkpoints
  triage    batched crash triage on the device batch (wtf_tpu_torch/triage):
            minimize (crash bisection), distill (exact-attribution corpus
            minset), vbreak (virtual-breakpoint replay)
  fuzz      node loop: dial the master, execute, report (wtf_tpu_torch/dist):
            `--backend gpu` (default) runs one device batch per round,
            one connection per lane or, with `--mux`, one for the whole
            batch; `--backend emu` one testcase at a time on the oracle
  master    testcase server: corpus, mutation, coverage aggregation,
            crash intake (no device work; `--runs 0` = minset)
  fleet     `reshard` (resume a checkpointed campaign on another
            --mesh-devices count), `soak` (simulated clients over the real
            wire) and `fsck` (verify and repair a content-addressed store)
  status    render the status.json a master (or campaign) keeps under
            --telemetry-dir
  lint      the port's lint (wtf_tpu_torch/analysis): the AST contract
            families and the op census of the steady-state programs,
            pinned on the CPU and, by default, also run on the card
  snapshot  convert a snapshot between mem.npz and a Windows crash dump
            (mem.dmp, bitmap or full)

`run`, `campaign`, `sched`, `triage` and `fuzz` run on a CUDA device by
default (`--device cuda`) and raise when there is none; `--device cpu`
runs the plain PyTorch versions of the kernels on the CPU.  `master`,
`fleet` and `status` do no device work, as in the JAX package, and
`lint` runs its census on the card as well unless given `--device cpu`
(its AST families alone need no device).  `run`,
`campaign`, `triage vbreak` and `fuzz` take `--backend emu` to run on the
single-step oracle instead (`--backend gpu`, the default, is the device
batch; the JAX CLI's `run` defaults to its oracle).  `--burst-any-tier
on|off` forces the oracle burst's any-instruction tier (default: on for
CUDA, off on the CPU).  `campaign --mutator byte|mangle|tlv` picks a host engine by name,
and `campaign --store DIR` journals finds and crashes in a
content-addressed store (wtf_tpu_torch/fleet/store).
`--fused-step on|auto` drives the fused step kernel (interp/pstep.py); on
a CUDA device both raise when it cannot be built.  `--device-decode`
services decode-cache misses on the device (interp/devdec.py).  `--state
DIR` loads the snapshot from DIR (mem.npz or mem.dmp, regs.json,
symbol-store.json) instead of the target's factory;
`--inputs/--outputs/--crashes` override the dirs under `--target`.
`--mesh-devices N` on `campaign`, `fuzz`, `sched` and `triage` shards the
lane batch over a lane mesh (wtf_tpu_torch/meshrun): N cards on cuda, N
shards of the CPU with `--device cpu`; `campaign --coordinator
--num-processes --process-id` joins torch.distributed (gloo) and runs one
mesh over every process's shards (`--mesh-devices` of them each): the
`--lanes` batch is global, every process runs the same campaign on it
and writes the same files.  On a mesh, `campaign --megachunk M` runs its
windows per shard and `--device-decode` services the windows' decode
misses with one commit of every shard's blocks (fuzz/megachunk.py).
`--supervise` / `--dispatch-timeout` put every device dispatch under the
supervisor (wtf_tpu_torch/supervise), and `campaign --checkpoint-every` /
`--resume` write and continue crash-safe checkpoints
(wtf_tpu_torch/resume).  `--telemetry-dir` writes events.jsonl (run-start
first, run-end with a metrics dump last), `--trace-out` a Chrome-trace
timeline of every span; `--target-module` imports modules that register
more targets.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import logging
import random
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import List, Optional

from wtf_tpu_torch.config import DEFAULT_ADDRESS, TargetPaths
from wtf_tpu_torch.core.results import Crash
from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
from wtf_tpu_torch.telemetry import NULL, Registry, open_event_log

TRACE_TYPES = ("rip", "cov", "tenet")


def _add_common(p: argparse.ArgumentParser) -> None:
    _add_target_args(p)
    _add_engine_args(p)


def _add_target_args(p: argparse.ArgumentParser) -> None:
    """Target selection, its dirs and the telemetry outputs."""
    p.add_argument("--name", required=True, help="registered target name")
    p.add_argument("--target-module", action="append", default=[],
                   help="extra python module(s) to import for target "
                        "registration")
    p.add_argument("--target", type=Path, default=None,
                   help="target root dir (inputs/outputs/crashes/state "
                        "default underneath, wtf.cc:48-68)")
    p.add_argument("--inputs", type=Path, default=None)
    p.add_argument("--outputs", type=Path, default=None)
    p.add_argument("--crashes", type=Path, default=None)
    p.add_argument("--state", type=Path, default=None,
                   help="snapshot dir (mem.npz or mem.dmp + regs.json); "
                        "defaults to <target>/state, else the target's "
                        "own snapshot factory")
    p.add_argument("--telemetry-dir", type=Path, default=None,
                   help="write machine-readable telemetry (events.jsonl: "
                        "run-start/heartbeat/new-coverage/crash/timeout/"
                        "run-end records with a full metrics dump)")
    p.add_argument("--trace-out", type=Path, default=None,
                   help="write a Chrome-trace-event timeline "
                        "(chrome://tracing / Perfetto JSON) of every span, "
                        "plus instant marks for point events (crash/"
                        "new-coverage/checkpoint/recovery)")


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    """The device and its execution engine."""
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
    p.add_argument("--burst-any-tier", choices=("auto", "on", "off"),
                   default="auto",
                   help="the oracle burst's any-instruction tier for "
                        "chronically diverting lanes.  auto = the device "
                        "default (on for CUDA, off on the CPU); on/off "
                        "force it")
    p.add_argument("--device-decode", action="store_true",
                   help="device-resident x86 decode (interp/devdec.py): "
                        "megachunk windows service decode-cache misses on "
                        "the device (page-walked fetch, batched decode, "
                        "publish-order slot reservation), parking only "
                        "encodings outside its subset for the host; host "
                        "service rounds fetch the missing code windows in "
                        "one device pass; the host decoder cross-checks "
                        "every device-published entry at harvest")
    p.add_argument("--supervise", action="store_true",
                   help="self-healing device runtime (wtf_tpu_torch/"
                        "supervise): watchdogged dispatches, "
                        "rebuild-and-replay recovery, the degradation "
                        "ladder, per-batch integrity checks + lane "
                        "quarantine")
    p.add_argument("--dispatch-timeout", type=float, default=0.0,
                   metavar="SECS",
                   help="watchdog bound for ONE base-chunk dispatch "
                        "(scaled by chunk steps and megachunk window); "
                        "0 = no watchdog.  Implies --supervise")


def _add_mesh_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                   help="shard the lane batch over a lane mesh "
                        "(wtf_tpu_torch/meshrun): on cuda the first N "
                        "cards, one shard each (0 = every card; raises "
                        "when fewer are visible); with --device cpu N "
                        "shards of the CPU.  --lanes is the TOTAL lane "
                        "count and must divide by N; the coverage merge "
                        "runs across the shards, so the loop sees one "
                        "logical backend")


def _supervise_kwargs(args) -> dict:
    """The backend's supervisor settings: --dispatch-timeout implies
    --supervise (wtf_tpu/cli.py `_backend_tuning_kwargs`)."""
    if args.supervise or args.dispatch_timeout:
        return {"supervise": True, "dispatch_timeout": args.dispatch_timeout}
    return {}


def _tuning_kwargs(args) -> dict:
    """The GpuBackend's engine settings from the engine args: the device,
    the fused step, the burst tier (only when forced), device decode and
    the supervisor."""
    kwargs = dict(device=args.device, fused_step=args.fused_step,
                  fused_k=args.fused_k, device_decode=args.device_decode,
                  **_supervise_kwargs(args))
    if args.burst_any_tier != "auto":
        kwargs["burst_any_tier"] = args.burst_any_tier == "on"
    mesh = getattr(args, "mesh_devices", None)
    if mesh is not None:
        kwargs["mesh_devices"] = mesh
    return kwargs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="wtf_tpu_torch",
        description="snapshot fuzzer on a batched x86-64 interpreter "
                    "(PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="subcommand", required=True)

    run = sub.add_parser("run", help="replay testcases / write traces")
    _add_common(run)
    run.add_argument("--backend", choices=("gpu", "emu"), default="gpu",
                     help="gpu = lane 0 of the device batch on --device "
                          "(default); emu = the single-step oracle")
    run.add_argument("--input", type=Path, required=True,
                     help="testcase file or directory")
    run.add_argument("--limit", type=int, default=0,
                     help="instruction budget per testcase (0 = none)")
    run.add_argument("--runs", type=int, default=1,
                     help="times to run each testcase")
    run.add_argument("--trace-path", type=Path, default=None,
                     help="file (single input) or dir to write traces")
    run.add_argument("--trace-type", choices=TRACE_TYPES, default="rip")
    run.add_argument("--coverage", type=Path, default=None,
                     help="dir of .cov files (IDA/Binja/Ghidra exports); "
                          "prints covered/total per run set")
    run.add_argument("--lanes", type=int, default=4)

    camp = sub.add_parser(
        "campaign", help="single-process fuzz loop over one device batch")
    _add_common(camp)
    camp.add_argument("--backend", choices=("gpu", "emu"), default="gpu",
                      help="gpu = the device batch on --device (default); "
                           "emu = the single-step oracle, one testcase at "
                           "a time")
    camp.add_argument("--limit", type=int, default=0)
    camp.add_argument("--runs", type=int, default=0,
                      help="testcase budget; 0 = minset: replay inputs/ "
                           "once and write the coverage-minimal subset to "
                           "outputs/ (reference --runs=0, server.h:552-556)")
    camp.add_argument("--max_len", type=int, default=1024 * 1024)
    camp.add_argument("--seed", type=int, default=0)
    camp.add_argument("--lanes", type=int, default=64)
    camp.add_argument("--mutator",
                      choices=("auto", "byte", "mangle", "tlv", "devmangle"),
                      default="auto",
                      help="mutation engine: auto = the target's custom "
                           "mutator, else the best host mangle engine; "
                           "byte, mangle, tlv = that host engine. "
                           "devmangle = the device-resident engine "
                           "(wtf_tpu_torch/devmut): the whole batch is "
                           "generated on the device from the corpus slab "
                           "(a target with a DeviceInsertSpec only)")
    camp.add_argument("--stop-on-crash", action="store_true")
    camp.add_argument("--megachunk", type=int, default=0, metavar="N",
                      help="multi-batch windows (wtf_tpu_torch/fuzz/"
                           "megachunk): fold up to N whole batches — "
                           "restore, devmut generation, insert, the run "
                           "to quiescence, the coverage merge — into one "
                           "call that stays on the device, so per-batch "
                           "host work collapses to the status pull and "
                           "find harvest.  Needs --mutator devmangle and "
                           "a nonzero --limit; 0 = off")
    camp.add_argument("--checkpoint-every", type=int, default=0,
                      metavar="N",
                      help="crash-safe checkpointing (wtf_tpu_torch/"
                           "resume): persist the resumable campaign state "
                           "every N batches (atomic tmp+fsync+rename; "
                           "previous generation kept as .prev).  A kill "
                           "at any point costs at most one interval")
    camp.add_argument("--checkpoint-dir", type=Path, default=None,
                      help="checkpoint directory (default: "
                           "<target>/checkpoint when --target is given; "
                           "a --resume dir is reused)")
    camp.add_argument("--resume", type=Path, default=None, metavar="DIR",
                      help="resume from a checkpoint dir: coverage, crash "
                           "set, corpus, RNG and devmut streams restore "
                           "bit-identically to the uninterrupted run")
    camp.add_argument("--store", type=Path, default=None, metavar="DIR",
                      help="content-addressed corpus/crash store root "
                           "(wtf_tpu_torch/fleet/store); outputs/ and "
                           "crashes/ become flat views of it")
    camp.add_argument("--coordinator", default=None,
                      help="torch.distributed (gloo) coordinator address "
                           "for a multi-process launch (host:port)")
    camp.add_argument("--num-processes", type=int, default=None)
    camp.add_argument("--process-id", type=int, default=None)
    camp.add_argument("--xprof-dir", type=Path, default=None,
                      help="write one torch.profiler window (CPU and, on "
                           "a card, CUDA activity with CPU-side stacks) "
                           "over --xprof-batches steady-state batches "
                           "(the first 2 are skipped) into this dir as a "
                           "Chrome trace; open it with Perfetto or "
                           "chrome://tracing.  For counts and call sites "
                           "only: on a card the stacks slow the window's "
                           "batches about tenfold, so its timings are "
                           "not the campaign's")
    camp.add_argument("--xprof-batches", type=int, default=4,
                      help="batches inside the --xprof-dir window")
    _add_mesh_arg(camp)

    sched = sub.add_parser(
        "sched", help="multi-tenant campaign scheduler (wtf_tpu_torch/"
                      "tenancy): a jobs table placed onto ONE device batch "
                      "by priority and lane quota, preempted via "
                      "per-tenant checkpoints")
    sched.add_argument("--jobs", type=Path, required=True,
                       help='jobs table: {"jobs": [{"name", "target", '
                            '"lanes", "runs", "priority", "seed", '
                            '"mutator", "max_len", "inputs", '
                            '"checkpoint_every"}, ...]}')
    sched.add_argument("--workdir", type=Path, required=True,
                       help="per-job state root: <workdir>/<job>/"
                            "{checkpoint,crashes}.  Checkpoints carry "
                            "every bit a job needs across placements, "
                            "so a killed sched run resumes from here")
    sched.add_argument("--lanes", type=int, default=64,
                       help="total lane budget of the shared batch")
    sched.add_argument("--limit", type=int, default=0,
                       help="instruction budget per testcase (applies "
                            "to every job of the shared batch)")
    sched.add_argument("--quantum", type=int, default=4,
                       help="batches per scheduling round; at each "
                            "quantum boundary unfinished placed jobs "
                            "checkpoint, and jobs left waiting preempt "
                            "them in the next placement")
    sched.add_argument("--max-rounds", type=int, default=1 << 12)
    sched.add_argument("--target-module", action="append", default=[],
                       help="extra python module(s) to import for "
                            "target registration")
    sched.add_argument("--telemetry-dir", type=Path, default=None,
                       help="events.jsonl with tenant-tagged records + "
                            "sched-round/sched-preempt/sched-complete")
    sched.add_argument("--store", type=Path, default=None, metavar="DIR",
                       help="content-addressed store root; each job "
                            "gets its own tenant-<name> namespace "
                            "(wtf_tpu_torch/fleet/store)")
    _add_engine_args(sched)
    _add_mesh_arg(sched)

    triage = sub.add_parser(
        "triage", help="batched crash triage on the device batch "
                       "(wtf_tpu_torch/triage): minimize / distill / vbreak")
    tsub = triage.add_subparsers(dest="triage_cmd", required=True)

    tmin = tsub.add_parser(
        "minimize", help="bisect a crasher to a minimal reproducer of "
                         "the SAME crash bucket — thousands of candidate "
                         "reductions built on the device per dispatch")
    _add_common(tmin)
    tmin.add_argument("--input", type=Path, required=True,
                      help="the crashing testcase")
    tmin.add_argument("--output", type=Path, default=None,
                      help="where the minimized reproducer lands "
                           "(default: <input>.min)")
    tmin.add_argument("--limit", type=int, default=0)
    tmin.add_argument("--lanes", type=int, default=64,
                      help="candidates per dispatch")
    tmin.add_argument("--max-rounds", type=int, default=64)
    _add_mesh_arg(tmin)

    tdis = tsub.add_parser(
        "distill", help="re-execute the corpus in one batched sweep, "
                        "compute exact per-testcase edge attribution "
                        "from the coverage bitmaps, and keep a set-cover "
                        "subset with identical aggregate coverage (the "
                        "exact-attribution minset)")
    _add_common(tdis)
    tdis.add_argument("--from-checkpoint", type=Path, default=None,
                      metavar="DIR",
                      help="distill a campaign checkpoint's corpus "
                           "(wtf_tpu_torch/resume dir) instead of inputs/")
    tdis.add_argument("--limit", type=int, default=0)
    tdis.add_argument("--lanes", type=int, default=64)
    _add_mesh_arg(tdis)

    tvb = tsub.add_parser(
        "vbreak", help="virtual-breakpoint replay: arm a breakpoint at "
                       "a RIP/icount and capture a register+memory "
                       "window per lane across (perturbed) replays")
    _add_common(tvb)
    tvb.add_argument("--backend", choices=("gpu", "emu"), default="gpu",
                     help="gpu = the device batch on --device (default); "
                          "emu = the single-step oracle (debugging "
                          "convenience; one replay at a time)")
    tvb.add_argument("--input", type=Path, required=True,
                     help="testcase file or directory")
    tvb.add_argument("--break-at", required=True,
                     help="capture point: hex address, symbol, or "
                          "symbol+0xOFF")
    tvb.add_argument("--hit", type=int, default=1,
                     help="capture on the Nth arrival at the RIP")
    tvb.add_argument("--min-icount", type=int, default=0,
                     help="only capture once this many instructions "
                          "retired (arrivals before resume past the bp)")
    tvb.add_argument("--mem", default="",
                     help="memory window GVA:LEN (hex ok; default: 64 "
                          "bytes at rsp)")
    tvb.add_argument("--variants", type=int, default=0,
                     help="add N deterministic single-byte perturbations "
                          "per input to the sweep")
    tvb.add_argument("--out", type=Path, default=None,
                     help="write captures as JSON")
    tvb.add_argument("--limit", type=int, default=0)
    tvb.add_argument("--lanes", type=int, default=64)
    _add_mesh_arg(tvb)

    fuzz = sub.add_parser("fuzz", help="fuzz node (dials the master)")
    _add_common(fuzz)
    fuzz.add_argument("--backend", choices=("gpu", "emu"), default="gpu",
                      help="gpu = one device batch per round on --device "
                           "(default); emu = the single-step oracle, one "
                           "testcase at a time")
    fuzz.add_argument("--limit", type=int, default=0)
    fuzz.add_argument("--address", default=DEFAULT_ADDRESS)
    fuzz.add_argument("--seed", type=int, default=0)
    fuzz.add_argument("--lanes", type=int, default=64)
    fuzz.add_argument("--mux", action="store_true",
                      help="one multiplexed master connection for the whole"
                           " lane batch instead of one per lane (scales a"
                           " wide node past the master's fd budget)")
    fuzz.add_argument("--max-retry-secs", type=float, default=60.0,
                      help="survive mid-campaign socket loss: reconnect "
                           "with jittered exponential backoff for this "
                           "long before giving up (0 = reference "
                           "behavior: first loss ends the node)")
    fuzz.add_argument("--wire-v1", action="store_true",
                      help="speak the legacy (pre-WTF2) hello to a "
                           "not-yet-upgraded master: raw downstream "
                           "frames, no BYE, and therefore no reconnect "
                           "(rolling-upgrade escape hatch)")
    fuzz.add_argument("--no-cov-delta", action="store_true",
                      help="ship whole coverage sets per result (the "
                           "pre-fleet WTF2 wire) instead of streaming "
                           "coverage deltas against the master's ack "
                           "cursor — the escape hatch for masters that "
                           "predate WTF3 (--wire-v1 implies it)")
    _add_mesh_arg(fuzz)

    master = sub.add_parser("master", help="master node (serves testcases)")
    _add_target_args(master)
    master.add_argument("--address", default=DEFAULT_ADDRESS)
    master.add_argument("--runs", type=int, default=0,
                        help="mutation budget; 0 = minset over inputs/")
    master.add_argument("--max_len", type=int, default=1024 * 1024)
    master.add_argument("--seed", type=int, default=0)
    master.add_argument("--reclaim-timeout", type=float, default=0.0,
                        help="reclaim in-flight testcases from a node "
                             "silent this long (presumed dead); 0 = off. "
                             "Reclaim-on-disconnect is always on; SIGTERM "
                             "drains gracefully either way")
    master.add_argument("--store", type=Path, default=None, metavar="DIR",
                        help="content-addressed corpus/crash store root "
                             "(wtf_tpu_torch/fleet/store): digest-named "
                             "blobs in sharded fanout dirs with a manifest "
                             "journal; outputs/ and crashes/ become flat "
                             "views of it")

    fleet = sub.add_parser(
        "fleet", help="fleet tier (wtf_tpu_torch/fleet): elastic "
                      "resharding, the corpus/crash store and the "
                      "thousand-client soak")
    fsub = fleet.add_subparsers(dest="fleet_cmd", required=True)
    fre = fsub.add_parser(
        "reshard", help="resume a checkpointed campaign under a "
                        "DIFFERENT --mesh-devices placement: coverage, "
                        "crash buckets, corpus and devmut streams are "
                        "placement-free, so the resumed run is "
                        "bit-identical to never having moved")
    _add_common(fre)
    fre.add_argument("--checkpoint", type=Path, required=True,
                     metavar="DIR",
                     help="the campaign checkpoint dir to re-place; a "
                          "running campaign writes one at every batch "
                          "boundary under --checkpoint-every")
    fre.add_argument("--runs", type=int, required=True,
                     help="total testcase budget to finish (the budget "
                          "is not part of the checkpoint)")
    fre.add_argument("--limit", type=int, default=0)
    fre.add_argument("--lanes", type=int, default=64,
                     help="must equal the checkpoint's lane count (the "
                          "lane count is the stream identity; lanes per "
                          "shard is what resharding changes)")
    fre.add_argument("--mutator",
                     choices=("auto", "byte", "mangle", "tlv",
                              "devmangle"), default="auto")
    fre.add_argument("--max_len", type=int, default=1024 * 1024)
    fre.add_argument("--seed", type=int, default=0)
    _add_mesh_arg(fre)
    fso = fsub.add_parser(
        "soak", help="the chaos soak (wtf_tpu_torch/fleet/soak): N "
                     "simulated clients over the real wire with injected "
                     "resets/reclaims/frame drops; zero-lost + "
                     "serial-replay-parity + delta-ratio assertions")
    fso.add_argument("--clients", type=int, default=256)
    fso.add_argument("--runs-per-client", type=int, default=60)
    fso.add_argument("--seed", type=int, default=0xF1EE7)
    fso.add_argument("--threads", type=int, default=16)
    fso.add_argument("--min-ratio", type=float, default=10.0)
    ffs = fsub.add_parser(
        "fsck", help="verify (and with --repair, recover) a fleet "
                     "store: quarantine torn blobs, drop journal "
                     "entries whose blob vanished, journal orphans")
    ffs.add_argument("--store", type=Path, required=True, metavar="DIR")
    ffs.add_argument("--namespace", default="default")
    ffs.add_argument("--repair", action="store_true")

    status = sub.add_parser(
        "status", help="live campaign/fleet status: render the "
                       "atomically-refreshed status.json a running "
                       "campaign or master keeps under --telemetry-dir")
    status.add_argument("dir", type=Path,
                        help="the telemetry dir holding status.json")
    status.add_argument("--json", action="store_true",
                        help="print the raw status document")
    status.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                        help="re-render every SECS seconds until ^C "
                             "(0 = render once)")

    lint = sub.add_parser(
        "lint", help="the port's lint: hot-path contracts and the op "
                     "census (wtf_tpu_torch/analysis; the census also on "
                     "the card unless --device cpu)")
    from wtf_tpu_torch.analysis import add_lint_arguments

    add_lint_arguments(lint)

    snap = sub.add_parser(
        "snapshot", help="convert snapshots between formats")
    snap.add_argument("--state", type=Path, required=True,
                      help="input state dir (mem.npz or mem.dmp + regs.json)")
    snap.add_argument("--out", type=Path, required=True,
                      help="output state dir")
    snap.add_argument("--format", choices=("npz", "dmp-bmp", "dmp-full"),
                      default="npz")
    return parser


def _paths_from(args) -> TargetPaths:
    return TargetPaths(target=args.target, inputs=args.inputs,
                       outputs=args.outputs, crashes=args.crashes,
                       state=args.state).resolve()


def _lookup_target(args):
    load_builtin_targets()
    for module in args.target_module:
        importlib.import_module(module)
    return Targets.instance().get(args.name)


@contextmanager
def _telemetry_for(args):
    """One registry + one event sink per CLI invocation, wired into the
    backend, the campaign loop and the heartbeat (wtf_tpu/cli.py
    `_telemetry_for`).  A fresh Registry, so repeated in-process
    invocations don't bleed counters.  Run-start on entry, run-end (with
    the metrics dump) and close on ANY exit, a failed backend build
    included; with --trace-out every span becomes a Chrome-trace complete
    event and every point event an instant mark."""
    registry = Registry()
    events = open_event_log(getattr(args, "telemetry_dir", None))
    trace_out = getattr(args, "trace_out", None)
    collector = None
    if trace_out is not None:
        from wtf_tpu_torch.telemetry import TapEventLog, TraceCollector

        collector = TraceCollector()
        registry.spans.collector = collector

        def _instant(type_, fields):
            if type_ in ("heartbeat", "run-start", "run-end"):
                return
            collector.instant(type_, {
                k: v for k, v in fields.items()
                if isinstance(v, (str, int, float, bool))})

        events = TapEventLog(events, _instant)
    events.emit("run-start", subcommand=args.subcommand,
                name=getattr(args, "name", None),
                backend=getattr(args, "backend", None),
                argv=getattr(args, "_argv", None))
    try:
        yield registry, events
    finally:
        events.emit("run-end", metrics=registry.dump())
        if collector is not None:
            try:
                n = collector.write(trace_out)
                print(f"trace: {n} events -> {trace_out}")
            except OSError as e:
                logging.getLogger("wtf_tpu_torch").warning(
                    "trace write failed: %s", e)
        events.close()


def build_backend(target, args, registry: Registry, events=NULL,
                  init_target: bool = True, mesh=None):
    """The backend of one invocation, initialized and (unless
    `init_target` is False: the fuzz nodes arm the target themselves)
    target-armed: the GpuBackend on --device (a MeshBackend with
    --mesh-devices, or on the LaneMesh `mesh` — a multi-process one, or
    one whose shards share a card, which no flag builds), or the
    single-step oracle for `--backend emu`.  Returns (backend, paths)."""
    from wtf_tpu_torch.backend import create_backend
    from wtf_tpu_torch.snapshot.loader import load_snapshot

    paths = _paths_from(args)
    with registry.spans.span("snapshot-load"):
        if paths.state and Path(paths.state).exists():
            snapshot = load_snapshot(paths.state)
        elif target.snapshot is not None:
            snapshot = target.snapshot()
        else:
            raise SystemExit(f"target {target.name!r} has no snapshot "
                             f"factory and no --state dir was given")
    tuning = _tuning_kwargs(args)
    if mesh is not None:
        tuning["mesh"] = mesh
    with registry.spans.span("init"):
        try:
            backend = create_backend(getattr(args, "backend", "gpu"),
                                     snapshot, n_lanes=args.lanes,
                                     limit=args.limit, registry=registry,
                                     events=events, **tuning)
            backend.initialize()
        except ValueError as e:
            flag = tuning.get("mesh_devices")
            if flag is None and mesh is None:
                raise
            # a mesh this machine or this run cannot take: no fallback
            raise SystemExit(f"--mesh-devices {flag}: {e}" if mesh is None
                             else f"{mesh}: {e}") from e
    if init_target:
        target.init(backend)
    return backend, paths


@dataclasses.dataclass
class ReplayRun:
    path: Path
    result: object      # TestcaseResult
    coverage: set       # new coverage rips
    rip: int            # lane 0 at the end of a device run
    icount: int


def replay(args, registry: Optional[Registry] = None, events=NULL):
    """`run`: every input through lane 0 of the device batch, in the
    reference's RunTestcaseAndRestore order (client.cc:88-180).  Returns
    (backend, [ReplayRun])."""
    from wtf_tpu_torch.core.results import Timedout

    target = _lookup_target(args)
    backend, _ = build_backend(target, args, registry or Registry(), events)
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
            if args.backend == "emu":
                rip, icount = backend.cpu.rip, backend.cpu.icount
            else:
                m = backend.runner.machine
                rip, icount = int(m.rip[0]), int(m.icount[0])
            runs.append(ReplayRun(path, result, backend.last_new_coverage(),
                                  rip & (1 << 64) - 1, icount))
            target.restore()
            backend.restore()
    return backend, runs


def cmd_run(args) -> int:
    crashes = 0
    with _telemetry_for(args) as (registry, events):
        backend, runs = replay(args, registry, events)
        for run in runs:
            if isinstance(run.result, Crash):
                crashes += 1
                events.emit("crash", name=run.result.name,
                            input=run.path.name)
            print(f"{run.path.name}: {run.result} "
                  f"(|cov| = {len(run.coverage)})")
        backend.print_run_stats()
        if args.coverage is not None:
            from wtf_tpu_torch.utils.covfiles import parse_cov_files

            wanted = parse_cov_files(args.coverage)
            covered = backend.aggregate_coverage() & wanted
            print(f"coverage: {len(covered)}/{len(wanted)} "
                  f"listed basic blocks hit")
    return 0 if crashes == 0 else 2


def mutator_for(target, rng: random.Random, max_len: int):
    """The host mutator of `--mutator auto` (wtf_tpu/cli.py `_mutator_for`):
    the target's own, else the native mangle engine, else (no g++) the
    Python one."""
    from wtf_tpu_torch.fuzz.native_mutator import best_mangle_mutator

    if target.create_mutator is not None:
        return target.create_mutator(rng, max_len)
    return best_mangle_mutator(rng, max_len)


def build_campaign(args, registry: Optional[Registry] = None, events=NULL,
                   mesh=None):
    """`campaign` up to its first batch: seed the corpus (left empty for
    the minset, which fills it from its own walk), build the mutator from
    --seed and the FuzzLoop, and with --resume restore the checkpoint
    into it.  `mesh` is a LaneMesh to run on (see build_backend); with
    --coordinator it is the processes' mesh.  Returns the FuzzLoop."""
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import create_mutator

    # checkpoint dir defaulting: explicit flag > the resume dir (a
    # resumed campaign keeps checkpointing in place) > <target>/checkpoint
    ckpt_dir = args.checkpoint_dir or args.resume
    if ckpt_dir is None and args.checkpoint_every and args.target:
        ckpt_dir = Path(args.target) / "checkpoint"
    if args.checkpoint_every and ckpt_dir is None:
        raise SystemExit("--checkpoint-every needs --checkpoint-dir "
                         "(or --target to default one under)")
    if args.resume and args.runs == 0:
        raise SystemExit("--resume applies to fuzz campaigns "
                         "(--runs > 0); minset replays are stateless")
    if args.coordinator or args.num_processes:
        # a multi-process launch joins torch.distributed (gloo) first, and
        # the campaign runs on the global mesh of every process's shards
        # (the first --mesh-devices cards each, N shards of the CPU)
        from wtf_tpu_torch.meshrun.mesh import init_multihost, make_mesh

        mesh = init_multihost(
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id,
            devices=make_mesh(args.mesh_devices, args.device).devices)
    target = _lookup_target(args)
    registry = registry if registry is not None else Registry()
    backend, paths = build_backend(target, args, registry, events,
                                   mesh=mesh)
    rng = random.Random(args.seed or None)
    store = None
    if args.store:
        from wtf_tpu_torch.fleet.store import FleetStore

        store = FleetStore(args.store, registry=registry, events=events)
    if args.runs == 0:
        corpus = Corpus(rng=rng)
    elif paths.inputs and Path(paths.inputs).is_dir():
        corpus = Corpus.load_dir(paths.inputs, rng=rng,
                                 outputs_dir=paths.outputs)
        corpus.store = store
    else:
        corpus = Corpus(outputs_dir=paths.outputs, rng=rng, store=store)
    if args.mutator == "auto":
        mutator = mutator_for(target, rng, args.max_len)
    else:
        mutator = create_mutator(args.mutator, rng, args.max_len)
    loop = FuzzLoop(backend, target, mutator, corpus,
                    crashes_dir=paths.crashes, registry=registry,
                    events=events, checkpoint_dir=ckpt_dir,
                    checkpoint_every=args.checkpoint_every, store=store,
                    megachunk=args.megachunk,
                    xprof_dir=getattr(args, "xprof_dir", None),
                    xprof_batches=getattr(args, "xprof_batches", 4))
    if args.resume:
        from wtf_tpu_torch.resume import load_campaign, restore_campaign

        state, fell_back = load_campaign(args.resume)
        batch = restore_campaign(loop, state, args.resume)
        note = " (newest torn; resumed from .prev)" if fell_back else ""
        print(f"resumed at batch {batch}: "
              f"{loop.stats.testcases} testcases, "
              f"{len(corpus)} corpus entries{note}")
    return loop


def campaign(args, registry: Optional[Registry] = None, events=NULL,
             mesh=None):
    """`campaign`: build it (build_campaign) and run the fuzz loop until
    --runs testcases (or the first crash with --stop-on-crash).  Returns
    the FuzzLoop.  A device the supervisor cannot rebuild in this process
    ends the campaign with the message to resume from its last
    checkpoint."""
    from wtf_tpu_torch.supervise import DeviceLost

    loop = build_campaign(args, registry, events, mesh)
    try:
        loop.fuzz(runs=args.runs, print_stats=True,
                  stop_on_crash=args.stop_on_crash)
    except DeviceLost as e:
        raise SystemExit(f"campaign stopped at batch {loop.batches_done}: "
                         f"{e}") from e
    return loop


def _minset_seed_walk(paths: TargetPaths, corpus):
    """The ONE minset measurement walk shared by `campaign --runs 0` and
    `triage distill`: a single scan over inputs/ AND any prior outputs/
    feeds `corpus` (shared size-sorted replay ordering; add_digested
    dedups) and snapshots outputs/ (pre-dedup census) so it can end as
    exactly the kept subset of what was measured.  Returns the
    [(path, digest)] outputs snapshot."""
    from wtf_tpu_torch.fuzz.corpus import seed_paths

    out_dir = Path(paths.outputs) if paths.outputs else None
    outputs_snapshot = []
    for p, digest, data in seed_paths([paths.inputs, paths.outputs],
                                      with_data=True, keep_dups=True):
        corpus.add_digested(data, digest)
        if out_dir and p.parent == out_dir:
            outputs_snapshot.append((p, digest))
    return outputs_snapshot


def _prune_outputs(outputs_snapshot, kept) -> None:
    """outputs/ ends as exactly the kept subset of what was measured:
    every snapshot file's content was replayed (directly or via a
    content-identical twin), so prune by content digest.  Files that
    appeared after the walk were never measured and stay untouched."""
    for p, digest in outputs_snapshot:
        if not (digest in kept.digests and p.name == digest):
            p.unlink(missing_ok=True)


def _leave_processes(loop) -> None:
    """A campaign whose mesh spans processes leaves torch.distributed
    together: a barrier, so that no process exits while another still
    talks to it (gloo aborts the process whose peer went away), then the
    group's teardown."""
    mesh = getattr(loop.backend, "mesh", None)
    if mesh is not None and mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def cmd_campaign(args) -> int:
    with _telemetry_for(args) as (registry, events):
        if args.runs == 0:
            # reference semantics (server.h:552-556): replay the seeds —
            # plus any prior campaign's outputs/, so a corpus can
            # minimize itself — and leave outputs/ holding exactly the
            # coverage-minimal subset
            loop = build_campaign(args, registry, events)
            paths = _paths_from(args)
            outputs_snapshot = _minset_seed_walk(paths, loop.corpus)
            kept = loop.minset(paths.outputs, print_stats=True)
            _prune_outputs(outputs_snapshot, kept)
            print(loop.stats.line(len(loop.corpus), loop._coverage()))
            print(f"minset: kept {len(kept)}/{len(loop.corpus)} seeds")
            _leave_processes(loop)
            return 0 if loop.stats.crashes == 0 else 2
        loop = campaign(args, registry, events)
        print(loop.stats.line(len(loop.corpus), loop._coverage()))
        loop.backend.print_run_stats()
        if loop.reshard_to is not None:
            # the supervisor's bottom rung stopped a failing mesh campaign
            print(f"reshard requested at batch {loop.batches_done}: "
                  f"continue with `fleet reshard --checkpoint "
                  f"{loop.checkpoint_dir} --mesh-devices "
                  f"{loop.reshard_to} --runs {args.runs}`")
        _leave_processes(loop)
        return 0 if loop.stats.crashes == 0 else 2


def sched(args, registry: Optional[Registry] = None, events=NULL):
    """`sched`: place the jobs table onto one device batch and run it to
    completion (wtf_tpu_torch/tenancy/sched.py).  Returns (Scheduler,
    {job name: summary})."""
    from wtf_tpu_torch.tenancy.sched import Scheduler, load_jobs

    load_builtin_targets()
    for module in args.target_module:
        importlib.import_module(module)
    jobs = load_jobs(args.jobs)
    registry = registry if registry is not None else Registry()
    store = None
    if args.store:
        from wtf_tpu_torch.fleet.store import FleetStore

        store = FleetStore(args.store, registry=registry, events=events)
    tuning = _tuning_kwargs(args)
    mesh_devices = tuning.pop("mesh_devices", None)
    scheduler = Scheduler(jobs, n_lanes=args.lanes, workdir=args.workdir,
                          limit=args.limit, quantum=args.quantum,
                          mesh_devices=mesh_devices, registry=registry,
                          events=events, backend_tuning=tuning, store=store)
    return scheduler, scheduler.run(max_rounds=args.max_rounds)


def cmd_sched(args) -> int:
    with _telemetry_for(args) as (registry, events):
        scheduler, summary = sched(args, registry, events)
    crashes = 0
    for name, s in summary.items():
        crashes += s["crashes"]
        state = ("done" if s["done"]
                 else f"stopped at batch {s['batches']}")
        print(f"[sched] {name}: {state}, {s['testcases']} testcases, "
              f"{s['crashes']} crashes, {s['preemptions']} preemptions")
    print(f"[sched] {scheduler.rounds} rounds over {args.lanes} lanes")
    return 0 if crashes == 0 else 2


# ---------------------------------------------------------------------------
# triage (wtf_tpu/cli.py cmd_triage and its subcommands)
# ---------------------------------------------------------------------------

def _parse_break_at(spec: str, symbols: dict) -> int:
    """hex address, symbol, or symbol+0xOFF over the snapshot's symbol
    store (the reference resolves bp sites the same way, backend.cc:
    214-239)."""
    base, _, off = spec.partition("+")
    offset = int(off, 0) if off else 0
    try:
        return int(base, 0) + offset
    except ValueError:
        pass
    if base in symbols:
        return int(symbols[base]) + offset
    raise SystemExit(
        f"--break-at {spec!r}: not an address and not in the symbol "
        f"store ({len(symbols)} symbols; e.g. {sorted(symbols)[:4]})")


def _triage_inputs(path: Path) -> List[tuple]:
    """[(name, bytes)] for a testcase file or directory."""
    if path.is_dir():
        return [(p.name, p.read_bytes())
                for p in sorted(p for p in path.iterdir() if p.is_file())]
    return [(path.name, path.read_bytes())]


def cmd_triage(args) -> int:
    """`triage {minimize,distill,vbreak}` — the batched triage engine
    (wtf_tpu_torch/triage): replay variants at campaign throughput on the
    same card and kernels."""
    target = _lookup_target(args)
    with _telemetry_for(args) as (registry, events):
        backend, paths = build_backend(target, args, registry, events)
        command = {"minimize": _triage_minimize, "distill": _triage_distill,
                   "vbreak": _triage_vbreak}[args.triage_cmd]
        return command(args, paths, backend, target, registry, events)


def _triage_minimize(args, paths, backend, target, registry, events) -> int:
    from wtf_tpu_torch.triage import minimize
    from wtf_tpu_torch.utils.atomicio import atomic_write_bytes

    crasher = args.input.read_bytes()
    try:
        result = minimize(backend, target, crasher,
                          registry=registry, events=events,
                          max_rounds=args.max_rounds)
    except ValueError as e:
        print(f"minimize: {e}")
        return 1
    out = args.output or args.input.with_name(args.input.name + ".min")
    atomic_write_bytes(out, result.data)
    print(f"minimize: {result.from_len} -> {len(result.data)} bytes "
          f"(bucket {result.bucket}; {result.rounds} rounds, "
          f"{result.dispatches} dispatches, {result.candidates} "
          f"candidates, {result.simplified} bytes zeroed)")
    print(f"wrote {out}")
    return 0


def _triage_distill(args, paths, backend, target, registry, events) -> int:
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.triage import distill

    out_dir = Path(paths.outputs) if paths.outputs else None
    outputs_snapshot: List[tuple] = []
    if args.from_checkpoint:
        # checkpoint-aware input: the campaign checkpoint's corpus, in
        # manifest order with digests verified (wtf_tpu_torch/resume).
        # The checkpoint is the measurement domain — pre-existing outputs/
        # files were not measured and stay untouched.
        from wtf_tpu_torch.resume import load_campaign
        from wtf_tpu_torch.resume.checkpoint import restore_corpus

        state, _ = load_campaign(args.from_checkpoint)
        source = Corpus()
        restore_corpus(source, state, args.from_checkpoint)
    else:
        # the campaign --runs 0 measurement walk + prune, shared with
        # minset so the two can never drift on which outputs/ files they
        # delete
        source = Corpus()
        outputs_snapshot = _minset_seed_walk(paths, source)
    if not len(source):
        raise SystemExit("distill found no seeds (--inputs/--target "
                         "dirs, or --from-checkpoint)")
    testcases = list(source)
    result = distill(backend, target, testcases,
                     registry=registry, events=events)
    kept = Corpus(outputs_dir=out_dir)
    for idx in result.keep:
        kept.add(testcases[idx])
    _prune_outputs(outputs_snapshot, kept)
    crashes = registry.counter("triage.crashes").value
    print(f"distill: kept {len(result.keep)}/{len(testcases)} seeds "
          f"(exact cover, {result.kept_bits}/{result.total_bits} bits; "
          f"prefix minset would keep {len(result.prefix_keep)}; "
          f"{registry.counter('triage.dispatches').value} dispatches, "
          f"{crashes} crashes)")
    if out_dir:
        print(f"wrote minset to {out_dir}")
    return 0


def _triage_vbreak(args, paths, backend, target, registry, events) -> int:
    import json

    from wtf_tpu_torch.triage import oracle_capture, perturbations, vbreak
    from wtf_tpu_torch.triage.bucket import TOS_BYTES

    rip = _parse_break_at(args.break_at, getattr(backend, "symbols", {}))
    mem_gva, mem_len = None, TOS_BYTES
    if args.mem:
        try:
            gva_s, _, len_s = args.mem.partition(":")
            mem_gva = int(gva_s, 0)
            mem_len = int(len_s, 0) if len_s else TOS_BYTES
        except ValueError:
            raise SystemExit(f"--mem {args.mem!r}: expected GVA[:LEN] "
                             "(hex ok, e.g. 0x7fffe000:128)")
    testcases = []
    for _, data in _triage_inputs(args.input):
        testcases.extend(perturbations(data, args.variants + 1))
    try:
        if args.backend == "emu":
            captures = [
                oracle_capture(backend, target, data, rip, index=i,
                               hit=args.hit, min_icount=args.min_icount,
                               mem_gva=mem_gva, mem_len=mem_len)
                for i, data in enumerate(testcases)]
        else:
            captures, _results = vbreak(
                backend, target, testcases, rip, hit=args.hit,
                min_icount=args.min_icount, mem_gva=mem_gva,
                mem_len=mem_len, registry=registry, events=events)
    except ValueError as e:
        # e.g. the target's init already owns the breakpoint — the same
        # clean one-liner the minimize subcommand gives
        print(f"vbreak: {e}")
        return 1
    got = [c for c in captures if c is not None]
    print(f"vbreak: {len(got)}/{len(testcases)} replays captured at "
          f"{rip:#x} (hit {args.hit})")
    for c in got:
        print(f"  #{c.index} icount={c.icount} rip={c.rip:#x} "
              f"rsp={c.gpr[4]:#x} rax={c.gpr[0]:#x} "
              f"mem[{len(c.mem)}]@{c.mem_gva:#x}={c.mem[:16].hex()}")
    if args.out:
        args.out.write_text(json.dumps(
            [c.as_dict() if c else None for c in captures], indent=1))
        print(f"wrote {args.out}")
    return 0


# ---------------------------------------------------------------------------
# the master/client plane (wtf_tpu/cli.py cmd_fuzz, cmd_master, cmd_fleet,
# cmd_status)
# ---------------------------------------------------------------------------

def fuzz(args, registry: Optional[Registry] = None, events=NULL):
    """`fuzz`: build the backend and serve the master at --address until it
    says BYE (or stays gone past --max-retry-secs).  Returns the node
    (`BatchClient` for --backend gpu, `Client` for emu), whose `runs`
    and `rounds` say what it served."""
    from wtf_tpu_torch.dist.client import BatchClient, Client

    target = _lookup_target(args)
    registry = registry if registry is not None else Registry()
    backend, _ = build_backend(target, args, registry, events,
                               init_target=False)
    kwargs = dict(registry=registry, events=events, print_stats=True,
                  max_retry_secs=args.max_retry_secs,
                  wire_v1=args.wire_v1, cov_delta=not args.no_cov_delta)
    if args.backend == "gpu":
        node = BatchClient(backend, target, args.address, mux=args.mux,
                           **kwargs)
    else:
        node = Client(backend, target, args.address, **kwargs)
    node.run()
    return node


def cmd_fuzz(args) -> int:
    with _telemetry_for(args) as (registry, events):
        node = fuzz(args, registry, events)
    print(f"node served {node.runs} testcases")
    return 0


def master(args, registry: Optional[Registry] = None, events=NULL):
    """`master`: the testcase server over the target's host mutator
    (`mutator_for`, as the JAX CLI's `_mutator_for`).  It builds no
    backend and does no device work.  Runs until the budget is served
    (or a SIGTERM drain) and returns the Server."""
    from wtf_tpu_torch.dist.server import Server
    from wtf_tpu_torch.fuzz.corpus import Corpus

    target = _lookup_target(args)
    paths = _paths_from(args)
    registry = registry if registry is not None else Registry()
    rng = random.Random(args.seed or None)
    store = None
    if args.store:
        from wtf_tpu_torch.fleet.store import FleetStore

        store = FleetStore(args.store, registry=registry, events=events)
    corpus = Corpus(outputs_dir=paths.outputs, rng=rng, store=store)
    coverage_path = (Path(paths.target) / "coverage.cov"
                     if paths.target else None)
    server = Server(args.address, mutator_for(target, rng, args.max_len),
                    corpus, inputs_dir=paths.inputs,
                    crashes_dir=paths.crashes, runs=args.runs,
                    max_len=args.max_len, print_stats=True,
                    coverage_path=coverage_path, registry=registry,
                    events=events, reclaim_timeout=args.reclaim_timeout,
                    store=store, telemetry_dir=args.telemetry_dir)
    server.run()
    return server


def cmd_master(args) -> int:
    with _telemetry_for(args) as (registry, events):
        server = master(args, registry, events)
    print(server.stats.line(len(server.coverage), len(server.corpus), 0))
    if server.drained:
        # SIGTERM drain: state persisted, nodes notified — a supervisor
        # restarting the master must read this as a clean stop
        print("master drained (state persisted)")
        return 0
    return 0 if server.stats.crashes == 0 else 2


def cmd_fleet(args) -> int:
    """`fleet {reshard,soak,fsck}` — the fleet tier
    (wtf_tpu_torch/fleet)."""
    import json

    if args.fleet_cmd == "reshard":
        return fleet_reshard(args)
    if args.fleet_cmd == "soak":
        import tempfile

        from wtf_tpu_torch.fleet.soak import run_soak

        logging.getLogger("wtf_tpu_torch").setLevel(logging.ERROR)
        with tempfile.TemporaryDirectory() as tmp:
            report = run_soak(tmp, clients=args.clients,
                              runs_per_client=args.runs_per_client,
                              seed=args.seed, threads=args.threads,
                              min_ratio=args.min_ratio)
        print(json.dumps(report, indent=1))
        print(f"fleet soak PASS ({report['clients']} clients, zero "
              f"lost, delta {report['delta_ratio']}x smaller)")
        return 0
    from wtf_tpu_torch.fleet.store import FleetStore

    store = FleetStore(args.store, namespace=args.namespace)
    report = store.verify(repair=args.repair)
    print(f"fsck {args.store}/{args.namespace}: "
          f"{report['ok']}/{report['blobs']} blobs ok, "
          f"{len(report['torn'])} torn, "
          f"{len(report['missing'])} missing, "
          f"{len(report['orphans'])} orphan(s)"
          + (" — repaired" if args.repair else ""))
    broken = report["torn"] or report["missing"] or report["orphans"]
    return 0 if (args.repair or not broken) else 1


def fleet_reshard(args) -> int:
    """Resume a checkpointed campaign under a different --mesh-devices
    placement (wtf_tpu_torch/fleet/elastic).  Checkpoints are
    placement-free and the devmut stream does not depend on the shard
    count, so the resumed run is bit-identical to one that never moved."""
    from wtf_tpu_torch.fleet.elastic import (
        describe_checkpoint, run_elastic, validate_placement,
    )
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import create_mutator
    from wtf_tpu_torch.resume import CheckpointError, load_campaign

    try:
        info = describe_checkpoint(args.checkpoint)
        state, _ = load_campaign(args.checkpoint)
        validate_placement(state, args.mesh_devices)
    except (CheckpointError, ValueError) as e:
        print(f"reshard: {e}")
        return 1
    cfg = info["config"]
    print(f"reshard: checkpoint at batch {info['batches']} "
          f"({cfg.get('lanes')} lanes on "
          f"{cfg.get('mesh_devices') or 1} device(s), "
          f"{info['corpus']} corpus entries) -> "
          f"{args.mesh_devices or 1} device(s)")
    target = _lookup_target(args)
    with _telemetry_for(args) as (registry, events):

        def build_loop(mesh_devices):
            placed = argparse.Namespace(**{**vars(args),
                                           "mesh_devices": mesh_devices})
            backend, paths = build_backend(target, placed, registry, events)
            rng = random.Random(args.seed or None)
            corpus = Corpus(outputs_dir=paths.outputs, rng=rng)
            mutator = (mutator_for(target, rng, args.max_len)
                       if args.mutator == "auto"
                       else create_mutator(args.mutator, rng, args.max_len))
            return FuzzLoop(backend, target, mutator, corpus,
                            crashes_dir=paths.crashes, registry=registry,
                            events=events, checkpoint_dir=args.checkpoint,
                            checkpoint_every=1)

        loop = run_elastic(build_loop, args.runs, args.checkpoint,
                           start_devices=args.mesh_devices, resume=True,
                           print_stats=True)
        print(loop.stats.line(len(loop.corpus), loop._coverage()))
        return 0 if loop.stats.crashes == 0 else 2


def _derived_status_rows(metrics: dict) -> List[str]:
    """The operator-facing derived lines shared by campaign and fleet
    status (wtf_tpu/cli.py `_derived_status_rows`): each row appears only
    when its subsystem actually ran, so a plain campaign renders just the
    heartbeat line."""
    rows: List[str] = []

    def val(name, default=0):
        v = metrics.get(name, default)
        return v if isinstance(v, (int, float)) else default

    instr = val("device.instructions")
    fused = val("device.fused_steps")
    if fused and instr:
        rows.append(f"fused occupancy: {fused / instr:.1%}")
    windows = val("megachunk.windows")
    if windows:
        zh = val("devdec.zero_host_windows")
        rows.append(f"zero-host windows: {zh}/{windows} "
                    f"({zh / windows:.0%})")
        rounds = val("device.fused_window_rounds")
        sweeps = val("device.fused_window_xla_steps")
        if rounds:
            rows.append(f"fused windows: "
                        f"{rounds / (rounds + sweeps):.1%} of "
                        f"{rounds + sweeps} quiesce dispatches "
                        f"in-kernel")
            saved = val("device.fused_window_bytes_saved")
            if saved:
                rows.append(f"donation: {saved / (1 << 20):.1f} MiB "
                            f"copy-through saved "
                            f"({saved // max(rounds, 1)} B/dispatch)")
        prelaunched = val("megachunk.prelaunched")
        if prelaunched:
            rows.append(f"prelaunch: "
                        f"{val('megachunk.prelaunch_hits')}/{prelaunched}"
                        f" adopted, {val('megachunk.prelaunch_dropped')}"
                        f" dropped")
    phase = metrics.get("phase.seconds") or {}
    if isinstance(phase, dict) and phase:
        from wtf_tpu_torch.telemetry.spans import DEVICE_SPAN_LEAVES

        top = sum(s for p, s in phase.items() if "/" not in p)
        dev = sum(s for p, s in phase.items()
                  if "/" in p and p.split("/")[-1] in DEVICE_SPAN_LEAVES)
        if top:
            rows.append(f"host share: "
                        f"{max(top - dev, 0.0) / top:.1%} of "
                        f"accounted wall")
    if val("supervise.dispatches"):
        rows.append(f"supervisor: rung {val('supervise.rung')}, "
                    f"{val('supervise.rebuilds')} rebuilds, "
                    f"{val('supervise.quarantined_lanes')} lanes "
                    f"quarantined")
    delta = val("dist.cov_bytes_delta")
    bitmap = val("dist.cov_bytes_bitmap")
    if delta and bitmap:
        rows.append(f"delta frames: {bitmap - delta} cov bytes saved "
                    f"({bitmap / delta:.1f}x smaller)")
    tenants = sorted({name.split(".")[1] for name in metrics
                      if name.startswith("tenant.")
                      and len(name.split(".")) >= 3})
    for t in tenants:
        rows.append(f"tenant {t}: "
                    f"execs={metrics.get(f'tenant.{t}.testcases', 0) or 0}"
                    f" newcov="
                    f"{metrics.get(f'tenant.{t}.new_coverage', 0) or 0}"
                    f" crashes="
                    f"{metrics.get(f'tenant.{t}.crashes', 0) or 0}")
    return rows


def _render_status(doc: dict) -> None:
    age = max(time.time() - float(doc.get("ts", 0) or 0), 0.0)
    if doc.get("kind") == "fleet":
        print(f"fleet: {doc.get('nodes', 0)} node(s), "
              f"{doc.get('frames', 0)} telem frames "
              f"({doc.get('duplicates_dropped', 0)} duplicates dropped), "
              f"as of {age:.0f}s ago")
        for row in doc.get("per_node", []):
            print(f"  {row.get('node', '?')[:12]:<12} "
                  f"seq={row.get('seq')}/e{row.get('epoch')} "
                  f"execs={row.get('testcases')} "
                  f"({row.get('execs_per_s')}/s) "
                  f"crash={row.get('crashes')} "
                  f"newcov={row.get('new_coverage')}")
    else:
        print(f"campaign: batch {doc.get('batches', 0)}, "
              f"as of {age:.0f}s ago")
        if doc.get("line"):
            print(f"  {doc['line']}")
    for row in _derived_status_rows(doc.get("metrics") or {}):
        print(f"  {row}")


def cmd_status(args) -> int:
    """`status <dir>`: render the status.json a running campaign
    (FuzzLoop._write_status, every heartbeat) or fleet master
    (FleetTelemetry.write_exports, every persistence interval) refreshes
    atomically — readers always see a complete document."""
    import json

    path = args.dir / "status.json"
    while True:
        try:
            doc = json.loads(path.read_text())
        except FileNotFoundError:
            print(f"status: no status.json under {args.dir} — is the "
                  f"campaign/master running with --telemetry-dir?")
            return 1
        except ValueError:
            doc = None  # mid-rotation torn read: keep the last render
        if doc is not None:
            if args.json:
                print(json.dumps(doc))
            else:
                if args.watch:
                    print("\x1b[2J\x1b[H", end="")
                _render_status(doc)
        if not args.watch:
            return 0
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


def cmd_lint(args) -> int:
    """`lint`: the port's lint (wtf_tpu_torch/analysis), telemetry-wired
    like every other subcommand — findings land in the registry
    (`analysis.*`) and the JSONL stream."""
    from wtf_tpu_torch.analysis import lint_main

    families = args.families.split(",") if args.families else None
    with _telemetry_for(args) as (registry, events):
        return lint_main(families=families, budgets=args.budgets,
                         rebaseline=args.rebaseline,
                         allow_regression=args.allow_regression,
                         as_json=args.json, deep=args.deep,
                         sarif=str(args.sarif) if args.sarif else None,
                         device=args.device,
                         registry=registry, events=events)


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
    # the argv actually parsed — the provenance in the run-start event
    args._argv = list(argv) if argv is not None else sys.argv[1:]
    if args.subcommand in ("fuzz", "master", "fleet"):
        # the master/client plane reports operational events (reconnects,
        # reclaims, drains, malformed frames) through `logging`: a
        # message-only handler on the CURRENT stdout, scoped to this
        # package's logger, as the JAX CLI's main does
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        wlog = logging.getLogger("wtf_tpu_torch")
        wlog.handlers[:] = [handler]
        wlog.setLevel(logging.INFO)
        wlog.propagate = False
    return {"run": cmd_run, "campaign": cmd_campaign, "sched": cmd_sched,
            "triage": cmd_triage, "fuzz": cmd_fuzz, "master": cmd_master,
            "fleet": cmd_fleet, "status": cmd_status, "lint": cmd_lint,
            "snapshot": cmd_snapshot}[args.subcommand](args)


def console_main() -> None:
    sys.exit(main())


if __name__ == "__main__":
    console_main()
