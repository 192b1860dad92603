"""Build the real entry points: a warmed demo_tlv Runner, a timed chunk,
a two-tenant Runner, and a demo_tlv FuzzLoop ready to fuzz.

The counterpart of the builders of wtf_tpu/analysis/trace.py (its jaxpr
and HLO lowerings have no torch counterpart).  Every builder takes
`device`, default cuda like every entry point of the port (it raises on a
machine without a CUDA device; pass "cpu" to run on the CPU).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

DEFAULT_PAYLOAD = b"\x01\x08AAAAAAAA" * 200
TLV_SEED = b"\x01\x04AAAA\x02\x08BBBBBBBB"


def insert_payload(runner, payload: bytes) -> None:
    """Write `payload` (demo_tlv calling convention: bytes at INPUT_GVA,
    length in rdx) into every lane and push."""
    from wtf_tpu_torch.harness import demo_tlv

    view = runner.view()
    for lane in range(runner.n_lanes):
        view.virt_write(lane, demo_tlv.INPUT_GVA, payload)
        view.r["gpr"][lane, 2] = np.uint64(len(payload))
    runner.push(view)


def build_tlv_runner(n_lanes: int = 1024, chunk_steps: int = 512,
                     payload: Optional[bytes] = DEFAULT_PAYLOAD,
                     snapshot=None, warm: bool = True, limit: int = 0,
                     device="cuda", **runner_kwargs):
    """A demo_tlv Runner ready to dispatch: decode cache warmed through
    the host oracle, payload inserted in every lane.  `payload=None`
    skips both."""
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.interp.runner import Runner, warm_decode_cache

    if snapshot is None:
        snapshot = demo_tlv.build_snapshot()
    runner = Runner(snapshot, n_lanes=n_lanes, chunk_steps=chunk_steps,
                    device=device, **runner_kwargs)
    runner.limit = limit
    if payload is not None:
        if warm:
            warm_decode_cache(runner, demo_tlv.TARGET, payload)
        insert_payload(runner, payload)
    return runner


def timed_chunk(runner, limit: int = 1 << 40) -> dict:
    """Run the runner's precise chunk (`chunk_steps` steps) twice, the
    first from a cold start; returns {"cold_wall_s", "warm_wall_s",
    "instr"} (instructions retired by the second).  Leaves the machine
    at the post-chunk state."""
    import torch

    from wtf_tpu_torch.interp.step import run_steps

    tab = runner.device_tab()
    m = runner.machine

    def chunk() -> float:
        t0 = time.perf_counter()
        run_steps(tab, runner.image, m, limit, runner.chunk_steps)
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)
        return time.perf_counter() - t0

    cold_s = chunk()
    ic0 = m.icount.clone()
    warm_s = chunk()
    return {"cold_wall_s": cold_s, "warm_wall_s": warm_s,
            "instr": int((m.icount - ic0).sum())}


def build_tenant_runner(quotas=(2, 2), order=("demo_tlv", "demo_kernel"),
                        chunk_steps: int = 16, device="cuda",
                        **runner_kwargs):
    """A heterogeneous two-tenant Runner (wtf_tpu_torch/tenancy): the
    `order`ed targets' lanes behind one stacked image table, no decode
    warmup, no payload."""
    from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.tenancy.backend import TenantSpec

    load_builtin_targets()
    targets = Targets.instance()
    specs = []
    for name, lanes in zip(order, quotas):
        target = targets.get(name)
        specs.append(TenantSpec(name=name, target=target,
                                snapshot=target.snapshot(), lanes=lanes))
    return Runner(specs[0].snapshot, n_lanes=sum(quotas),
                  chunk_steps=chunk_steps, tenants=specs, device=device,
                  **runner_kwargs)


def build_tlv_campaign(n_lanes: int = 64, mutator: str = "mangle",
                       limit: int = 100_000, seed: int = 0x77F,
                       max_len: int = 0x400, registry=None,
                       megachunk: int = 0, device="cuda",
                       **backend_kwargs):
    """A demo_tlv FuzzLoop ready to fuzz: the gpu backend built and
    initialized (a MeshBackend with `mesh_devices=N` or `mesh=LaneMesh`),
    target init done, one TLV seed in the corpus, and the mutation engine
    picked by name ("mangle" = the best host engine; "devmangle" = the
    device engine, wtf_tpu_torch/devmut)."""
    import random

    from wtf_tpu_torch.backend import create_backend
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import create_mutator
    from wtf_tpu_torch.fuzz.native_mutator import best_mangle_mutator
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.telemetry import Registry

    registry = registry if registry is not None else Registry()
    backend = create_backend("gpu", demo_tlv.build_snapshot(),
                             n_lanes=n_lanes, limit=limit,
                             registry=registry, device=device,
                             **backend_kwargs)
    backend.initialize()
    demo_tlv.TARGET.init(backend)
    rng = random.Random(seed)
    corpus = Corpus(rng=rng)
    corpus.add(TLV_SEED)
    mut = (best_mangle_mutator(rng, max_len) if mutator == "mangle"
           else create_mutator(mutator, rng, max_len))
    return FuzzLoop(backend, demo_tlv.TARGET, mut, corpus,
                    registry=registry, megachunk=megachunk)
