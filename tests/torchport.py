"""Shared helpers for the differential tests of the PyTorch port
(tests/test_torch_*.py): build the same guest in both packages, carry
state between them through wtf_tpu_torch.convert, and compare.

Everything runs on the CPU: the JAX side with JAX_PLATFORMS=cpu (the
Pallas kernel in interpret mode), the port with `device="cpu"`, where its
kernels run their plain PyTorch versions.  All state is integer, so every
comparison is bit-exact.
"""

from __future__ import annotations

import pickle
import subprocess
import tempfile
from functools import lru_cache, partial
from pathlib import Path
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np
import pytest

from tests.asmhelper import assemble
from tests.emurunner import CODE_BASE, STACK_TOP
from wtf_tpu.interp.machine import Machine as JMachine
from wtf_tpu.interp.uoptable import UopTable as JTable
from wtf_tpu.mem.overlay import DirtyOverlay as JOverlay
from wtf_tpu.mem.physmem import MemImage as JImage
from wtf_tpu.snapshot.synthetic import SyntheticSnapshotBuilder as JBuilder
from wtf_tpu_torch import convert
from wtf_tpu_torch.core.gxa import PAGE_SIZE
from wtf_tpu_torch.cpu.emu import (
    DivideError, EmuCpu, EmuMem, GuestCrash, MemFault, UnsupportedInsn,
)
from wtf_tpu_torch.interp.machine import machine_init
from wtf_tpu_torch.interp.runner import Runner
from wtf_tpu_torch.mem.physmem import PhysMem
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

# one padded image geometry for every lockstep case, so the JAX executors
# compile once per test file
IMAGE_SLOTS = 64
IMAGE_SPAN = 2048


# ---------------------------------------------------------------------------
# guests
# ---------------------------------------------------------------------------

def build_guest(asm: str, data: Optional[Dict[int, bytes]] = None,
                regs: Optional[Dict[str, int]] = None,
                readonly: Optional[Dict[int, int]] = None,
                large: Optional[tuple] = None):
    """Assemble `asm` at CODE_BASE with a stack, data mappings and
    optional read-only mappings ({gva: size}) / one large-page mapping
    ((gva, gpa, size_shift, {gpa: bytes}) with a sibling 4K page mapped).
    Returns (pages, port CpuState); the JAX package's SyntheticSnapshotBuilder
    yields the identical pages (same bump allocator), see jax_guest."""
    b = SyntheticSnapshotBuilder()
    _populate(b, asm, data, readonly, large)
    pages, cpu = b.build(rip=CODE_BASE, rsp=STACK_TOP - 0x100)
    for name, value in (regs or {}).items():
        setattr(cpu, name, value)
    return pages, cpu


def _populate(b, asm, data, readonly, large):
    b.write(CODE_BASE, assemble(asm))
    b.map(STACK_TOP - 0x4000, 0x5000)
    for gva, blob in (data or {}).items():
        b.write(gva, blob)
    for gva, size in (readonly or {}).items():
        b.map(gva, size, writable=False)
    if large is not None:
        gva, gpa, shift, blobs = large
        b.map(gva + (1 << shift), 0x1000)
        b.add_large_page_mapping(gva, gpa, shift)
        for at, blob in blobs.items():
            b._phys_page(at >> 12)[at & 0xFFF:(at & 0xFFF) + len(blob)] \
                = blob


def jax_guest(asm: str, data=None, regs=None, readonly=None, large=None):
    """The same guest through the JAX package's snapshot code -> (pages,
    CpuState of the JAX package)."""
    b = JBuilder()
    _populate(b, asm, data, readonly, large)
    pages, cpu = b.build(rip=CODE_BASE, rsp=STACK_TOP - 0x100)
    for name, value in (regs or {}).items():
        setattr(cpu, name, value)
    return pages, cpu


def oracle_rips(pages, cpu, max_steps: int = 20_000):
    """Every rip the host oracle visits, in order (until int3/hlt, a
    fault, #DE or an instruction the oracle does not model)."""
    emu = EmuCpu(EmuMem(PhysMem.from_pages(pages)), cpu.copy())
    rips = []
    for _ in range(max_steps):
        rips.append(emu.rip)
        try:
            emu.step()
        except (GuestCrash, MemFault, DivideError, UnsupportedInsn):
            break
    return rips


def warm_runner(pages, cpu, n_lanes: int = 4, uop_capacity: int = 1024,
                overlay_slots: int = 8, **kw) -> Runner:
    """A CPU Runner whose decode cache holds every instruction the oracle
    reaches in the guest (decoded from the pristine image)."""
    r = Runner(Snapshot.from_pages(pages, cpu), n_lanes=n_lanes,
               uop_capacity=uop_capacity, overlay_slots=overlay_slots,
               device="cpu", **kw)
    view = r.view()
    for rip in dict.fromkeys(oracle_rips(pages, cpu)):
        if not r.cache.has(rip):
            r._decode_at(view, 0, rip)
    return r


def padded_image(pages) -> Dict[str, np.ndarray]:
    """The image of `pages` at the fixed IMAGE_SLOTS x IMAGE_SPAN geometry
    (PhysMem's slot order), as JAX-layout numpy leaves."""
    pfns = sorted(pages)
    assert len(pfns) < IMAGE_SLOTS and max(pfns) < IMAGE_SPAN
    packed = np.zeros((IMAGE_SLOTS, PAGE_SIZE), dtype=np.uint8)
    table = np.zeros((1, IMAGE_SPAN), dtype=np.int32)
    for slot, pfn in enumerate(pfns, start=1):
        packed[slot] = np.frombuffer(pages[pfn], dtype=np.uint8)
        table[0, pfn] = slot
    return {"pages": packed.view(np.uint64), "frame_table": table}


def initial_machine(cpu, n_lanes, uop_capacity, overlay_slots,
                    lane_regs=None):
    """The port's batch at the snapshot state, with optional per-lane
    register values ({lane: {gpr index: value}})."""
    m = machine_init(cpu, n_lanes, uop_capacity, overlay_slots,
                     device="cpu")
    for lane, regs in (lane_regs or {}).items():
        for idx, value in regs.items():
            m.gpr[lane, idx] = convert.pack_limbs(np.array(
                [value & 0xFFFFFFFF, value >> 32 & 0xFFFFFFFF],
                dtype=np.uint32)).item()
    return m


def lockstep(asm, data=None, regs=None, lane_regs=None, limit=0,
             n_lanes=4, max_steps=3000, uop_capacity=1024, overlay_slots=8):
    """Step the JAX step_lane (`make_run_chunk(1)`) and the port's
    `run_steps` (which computes only the opclass groups its scan finds)
    from the same state until no lane runs, every plane equal after each
    step.  Lanes both engines leave to the host oracle (UNSUPPORTED) are
    single-stepped by the port runner's oracle and the state is carried
    over to the JAX machine, so the lockstep goes on past them.  Returns
    (port machine, statuses seen, lanes served by the oracle)."""
    from wtf_tpu.interp import step as JS
    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp import step as TS

    running, unsupported = int(StatusCode.RUNNING), \
        int(StatusCode.UNSUPPORTED)
    pages, cpu = build_guest(asm, data, regs)
    r = warm_runner(pages, cpu, n_lanes, uop_capacity, overlay_slots)
    tab = r.cache.device("cpu")
    img_leaves = padded_image(pages)
    img = convert.image_from_jax(img_leaves)
    img_j = jax_image(img_leaves)
    tab_j = jax_table(convert.table_to_jax(tab))
    m = initial_machine(cpu, n_lanes, uop_capacity, overlay_slots,
                        lane_regs)
    mj = to_jax(m)
    run1 = JS.make_run_chunk(1, donate=False)
    seen, served = set(), 0
    for i in range(max_steps):
        if not bool((m.status == running).any()):
            break
        mj = run1(tab_j, img_j, mj, jnp.uint64(limit))
        TS.run_steps(tab, img, m, limit, 1)
        assert_machines_equal(mj, m, where=f"step {i}")
        seen |= {StatusCode(int(s)) for s in m.status}
        oracle = (m.status == unsupported).nonzero()[:, 0]
        if len(oracle):
            # the runner's service: single-step those lanes on the oracle
            r.machine = m
            view = r.view()
            for lane in oracle.tolist():
                r._fallback_step(view, lane)
            r.push(view)
            m = r.machine
            mj = to_jax(m)
            served += len(oracle)
    else:
        raise AssertionError(f"lanes still running after {max_steps} steps")
    return m, seen, served


# ---------------------------------------------------------------------------
# conversions to JAX pytrees
# ---------------------------------------------------------------------------

def jax_leaves(m: JMachine) -> Dict[str, np.ndarray]:
    out = {f: np.asarray(getattr(m, f)) for f in m._fields
           if f != "overlay"}
    for g in m.overlay._fields:
        out[f"overlay.{g}"] = np.asarray(getattr(m.overlay, g))
    return out


def jax_machine(leaves: Dict[str, np.ndarray]) -> JMachine:
    ov = JOverlay(**{g: jnp.asarray(leaves[f"overlay.{g}"])
                     for g in JOverlay._fields})
    return JMachine(**{f: jnp.asarray(leaves[f]) for f in JMachine._fields
                       if f != "overlay"}, overlay=ov)


def jax_table(leaves) -> JTable:
    return JTable(**{f: jnp.asarray(leaves[f]) for f in JTable._fields})


def jax_image(leaves) -> JImage:
    return JImage(pages=jnp.asarray(leaves["pages"]),
                  frame_table=jnp.asarray(leaves["frame_table"]))


def to_jax(m) -> JMachine:
    return jax_machine(convert.machine_to_jax(m))


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def diff_machines(jm: JMachine, tm, skip=()) -> list:
    """Field names where the JAX machine and the port's differ (bit for
    bit, in the JAX layout)."""
    want = jax_leaves(jm)
    got = convert.machine_to_jax(tm)
    bad = []
    for name, a in want.items():
        if name in skip:
            continue
        b = got[name]
        if a.shape != b.shape or not np.array_equal(
                a.view(np.uint8) if a.dtype != bool else a,
                b.view(np.uint8) if b.dtype != bool else b):
            bad.append(name)
    return bad


def assert_machines_equal(jm: JMachine, tm, skip=(), where="") -> None:
    bad = diff_machines(jm, tm, skip)
    if bad:
        want = jax_leaves(jm)
        got = convert.machine_to_jax(tm)
        detail = []
        for name in bad[:4]:
            a, b = want[name], got[name]
            if a.shape != b.shape:
                detail.append(f"{name}: shape {a.shape} vs {b.shape}")
                continue
            idx = np.argwhere(a != b)[:3]
            detail.append(f"{name} @ {idx.tolist()}: jax "
                          f"{[a[tuple(i)] for i in idx]} port "
                          f"{[b[tuple(i)] for i in idx]}")
        raise AssertionError(f"{where}: planes differ: {bad}\n"
                             + "\n".join(detail))



# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------

def build_port_tlv_campaign(n_lanes: int = 64, mutator: str = "mangle",
                            limit: int = 100_000, seed: int = 0x77F,
                            max_len: int = 0x400, megachunk: int = 0,
                            **backend_kwargs):
    """The package's build_tlv_campaign (wtf_tpu_torch/analysis/trace.py)
    on the CPU: a demo_tlv FuzzLoop with one TLV seed in the corpus.
    `mesh_devices=N` (N shards of the CPU) or `mesh=LaneMesh` builds a
    MeshBackend."""
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign

    return build_tlv_campaign(n_lanes=n_lanes, mutator=mutator, limit=limit,
                              seed=seed, max_len=max_len,
                              megachunk=megachunk, device="cpu",
                              **backend_kwargs)


def campaign_fingerprint(loop) -> dict:
    """Everything the resume and supervision parity bars name, bit for
    bit, from either package's FuzzLoop (the aggregate bitmaps through
    the backend's coverage_state, uint32 words in both)."""
    from wtf_tpu.utils.hashing import hex_digest

    cov, edge = loop.backend.coverage_state()
    return {
        "cov": np.asarray(cov).tobytes(),
        "edge": np.asarray(edge).tobytes(),
        "cov_bits": loop._coverage(),
        "corpus_order": [hex_digest(d) for d in loop.corpus],
        "crashes": sorted(loop.crash_names),
        "buckets": sorted(loop.crash_buckets),
        "testcases": loop.stats.testcases,
        "new_coverage": loop.stats.new_coverage,
    }


def record_devmut_stream(loop, into: list) -> None:
    """Capture every executed devmut batch's exact bytes (words + lens)
    of either package's DevMangleMutator."""
    original = loop.mutator.take_batch

    def take_batch():
        words, lens = original()
        into.append((np.asarray(words).tobytes(),
                     np.asarray(lens).tobytes()))
        return words, lens

    loop.mutator.take_batch = take_batch


def checkpoint_at_every_boundary(loop, ckpt_dir, copies_dir) -> None:
    """Checkpoint `loop` after every batch into `ckpt_dir` and copy the
    directory to `copies_dir/<batch>` at each boundary: the disk state a
    kill at that boundary leaves behind (the checkpoint is written before
    the heartbeat, where fuzz_until_killed kills)."""
    import shutil
    from pathlib import Path

    loop.checkpoint_dir, loop.checkpoint_every = Path(ckpt_dir), 1
    original = loop._heartbeat

    def heartbeat(print_stats):
        shutil.copytree(ckpt_dir, Path(copies_dir) / str(loop.batches_done))
        original(print_stats)

    loop._heartbeat = heartbeat


@lru_cache(maxsize=None)
def assemble_private(source: str) -> bytes:
    """tests/asmhelper.py's `assemble` without its on-disk cache, which
    another process may be writing when this one reads it (a truncated
    read): what decides a file's parametrisation at collection must
    assemble the same in every xdist worker."""
    with tempfile.TemporaryDirectory() as tmp:
        obj, binf = Path(tmp) / "t.o", Path(tmp) / "t.bin"
        subprocess.run(["as", "-msyntax=intel", "-mnaked-reg", "-o",
                        str(obj), "--"], input=source.encode(),
                       capture_output=True, check=True)
        subprocess.run(["objcopy", "-O", "binary", "--only-section=.text",
                        str(obj), str(binf)], check=True)
        return binf.read_bytes()


def spawned_pool(workers: int):
    """A ProcessPoolExecutor of `workers` spawned processes on one torch
    thread each, for a test that runs independent legs of a smoke at
    once (the smoke's functions, so the workers import no JAX)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    return ProcessPoolExecutor(
        workers, initializer=torch.set_num_threads, initargs=(1,),
        mp_context=multiprocessing.get_context("spawn"))


class _CallOnLoad:
    """Pickles as a call: loading it runs fn(*args, **kw)."""

    def __init__(self, fn, *args, **kw):
        self.call = partial(fn, *args, **kw)

    def __reduce__(self):
        return self.call, ()


def submit_now(pool, fn, *args, **kw):
    """pool.submit(fn, *args, **kw) with the call pickled here and now:
    the pool pickles in a thread of its own, after the test may have
    monkeypatched fn's name in its module for the in-process side."""
    return pool.submit(pickle.loads,
                       pickle.dumps(_CallOnLoad(fn, *args, **kw)))


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's port side on one intra-op thread: the precise step
    is thousands of tiny CPU ops per instruction, which a thread pool
    only slows (13 against 18 ms per demo_pe step here)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
