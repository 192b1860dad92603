"""The port's device decode (wtf_tpu_torch/interp/devdec.py) against the
JAX package's (wtf_tpu/interp/devdec.py), on the CPU, at tolerance 0 (all
state is integer).

  * `decode_window` on the three-part random grid of
    tests/test_devdec.py::test_decode_window_differential (seed 0x77F):
    the `known` mask and every field, disp and imm equal to the JAX
    decoder's, and to the host decoder on the known rows;
  * `compute_blocks` + `commit_blocks` against the JAX `lane_block` +
    `commit_blocks` on the fixture of tests/test_devdec.py (its writes,
    plus a high-half copy of the first program after them) and its five
    cases — a duplicate rip, a page-fault lane, a park that parks the
    rest, an encoding across a page boundary, a warm resume with an SMC
    re-decode — and a canonical-negative case: committed table rows,
    count, statuses, fault fields, CTR_MEM_FAULT increments, parks and
    stats;
  * `gather_windows` against the JAX one at low-half and high-half rips;
  * 8-lane demo_tlv devmangle campaigns with device decode (fused step
    on and off, --megachunk 4 and 0) against the JAX --device-decode
    window campaign at equal seeds: coverage and edge bytes, corpus
    digests, crash names and buckets, and the decode cache's
    checkpoint_entries; the same without device decode; the published
    rows adopted with no cross-check mismatch and no host decode; the
    cache's re-uploaded table equal to the window's row for row;
  * `adopt_device_entries`' cross-check and order check;
  * `import wtf_tpu_torch.interp.devdec` leaves jax out of sys.modules.
"""

import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_devdec import _HostService
from wtf_tpu.analysis.trace import build_tlv_campaign
from wtf_tpu.cpu.decoder import decode as jax_pkg_decode
from wtf_tpu.interp import devdec as JD
from wtf_tpu.interp.uoptable import DecodeCache as JCache
from wtf_tpu.mem.overlay import overlay_init as j_overlay_init
from wtf_tpu.mem.physmem import IMAGE_IN_AXES
from wtf_tpu.mem.physmem import PhysMem as JPhysMem
from wtf_tpu.mem.physmem import lane_image as j_lane_image
from wtf_tpu.snapshot.synthetic import SyntheticSnapshotBuilder as JBuilder
from wtf_tpu.utils.hashing import hex_digest
from wtf_tpu_torch.cpu.decoder import decode
from wtf_tpu_torch.cpu.uops import INT_FIELDS
from wtf_tpu_torch.interp import devdec as PD
from wtf_tpu_torch.interp.machine import machine_init
from wtf_tpu_torch.interp.uoptable import DecodeCache
from wtf_tpu_torch.mem.physmem import PhysMem, lane_image
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
MASK64 = (1 << 64) - 1
NEED_DECODE, RUNNING, PAGE_FAULT = 8, 0, 7

CODE = 0x140000000
# nop; mov eax,5; jnz +2; ret; inc ecx; ret   (all device-subset)
PROG = bytes.fromhex("90" "b805000000" "7502" "c3" "ffc1" "c3")
# a second chain: xor r8,r8; call +0; ret
PROG2 = bytes.fromhex("4d31c0" "e800000000" "c3")
X87 = bytes.fromhex("d8c1" "c3")          # fadd st(1): parks on the device
# mov eax,5 three bytes before a page boundary (crosses it), then ret
SPLIT_OFF = 0xFFD
HIGH = 0xFFFF_8000_4000_0000               # PROG again, canonical-negative
LANES = 4                                  # every service case, padded


def _populate(b):
    b.write(CODE, PROG + b"\x00" * 16)
    b.write(CODE + 0x100, PROG2 + b"\x00" * 16)
    b.write(CODE + 0x200, X87 + b"\x00" * 16)
    b.write(CODE + SPLIT_OFF, bytes.fromhex("b805000000" "c3") + b"\x00" * 8)
    b.write(HIGH, PROG + b"\x00" * 16)
    return b.build(rip=CODE, rsp=0x7FFE0F00)


@pytest.fixture(scope="module")
def fx():
    """The same snapshot through both packages' builders, and the JAX
    service round (lane_block vmapped + commit_blocks) compiled once for
    LANES lanes."""
    jpages, jcpu = _populate(JBuilder())
    pages, cpu = _populate(SyntheticSnapshotBuilder())
    assert jpages == pages
    jmem = JPhysMem.from_pages(jpages)

    def round_(tab, count, image, cr3, rips, sts, capacity):
        blocks = jax.vmap(
            JD.lane_block,
            in_axes=(None, IMAGE_IN_AXES, 0, 0, 0, 0, None, None),
        )(tab, image, j_overlay_init(LANES, 4), cr3, rips, sts,
          jnp.zeros((2,), jnp.uint64), jnp.int32(0))
        return JD.commit_blocks(tab, count, blocks, sts, capacity)

    return {"jmem": jmem, "jcr3": int(jcpu.cr3),
            "mem": PhysMem.from_pages(pages), "cpu": cpu,
            "round": jax.jit(round_, static_argnums=(6,))}


def _pad(rips, sts):
    rips = list(rips) + [CODE] * (LANES - len(rips))
    sts = list(sts) + [RUNNING] * (LANES - len(sts))
    return rips, sts


def _jax_round(fx, rips, sts, cache: JCache):
    rips, sts = _pad(rips, sts)
    return fx["round"](cache.device(), jnp.int32(cache.count),
                       j_lane_image(fx["jmem"].image, LANES),
                       jnp.full((LANES,), fx["jcr3"], jnp.uint64),
                       jnp.asarray(rips, jnp.uint64),
                       jnp.asarray(sts, jnp.int32), cache.capacity)


def _port_machine(fx, rips, sts, capacity):
    rips, sts = _pad(rips, sts)
    m = machine_init(fx["cpu"], LANES, capacity, 4, 17, "cpu")
    m.rip = torch.tensor([r - (1 << 64) if r >> 63 else r for r in rips],
                         dtype=torch.int64)
    m.status = torch.tensor(sts, dtype=torch.int32)
    return m


def _port_round(fx, rips, sts, cache: DecodeCache):
    m = _port_machine(fx, rips, sts, cache.capacity)
    image = lane_image(fx["mem"].image("cpu"), LANES)
    tab = cache.device("cpu")
    blocks = PD.compute_blocks(tab, image, m,
                               torch.zeros(2, dtype=torch.int64), 0)
    return PD.commit_blocks(tab, cache.count, blocks, m.status,
                            cache.capacity)


def _assert_commit_equal(j, p):
    """Port CommitOut == JAX CommitOut: every table row (the JAX rip
    limbs against the port's int64 keys), the count, the lane deltas and
    the stats."""
    assert p.count == int(j.count)
    limbs = np.asarray(j.tab.rip_l).astype(np.uint64)
    keys = limbs[:, 0] | (limbs[:, 1] << np.uint64(32))
    np.testing.assert_array_equal(p.tab.rip.numpy().view(np.uint64), keys)
    np.testing.assert_array_equal(p.tab.meta_i32.numpy(),
                                  np.asarray(j.tab.meta_i32))
    np.testing.assert_array_equal(p.tab.meta_u64.numpy().view(np.uint64),
                                  np.asarray(j.tab.meta_u64))
    np.testing.assert_array_equal(p.tab.hash_tab.numpy(),
                                  np.asarray(j.tab.hash_tab))
    np.testing.assert_array_equal(p.status.numpy(), np.asarray(j.status))
    np.testing.assert_array_equal(p.fault_gva.numpy().view(np.uint64),
                                  np.asarray(j.fault_gva))
    np.testing.assert_array_equal(p.fault_mask.numpy(),
                                  np.asarray(j.fault_mask))
    np.testing.assert_array_equal(p.mem_fault_inc.numpy(),
                                  np.asarray(j.mem_fault_inc))
    np.testing.assert_array_equal(p.parked.numpy(), np.asarray(j.parked))
    assert p.stats == tuple(int(x) for x in np.asarray(j.stats))


# -- decode_window: the randomized-encoding grid ---------------------------

def _decode_grid() -> np.ndarray:
    """tests/test_devdec.py's three-part grid (seed 0x77F): opcode-map and
    ModRM skeletons with random prefix/REX dressing, fully random
    windows, and prefix runs that truncate."""
    rng = np.random.default_rng(0x77F)
    prefix_sets = [
        b"", b"\x66", b"\x67", b"\xf0", b"\xf2", b"\xf3", b"\x64",
        b"\x65", b"\x2e", b"\x66\xf3", b"\xf2\xf3", b"\x66\x67\x65",
        b"\xf0\x66", b"\x66\x66",
    ]
    rexes = [b"", b"\x40", b"\x48", b"\x41", b"\x44", b"\x42", b"\x4f",
             b"\x45", b"\x4c"]
    cases = []
    for m in (0, 1):
        for op in range(256):
            for _ in range(4):
                digit, mod = rng.integers(8), rng.integers(4)
                rm = int(rng.choice([0, 3, 4, 5]))
                modrm = (int(mod) << 6) | (int(digit) << 3) | rm
                pfx = prefix_sets[rng.integers(len(prefix_sets))]
                rex = rexes[rng.integers(len(rexes))]
                body = bytes([0x0F, op] if m else [op]) + bytes([modrm])
                tail = rng.integers(0, 256, 14, dtype=np.uint8).tobytes()
                cases.append((pfx + rex + body + tail)[:15])
    for _ in range(3000):
        cases.append(rng.integers(0, 256, 15, dtype=np.uint8).tobytes())
    for _ in range(1000):
        n = rng.integers(8, 15)
        pfx = bytes(rng.choice(
            [0x66, 0x67, 0xF0, 0xF2, 0xF3, 0x64, 0x2E], n))
        body = rng.integers(0, 256, 15, dtype=np.uint8).tobytes()
        cases.append((pfx + body)[:15])
    return np.frombuffer(b"".join(cases), np.uint8).reshape(len(cases), 15)


def test_decode_window_equals_jax_and_host():
    wins = _decode_grid()
    j = jax.jit(jax.vmap(JD.decode_window))(jnp.asarray(wins))
    p = PD.decode_window(torch.from_numpy(wins.copy()))
    known = p.known.numpy()
    np.testing.assert_array_equal(known, np.asarray(j.known))
    np.testing.assert_array_equal(p.f.numpy(), np.asarray(j.f))
    np.testing.assert_array_equal(p.disp.numpy().view(np.uint64),
                                  np.asarray(j.disp))
    np.testing.assert_array_equal(p.imm.numpy().view(np.uint64),
                                  np.asarray(j.imm))
    assert known.sum() > len(wins) // 10        # the subset is not vacuous
    f, disp, imm = (p.f.numpy(), p.disp.numpy().view(np.uint64),
                    p.imm.numpy().view(np.uint64))
    for i in np.nonzero(known)[0]:
        hu = decode(wins[i].tobytes(), 0)
        assert [int(v) for v in f[i]] == [int(getattr(hu, name))
                                          for name in INT_FIELDS]
        assert int(disp[i]) == hu.disp & MASK64
        assert int(imm[i]) == hu.imm & MASK64


# -- the service round: blocks + commit ------------------------------------

SERVICE_CASES = {
    # all decodable, one duplicate rip, one lane not needy
    "duplicate": ([CODE, CODE + 0x100, CODE, CODE + 6],
                  [NEED_DECODE, NEED_DECODE, NEED_DECODE, RUNNING]),
    # an unmapped rip faults; the lanes around it still commit
    "page_fault": ([CODE + 0x100, 0xDEAD0000, CODE], [NEED_DECODE] * 3),
    # x87 parks its lane and every later needy lane
    "park_first": ([CODE + 0x200, CODE], [NEED_DECODE] * 2),
    "park_rest": ([CODE, CODE + 0x200, CODE + 0x100], [NEED_DECODE] * 3),
    # mov eax,5 across a page boundary: pfn1 = pfn0 + 1
    "page_cross": ([CODE + SPLIT_OFF], [NEED_DECODE]),
    # canonical-negative code, an unmapped high-half rip, and low-half
    "high_half": ([HIGH, 0xFFFF_8000_0000_1000, CODE + 0x100],
                  [NEED_DECODE] * 3),
}


@pytest.mark.parametrize("case", sorted(SERVICE_CASES))
def test_service_round_equals_jax(fx, case):
    rips, sts = SERVICE_CASES[case]
    j = _jax_round(fx, rips, sts, JCache())
    p = _port_round(fx, rips, sts, DecodeCache())
    _assert_commit_equal(j, p)
    if case == "page_cross":
        mi = p.tab.meta_i32.numpy()
        assert mi[0, -2] == mi[0, -3] + 1          # pfn1 == pfn0 + 1
    if case == "page_fault":
        assert p.fault_mask.tolist()[:3] == [False, True, False]
        assert p.fault_gva.tolist()[1] == 0xDEAD0000
    if case == "park_rest":
        assert p.parked.tolist()[:3] == [False, True, True]
    if case == "high_half":
        assert p.count > 0 and p.status.tolist()[:3] == [
            RUNNING, PAGE_FAULT, RUNNING]


def test_service_warm_resume_and_smc_redecode(fx):
    """Warm start: lanes re-missing cached rips resume without publishing.
    After an SMC re-decode updates an entry in place (same index) in both
    caches, a second round still resumes against the updated rows."""
    hs = _HostService((fx["jmem"], fx["jcr3"]))
    jcache = JCache()
    hs.service(jcache, j_overlay_init(2, 4), [CODE, CODE + 0x100],
               [NEED_DECODE] * 2, 2)
    cache = DecodeCache()
    for rip, raw, pfn0, pfn1 in jcache.checkpoint_entries():
        cache.add(rip, decode(raw, rip), pfn0, pfn1)
    assert cache.checkpoint_entries() == jcache.checkpoint_entries()
    rips, sts = [CODE, CODE + 0x100], [NEED_DECODE] * 2
    j = _jax_round(fx, rips, sts, jcache)
    p = _port_round(fx, rips, sts, cache)
    _assert_commit_equal(j, p)
    assert p.count == cache.count and p.stats == (0, 0, 0)

    raw = bytes.fromhex("ffc1") + b"\x90" * 13
    idx = cache.entry_index(CODE)
    for c, dec in ((cache, decode), (jcache, jax_pkg_decode)):
        c.update(CODE, dec(raw, CODE), int(c.pfn0[idx]), int(c.pfn1[idx]))
    assert cache.entry_index(CODE) == idx
    j = _jax_round(fx, rips, sts, jcache)
    p = _port_round(fx, rips, sts, cache)
    _assert_commit_equal(j, p)
    new = decode(raw, CODE)
    assert [int(v) for v in p.tab.meta_i32[idx, :len(INT_FIELDS)]] == [
        int(getattr(new, name)) for name in INT_FIELDS]


@pytest.mark.parametrize("rip", [CODE, CODE + SPLIT_OFF, HIGH,
                                 0xFFFF_8000_0000_1000])
def test_gather_windows_equals_jax(fx, rip):
    """The host-service gather: window bytes, fault, pfn0 and pfn14 at a
    low-half, a page-crossing, a high-half and an unmapped high-half rip
    (lanes 1 and 3 asked, in reverse order)."""
    rips = [CODE + 0x100, rip, CODE, rip + 1]
    idx = [3, 1]
    j = JD.gather_windows(j_lane_image(fx["jmem"].image, LANES),
                          j_overlay_init(LANES, 4),
                          jnp.full((LANES,), fx["jcr3"], jnp.uint64),
                          jnp.asarray(rips, jnp.uint64),
                          jnp.asarray(idx, jnp.int32))
    m = _port_machine(fx, rips, [RUNNING] * LANES, 1 << 10)
    p = PD.gather_windows(lane_image(fx["mem"].image("cpu"), LANES),
                          m.overlay, m.cr3, m.rip, torch.tensor(idx))
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- adoption ----------------------------------------------------------------

def test_adopt_device_entries_crosschecks_and_orders():
    """A published row whose fields disagree with the host decoder counts
    as one mismatch and the HOST decode is stored; rows starting anywhere
    but at the cache's count are refused."""
    uop = decode(PROG[1:6], CODE + 1)                   # mov eax, 5
    src = DecodeCache(capacity=64)
    src.add(CODE + 1, uop, 7, 7)
    tab = src.device("cpu")
    rip, mi, mu = (tab.rip[:1].numpy(), tab.meta_i32[:1].numpy().copy(),
                   tab.meta_u64[:1].numpy())
    dst = DecodeCache(capacity=64)
    assert dst.adopt_device_entries(rip, mi, mu, 0, 1) == 0
    assert dst.checkpoint_entries() == src.checkpoint_entries()
    mi[0, 0] += 1                                       # a wrong opc
    bad = DecodeCache(capacity=64)
    assert bad.adopt_device_entries(rip, mi, mu, 0, 1) == 1
    assert bad.uop_at(CODE + 1) == uop
    with pytest.raises(RuntimeError, match="out of order"):
        bad.adopt_device_entries(rip, mi, mu, 0, 1)


# -- campaigns ---------------------------------------------------------------

BUILD = dict(n_lanes=8, limit=20_000, chunk_steps=128, overlay_slots=16)
RUNS = BUILD["n_lanes"] * 6
SEED = 0x5EED
SEED_INPUT = b"\x01\x04AAAA\x02\x08BBBBBBBB"   # build_tlv_campaign's seed
MAX_LEN = 0x400


def _fingerprint(loop, cov, edge, entries) -> dict:
    return {
        "cov": cov.tobytes(),
        "edge": edge.tobytes(),
        "corpus_order": [hex_digest(d) for d in loop.corpus],
        "crashes": sorted(loop.crash_names),
        "buckets": sorted(loop.crash_buckets),
        "testcases": loop.stats.testcases,
        "timeouts": loop.stats.timeouts,
        "new_coverage": loop.stats.new_coverage,
        "entries": entries,
    }


@pytest.fixture(scope="module")
def jax_dd_window():
    """The JAX package's --device-decode ladder window campaign."""
    loop = build_tlv_campaign(mutator="devmangle", seed=SEED, megachunk=4,
                              max_len=MAX_LEN, fused_step="off",
                              device_decode=True, **BUILD)
    loop.fuzz(RUNS)
    cov, edge = loop.backend.coverage_state()
    fp = _fingerprint(loop, cov, edge,
                      list(loop.backend.runner.cache.checkpoint_entries()))
    reg = loop.backend.registry
    assert reg.counter("devdec.published").value > 0
    assert fp["new_coverage"] > 1 and fp["testcases"] == RUNS
    return fp


def _port_campaign(megachunk: int, fused: str, device_decode: bool):
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import create_mutator
    from wtf_tpu_torch.harness import demo_tlv

    backend = GpuBackend(demo_tlv.build_snapshot(),
                         n_lanes=BUILD["n_lanes"], limit=BUILD["limit"],
                         chunk_steps=BUILD["chunk_steps"],
                         overlay_slots=BUILD["overlay_slots"],
                         device="cpu", fused_step=fused,
                         device_decode=device_decode)
    backend.initialize()
    demo_tlv.TARGET.init(backend)
    rng = random.Random(SEED)
    corpus = Corpus(rng=rng)
    corpus.add(SEED_INPUT)
    loop = FuzzLoop(backend, demo_tlv.TARGET,
                    create_mutator("devmangle", rng, MAX_LEN), corpus,
                    megachunk=megachunk)
    # record every window's table and count as the harvest sees them, and
    # the cache's device copy right after each adoption
    seen = []
    harvest = backend._harvest_device_decode

    def recording(out):
        n = harvest(out)
        seen.append((out.tab, out.count, backend.runner.device_tab()))
        return n

    backend._harvest_device_decode = recording
    loop.fuzz(RUNS)
    b = loop.backend
    fp = _fingerprint(loop, b._agg_cov.numpy().view(np.uint32),
                      b._agg_edge.numpy().view(np.uint32),
                      b.runner.cache.checkpoint_entries())
    return loop, fp, seen


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("megachunk", [4, 0])
def test_device_decode_campaign_equals_jax(jax_dd_window, megachunk, fused):
    loop, fp, seen = _port_campaign(megachunk, fused, True)
    assert fp == jax_dd_window
    reg, runner = loop.registry, loop.backend.runner
    assert reg.counter("devdec.crosscheck_mismatches").value == 0
    if megachunk:
        # every miss serviced on the device: the host decoder ran only as
        # the cross-check of the published rows
        assert reg.counter("devdec.published").value > 0
        assert reg.counter("devdec.zero_host_windows").value > 0
        assert (reg.counter("devdec.zero_host_windows").value
                + reg.counter("megachunk.incomplete_windows").value
                == reg.counter("megachunk.windows").value)
        assert runner.stats["decodes"] == 0
        assert reg.counter("devdec.service_rounds").value > 0
        assert (reg.counter("devdec.service_k1_rounds").value > 0) == (
            fused == "on")
        assert "zero_host_window_rate" in loop.steady_state_fields()
        # after each adoption the cache's device table is the window's,
        # row for row
        assert seen
        for tab, count, synced in seen:
            for name in ("rip", "meta_i32", "meta_u64"):
                assert torch.equal(getattr(tab, name)[:count],
                                   getattr(synced, name)[:count]), name
            assert torch.equal(tab.hash_tab, synced.hash_tab)
        # the finish breakpoint's entry carries bp = 1, so the window's
        # finish rewrite fires on it
        from wtf_tpu_torch.harness.demo_tlv import FINISH_GVA

        idx = runner.cache.entry_index(FINISH_GVA)
        assert idx is not None and runner.cache.bp[idx] == 1
    else:
        # batch at a time: the host service fetched its code windows on
        # the device
        assert runner.stats["decode_windows_gathered"] > 0
        assert runner.stats["decodes"] > 0
        assert not seen


def test_device_decode_off_equals_on(jax_dd_window):
    """The port's window campaign without device decode: the same
    campaign, its misses decoded by the host."""
    loop, fp, seen = _port_campaign(4, "off", False)
    assert fp == jax_dd_window
    assert not seen and loop.backend.runner.stats["decodes"] > 0
    assert loop.registry.counter("devdec.published").value == 0


def test_devdec_import_leaves_jax_out():
    code = ("import sys, wtf_tpu_torch.interp.devdec, "
            "wtf_tpu_torch.fuzz.megachunk; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not [m for m in sys.modules if m.startswith('wtf_tpu.')]")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)

