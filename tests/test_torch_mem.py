"""The port's memory layers (wtf_tpu_torch/mem/) against the JAX package's
(wtf_tpu/mem/), bit for bit, on random worlds made with numpy from a seed:

  * page tables with 4K, 2MiB and 1GiB mappings, random present/writable/
    user bits, several virtual pages aliasing one frame, tables reachable
    through the overlay;
  * per-lane overlays whose rows repeat pfns (the FIRST matching row must
    win), hold page-table frames, and carry random valid bytes and data.

The JAX functions are single-lane and run under jax.vmap; the port's are
written over the lane axis.  Stores compare every overlay plane, raw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtf_tpu.interp import limbs as L
from wtf_tpu.mem import overlay as JO
from wtf_tpu.mem import paging as JP
from wtf_tpu.mem.physmem import MemImage as JImage
from wtf_tpu_torch.mem import overlay as TO
from wtf_tpu_torch.mem import paging as TP
from wtf_tpu_torch.mem.physmem import MemImage

from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 8
SLOTS = 16
SPAN = 256
PAGES = 64
K = 12


def _world(seed: int):
    rng = np.random.default_rng(seed)
    phys = rng.integers(0, 1 << 64, (PAGES, 512), dtype=np.uint64)
    phys[0] = 0
    table = np.zeros(SPAN, dtype=np.int32)
    frames = rng.choice(np.arange(1, SPAN), PAGES - 1, replace=False)
    table[frames] = np.arange(1, PAGES)
    # page tables: PML4 in frame 1, then PDPTs/PDs/PTs in frames 2..9
    tpfn = frames[:9]

    def entry(child_pfn, flags):
        return np.uint64((int(child_pfn) << 12) | flags)

    def page_of(pfn):
        return phys[table[pfn]]

    for t in tpfn:
        page_of(t)[:] = 0
    pml4, pdpt_a, pdpt_b, pd_a, pd_b, pt_a, pt_b, pt_c, _ = tpfn
    page_of(pml4)[0] = entry(pdpt_a, 0x7)
    page_of(pml4)[1] = entry(pdpt_b, 0x5)             # read-only branch
    page_of(pml4)[0x1FF] = entry(pdpt_b, 0x7)         # upper half
    page_of(pdpt_a)[0] = entry(pd_a, 0x7)
    page_of(pdpt_a)[1] = np.uint64((0x40000 << 12) | 0x87)   # 1GiB page
    page_of(pdpt_a)[2] = entry(pd_b, 0x3)
    page_of(pdpt_b)[0] = entry(pd_b, 0x7)
    page_of(pd_a)[0] = entry(pt_a, 0x7)
    page_of(pd_a)[1] = entry(pt_b, 0x7)
    page_of(pd_a)[2] = np.uint64((0x200 << 12) | 0x83)       # 2MiB page
    page_of(pd_b)[0] = entry(pt_c, 0x7)
    page_of(pd_b)[5] = np.uint64((0x600 << 12) | 0x81)       # 2MiB, ro
    data = frames[9:]
    for pt in (pt_a, pt_b, pt_c):
        page = page_of(pt)
        idx = rng.choice(512, 64, replace=False)
        # few frames for many PTEs: aliased mappings
        targets = rng.choice(data[:12], 64)
        flags = rng.choice([0x7, 0x5, 0x3, 0x6, 0x1], 64)
        page[idx] = (targets.astype(np.uint64) << np.uint64(12)) \
            | flags.astype(np.uint64)
    cr3 = np.full(N_LANES, int(pml4) << 12, dtype=np.uint64)
    cr3[1] |= 0xFFF                       # low bits ignored by the walk
    # virtual addresses: mostly inside the populated tables
    i4 = rng.choice([0, 0, 0, 1, 0x1FF, 7], (N_LANES, K))
    i3 = rng.choice([0, 0, 1, 2, 3], (N_LANES, K))
    i2 = rng.choice([0, 1, 2, 5, 9], (N_LANES, K))
    i1 = rng.integers(0, 512, (N_LANES, K))
    off = rng.integers(0, 4096, (N_LANES, K))
    gva = ((i4.astype(np.uint64) << np.uint64(39))
           | (i3.astype(np.uint64) << np.uint64(30))
           | (i2.astype(np.uint64) << np.uint64(21))
           | (i1.astype(np.uint64) << np.uint64(12)) | off.astype(np.uint64))
    upper = i4 == 0x1FF
    gva[upper] |= np.uint64(0xFFFF_0000_0000_0000)
    gva[:, 0] = np.uint64(0x8000_0000_0000_0000)   # non-canonical
    # overlays: repeated pfns, page-table frames, frames out of the dump
    pool = np.concatenate([data[:12], tpfn[:5], [SPAN - 1, 3]])
    ov_pfn = rng.choice(pool, (N_LANES, SLOTS)).astype(np.int32)
    count = rng.integers(0, SLOTS + 1, N_LANES).astype(np.int32)
    ov_pfn[np.arange(SLOTS)[None, :] >= count[:, None]] = -1
    valid = rng.integers(0, 2, (N_LANES, SLOTS, 512)).astype(np.uint8)
    ov_data = rng.integers(0, 1 << 64, (N_LANES, SLOTS, 512),
                           dtype=np.uint64)
    overflow = np.zeros(N_LANES, dtype=bool)
    return dict(pages=phys, table=table[None, :], cr3=cr3, gva=gva,
                ov_pfn=ov_pfn, ov_data=ov_data, valid=valid, count=count,
                overflow=overflow, rng=rng, frames=frames)


def _jax(w):
    img = JImage(pages=jnp.asarray(w["pages"]),
                 frame_table=jnp.asarray(w["table"]))
    ov = JO.DirtyOverlay(pfn=jnp.asarray(w["ov_pfn"]),
                         data=jnp.asarray(w["ov_data"]),
                         valid=jnp.asarray(w["valid"]),
                         count=jnp.asarray(w["count"]),
                         overflow=jnp.asarray(w["overflow"]))
    return img, ov


def _port(w):
    img = MemImage(pages=torch.from_numpy(w["pages"].view(np.int64)),
                   frame_table=torch.from_numpy(w["table"]))
    ov = TO.DirtyOverlay(pfn=torch.from_numpy(w["ov_pfn"].copy()),
                         data=torch.from_numpy(
                             w["ov_data"].view(np.int64).copy()),
                         valid=torch.from_numpy(w["valid"].copy()),
                         count=torch.from_numpy(w["count"].copy()),
                         overflow=torch.from_numpy(w["overflow"].copy()))
    return img, ov


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64))


def _eq(want, got, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == np.uint64:
        got = got.view(np.uint64)
    assert want.shape == got.shape, what
    bad = np.argwhere(want != got)
    assert not len(bad), (what, bad[:4].tolist())


def _overlays_equal(jov, tov, what):
    _eq(jov.pfn, tov.pfn, f"{what}: pfn")
    _eq(jov.data, tov.data, f"{what}: data")
    _eq(jov.valid, tov.valid, f"{what}: valid")
    _eq(jov.count, tov.count, f"{what}: count")
    _eq(jov.overflow, tov.overflow, f"{what}: overflow")


@pytest.mark.parametrize("seed", range(3))
def test_walk_matches_translate_vec_l(seed):
    w = _world(seed)
    jimg, jov = _jax(w)
    timg, tov = _port(w)
    walk = jax.vmap(JP.translate_vec_l, in_axes=(None, 0, 0, 0))
    gva_l = jnp.asarray(L.unpack_np(w["gva"]))
    t = walk(jimg, jov, jnp.asarray(w["cr3"]), gva_l)
    p = TP.translate(timg, tov, _i64(w["cr3"]), _i64(w["gva"]))
    for f in ("gpa", "ok", "writable", "user"):
        _eq(getattr(t, f), getattr(p, f), f)
    # the grid reaches large pages, faults and read-only leaves
    assert np.asarray(t.ok).any() and not np.asarray(t.ok).all()
    assert not np.asarray(t.writable)[np.asarray(t.ok)].all()


@pytest.mark.parametrize("seed", range(3))
def test_overlay_lookup_and_reads_match(seed):
    w = _world(seed)
    jimg, jov = _jax(w)
    timg, tov = _port(w)
    rng = w["rng"]
    pool = np.concatenate([w["ov_pfn"].ravel(), [0x7FFFFFFF, 5, 200]])
    pfn = rng.choice(pool, (N_LANES, K)).astype(np.int32)
    idx, hit = jax.vmap(JO.lookup_vec)(jov, jnp.asarray(pfn))
    tidx, thit = TO.lookup(tov, torch.from_numpy(pfn).long())
    _eq(idx.astype(np.int64), tidx, "lookup idx")
    _eq(hit, thit, "lookup hit")
    assert np.asarray(hit).any() and not np.asarray(hit).all()
    gpa = ((rng.choice(np.concatenate([w["frames"], [SPAN + 3]]),
                       (N_LANES, K)).astype(np.uint64) << np.uint64(12))
           | rng.integers(0, 4096, (N_LANES, K)).astype(np.uint64))
    last = gpa + rng.integers(0, 16, (N_LANES, K)).astype(np.uint64)
    pte = jax.vmap(JO.pte_read_vec, in_axes=(None, 0, 0))(
        jimg, jov, jnp.asarray(gpa & ~np.uint64(7)))
    _eq(pte, TO.pte_read(timg, tov, _i64(gpa & ~np.uint64(7))), "pte_read")
    win = jax.vmap(JO.load_windows3_vec, in_axes=(None, 0, 0, 0))(
        jimg, jov, jnp.asarray(gpa), jnp.asarray(last))
    twin = TO.load_windows3(timg, tov, _i64(gpa), _i64(last))
    for j in range(3):
        _eq(win[j], twin[j], f"window word {j}")
    lo, hi = jax.vmap(JO.extract_pair)(*win, jnp.asarray(gpa))
    tlo, thi = TO.extract_pair(*twin, _i64(gpa))
    _eq(lo, tlo, "extract lo")
    _eq(hi, thi, "extract hi")


@pytest.mark.parametrize("seed", range(4))
def test_stores_and_ensure_page_match(seed):
    w = _world(seed)
    rng = w["rng"]
    jimg, jov = _jax(w)
    timg, tov = _port(w)
    for rnd in range(6):
        # first frames from the overlay pool or the dump, sizes 1..16,
        # crossings into an aliased or a distinct frame, some disabled
        pf0 = rng.choice(np.concatenate([w["ov_pfn"].ravel(),
                                         w["frames"][9:20]]), N_LANES)
        pf0 = np.where(pf0 < 0, w["frames"][10], pf0).astype(np.uint64)
        off = rng.integers(0, 4096, N_LANES).astype(np.uint64)
        size = rng.choice([1, 2, 4, 8, 16, 3], N_LANES).astype(np.int32)
        g0 = (pf0 << np.uint64(12)) | off
        cross = off + size.astype(np.uint64) > 4096
        pf1 = np.where(rng.integers(0, 2, N_LANES) == 1, pf0,
                       rng.choice(w["frames"][9:20], N_LANES)
                       .astype(np.uint64))
        g1 = np.where(cross, (pf1 << np.uint64(12))
                      + ((off + size.astype(np.uint64) - 1)
                         & np.uint64(0xFFF)),
                      g0 + size.astype(np.uint64) - 1)
        g1[0] = np.uint64(SPAN + 9) << np.uint64(12)   # out-of-range frame
        lo = rng.integers(0, 1 << 64, N_LANES, dtype=np.uint64)
        hi = rng.integers(0, 1 << 64, N_LANES, dtype=np.uint64)
        en = rng.integers(0, 4, N_LANES) > 0

        class T:
            def __init__(self, gpa):
                self.gpa = gpa

        store = jax.vmap(
            lambda ov, a, b, s, x, y, e: JO.store_window3(
                jimg, ov, T(a), T(b), s, x, y, e))
        jov, ok = store(jov, jnp.asarray(g0), jnp.asarray(g1),
                        jnp.asarray(size), jnp.asarray(lo), jnp.asarray(hi),
                        jnp.asarray(en))
        tok = TO.store_window3(timg, tov, _i64(g0), _i64(g1),
                               torch.from_numpy(size), _i64(lo), _i64(hi),
                               torch.from_numpy(en))
        _eq(ok, tok, f"store ok, round {rnd}")
        _overlays_equal(jov, tov, f"store round {rnd}")
        pfn = rng.choice(np.concatenate([w["frames"], [0x7FFFFFFF]]),
                         N_LANES).astype(np.int32)
        jov, jidx, jok = jax.vmap(JO.ensure_page, in_axes=(None, 0, 0, 0))(
            jimg, jov, jnp.asarray(pfn), jnp.asarray(en))
        tidx, tok = TO.ensure_page(tov, torch.from_numpy(pfn).long(),
                                   torch.from_numpy(en))
        _eq(np.asarray(jidx).astype(np.int64), tidx, "ensure_page idx")
        _eq(jok, tok, "ensure_page ok")
        _overlays_equal(jov, tov, f"ensure_page round {rnd}")
    assert np.asarray(jov.overflow).any() or np.asarray(jov.count).max() \
        == SLOTS


@pytest.mark.parametrize("seed", range(2))
def test_byte_paths_match(seed):
    w = _world(seed)
    rng = w["rng"]
    jimg, jov = _jax(w)
    timg, tov = _port(w)
    n = 24
    for rnd in range(3):
        pf0 = rng.choice(w["frames"][9:20], N_LANES).astype(np.uint64)
        pf1 = rng.choice(w["frames"][9:20], N_LANES).astype(np.uint64)
        off = rng.choice([0, 100, 4090, 4095, 4072], N_LANES) \
            .astype(np.uint64)
        g0 = (pf0 << np.uint64(12)) | off
        k = np.arange(n, dtype=np.uint64)
        first = (off[:, None] + k[None, :]) < 4096
        gvec = np.where(first, g0[:, None] + k[None, :],
                        (pf1[:, None] << np.uint64(12))
                        + (off[:, None] + k[None, :] - 4096))
        got = TO.gather_bytes(timg, tov, _i64(gvec),
                              torch.from_numpy(first))
        want = jax.vmap(JO.gather_bytes, in_axes=(None, 0, 0, 0))(
            jimg, jov, jnp.asarray(gvec), jnp.asarray(first))
        _eq(want, got, f"gather_bytes round {rnd}")
        values = rng.integers(0, 256, (N_LANES, n)).astype(np.uint8)
        en = rng.integers(0, 3, N_LANES) > 0
        jov, ok = jax.vmap(JO.scatter_span, in_axes=(None, 0, 0, 0, 0, 0))(
            jimg, jov, jnp.asarray(gvec[:, 0]), jnp.asarray(gvec[:, -1]),
            jnp.asarray(values), jnp.asarray(en))
        tok = TO.scatter_span(timg, tov, _i64(gvec[:, 0]),
                              _i64(gvec[:, -1]), torch.from_numpy(values),
                              torch.from_numpy(en))
        _eq(ok, tok, f"scatter ok, round {rnd}")
        _overlays_equal(jov, tov, f"scatter round {rnd}")
