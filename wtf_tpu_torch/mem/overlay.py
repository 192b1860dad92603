"""Per-lane dirty-page overlay: copy-on-write guest memory, batched.

The counterpart of wtf_tpu/mem/overlay.py, written over the lane axis
directly (the JAX module is single-lane and vmapped).  Each lane owns
`capacity` overlay rows; a row is a DELTA of one physical page: `valid`
marks the words of `data` a store has written, and a read takes the
overlay word when its valid byte is set and the base image word
otherwise.  Claiming a row clears its validity and never copies the base
page.  `Restore()` is `overlay_reset`: drop the row index, keep the
storage.

Lookups take the FIRST row holding a pfn, exactly like the JAX package's
argmax.  Updates happen in place on the tensors the caller holds (the
overlay is the largest buffer of the batch; the JAX package gets the same
effect from buffer donation).
"""

from __future__ import annotations

import dataclasses

import torch

from wtf_tpu_torch.core.gxa import PAGE_SHIFT, PAGE_SIZE
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.mem.physmem import PAGE_WORDS, MemImage, frame_slot

# pfn sentinel for "out of physical range": never matches a stored pfn,
# and frame_slot() maps it to the zero page
PFN_OOB = 0x7FFFFFFF


@dataclasses.dataclass
class DirtyOverlay:
    """Every lane's dirty pages (leading lane axis on every field)."""

    pfn: torch.Tensor       # int32[L, capacity]; -1 = free row
    data: torch.Tensor      # int64[L, capacity, PAGE_WORDS]
    valid: torch.Tensor     # uint8[L, capacity, PAGE_WORDS]; 1 = overlaid
    count: torch.Tensor     # int32[L]: allocated rows
    overflow: torch.Tensor  # bool[L]: the lane ran out of rows

    @property
    def capacity(self) -> int:
        return self.pfn.shape[1]


def overlay_init(n_lanes: int, capacity: int, device) -> DirtyOverlay:
    return DirtyOverlay(
        pfn=torch.full((n_lanes, capacity), -1, dtype=torch.int32,
                       device=device),
        data=torch.zeros((n_lanes, capacity, PAGE_WORDS), dtype=torch.int64,
                         device=device),
        valid=torch.zeros((n_lanes, capacity, PAGE_WORDS),
                          dtype=torch.uint8, device=device),
        count=torch.zeros(n_lanes, dtype=torch.int32, device=device),
        overflow=torch.zeros(n_lanes, dtype=torch.bool, device=device),
    )


def overlay_reset(ov: DirtyOverlay) -> None:
    """Restore(): drop every dirty page, O(1) in page data (stale data and
    validity are unreachable once pfn is -1; validity is cleared when a
    row is claimed again)."""
    ov.pfn.fill_(-1)
    ov.count.zero_()
    ov.overflow.zero_()


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """Lane-index tensor broadcastable against `t` ([L, ...])."""
    n = t.shape[0]
    return torch.arange(n, device=t.device).view((n,) + (1,) * (t.dim() - 1))


def split_gpa(image: MemImage, gpa: torch.Tensor):
    """gpa (int64) -> (pfn with the OOB sentinel, page offset), int64."""
    pfn = I.shr(gpa, PAGE_SHIFT)
    pfn = torch.where((pfn >= 0) & (pfn < image.nframes), pfn,
                      torch.full_like(pfn, PFN_OOB))
    return pfn, gpa & (PAGE_SIZE - 1)


def lookup(ov: DirtyOverlay, pfn: torch.Tensor):
    """pfn [L] or [L, K] -> (row, hit): the FIRST row holding it."""
    rows = ov.pfn.long()
    if pfn.dim() == 1:
        eq = rows == pfn.long()[:, None]
        return eq.to(torch.uint8).argmax(-1), eq.any(-1)
    eq = rows[:, None, :] == pfn.long()[:, :, None]
    return eq.to(torch.uint8).argmax(-1), eq.any(-1)


def read_words(image: MemImage, ov: DirtyOverlay, slot, row, use_ov, widx):
    """Overlay-aware aligned words ([L, K] each): the overlay word when
    the row is hit and the word's valid byte is set, else the image."""
    lane = _lanes(row)
    base = image.pages[slot.long(), widx.long()]
    ovw = ov.data[lane, row.long(), widx.long()]
    ov_valid = ov.valid[lane, row.long(), widx.long()] != 0
    return torch.where(use_ov & ov_valid, ovw, base)


def pte_read(image: MemImage, ov: DirtyOverlay, gpa: torch.Tensor):
    """8-aligned little-endian word reads, gpa [L, K] -> int64[L, K]."""
    pfn, off = split_gpa(image, gpa)
    row, hit = lookup(ov, pfn)
    return read_words(image, ov, frame_slot(image, pfn), row, hit, off >> 3)


def load_windows3(image: MemImage, ov: DirtyOverlay, gpa_first, gpa_last):
    """[L, K] 3-word windows covering any <= 16-byte span each ->
    (w0, w1, w2).  Words past the first page come from the last byte's
    page."""
    k = gpa_first.shape[1]
    pfn0, off0 = split_gpa(image, gpa_first)
    pfn1, _ = split_gpa(image, gpa_last)
    rows, hits = lookup(ov, torch.cat([pfn0, pfn1], dim=1))
    row0, row1 = rows[:, :k], rows[:, k:]
    hit0, hit1 = hits[:, :k], hits[:, k:]
    slot0, slot1 = frame_slot(image, pfn0), frame_slot(image, pfn1)
    w_start = off0 >> 3
    out = []
    for j in range(3):
        on_first = (w_start + j) < PAGE_WORDS
        widx = torch.where(on_first, w_start + j, w_start + j - PAGE_WORDS)
        out.append(read_words(
            image, ov, torch.where(on_first, slot0, slot1),
            torch.where(on_first, row0, row1),
            torch.where(on_first, hit0, hit1), widx))
    return out[0], out[1], out[2]


def extract_pair(w0, w1, w2, gpa_first):
    """(lo, hi) of the 16 bytes starting at gpa_first, from its window."""
    sh = (gpa_first & 7) * 8
    inv = 64 - sh
    lo = I.shr(w0, sh) | I.shl(w1, inv)
    hi = I.shr(w1, sh) | I.shl(w2, inv)
    return lo, hi


def ensure_page(ov: DirtyOverlay, pfn: torch.Tensor, enabled: torch.Tensor):
    """Claim a row for pfn [L] where `enabled` (delta semantics: the row's
    words mean nothing until a store sets their valid bytes).  Returns
    (row, ok); ok is False when the lane is out of rows or pfn is out of
    range.  Mirrors the JAX ensure_page, including its row choice
    (`count % capacity`) for lanes that do not allocate."""
    capacity = ov.capacity
    lanes = torch.arange(pfn.shape[0], device=pfn.device)
    idx0, hit = lookup(ov, pfn)
    in_range = pfn != PFN_OOB
    can_alloc = ov.count < capacity
    do_alloc = enabled & ~hit & can_alloc & in_range
    idx = torch.where(hit, idx0, (ov.count % capacity).long())
    ov.valid[lanes, idx] = torch.where(
        do_alloc[:, None], torch.zeros_like(ov.valid[lanes, idx]),
        ov.valid[lanes, idx])
    ov.pfn[lanes, idx] = torch.where(do_alloc, pfn.to(torch.int32),
                                     ov.pfn[lanes, idx])
    ov.count += do_alloc.to(torch.int32)
    ov.overflow |= enabled & ~hit & ~can_alloc & in_range
    return idx, (hit | do_alloc) & in_range


def store_window3(image: MemImage, ov: DirtyOverlay, gpa_first, gpa_last,
                  size, lo, hi, enabled) -> torch.Tensor:
    """Commit up to 16 bytes (value lo, hi; little-endian) at [L] spans
    through the lane overlays: claim the one or two touched rows, then a
    3-word masked read-modify-write.  Returns ok ([L]; False = overlay
    full).

    Like the JAX store_window3 the 3-word write-back runs for EVERY lane:
    a lane that does not store writes each word's current value back
    (image words land in rows where they stay invalid), so the data
    planes of the two packages stay identical word for word."""
    lanes = torch.arange(gpa_first.shape[0], device=gpa_first.device)
    pfn0, off0 = split_gpa(image, gpa_first)
    pfn1, _ = split_gpa(image, gpa_last)
    size = size.long()
    crosses = (off0 + size) > PAGE_SIZE
    row0, ok0 = ensure_page(ov, pfn0, enabled)
    row1, ok1 = ensure_page(ov, pfn1, enabled & crosses)
    ok = ok0 & (ok1 | ~crosses)
    do = enabled & ok
    slot0, slot1 = frame_slot(image, pfn0), frame_slot(image, pfn1)
    sh = (off0 & 7) * 8
    inv = 64 - sh
    v = (I.shl(lo, sh), I.shr(lo, inv) | I.shl(hi, sh), I.shr(hi, inv))
    end_bit = sh + size * 8
    w_start = off0 >> 3
    rows, widxs, news, vnews = [], [], [], []
    for j in range(3):
        on_first = (w_start + j) < PAGE_WORDS
        widx = torch.where(on_first, w_start + j, w_start + j - PAGE_WORDS)
        row = torch.where(on_first, row0, row1)
        slot = torch.where(on_first, slot0, slot1)
        lo_bit = 64 * j
        start_in = torch.clamp(sh, min=lo_bit)
        end_in = torch.clamp(end_bit, max=lo_bit + 64)
        has = end_in > start_in
        n_bits = torch.where(has, end_in - start_in, torch.zeros_like(sh))
        off_in = torch.where(has, start_in - lo_bit, torch.zeros_like(sh))
        # n_bits == 64 wraps (1 << 64 -> 0) to the all-ones mask
        mask = I.shl(I.shl(torch.ones_like(sh), n_bits) - 1, off_in)
        was_valid = ov.valid[lanes, row, widx] != 0
        old = torch.where(was_valid, ov.data[lanes, row, widx],
                          image.pages[slot.long(), widx])
        touched = do & (mask != 0)
        rows.append(row)
        widxs.append(widx)
        news.append(torch.where(touched, (old & ~mask) | (v[j] & mask), old))
        vnews.append(touched | was_valid)
    rows3 = torch.stack(rows, 1)
    widxs3 = torch.stack(widxs, 1)
    lanes3 = lanes[:, None].expand_as(rows3)
    ov.data[lanes3, rows3, widxs3] = torch.stack(news, 1)
    ov.valid[lanes3, rows3, widxs3] = torch.stack(vnews, 1).to(torch.uint8)
    return ok


# ---------------------------------------------------------------------------
# byte-granular paths (host-driven I/O and tests)
# ---------------------------------------------------------------------------

def gather_bytes(image: MemImage, ov: DirtyOverlay, gpa_vec, first_mask):
    """Overlay-aware read of [L, N] bytes spread over at most two physical
    pages per lane (`first_mask` marks bytes on the first byte's page)."""
    n = gpa_vec.shape[1]
    pfn0, _ = split_gpa(image, gpa_vec[:, 0])
    pfn1, _ = split_gpa(image, gpa_vec[:, n - 1])
    idx0, hit0 = lookup(ov, pfn0)
    idx1, hit1 = lookup(ov, pfn1)
    slot0, slot1 = frame_slot(image, pfn0), frame_slot(image, pfn1)
    byte_off = gpa_vec & (PAGE_SIZE - 1)
    pick = lambda a, b: torch.where(first_mask, a[:, None], b[:, None])  # noqa: E731
    words = read_words(image, ov, pick(slot0, slot1), pick(idx0, idx1),
                       pick(hit0, hit1), byte_off >> 3)
    return (I.shr(words, (byte_off & 7) * 8) & 0xFF).to(torch.uint8)


def scatter_span(image: MemImage, ov: DirtyOverlay, gpa_first, gpa_last,
                 values: torch.Tensor, enabled) -> torch.Tensor:
    """Overlay-aware write of a virtually contiguous [L, N] byte span over
    at most two physical pages per lane -> ok [L].  Like the JAX
    scatter_span, every lane writes its window words back (untouched
    words unchanged in value)."""
    n = values.shape[1]
    lanes = torch.arange(values.shape[0], device=values.device)
    pfn0, off0 = split_gpa(image, gpa_first)
    pfn1, _ = split_gpa(image, gpa_last)
    two_pages = pfn1 != pfn0
    idx0, ok0 = ensure_page(ov, pfn0, enabled)
    idx1, ok1 = ensure_page(ov, pfn1, enabled & two_pages)
    ok = ok0 & torch.where(two_pages, ok1, torch.ones_like(ok1))
    do = enabled & ok
    head = off0 & 7
    n_words = (n + 7 + 7) // 8
    w_start = off0 >> 3
    vals = values.long()
    slot0, slot1 = frame_slot(image, pfn0), frame_slot(image, pfn1)
    k = torch.arange(8, device=values.device)
    rows, widxs, news, vnews = [], [], [], []
    for j in range(n_words):
        src = (8 * j - head)[:, None] + k[None, :]
        inside = (src >= 0) & (src < n)
        byte = torch.gather(vals, 1, src.clamp(0, n - 1))
        word = (torch.where(inside, byte, torch.zeros_like(byte))
                << (k * 8)).sum(1)
        mask = (torch.where(inside, torch.full_like(byte, 0xFF),
                            torch.zeros_like(byte)) << (k * 8)).sum(1)
        on_first = (w_start + j) < PAGE_WORDS
        widx = torch.where(on_first, w_start + j, w_start + j - PAGE_WORDS)
        row = torch.where(on_first, idx0, torch.where(two_pages, idx1, idx0))
        slot = torch.where(on_first, slot0,
                           torch.where(two_pages, slot1, slot0))
        was_valid = ov.valid[lanes, row, widx] != 0
        old = torch.where(was_valid, ov.data[lanes, row, widx],
                          image.pages[slot.long(), widx])
        touched = do & (mask != 0)
        rows.append(row)
        widxs.append(widx)
        news.append(torch.where(touched, (old & ~mask) | (word & mask), old))
        vnews.append(touched | was_valid)
    rws = torch.stack(rows, 1)
    wxs = torch.stack(widxs, 1)
    lanes_n = lanes[:, None].expand_as(rws)
    ov.data[lanes_n, rws, wxs] = torch.stack(news, 1)
    ov.valid[lanes_n, rws, wxs] = torch.stack(vnews, 1).to(torch.uint8)
    return ok
