"""Candidate generation for crash minimization, on the device.

The counterpart of wtf_tpu/triage/candidates.py: one call turns the
current best reproducer into a whole batch of candidate reductions, in
the devmut engine's byte-plane idiom (wtf_tpu_torch/devmut/engine.py),
for the minimizer's three candidate classes:

  OP_TRUNCATE  keep the first `pos` bytes (tail removal)
  OP_DELETE    remove the block [pos, pos+size) — the tail shifts left
               through ONE clamped gather
  OP_ZERO      overwrite [pos, pos+size) with 0x00 at unchanged length
               (byte simplification; size 0 == identity, the baseline
               replay descriptor)

The reproducer is uploaded once per round as packed words (zero-padded
past its length, the devmut slab contract); descriptors (op/pos/size per
lane) are small host arrays.  The output feeds `Runner.device_insert`
through `GpuBackend.run_batch_words`, so the candidate bytes never visit
the host — the harvest pulls only the one winning lane.

Representation: the JAX build_candidates works in u32; here words are
int32 holding the u32 bits and every length, position and gather index
is an int64 holding the u32 value (torch on the CPU has no u32 add or
shift).
The clamps cannot wrap (`cur_len >= 1`), and the zero window's end
`pos + size` is taken mod 2**32 as the u32 add wraps it.  The JAX
package's `PORTED_LIMB_PATHS` (a lint export) has no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from wtf_tpu_torch.devmut.engine import pack_words, unpack_bytes

OP_TRUNCATE = 0
OP_DELETE = 1
OP_ZERO = 2
OP_NAMES = ("truncate", "delete", "zero")

M32 = 0xFFFFFFFF


def build_candidates(cur_words: torch.Tensor, cur_len: int,
                     ops: torch.Tensor, pos: torch.Tensor,
                     size: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build one candidate per lane from the current reproducer.

    cur_words int32[W]   packed reproducer (zero-padded past cur_len)
    cur_len   int        reproducer byte length (>= 1)
    ops       int32[L]   OP_* per lane
    pos       int64[L]   truncate: the new length; delete/zero: offset
                         (u32 values)
    size      int64[L]   delete/zero block size (u32 values; clamped)

    Returns (words int32[L, W], lens int32[L]).  Candidate lengths stay
    >= 1; bytes past each candidate's length are zero (the padded-slab
    contract device_insert relies on for deterministic page contents).
    """
    dev = cur_words.device
    max_len = cur_words.shape[0] * 4
    n_lanes = ops.shape[0]
    cur = torch.tensor(int(cur_len), dtype=torch.int64, device=dev)
    pos = pos.long()
    size = size.long()
    idx = torch.arange(max_len, device=dev).expand(n_lanes, max_len)
    b = unpack_bytes(cur_words)[None, :].expand(n_lanes, max_len)

    # truncate: new length = clamp(pos, 1, cur_len)
    ln_tr = torch.minimum(pos.clamp(min=1), cur)

    # delete [pos, pos+size): clamp so at least one byte survives
    dpos = torch.minimum(pos, cur - 1)
    dsz = torch.minimum(torch.minimum(size, cur - dpos), cur - 1)
    src_del = torch.where(idx < dpos[:, None], idx, idx + dsz[:, None])
    b_del = b.gather(1, src_del.clamp(max=max_len - 1))
    ln_del = cur - dsz

    # zero [pos, pos+size) at unchanged length (size 0 == identity)
    end = (pos + size) & M32
    zwin = (idx >= pos[:, None]) & (idx < end[:, None])
    b_zero = torch.where(zwin, torch.zeros_like(b), b)

    is_tr = ops == OP_TRUNCATE
    is_del = ops == OP_DELETE
    out_b = torch.where(is_del[:, None], b_del,
                        torch.where(is_tr[:, None], b, b_zero))
    out_ln = torch.where(is_del, ln_del,
                         torch.where(is_tr, ln_tr, cur.expand(n_lanes)))
    out_b = torch.where(idx < out_ln[:, None], out_b, torch.zeros_like(out_b))
    return pack_words(out_b), out_ln.to(torch.int32)


def zero_counts(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-lane count of zero bytes inside each candidate's length — the
    simplification half of the minimizer's (len, -zeros) score, computed
    on the device so scoring never pulls candidate bytes."""
    b = unpack_bytes(words)
    idx = torch.arange(b.shape[1], device=words.device)[None, :]
    inside = idx < lens.long()[:, None]
    return (inside & (b == 0)).sum(1).to(torch.int32)


def pack_testcase(data: bytes, max_len: int) -> Tuple[np.ndarray, int]:
    """Host helper: bytes -> (packed u32[max_len/4] zero-padded, length).
    The upload format `build_candidates` and the devmut slab share."""
    data = data[:max_len]
    words = (max_len + 3) // 4
    buf = np.zeros(words * 4, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.view(np.uint32), len(data)


def upload(words: np.ndarray, device) -> torch.Tensor:
    """pack_testcase's u32 words as the int32 tensor build_candidates
    takes."""
    return torch.from_numpy(words.view(np.int32).copy()).to(device)
