"""Carry interpreter state between the JAX package's layout and the port's.

The JAX package keeps its hot 64-bit fields as little-endian u32 limb
pairs (`gpr_l` uint32[L, 16, 2], ...), its u32 counters and bitmaps as
uint32 and its other 64-bit fields as uint64; the port keeps every 64-bit
value in one int64 and every u32 word in one int32, with the same bits.
These functions take and return the JAX side as a dict of field name ->
numpy array (overlay fields under "overlay.<name>"), so this module never
imports the JAX package; limb pairs are bitcast on the host.  The tests
use them to feed both packages the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from wtf_tpu_torch.interp.machine import Machine
from wtf_tpu_torch.interp.uoptable import UopTable
from wtf_tpu_torch.mem.overlay import DirtyOverlay
from wtf_tpu_torch.mem.physmem import MemImage

# JAX Machine limb fields -> the port's field
_LIMB = {"gpr_l": "gpr", "rip_l": "rip", "rflags_l": "rflags",
         "xmm_l": "xmm", "fs_base_l": "fs_base", "gs_base_l": "gs_base"}
_U32 = ("ctr", "cov", "edge")


def pack_limbs(a: np.ndarray) -> np.ndarray:
    """uint32[..., 2] limb pairs -> int64[...] (the u64 bits)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return a.view(np.uint64).reshape(a.shape[:-1]).view(np.int64)


def unpack_limbs(a: np.ndarray) -> np.ndarray:
    """int64[...] -> uint32[..., 2] little-endian limb pairs."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32).reshape(a.shape + (2,))


def _t(a: np.ndarray, device) -> torch.Tensor:
    # a copy: arrays handed over from JAX are read-only views
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def machine_from_jax(leaves: Dict[str, np.ndarray], device="cpu") -> Machine:
    kw = {}
    for f in dataclasses.fields(Machine):
        name = f.name
        if name == "overlay":
            continue
        if name == "xmm":
            x = leaves["xmm_l"]
            kw[name] = _t(pack_limbs(x.reshape(x.shape[:-1] + (4, 2))),
                          device)
        elif name in _LIMB.values():
            jname = next(k for k, v in _LIMB.items() if v == name)
            kw[name] = _t(pack_limbs(leaves[jname]), device)
        elif name in _U32:
            kw[name] = _t(np.asarray(leaves[name], np.uint32)
                          .view(np.int32), device)
        else:
            a = np.asarray(leaves[name])
            kw[name] = _t(a.view(np.int64) if a.dtype == np.uint64 else a,
                          device)
    ov = DirtyOverlay(
        pfn=_t(np.asarray(leaves["overlay.pfn"], np.int32), device),
        data=_t(np.asarray(leaves["overlay.data"], np.uint64)
                .view(np.int64), device),
        valid=_t(np.asarray(leaves["overlay.valid"], np.uint8), device),
        count=_t(np.asarray(leaves["overlay.count"], np.int32), device),
        overflow=_t(np.asarray(leaves["overlay.overflow"], bool), device))
    return Machine(**kw, overlay=ov)


def machine_to_jax(m: Machine) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(m):
        name = f.name
        if name == "overlay":
            for g in dataclasses.fields(m.overlay):
                a = _np(getattr(m.overlay, g.name))
                out[f"overlay.{g.name}"] = (a.view(np.uint64)
                                            if g.name == "data" else a)
            continue
        a = _np(getattr(m, name))
        if name == "xmm":
            out["xmm_l"] = unpack_limbs(a).reshape(a.shape[:-1] + (8,))
        elif name in _LIMB.values():
            jname = next(k for k, v in _LIMB.items() if v == name)
            out[jname] = unpack_limbs(a)
        elif name in _U32:
            out[name] = a.view(np.uint32)
        elif a.dtype == np.int64:
            out[name] = a.view(np.uint64)
        else:
            out[name] = a
    return out


def table_from_jax(leaves: Dict[str, np.ndarray], device="cpu") -> UopTable:
    return UopTable(
        rip=_t(pack_limbs(leaves["rip_l"]), device),
        meta_i32=_t(np.asarray(leaves["meta_i32"], np.int32), device),
        meta_u64=_t(np.asarray(leaves["meta_u64"], np.uint64)
                    .view(np.int64), device),
        hash_tab=_t(np.asarray(leaves["hash_tab"], np.int32), device))


def table_to_jax(tab: UopTable) -> Dict[str, np.ndarray]:
    return {"rip_l": unpack_limbs(_np(tab.rip)),
            "meta_i32": _np(tab.meta_i32),
            "meta_u64": _np(tab.meta_u64).view(np.uint64),
            "hash_tab": _np(tab.hash_tab)}


def image_from_jax(leaves: Dict[str, np.ndarray], device="cpu") -> MemImage:
    tenant = leaves.get("tenant")
    return MemImage(
        pages=_t(np.asarray(leaves["pages"], np.uint64).view(np.int64),
                 device),
        frame_table=_t(np.asarray(leaves["frame_table"], np.int32), device),
        tenant=None if tenant is None else _t(
            np.asarray(tenant, np.int32), device))


def image_to_jax(img: MemImage) -> Dict[str, np.ndarray]:
    out = {"pages": _np(img.pages).view(np.uint64),
           "frame_table": _np(img.frame_table)}
    if img.tenant is not None:
        out["tenant"] = _np(img.tenant)
    return out
