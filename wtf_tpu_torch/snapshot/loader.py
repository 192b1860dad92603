"""Unified snapshot loading.

A snapshot is the checkpoint the whole system revolves around (reference
README.md:168-240): guest memory (`mem.dmp`) + registers (`regs.json`) +
symbols (`symbol-store.json`) living in a target's `state/` directory
(wtf.cc:127-129).  This module loads any of:

  - `mem.npz`   — the raw packed format used by synthetic snapshots/tests.

Windows crash dumps (`mem.dmp`, wtf_tpu/snapshot/kdmp.py in the JAX
package) are not carried over yet: loading one raises.

into a `Snapshot{PhysMem, CpuState, symbols}` ready for device upload.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from wtf_tpu_torch.core.cpustate import CpuState, load_cpu_state_json, sanitize_cpu_state
from wtf_tpu_torch.core.gxa import PAGE_SIZE
from wtf_tpu_torch.mem.physmem import PhysMem


@dataclasses.dataclass
class Snapshot:
    physmem: PhysMem
    cpu: CpuState
    symbols: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_pages(
        cls, pages: Dict[int, bytes], cpu: CpuState, symbols: Optional[Dict[str, int]] = None
    ) -> "Snapshot":
        return cls(physmem=PhysMem.from_pages(pages), cpu=cpu, symbols=symbols or {})

    def save_raw(self, state_dir) -> None:
        """Persist in the raw format (mem.npz + regs.json + symbol-store.json)."""
        state_dir = Path(state_dir)
        state_dir.mkdir(parents=True, exist_ok=True)
        pages_np = self.physmem.pages.view(np.uint8)
        table_np = self.physmem.frame_table[0]
        pfns = np.nonzero(table_np)[0]
        slots = table_np[pfns]
        np.savez_compressed(
            state_dir / "mem.npz",
            pfns=pfns.astype(np.int64),
            pages=pages_np[slots],
        )
        (state_dir / "regs.json").write_text(dump_cpu_state_json(self.cpu))
        (state_dir / "symbol-store.json").write_text(
            json.dumps({k: hex(v) for k, v in self.symbols.items()}, indent=1)
        )


def load_snapshot(state_dir, sanitize: bool = True) -> Snapshot:
    """Load a snapshot directory (reference startup path wtf.cc:378-465:
    LoadCpuStateFromJSON -> backend init -> SanitizeCpuState)."""
    state_dir = Path(state_dir)
    cpu = load_cpu_state_json(state_dir / "regs.json")
    if sanitize and not sanitize_cpu_state(cpu):
        raise ValueError(f"unusable CPU state in {state_dir}")

    symbols: Dict[str, int] = {}
    symbol_path = state_dir / "symbol-store.json"
    if symbol_path.exists():
        raw = json.loads(symbol_path.read_text())
        symbols = {k: (int(v, 0) if isinstance(v, str) else int(v)) for k, v in raw.items()}

    npz_path = state_dir / "mem.npz"
    dmp_path = state_dir / "mem.dmp"
    if npz_path.exists():
        data = np.load(npz_path)
        pages = {
            int(pfn): bytes(page.tobytes())
            for pfn, page in zip(data["pfns"], data["pages"])
        }
    elif dmp_path.exists():
        raise NotImplementedError(
            f"{dmp_path}: crash-dump snapshots are not supported by "
            f"wtf_tpu_torch yet (use the raw mem.npz format)")
    else:
        raise FileNotFoundError(f"no mem.npz or mem.dmp under {state_dir}")

    return Snapshot(physmem=PhysMem.from_pages(pages), cpu=cpu, symbols=symbols)


def dump_cpu_state_json(cpu: CpuState) -> str:
    """Serialize a CpuState back to the bdump.js regs.json format, so
    synthetic snapshots round-trip through the same loader as real ones."""
    from wtf_tpu_torch.core.cpustate import _REG_KEYS, _SEG_KEYS  # noqa: SLF001

    data = {}
    for key in _REG_KEYS:
        data[key] = hex(getattr(cpu, key))
    for key in _SEG_KEYS:
        seg = getattr(cpu, key)
        data[key] = {
            "present": seg.present,
            "selector": hex(seg.selector),
            "base": hex(seg.base),
            "limit": hex(seg.limit),
            "attr": hex(seg.attr),
        }
    data["gdtr"] = {"base": hex(cpu.gdtr.base), "limit": hex(cpu.gdtr.limit)}
    data["idtr"] = {"base": hex(cpu.idtr.base), "limit": hex(cpu.idtr.limit)}
    data["fpst"] = [hex(v) for v in cpu.fpst]
    data["zmm"] = [{"q": [hex(limb) for limb in reg]} for reg in cpu.zmm]
    return json.dumps(data, indent=1)
