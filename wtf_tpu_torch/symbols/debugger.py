"""Symbol store + symbolization (reference `Debugger_t`).

The reference has two modes: DbgEng COM symbolization on Windows
(debugger.h:17-342) and a flat `symbol-store.json` name->address map on
Linux (debugger.h:343-386); every live resolution is persisted into the
store (AddSymbol, debugger.h:92-108) so Linux runs symbolize offline.
This framework has no DbgEng, so the store IS the source of truth —
what bdump/symbolizer tooling exported with the snapshot.

Provides both directions:
  get_symbol(name)  name -> address            (debugger.h:281-299)
  get_name(addr)    address -> 'module!sym+0x12', nearest-preceding
                    symbol, with a cache      (debugger.h:301-341)
  add_symbol(...)   insert + optional persist  (debugger.h:92-108)
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple


class Debugger:
    def __init__(self, symbols: Optional[Dict[str, int]] = None,
                 store_path: Optional[Path] = None):
        self._symbols: Dict[str, int] = dict(symbols or {})
        self._store_path = Path(store_path) if store_path else None
        self._name_cache: Dict[int, str] = {}
        self._sorted: Optional[List[Tuple[int, str]]] = None

    # -- loading / persistence ---------------------------------------------
    @classmethod
    def load(cls, store_path) -> "Debugger":
        """Load symbol-store.json ({'module!sym': '0xaddr' | int})."""
        store_path = Path(store_path)
        symbols: Dict[str, int] = {}
        if store_path.exists():
            raw = json.loads(store_path.read_text())
            symbols = {
                k: (int(v, 0) if isinstance(v, str) else int(v))
                for k, v in raw.items()
            }
        return cls(symbols, store_path=store_path)

    def save(self) -> None:
        if self._store_path is None:
            return
        self._store_path.write_text(json.dumps(
            {k: hex(v) for k, v in sorted(self._symbols.items())},
            indent=1))

    # -- name -> address ----------------------------------------------------
    def get_symbol(self, name: str) -> int:
        addr = self._symbols.get(name)
        if addr is None:
            raise KeyError(f"symbol {name!r} not in store "
                           f"({len(self._symbols)} symbols)")
        return addr

    def try_get_symbol(self, name: str) -> Optional[int]:
        return self._symbols.get(name)

    def add_symbol(self, name: str, address: int,
                   persist: bool = True) -> None:
        """Insert a resolution (reference persists every one so offline
        runs can symbolize, debugger.h:92-108)."""
        self._symbols[name] = address
        self._sorted = None
        self._name_cache.clear()
        if persist:
            self.save()

    # -- address -> name ----------------------------------------------------
    def _sorted_symbols(self) -> List[Tuple[int, str]]:
        if self._sorted is None:
            self._sorted = sorted(
                (addr, name) for name, addr in self._symbols.items())
        return self._sorted

    def get_name(self, address: int, style: str = "full") -> str:
        """Nearest preceding symbol + offset; raw hex when nothing
        precedes.  style='modoff' gives 'module+0xoff' (the reference's
        two DbgEng styles)."""
        cached = self._name_cache.get(address)
        if cached is not None and style == "full":
            return cached
        table = self._sorted_symbols()
        idx = bisect.bisect_right(table, (address, "\xff")) - 1
        if idx < 0 or not table:
            return f"{address:#x}"
        base, name = table[idx]
        offset = address - base
        if style == "modoff":
            module = name.split("!", 1)[0]
            out = module if offset == 0 else f"{module}+{offset:#x}"
        else:
            out = name if offset == 0 else f"{name}+{offset:#x}"
        if style == "full":
            self._name_cache[address] = out
        return out

    def __len__(self) -> int:
        return len(self._symbols)

    def __contains__(self, name: str) -> bool:
        return name in self._symbols
