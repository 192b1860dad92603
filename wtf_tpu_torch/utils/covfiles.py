"""Coverage-file (.cov) ingestion.

The reference consumes JSON files produced by IDA/Binja/Ghidra scripts
(scripts/gen_coveragefile_*.py) with shape {"name": str, "addresses": [int]},
where addresses are module-relative or absolute basic-block starts
(utils.cc:314-379 ParseCovFiles).  Used to pre-register coverage breakpoints
for backends without per-instruction visibility; for the TPU interpreter
backend they instead seed the known-coverage sets so parity comparisons work.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Set


def parse_cov_files(cov_dir) -> Set[int]:
    """Parse every .cov JSON file in a directory into a set of GVAs."""
    addresses: Set[int] = set()
    cov_dir = Path(cov_dir)
    if not cov_dir.is_dir():
        return addresses
    for path in sorted(cov_dir.glob("*.cov")):
        data = json.loads(path.read_text())
        for addr in data.get("addresses", []):
            if isinstance(addr, str):
                addr = int(addr, 0)
            addresses.add(int(addr))
    return addresses
