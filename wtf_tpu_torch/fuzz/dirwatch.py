"""Directory watcher: mid-campaign corpus injection.

Reference `DirWatcher_t` (src/wtf/dirwatch.h): polls a directory and
returns newly appeared files, size-sorted, so operators can drop seeds
into a running master.  The master calls poll() between reactor
iterations and prepends results to its seed paths.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional


class DirWatcher:
    def __init__(self, directory):
        self.directory = Path(directory)
        self._seen = set()
        if self.directory.is_dir():
            self._seen = {p.name for p in self.directory.iterdir()}

    def poll(self) -> List[Path]:
        """New files since the last poll, biggest first (matching the
        master's seed ordering, server.h:399-414).  Robust against files
        vanishing mid-scan (atomic-rename temp files, operator cleanup)."""
        if not self.directory.is_dir():
            return []
        fresh = []
        for p in self.directory.iterdir():
            if p.name in self._seen:
                continue
            try:
                if p.is_file():
                    fresh.append((p.stat().st_size, p))
                    self._seen.add(p.name)
            except OSError:
                continue  # vanished between iterdir and stat; not seen
        return [p for _, p in sorted(fresh, key=lambda t: t[0],
                                     reverse=True)]
