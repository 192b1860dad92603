"""Path conventions (copied from wtf_tpu/config.py `TargetPaths`)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class TargetPaths:
    """targets/<t>/{inputs,outputs,crashes,state} conventions."""

    target: Optional[Path] = None
    inputs: Optional[Path] = None
    outputs: Optional[Path] = None
    crashes: Optional[Path] = None
    state: Optional[Path] = None

    def resolve(self) -> "TargetPaths":
        """Default unset dirs from the target root (wtf.cc:48-68)."""
        if self.target is not None:
            root = Path(self.target)
            self.inputs = self.inputs or root / "inputs"
            self.outputs = self.outputs or root / "outputs"
            self.crashes = self.crashes or root / "crashes"
            self.state = self.state or root / "state"
        return self
