"""The graceful-degradation ladder: trade wall-clock for stability.

A copy of wtf_tpu/supervise/ladder.py.

Every rung below "full" turns OFF one throughput feature whose output is
already pinned bit-identical to the plain path at equal seeds (megachunk
parity, fused-step parity, and the adaptive-chunk schedule are all
tier-1 parity tests) — so stepping down after repeated device failures
changes how fast the campaign runs, never what it finds:

  level 0  full            megachunk windows, fused step, adaptive chunks
  level 1  no-megachunk    batch-at-a-time dispatch (smallest abandonable
                           unit shrinks from a window to one batch)
  level 2  no-fused        fused mutate->execute off; plain chunk executor
  level 3  fixed-chunk     adaptive chunk growth off; base chunk_steps
                           only (the smallest step surface: one chunk size)

Rungs that don't apply to the campaign (no megachunk configured, fused
step already off) are skipped at construction, so `level` always indexes
a real change.  Hysteresis: one failure steps down one rung immediately;
`promote_after` CONSECUTIVE clean batches step back up one rung — a
flapping device ratchets down and stays down.

Below the bottom rung there is nothing left to turn off on this backend;
further failures set `wants_reshard`, the flag a multi-device campaign
reads to shrink its mesh (single-device campaigns only record it).
"""

from __future__ import annotations

FULL = "full"
NO_MEGACHUNK = "no-megachunk"
NO_FUSED = "no-fused"
FIXED_CHUNK = "fixed-chunk"


class DegradationLadder:
    def __init__(self, loop, promote_after: int = 8):
        runner = loop.backend.runner
        self._orig_fused = bool(getattr(runner, "fused_enabled", False))
        self._orig_adaptive = bool(getattr(runner, "adaptive_chunks", True))
        self.rungs = [FULL]
        if getattr(loop, "megachunk", 0):
            self.rungs.append(NO_MEGACHUNK)
        if self._orig_fused:
            self.rungs.append(NO_FUSED)
        if self._orig_adaptive:
            self.rungs.append(FIXED_CHUNK)
        self.level = 0
        self.promote_after = max(1, int(promote_after))
        self.clean_streak = 0
        self.wants_reshard = False

    @property
    def rung_name(self) -> str:
        return self.rungs[self.level]

    def _active(self, rung: str) -> bool:
        """Level k activates every degradation in rungs[1..k]."""
        try:
            return self.rungs.index(rung) <= self.level
        except ValueError:
            return False

    @property
    def megachunk_off(self) -> bool:
        return self._active(NO_MEGACHUNK)

    def on_failure(self) -> bool:
        """Step down one rung; returns True when the rung changed.  At
        the bottom, flag the elastic-reshard escape hatch instead."""
        self.clean_streak = 0
        if self.level + 1 < len(self.rungs):
            self.level += 1
            return True
        self.wants_reshard = True
        return False

    def on_clean(self) -> bool:
        """One clean batch; returns True when the streak re-promotes a
        rung (hysteresis: promote_after consecutive cleans per rung)."""
        if self.level == 0:
            return False
        self.clean_streak += 1
        if self.clean_streak >= self.promote_after:
            self.clean_streak = 0
            self.level -= 1
            return True
        return False

    def apply(self, loop) -> None:
        """Install this rung's flags on the CURRENT runner.  Called after
        every rung change and after every rebuild (the fresh Runner comes
        up with its construction-time defaults, not the rung's)."""
        runner = loop.backend.runner
        runner.fused_enabled = self._orig_fused and not self._active(NO_FUSED)
        runner.adaptive_chunks = (self._orig_adaptive
                                  and not self._active(FIXED_CHUNK))
