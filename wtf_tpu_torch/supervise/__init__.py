"""Self-healing device runtime (supervise/), the counterpart of
wtf_tpu/supervise.

  supervisor.Supervisor  the per-backend dispatch guard: watchdog,
                         batch-boundary snapshot + rebuild/replay
                         recovery, per-batch integrity + quarantine
  ladder.DegradationLadder
                         megachunk -> batch -> fused-off -> fixed-chunk
                         step-down with hysteresis re-promotion
  integrity              the invariant/digest fold over the machine
                         planes and the poison/mask write-side helpers

See supervisor.py's module docstring for the full contract; SEAM_SITES
enumerates every dispatch entry point that must route through
Supervisor.dispatch.
"""

from wtf_tpu_torch.supervise.ladder import DegradationLadder  # noqa: F401
from wtf_tpu_torch.supervise.supervisor import (  # noqa: F401
    DEVICE_ERROR, DEVICE_HANG, DEVICE_POISON, MACHINE_SEAMS, SEAM_SITES,
    DeviceLost, DispatchError, DispatchFailure, DispatchHang, LanePoisoned,
    Supervisor,
)
