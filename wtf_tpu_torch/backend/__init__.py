"""Backends (reference `Backend_t`, src/wtf/backend.h:161-596).

  base.py - the Backend contract (copied from wtf_tpu/backend/base.py)
  emu.py  - EmuBackend, the host oracle (copied; the trace runs use it)
  gpu.py  - GpuBackend, the batched device interpreter on a CUDA device
            (or, when asked, on the CPU)
"""

from wtf_tpu_torch.backend.base import Backend, BreakpointHandler  # noqa: F401
