"""Backends (reference `Backend_t`, src/wtf/backend.h:161-596).

  base.py - the Backend contract (copied from wtf_tpu/backend/base.py)
  emu.py  - EmuBackend, the host oracle (copied; the trace runs use it)
  gpu.py  - GpuBackend, the batched device interpreter on a CUDA device
            (or, when asked, on the CPU)

A `mesh_devices` kwarg on the gpu backend upgrades it to the lane mesh
(wtf_tpu_torch/meshrun): the same contract, lane count = lanes per
shard x shards.
"""

from wtf_tpu_torch.backend.base import Backend, BreakpointHandler  # noqa: F401

# the oracle's own settings; the rest tune the device batch
_EMU_KWARGS = ("limit", "deliver_exceptions", "registry", "events")


def create_backend(name: str, snapshot, **kwargs) -> Backend:
    """Instantiate a backend by CLI name (reference wtf.cc:403-415):
    `gpu` (a MeshBackend when `mesh_devices` is given, 0 = every visible
    device, or a LaneMesh as `mesh`) or `emu`, which ignores the device
    batch's settings."""
    if name == "emu":
        from wtf_tpu_torch.backend.emu import EmuBackend

        return EmuBackend(snapshot, **{k: v for k, v in kwargs.items()
                                       if k in _EMU_KWARGS})
    if name == "gpu":
        if (kwargs.get("mesh_devices") is not None
                or kwargs.get("mesh") is not None):
            from wtf_tpu_torch.meshrun.backend import MeshBackend

            return MeshBackend(snapshot, **kwargs)
        kwargs.pop("mesh_devices", None)
        kwargs.pop("mesh", None)
        from wtf_tpu_torch.backend.gpu import GpuBackend

        return GpuBackend(snapshot, **kwargs)
    raise ValueError(f"unknown backend {name!r} (expected emu|gpu)")
