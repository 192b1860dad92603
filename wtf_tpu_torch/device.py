"""Where the port runs: a CUDA device unless the caller asks for the CPU.

Every entry point takes `--device`, default `cuda`.  Without a usable
CUDA device that default raises instead of quietly running on the CPU;
only an explicit `--device cpu` (what the tests pass) runs the plain
PyTorch versions of the kernels there.  The kernels themselves are built
by csrc/build.py.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The torch.device for `name` ("cuda", "cuda:N" or "cpu"); raises
    when CUDA is asked for and not available."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                f"is False; pass --device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev

