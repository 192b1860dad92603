"""Build the hand-written CUDA kernels and bind them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -I<build dir> -o lib<name>-<hash>.so

into `wtf_tpu_torch/_build/`, at first use, from the sources in the
checkout alone.  The constants the kernels share with the Python side
(uop field columns, opcode numbers, status codes, counter indices) are
written into `wtf_consts.h` from the Python modules before compiling, so
the two cannot drift.  The library name carries a hash of the source
and that header; a stale build is never loaded.  A failed build raises
KernelError with nvcc's output; the wrappers raise KernelError when a
launch fails and KernelArgumentError when they refuse their arguments.

`build_all()` starts one nvcc per source at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent
BUILD = CSRC.parent / "_build"
KERNELS = ("fused_step", "probe")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per kernel source (registers, spills)
PTXAS: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


class KernelError(RuntimeError):
    """A kernel of this package failed to build or to launch.  The
    supervisor never replays one: the same call fails again, and a rung
    of its ladder without the kernel would carry on without it."""


class KernelArgumentError(KernelError, ValueError):
    """A kernel's wrapper refused its arguments (the launch was never
    made)."""


# each library's C functions: every pointer (and the stream) as c_void_p,
# ints as c_int
_SIGNATURES = {
    "probe": [("wtf_probe", [ctypes.c_void_p] * 3),
              ("wtf_empty", [ctypes.c_void_p])],
    "fused_step": [
        ("wtf_fused_step",
         [ctypes.c_void_p, ctypes.c_int,            # hash
          ctypes.c_void_p, ctypes.c_int,            # meta_i32
          ctypes.c_void_p,                          # meta_u64
          ctypes.c_void_p,                          # pages
          ctypes.c_void_p, ctypes.c_int,            # frame table
          ctypes.c_void_p, ctypes.c_void_p,         # tenant, cr3
          ctypes.c_void_p, ctypes.c_void_p,         # fs, gs
          ctypes.c_void_p, ctypes.c_void_p,         # gpr, rip
          ctypes.c_void_p, ctypes.c_void_p,         # rflags, status
          ctypes.c_void_p, ctypes.c_void_p,         # icount, bp_skip
          ctypes.c_void_p,                          # ctr
          ctypes.c_void_p, ctypes.c_int,            # cov
          ctypes.c_void_p, ctypes.c_int,            # edge
          ctypes.c_void_p, ctypes.c_void_p,         # ov pfn, data
          ctypes.c_void_p, ctypes.c_void_p,         # valid, count
          ctypes.c_int,                             # slots
          ctypes.c_int64,                           # limit
          ctypes.c_int, ctypes.c_int,               # L, K
          ctypes.c_int, ctypes.c_int, ctypes.c_int,  # grid, block, shared
          ctypes.c_void_p]),                        # stream
        ("wtf_fused_occupancy",
         [ctypes.c_int, ctypes.c_int,               # block, shared
          ctypes.POINTER(ctypes.c_int)]),           # out: blocks per SM
    ],
}


def consts_header() -> str:
    """The shared constants, from the Python modules that define them."""
    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.cpu import uops as U
    from wtf_tpu_torch.interp import machine, uoptable

    lines = ["// generated by wtf_tpu_torch/csrc/build.py — do not edit",
             "#pragma once"]
    for name in sorted(vars(U)):
        if name.split("_")[0] in ("OPC", "K", "REG", "SEG", "ALU", "SH",
                                  "UN", "MUL"):
            value = getattr(U, name)
            if isinstance(value, int):
                lines.append(f"#define {name} ({value})")
    for name in sorted(vars(uoptable)):
        if name.startswith(("F_", "M_", "MU_")) or name in ("NF", "PROBES"):
            lines.append(f"#define {name} ({getattr(uoptable, name)})")
    for name in sorted(vars(machine)):
        if name.startswith("CTR_") or name == "N_CTRS":
            lines.append(f"#define {name} ({getattr(machine, name)})")
    for code in StatusCode:
        lines.append(f"#define ST_{code.name} ({int(code)})")
    return "\n".join(lines) + "\n"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin, "
                      "/usr/local/cuda/bin): the CUDA kernels cannot be "
                      "built here")


def _target(name: str, header: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                       + header.encode() + ARCH.encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{h}.so"


def _write_if_changed(path: Path, text: str) -> None:
    """Replace `path` by `text` atomically, and only if it differs, so a
    concurrent nvcc never reads a half-written header."""
    if path.exists() and path.read_text() == text:
        return
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def build_all(names=KERNELS) -> Dict[str, Path]:
    """Compile every named kernel (one nvcc each, all started together)
    unless its library is already built; returns name -> library path."""
    header = consts_header()
    BUILD.mkdir(parents=True, exist_ok=True)
    _write_if_changed(BUILD / "wtf_consts.h", header)
    out: Dict[str, Path] = {}
    procs: List = []
    for name in names:
        target = _target(name, header)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{BUILD}",
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, cmd, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, target, tmp, cmd, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise KernelError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
