"""Deterministic CPUID model shared by the Python oracle and the device
executor.

The reference gets CPUID behavior from its virtualization layer (bochs' model
or the host CPU via KVM/WHV, kvm_backend.cc:436-465 loads the host CPUID into
the VM).  For determinism across backends and chips we pin one synthetic CPU
identity: a generic x86-64 with SSE2/POPCNT and no AVX/XSAVE-dependent
features, so guests stay on code paths the interpreter supports.  Both
executors consult this exact table, keeping differential traces aligned.
"""

from __future__ import annotations

from typing import Dict, Tuple

# (leaf, subleaf) -> (eax, ebx, ecx, edx).  Missing subleaf falls back to
# subleaf 0; missing leaf falls back to highest basic leaf (Intel behavior).
_GENU = 0x756E6547  # "Genu"
_INEI = 0x49656E69  # "ineI"
_NTEL = 0x6C65746E  # "ntel"

# Feature bits, leaf 1 EDX: FPU|TSC|MSR|PAE|CX8|SEP|PGE|CMOV|CLFSH|MMX|FXSR|SSE|SSE2
_L1_EDX = (1 << 0) | (1 << 4) | (1 << 5) | (1 << 6) | (1 << 8) | (1 << 11) \
    | (1 << 13) | (1 << 15) | (1 << 19) | (1 << 23) | (1 << 24) | (1 << 25) \
    | (1 << 26)
# Leaf 1 ECX: POPCNT only.  SSE3/SSSE3/SSE4.x are NOT advertised — their
# instruction sets (movddup, palignr, pcmpistri, ...) are outside the
# implemented subset, so feature-dispatched guests (glibc ifunc etc.) must
# take the SSE2 paths both executors cover.  No OSXSAVE/AVX/RDRAND either
# (RDRAND still executes deterministically if code probes it blindly).
_L1_ECX = 1 << 23

CPUID_TABLE: Dict[Tuple[int, int], Tuple[int, int, int, int]] = {
    (0x0, 0): (0x0000000D, _GENU, _NTEL, _INEI),
    (0x1, 0): (0x000506E3, 0x00100800, _L1_ECX, _L1_EDX),
    (0x2, 0): (0x76036301, 0x00F0B5FF, 0x00000000, 0x00C30000),
    (0x4, 0): (0, 0, 0, 0),
    (0x7, 0): (0, 0, 0, 0),           # no BMI/AVX2 advertised
    (0xB, 0): (0, 0, 0, 0),           # no x2APIC topology
    (0xD, 0): (0, 0, 0, 0),
    (0x80000000, 0): (0x80000008, 0, 0, 0),
    (0x80000001, 0): (0, 0, 0x00000121, 0x2C100800),  # LAHF64|LZCNT|PREFETCHW; NX|PDPE1GB|RDTSCP|LM
    (0x80000002, 0): (0x20555054, 0x2D667477, 0x75706320, 0x00000000),  # "TPU wtf-cpu"
    (0x80000003, 0): (0, 0, 0, 0),
    (0x80000004, 0): (0, 0, 0, 0),
    (0x80000006, 0): (0, 0, 0x01006040, 0),
    (0x80000008, 0): (0x00003030, 0, 0, 0),  # 48-bit phys/virt
}

MAX_BASIC_LEAF = 0xD

# Single definition of the RDRAND-chain / edge-hash mixer lives in
# utils.hashing; re-exported here for executor convenience.
from wtf_tpu_torch.utils.hashing import splitmix64  # noqa: E402,F401


def cpuid(leaf: int, subleaf: int) -> Tuple[int, int, int, int]:
    """Architectural CPUID lookup with out-of-range fallback."""
    leaf &= 0xFFFFFFFF
    if (leaf, subleaf) in CPUID_TABLE:
        return CPUID_TABLE[(leaf, subleaf)]
    if (leaf, 0) in CPUID_TABLE:
        return CPUID_TABLE[(leaf, 0)]
    if leaf < 0x80000000 and leaf > MAX_BASIC_LEAF:
        return CPUID_TABLE[(MAX_BASIC_LEAF, 0)]
    return (0, 0, 0, 0)
