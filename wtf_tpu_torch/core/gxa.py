"""Strong-ish guest address helpers.

The reference wraps guest virtual/physical addresses in strong C++ types
(`Gva_t` / `Gpa_t`, reference src/wtf/gxa.h:10-88) so the two can't be mixed.
In Python we keep them as plain ints at the API boundary, but give them named
aliases + the same Align/Offset helpers so call sites read the same.  Inside
jitted interpreter code addresses are uint64 jax arrays.
"""

from __future__ import annotations

PAGE_SHIFT = 12
PAGE_SIZE = 1 << PAGE_SHIFT  # reference src/wtf/ram.h:10-17 (Page::Size)

# Type aliases for documentation purposes.
Gva = int  # guest virtual address
Gpa = int  # guest physical address


def page_align(addr: int) -> int:
    """Align an address down to its page base (gxa.h Align())."""
    return addr & ~(PAGE_SIZE - 1)


def page_offset(addr: int) -> int:
    """Offset of an address within its page (gxa.h Offset())."""
    return addr & (PAGE_SIZE - 1)


def page_number(addr: int) -> int:
    """Page frame number of an address."""
    return addr >> PAGE_SHIFT


def is_canonical(gva: int) -> bool:
    """True if `gva` is a canonical 48-bit x86-64 virtual address."""
    upper = gva >> 47
    return upper == 0 or upper == (1 << 17) - 1
