"""Device decode: decode-cache misses serviced on the device.

The counterpart of wtf_tpu/interp/devdec.py (ROADMAP A11).  Inside a
megachunk window (fuzz/megachunk.py) a lane that stops NEED_DECODE
fetches and decodes its own bytes on the device — the 15-byte window
through `paging.virt_read` (the overlay-aware walk the host's
`HostView.virt_read` mirrors), a LUT-driven prefix/REX scan, ModRM/SIB/
disp/imm extraction, length decode and uop synthesis — and publishes the
result into the uop table the step engines read, so the window keeps
running.  Only encodings outside the device subset park the lane for the
host service; the host decoder stays the oracle that re-decodes and
cross-checks every device-published entry at harvest
(`DecodeCache.adopt_device_entries`).

A service round has two phases, as in the JAX package:

  phase 1 (`compute_blocks`, lane-parallel): every NEED_DECODE lane whose
    miss is not in the round-start table fetches and decodes its miss and
    runs the LIFO prefetch walk of `runner._prefetch_block` against the
    round-start table plus its own records (up to RECS publish records);
  phase 2 (`commit_blocks`, sequential in lane order): the blocks replay
    the host service's publish order against the live table — the
    `cache.has` gate at the miss (resume), the fetch fault (PAGE_FAULT),
    key dedup against earlier lanes' records, the capacity margin, the
    first free probe slot of `DecodeCache._hash_insert` — and any lane
    whose walk could have diverged from the host's strictly sequential
    service parks, with every needy lane after it, so entry indices (and
    so coverage bits) are those of a host-serviced run.

The JAX package runs both phases inside one compiled program.  Eagerly,
phase 1 is tensor code over all lanes whose walk stops as soon as no lane
is still walking (one host read per `_WALK_CHECK` iterations), and phase
2's control — which lane commits, which slot each record claims — is a
replay of integers on the host from one read of the needy lanes' keys
and the round-start hash rows; the decoded rows themselves stay on the
device and land in a copy of the table in one scatter.  The result is
the JAX commit's, bit for bit (tests/test_torch_devdec.py).

The documented divergence of the JAX package is kept: a lane's walk sees
the round-start table plus its own records, so when two lanes' prefetch
regions overlap at differing miss rips the walk shape may differ from the
host's; the commit then parks (never publishes a different table).  On a
lane mesh (fuzz/megachunk.py's mesh window) `compute_blocks` runs on each
shard's machine and `commit_blocks` once, on every shard's blocks and
statuses gathered in global lane order; its per-lane outputs are cut per
shard and its table copied to each distinct device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.cpu.uops import INT_FIELDS
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.interp.uoptable import (
    MU_IMM, PROBES, UopTable, uop_lookup,
)
from wtf_tpu_torch.mem import paging
from wtf_tpu_torch.mem.physmem import MemImage
from wtf_tpu_torch.utils.hashing import splitmix64

NF = len(INT_FIELDS)
_IX = {name: i for i, name in enumerate(INT_FIELDS)}
MAX_LEN = 15          # cpu.decoder.MAX_INSN_LEN
PREFETCH_BUDGET = 48  # runner.PREFETCH_BUDGET
MARGIN = 64           # runner._PREFETCH_MARGIN
RECS = 50             # 1 miss + PREFETCH_BUDGET prefetched + slack
STACK = 64            # LIFO worklist depth bound (net +1 per publish)
WALK_ITERS = 112      # >= initial(2) + 2*budget pops + skipped pops slack
_WALK_CHECK = 4       # walk iterations between two "still walking?" reads

# ---------------------------------------------------------------------------
# Descriptor LUT: [2 maps, 256 opcodes, 8 modrm digits, N_COL] int32, built
# once at import (numpy) and uploaded once per device.  One row fully
# describes an opcode's decode rule; rows without a ModRM byte are
# replicated across the 8 digit slots.  Copied from the JAX package.
# ---------------------------------------------------------------------------
(C_KIND, C_OPC, C_SUB, C_COND, C_MODRM, C_FORM, C_SIZE8, C_RM8, C_OSZ,
 C_IMM, C_KIMM, C_SRCSIZE, C_SEXT, C_REP, C_SPECIAL) = range(15)
N_COL = 15

# C_KIND
K_UNKNOWN, K_KNOWN = 0, 1
# C_FORM (operand wiring)
(F_NONE, F_RM_REG, F_REG_RM, F_RM_DST, F_RM_SRC, F_OPREG_SRC, F_OPREG_DST,
 F_OPREG_DST8, F_ACC, F_LEA, F_XCHG_ACC, F_RM_CL) = range(12)
# C_OSZ (operation size rule; C_SIZE8 overrides to 1)
OSZ_STD, OSZ_PP, OSZ_8, OSZ_W84 = range(4)
# C_IMM (immediate rule)
(IMM_NONE, IMM_8SX, IMM_8ZX, IMM_16ZX, IMM_STD, IMM_32SX, IMM_MOVABS,
 IMM_ONE) = range(8)
# C_SPECIAL
(SP_NONE, SP_VEX, SP_E3, SP_CD, SP_C8, SP_AE, SP_C7RD, SP_BSCAN,
 SP_POPCNT) = range(9)


def _build_lut() -> np.ndarray:
    lut = np.zeros((2, 256, 8, N_COL), dtype=np.int32)
    # default: everything UNKNOWN (parks to host) until a rule claims it
    lut[:, :, :, C_KIND] = K_UNKNOWN

    def row(m, op, digit=None, kind=K_KNOWN, opc=U.OPC_INVALID, sub=0,
            cond=0, modrm=0, form=F_NONE, size8=0, rm8=0, osz=OSZ_STD,
            imm=IMM_NONE, kimm=0, srcsize=0, sext=0, rep=0, special=SP_NONE):
        r = np.array([kind, opc, sub, cond, modrm, form, size8, rm8, osz,
                      imm, kimm, srcsize, sext, rep, special],
                     dtype=np.int32)
        digits = range(8) if digit is None else [digit]
        for d in digits:
            lut[m, op, d] = r

    def invalid(m, op, digit=None, modrm=0):
        # host `_decode_primary`/`_decode_0f` fall-through: OPC_INVALID
        # keeping a32/lock and the bytes consumed so far
        row(m, op, digit=digit, opc=U.OPC_INVALID, modrm=modrm)

    # ---- primary map ------------------------------------------------------
    # every primary opcode host-decodes deterministically; rows not claimed
    # below are the decoder's unmatched `else` -> INVALID after the opcode
    for op in range(256):
        invalid(0, op)

    # 00-3D ALU block: op>>3 = sub, op&7 = form (skip the x6/x7/xE/xF gaps)
    for hi in range(8):
        base = hi << 3
        for lo, (f, s8, im) in enumerate((
                (F_RM_REG, 1, IMM_NONE), (F_RM_REG, 0, IMM_NONE),
                (F_REG_RM, 1, IMM_NONE), (F_REG_RM, 0, IMM_NONE),
                (F_ACC, 1, IMM_8SX), (F_ACC, 0, IMM_STD))):
            row(0, base + lo, opc=U.OPC_ALU, sub=hi, modrm=(lo < 4),
                form=f, size8=s8, imm=im, kimm=(im != IMM_NONE))
    for op in range(0x50, 0x58):  # push r
        row(0, op, opc=U.OPC_PUSH, form=F_OPREG_SRC, osz=OSZ_PP)
    for op in range(0x58, 0x60):  # pop r
        row(0, op, opc=U.OPC_POP, form=F_OPREG_DST, osz=OSZ_PP)
    row(0, 0x63, opc=U.OPC_MOV, modrm=1, form=F_REG_RM, srcsize=4, sext=1)
    row(0, 0x68, opc=U.OPC_PUSH, osz=OSZ_8, imm=IMM_32SX, kimm=1)
    row(0, 0x69, opc=U.OPC_MUL, sub=U.MUL_2OP, modrm=1, form=F_REG_RM,
        imm=IMM_STD, sext=2)
    row(0, 0x6A, opc=U.OPC_PUSH, osz=OSZ_8, imm=IMM_8SX, kimm=1)
    row(0, 0x6B, opc=U.OPC_MUL, sub=U.MUL_2OP, modrm=1, form=F_REG_RM,
        imm=IMM_8SX, sext=2)
    for op in range(0x70, 0x80):  # jcc rel8
        row(0, op, opc=U.OPC_JCC, cond=op & 0xF, osz=OSZ_8, imm=IMM_8SX)
    for d in range(8):  # group 1
        row(0, 0x80, digit=d, opc=U.OPC_ALU, sub=d, modrm=1, form=F_RM_DST,
            size8=1, imm=IMM_8SX, kimm=1)
        row(0, 0x81, digit=d, opc=U.OPC_ALU, sub=d, modrm=1, form=F_RM_DST,
            imm=IMM_STD, kimm=1)
        row(0, 0x83, digit=d, opc=U.OPC_ALU, sub=d, modrm=1, form=F_RM_DST,
            imm=IMM_8SX, kimm=1)
    row(0, 0x84, opc=U.OPC_ALU, sub=U.ALU_TEST, modrm=1, form=F_RM_REG,
        size8=1)
    row(0, 0x85, opc=U.OPC_ALU, sub=U.ALU_TEST, modrm=1, form=F_RM_REG)
    row(0, 0x86, opc=U.OPC_XCHG, modrm=1, form=F_RM_REG, size8=1)
    row(0, 0x87, opc=U.OPC_XCHG, modrm=1, form=F_RM_REG)
    row(0, 0x88, opc=U.OPC_MOV, modrm=1, form=F_RM_REG, size8=1)
    row(0, 0x89, opc=U.OPC_MOV, modrm=1, form=F_RM_REG)
    row(0, 0x8A, opc=U.OPC_MOV, modrm=1, form=F_REG_RM, size8=1)
    row(0, 0x8B, opc=U.OPC_MOV, modrm=1, form=F_REG_RM)
    row(0, 0x8D, opc=U.OPC_LEA, modrm=1, form=F_LEA)
    row(0, 0x8F, opc=U.OPC_POP, modrm=1, form=F_RM_DST, osz=OSZ_PP)
    row(0, 0x90, opc=U.OPC_NOP, osz=OSZ_8)
    for op in range(0x91, 0x98):
        row(0, op, opc=U.OPC_XCHG, form=F_XCHG_ACC)
    row(0, 0x98, opc=U.OPC_CONVERT, sub=0)
    row(0, 0x99, opc=U.OPC_CONVERT, sub=1)
    row(0, 0x9B, opc=U.OPC_NOP, osz=OSZ_8)  # fwait
    row(0, 0x9C, opc=U.OPC_PUSHF, osz=OSZ_8)
    row(0, 0x9D, opc=U.OPC_POPF, osz=OSZ_8)
    row(0, 0x9E, opc=U.OPC_FLAGOP, sub=U.FL_SAHF, osz=OSZ_8)
    row(0, 0x9F, opc=U.OPC_FLAGOP, sub=U.FL_LAHF, osz=OSZ_8)
    for op, sub in ((0xA4, U.STR_MOVS), (0xA6, U.STR_CMPS),
                    (0xAA, U.STR_STOS), (0xAC, U.STR_LODS),
                    (0xAE, U.STR_SCAS)):
        row(0, op, opc=U.OPC_STRING, sub=sub, size8=1, rep=1)
        row(0, op + 1, opc=U.OPC_STRING, sub=sub, rep=1)
    row(0, 0xA8, opc=U.OPC_ALU, sub=U.ALU_TEST, form=F_ACC, size8=1,
        imm=IMM_8SX, kimm=1)
    row(0, 0xA9, opc=U.OPC_ALU, sub=U.ALU_TEST, form=F_ACC, imm=IMM_STD,
        kimm=1)
    for op in range(0xB0, 0xB8):  # mov r8, imm8 (unsigned)
        row(0, op, opc=U.OPC_MOV, form=F_OPREG_DST8, size8=1, imm=IMM_8ZX,
            kimm=1)
    for op in range(0xB8, 0xC0):  # mov r, imm (movabs family, unsigned)
        row(0, op, opc=U.OPC_MOV, form=F_OPREG_DST, imm=IMM_MOVABS, kimm=1)
    for d in range(8):  # group 2
        row(0, 0xC0, digit=d, opc=U.OPC_SHIFT, sub=d, modrm=1,
            form=F_RM_DST, size8=1, imm=IMM_8ZX, kimm=1)
        row(0, 0xC1, digit=d, opc=U.OPC_SHIFT, sub=d, modrm=1,
            form=F_RM_DST, imm=IMM_8ZX, kimm=1)
        row(0, 0xD0, digit=d, opc=U.OPC_SHIFT, sub=d, modrm=1,
            form=F_RM_DST, size8=1, imm=IMM_ONE, kimm=1)
        row(0, 0xD1, digit=d, opc=U.OPC_SHIFT, sub=d, modrm=1,
            form=F_RM_DST, imm=IMM_ONE, kimm=1)
        row(0, 0xD2, digit=d, opc=U.OPC_SHIFT, sub=d, modrm=1,
            form=F_RM_CL, size8=1, srcsize=1)
        row(0, 0xD3, digit=d, opc=U.OPC_SHIFT, sub=d, modrm=1,
            form=F_RM_CL, srcsize=1)
    row(0, 0xC2, opc=U.OPC_RET, osz=OSZ_8, imm=IMM_16ZX)
    row(0, 0xC3, opc=U.OPC_RET, osz=OSZ_8)
    row(0, 0xC6, digit=0, opc=U.OPC_MOV, modrm=1, form=F_RM_DST, size8=1,
        imm=IMM_8ZX, kimm=1)
    for d in range(1, 8):
        invalid(0, 0xC6, digit=d, modrm=1)
    row(0, 0xC7, digit=0, opc=U.OPC_MOV, modrm=1, form=F_RM_DST,
        imm=IMM_STD, kimm=1)
    for d in range(1, 8):
        invalid(0, 0xC7, digit=d, modrm=1)
    row(0, 0xC8, kind=K_UNKNOWN)  # enter: rare; host-serviced
    row(0, 0xC9, opc=U.OPC_LEAVE, osz=OSZ_8)
    row(0, 0xCA, opc=U.OPC_IRET, sub=1, osz=OSZ_8, imm=IMM_16ZX)
    row(0, 0xCB, opc=U.OPC_IRET, sub=1, osz=OSZ_8)
    row(0, 0xCC, opc=U.OPC_INT, sub=3, osz=OSZ_8)
    row(0, 0xCD, opc=U.OPC_INT, osz=OSZ_8, special=SP_CD)
    row(0, 0xCF, opc=U.OPC_IRET, osz=OSZ_W84)
    for op in range(0xD8, 0xE0):  # x87 -> host
        row(0, op, kind=K_UNKNOWN)
    row(0, 0xE3, opc=U.OPC_JCC, osz=OSZ_8, imm=IMM_8SX, special=SP_E3)
    row(0, 0xE8, opc=U.OPC_CALL, osz=OSZ_8, imm=IMM_32SX, kimm=1)
    row(0, 0xE9, opc=U.OPC_JMP, osz=OSZ_8, imm=IMM_32SX, kimm=1)
    row(0, 0xEB, opc=U.OPC_JMP, osz=OSZ_8, imm=IMM_8SX, kimm=1)
    # 0xF1 (icebp): the oracle decoder leaves it unmatched -> INVALID
    row(0, 0xF4, opc=U.OPC_HLT, osz=OSZ_8)
    row(0, 0xF5, opc=U.OPC_FLAGOP, sub=U.FL_CMC, osz=OSZ_8)
    for op, sub in ((0xF8, U.FL_CLC), (0xF9, U.FL_STC), (0xFA, U.FL_CLI),
                    (0xFB, U.FL_STI), (0xFC, U.FL_CLD), (0xFD, U.FL_STD)):
        row(0, op, opc=U.OPC_FLAGOP, sub=sub, osz=OSZ_8)
    for op, s8, im in ((0xF6, 1, IMM_8SX), (0xF7, 0, IMM_STD)):  # group 3
        for d in (0, 1):
            row(0, op, digit=d, opc=U.OPC_ALU, sub=U.ALU_TEST, modrm=1,
                form=F_RM_DST, size8=s8, imm=im, kimm=1)
        row(0, op, digit=2, opc=U.OPC_UNARY, sub=U.UN_NOT, modrm=1,
            form=F_RM_DST, size8=s8)
        row(0, op, digit=3, opc=U.OPC_UNARY, sub=U.UN_NEG, modrm=1,
            form=F_RM_DST, size8=s8)
        row(0, op, digit=4, opc=U.OPC_MUL, sub=U.MUL_WIDE_U, modrm=1,
            form=F_RM_SRC, size8=s8)
        row(0, op, digit=5, opc=U.OPC_MUL, sub=U.MUL_WIDE_S, modrm=1,
            form=F_RM_SRC, size8=s8)
        row(0, op, digit=6, opc=U.OPC_DIV, sub=U.DIV_U, modrm=1,
            form=F_RM_SRC, size8=s8)
        row(0, op, digit=7, opc=U.OPC_DIV, sub=U.DIV_S, modrm=1,
            form=F_RM_SRC, size8=s8)
    row(0, 0xFE, digit=0, opc=U.OPC_UNARY, sub=U.UN_INC, modrm=1,
        form=F_RM_DST, size8=1)
    row(0, 0xFE, digit=1, opc=U.OPC_UNARY, sub=U.UN_DEC, modrm=1,
        form=F_RM_DST, size8=1)
    for d in range(2, 8):
        invalid(0, 0xFE, digit=d, modrm=1)
    row(0, 0xFF, digit=0, opc=U.OPC_UNARY, sub=U.UN_INC, modrm=1,
        form=F_RM_DST)
    row(0, 0xFF, digit=1, opc=U.OPC_UNARY, sub=U.UN_DEC, modrm=1,
        form=F_RM_DST)
    row(0, 0xFF, digit=2, opc=U.OPC_CALL, modrm=1, form=F_RM_SRC, osz=OSZ_8)
    row(0, 0xFF, digit=4, opc=U.OPC_JMP, modrm=1, form=F_RM_SRC, osz=OSZ_8)
    row(0, 0xFF, digit=6, opc=U.OPC_PUSH, modrm=1, form=F_RM_SRC,
        osz=OSZ_PP)
    for d in (3, 5, 7):
        invalid(0, 0xFF, digit=d, modrm=1)
    # C4/C5: VEX when no legacy/REX prefix (device -> host), else the
    # primary map's unmatched INVALID
    row(0, 0xC4, special=SP_VEX)
    row(0, 0xC5, special=SP_VEX)
    # moffs forms + far/IO/loop encodings the transcription does not pin:
    # park rather than guess (host decode is cheap and authoritative)
    for op in (0xA0, 0xA1, 0xA2, 0xA3, 0xE0, 0xE1, 0xE2):
        row(0, op, kind=K_UNKNOWN)

    # ---- 0F map -----------------------------------------------------------
    # default UNKNOWN (the `_decode_0f_sse` fall-through and everything not
    # explicitly matched parks to the host) — NOT invalid: the host decodes
    # SSE/x87 forms this subset does not model
    row(1, 0x05, opc=U.OPC_SYSCALL, osz=OSZ_8)
    row(1, 0x07, opc=U.OPC_SYSCALL, sub=1, osz=OSZ_8)
    row(1, 0x0B, opc=U.OPC_INT, sub=6, osz=OSZ_8)
    row(1, 0x0D, opc=U.OPC_NOP, modrm=1, osz=OSZ_8)  # prefetchw
    for op in range(0x18, 0x20):          # hint nops: ModRM consumed
        row(1, op, opc=U.OPC_NOP, modrm=1, osz=OSZ_8)
    row(1, 0x30, opc=U.OPC_MSR, sub=1, osz=OSZ_8)
    row(1, 0x31, opc=U.OPC_RDTSC, osz=OSZ_8)
    row(1, 0x32, opc=U.OPC_MSR, sub=0, osz=OSZ_8)
    for op in range(0x40, 0x50):
        row(1, op, opc=U.OPC_CMOVCC, cond=op & 0xF, modrm=1, form=F_REG_RM)
    for op in range(0x80, 0x90):
        row(1, op, opc=U.OPC_JCC, cond=op & 0xF, osz=OSZ_8, imm=IMM_32SX)
    for op in range(0x90, 0xA0):
        row(1, op, opc=U.OPC_SETCC, cond=op & 0xF, modrm=1, form=F_RM_DST,
            size8=1)
    row(1, 0xA2, opc=U.OPC_CPUID, osz=OSZ_8)
    for op, sub in ((0xA3, U.BT_BT), (0xAB, U.BT_BTS), (0xB3, U.BT_BTR),
                    (0xBB, U.BT_BTC)):
        row(1, op, opc=U.OPC_BT, sub=sub, modrm=1, form=F_RM_REG)
    for op, sub in ((0xA4, U.SH_SHLD), (0xAC, U.SH_SHRD)):
        row(1, op, opc=U.OPC_SHIFT, sub=sub, modrm=1, form=F_RM_REG,
            imm=IMM_8ZX, sext=3)
        row(1, op + 1, opc=U.OPC_SHIFT, sub=sub, modrm=1, form=F_RM_REG,
            sext=4)
    row(1, 0xAF, opc=U.OPC_MUL, sub=U.MUL_2OP, modrm=1, form=F_REG_RM)
    row(1, 0xB0, opc=U.OPC_CMPXCHG, modrm=1, form=F_RM_REG, size8=1)
    row(1, 0xB1, opc=U.OPC_CMPXCHG, modrm=1, form=F_RM_REG)
    row(1, 0xB6, opc=U.OPC_MOV, modrm=1, form=F_REG_RM, rm8=1, srcsize=1)
    row(1, 0xB7, opc=U.OPC_MOV, modrm=1, form=F_REG_RM, srcsize=2)
    row(1, 0xBE, opc=U.OPC_MOV, modrm=1, form=F_REG_RM, rm8=1, srcsize=1,
        sext=1)
    row(1, 0xBF, opc=U.OPC_MOV, modrm=1, form=F_REG_RM, srcsize=2, sext=1)
    row(1, 0xB8, opc=U.OPC_BITSCAN, sub=U.BS_POPCNT, modrm=1,
        form=F_REG_RM, special=SP_POPCNT)
    for d in range(4):
        invalid(1, 0xBA, digit=d, modrm=1)
    for d in range(4, 8):
        row(1, 0xBA, digit=d, opc=U.OPC_BT, sub=d - 4, modrm=1,
            form=F_RM_DST, imm=IMM_8ZX, kimm=1)
    row(1, 0xBC, opc=U.OPC_BITSCAN, sub=U.BS_BSF, modrm=1, form=F_REG_RM,
        special=SP_BSCAN)
    row(1, 0xBD, opc=U.OPC_BITSCAN, sub=U.BS_BSR, modrm=1, form=F_REG_RM,
        special=SP_BSCAN)
    row(1, 0xC0, opc=U.OPC_XADD, modrm=1, form=F_RM_REG, size8=1)
    row(1, 0xC1, opc=U.OPC_XADD, modrm=1, form=F_RM_REG)
    for op in range(0xC8, 0xD0):
        row(1, op, opc=U.OPC_BSWAP, form=F_OPREG_DST, osz=OSZ_W84)
    return lut


_LUT = _build_lut()
_TERMINAL = (U.OPC_RET, U.OPC_IRET, U.OPC_HLT, U.OPC_INT, U.OPC_INT1,
             U.OPC_INVALID, U.OPC_SYSCALL)


@functools.lru_cache(maxsize=None)
def _consts_on(device: str) -> Tuple[torch.Tensor, ...]:
    trunc = [0] * NF
    for name, value in (("opc", U.OPC_INVALID), ("length", 1), ("opsize", 8),
                        ("base_reg", U.REG_NONE), ("idx_reg", U.REG_NONE),
                        ("scale", 1)):
        trunc[_IX[name]] = value
    return tuple(torch.tensor(a, dtype=torch.int64).to(device)
                 for a in (_LUT.reshape(2 * 256 * 8, N_COL), trunc,
                           _TERMINAL))


def _consts(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(LUT int64[2 * 256 * 8, N_COL], the truncated-INVALID field row,
    the walk's terminal opcodes) on `device`, uploaded once per device."""
    return _consts_on(str(device))


# ---------------------------------------------------------------------------
# Batched decode of [N, 15] byte windows -> uop records
# ---------------------------------------------------------------------------


class DecUop(NamedTuple):
    known: torch.Tensor  # bool[N]: within the device subset (False -> park)
    f: torch.Tensor      # int32[N, NF] in uops.INT_FIELDS order
    disp: torch.Tensor   # int64[N] (u64 bits, sign-extended)
    imm: torch.Tensor    # int64[N] (u64 bits)


def _sel(c: torch.Tensor, a, b) -> torch.Tensor:
    """torch.where over int64 values where either side may be an int."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        a = torch.full(c.shape, a, dtype=torch.int64, device=c.device)
    return torch.where(c, a, b)


def _rd(win: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Clamped byte read win[n, i[n]]: out-of-window indices only occur on
    encodings whose consumed length exceeds the window, which decode as
    the host's _Truncated all-default INVALID, so the clamped value is
    never used."""
    return torch.gather(win, 1, i.clamp(0, MAX_LEN - 1)[:, None])[:, 0]


def _sx_u64(v: torch.Tensor, bits: int) -> torch.Tensor:
    sign = 1 << (bits - 1)
    return (v ^ sign) - sign  # two's-complement wrap == the host _sx mask


def _read_le_u64(win: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    k = torch.arange(8, device=win.device)
    b = torch.gather(win, 1, (i[:, None] + k).clamp(0, MAX_LEN - 1))
    return (b << (8 * k)).sum(1)


def decode_window(win: torch.Tensor) -> DecUop:
    """Decode the instruction at the start of each window (uint8[N, 15]).
    Replicates cpu.decoder.decode bit for bit over the device subset;
    anything the LUT marks UNKNOWN returns known=False for a host park.
    The counterpart of the JAX `decode_window` (one window, vmapped)."""
    w = win.long()
    dev = w.device
    n_rows = w.shape[0]
    idx15 = torch.arange(MAX_LEN, device=dev)

    # prefix scan (cpu.decoder._decode_prefixes): legacy prefixes in any
    # order and count, then at most one REX right before the opcode.  The
    # JAX scan takes bytes while they are legacy prefixes: here every
    # byte is classified at once and the run ends at the first other one.
    is66, is67 = w == 0x66, w == 0x67
    isf0, isf2, isf3 = w == 0xF0, w == 0xF2, w == 0xF3
    is64, is65 = w == 0x64, w == 0x65
    isnull = (w == 0x26) | (w == 0x2E) | (w == 0x36) | (w == 0x3E)
    legacy = is66 | is67 | isf0 | isf2 | isf3 | is64 | is65 | isnull
    other = ~legacy
    pos = _sel(other.any(1), other.to(torch.uint8).argmax(1), MAX_LEN)
    take = idx15[None, :] < pos[:, None]
    osize = (take & is66).any(1)
    asize = (take & is67).any(1)
    lock = (take & isf0).any(1)
    repne = (take & isf2).any(1)
    rep = (take & isf3).any(1)
    anyleg = (take & (is66 | isf0 | isf2 | isf3)).any(1)
    # the last segment prefix taken wins
    segpos = _sel(take & (is64 | is65), idx15[None, :].expand(n_rows, -1),
                  -1).max(1).values
    seg = _sel(segpos < 0, U.SEG_NONE,
               _sel(_rd(w, segpos) == 0x64, U.SEG_FS, U.SEG_GS))

    b = _rd(w, pos)
    isrex = (b >= 0x40) & (b <= 0x4F)
    rex = _sel(isrex, b & 0xF, 0)
    pos = pos + isrex.long()
    rex_w, rex_r = (rex >> 3) & 1, (rex >> 2) & 1
    rex_x, rex_b = (rex >> 1) & 1, rex & 1

    op = _rd(w, pos)
    pos = pos + 1
    map1 = op == 0x0F
    op2 = _rd(w, pos)
    pos = pos + map1.long()              # position after the opcode
    opv = _sel(map1, op2, op)

    lut, trunc_row, _ = _consts(dev)
    row = lut[(map1.long() * 256 + opv) * 8
                    + ((_rd(w, pos) >> 3) & 7)]
    known = row[:, C_KIND] == K_KNOWN
    special = row[:, C_SPECIAL]
    has_modrm = (row[:, C_MODRM] > 0) & known

    # speculative ModRM/SIB/disp parse (cpu.decoder._ModRM)
    modrm = _rd(w, pos)
    mod = modrm >> 6
    regf = ((modrm >> 3) & 7) | (rex_r << 3)
    rm = modrm & 7
    is_mem = mod != 3
    rm_reg = rm | (rex_b << 3)
    sib = _rd(w, pos + 1)
    sib_present = has_modrm & is_mem & (rm == 4)
    sidx = ((sib >> 3) & 7) | (rex_x << 3)
    sbase = (sib & 7) | (rex_b << 3)
    rip_rel = has_modrm & is_mem & (rm == 5) & (mod == 0)
    sib_disp32 = sib_present & ((sbase & 7) == 5) & (mod == 0)
    disp8 = has_modrm & is_mem & (mod == 1)
    disp32 = (has_modrm & is_mem & (mod == 2)) | rip_rel | sib_disp32
    disp_off = pos + 1 + sib_present.long()
    disp_len = _sel(disp8, 1, _sel(disp32, 4, 0))
    modrm_len = _sel(has_modrm, 1 + sib_present.long() + disp_len, 0)
    draw = _read_le_u64(w, disp_off)
    disp = _sel(disp8, _sx_u64(draw & 0xFF, 8),
                _sel(disp32, _sx_u64(draw & 0xFFFFFFFF, 32), 0))
    base_reg = _sel(
        rip_rel, U.REG_RIP,
        _sel(sib_present, _sel(sib_disp32, U.REG_NONE, sbase),
             _sel(is_mem, rm_reg, U.REG_NONE)))
    base_reg = _sel(has_modrm & is_mem, base_reg, U.REG_NONE)
    idx_reg = _sel(sib_present & (sidx != 4), sidx, U.REG_NONE)
    scale = _sel(sib_present, 1 << (sib >> 6), 1)

    # operation size
    size8 = row[:, C_SIZE8] > 0
    osz = row[:, C_OSZ]
    opsize = _sel(
        size8, 1,
        _sel(osz == OSZ_PP, _sel(osize, 2, 8),
             _sel(osz == OSZ_8, 8,
                  _sel(osz == OSZ_W84, _sel(rex_w > 0, 8, 4),
                       _sel(rex_w > 0, 8, _sel(osize, 2, 4))))))

    # immediate
    immc = row[:, C_IMM]
    imm_len = _sel(
        (immc == IMM_8SX) | (immc == IMM_8ZX), 1,
        _sel(immc == IMM_16ZX, 2,
             _sel(immc == IMM_STD, _sel(opsize == 2, 2, 4),
                  _sel(immc == IMM_32SX, 4,
                       _sel(immc == IMM_MOVABS,
                            _sel(opsize == 8, 8, _sel(opsize == 2, 2, 4)),
                            0)))))
    ipos = pos + modrm_len
    masked = _read_le_u64(w, ipos) & I.size_mask(imm_len)
    imm = _sel(
        immc == IMM_8SX, _sx_u64(masked, 8),
        _sel(immc == IMM_STD,
             _sel(opsize == 2, _sx_u64(masked, 16), _sx_u64(masked, 32)),
             _sel(immc == IMM_32SX, _sx_u64(masked, 32),
                  _sel(immc == IMM_ONE, 1, masked))))
    length = ipos + imm_len + (special == SP_CD).long()

    # specials
    sub = row[:, C_SUB]
    cond = row[:, C_COND]
    kind_unknown = ~known
    sub = _sel(special == SP_CD, _rd(w, ipos), sub)
    cond = _sel(special == SP_E3, _sel(asize, 17, 16), cond)
    bs = (special == SP_BSCAN) & rep
    sub = _sel(bs & (sub == U.BS_BSF), U.BS_TZCNT,
               _sel(bs & (sub == U.BS_BSR), U.BS_LZCNT, sub))
    kind_unknown = kind_unknown | ((special == SP_POPCNT) & ~rep)
    # C4/C5: VEX (-> host) unless a legacy/REX prefix #UDs it into the
    # primary map's unmatched INVALID
    vex = special == SP_VEX
    vex_invalid = vex & (anyleg | isrex)
    kind_unknown = kind_unknown | (vex & ~vex_invalid)

    # operand synthesis
    def g8(r):
        return _sel((rex == 0) & (r >= 4) & (r <= 7),
                    U.REG_AH_BASE + (r - 4), r)

    form = row[:, C_FORM]
    opreg = (opv & 7) | (rex_b << 3)
    rm_is_dst = ((form == F_RM_REG) | (form == F_RM_DST)
                 | (form == F_RM_CL))
    rm_is_src = (form == F_REG_RM) | (form == F_RM_SRC)
    rm_used = rm_is_dst | rm_is_src
    rm8 = size8 | (row[:, C_RM8] > 0)
    rm_regv = _sel(rm8, g8(rm_reg), rm_reg)
    reg_regv = _sel(size8, g8(regf), regf)
    mem_side = rm_used & is_mem

    dst_kind = _sel(
        rm_is_dst, _sel(is_mem, U.K_MEM, U.K_REG),
        _sel((form == F_REG_RM) | (form == F_LEA) | (form == F_OPREG_DST)
             | (form == F_OPREG_DST8) | (form == F_XCHG_ACC)
             | (form == F_ACC), U.K_REG, U.K_NONE))
    dst_reg = _sel(
        rm_is_dst & ~is_mem, rm_regv,
        _sel(form == F_REG_RM, reg_regv,
             _sel(form == F_LEA, regf,
                  _sel(form == F_OPREG_DST, opreg,
                       _sel(form == F_OPREG_DST8, g8(opreg),
                            _sel(form == F_XCHG_ACC, opreg, 0))))))
    dst_reg = _sel(dst_kind == U.K_REG, dst_reg, 0)
    src_kind = _sel(
        rm_is_src, _sel(is_mem, U.K_MEM, U.K_REG),
        _sel((form == F_RM_REG) | (form == F_OPREG_SRC)
             | (form == F_XCHG_ACC) | (form == F_RM_CL), U.K_REG, U.K_NONE))
    src_reg = _sel(
        rm_is_src & ~is_mem, rm_regv,
        _sel(form == F_RM_REG, reg_regv,
             _sel(form == F_OPREG_SRC, opreg, _sel(form == F_RM_CL, 1, 0))))
    src_reg = _sel(src_kind == U.K_REG, src_reg, 0)
    src_kind = _sel(row[:, C_KIMM] > 0, U.K_IMM, src_kind)

    lea_mem = (form == F_LEA) & is_mem
    use_mem = mem_side | lea_mem
    segv = _sel(mem_side, seg, U.SEG_NONE)  # lea ignores seg
    base_reg = _sel(use_mem, base_reg, U.REG_NONE)
    idx_reg = _sel(use_mem, idx_reg, U.REG_NONE)
    scale = _sel(use_mem, scale, 1)
    disp = _sel(use_mem, disp, 0)

    repv = _sel(row[:, C_REP] > 0,
                _sel(rep, U.REP_REP, _sel(repne, U.REP_REPNE, U.REP_NONE)),
                U.REP_NONE)

    opc = row[:, C_OPC]
    # lea reg-form: INVALID after the (consumed) ModRM
    lea_invalid = (form == F_LEA) & ~is_mem
    invalid = (opc == U.OPC_INVALID) | lea_invalid | vex_invalid

    def inv(val, default):
        return _sel(invalid, default, val)

    opc = _sel(invalid, U.OPC_INVALID, opc)
    length = _sel(vex_invalid, pos, length)
    # lea reg-form: the host sets opsize before bailing to INVALID
    opsize_out = _sel(invalid & ~lea_invalid, 8, opsize)
    fields = [
        opc, inv(sub, 0), inv(cond, 0), length, opsize_out,
        inv(row[:, C_SRCSIZE], 0), inv(row[:, C_SEXT], 0),
        inv(dst_kind, U.K_NONE), inv(dst_reg, 0),
        inv(src_kind, U.K_NONE), inv(src_reg, 0),
        inv(base_reg, U.REG_NONE), inv(idx_reg, U.REG_NONE),
        inv(scale, 1), inv(segv, U.SEG_NONE), inv(repv, U.REP_NONE),
        lock.long(), asize.long()]
    disp = inv(disp, 0)
    imm = inv(imm, 0)

    # truncation: the host raises _Truncated at the first needed byte past
    # the window and returns the ALL-default INVALID (a32/lock included)
    f = torch.stack(fields, 1)
    trunc = length > MAX_LEN
    f = torch.where(trunc[:, None], trunc_row, f)
    disp = _sel(trunc, 0, disp)
    imm = _sel(trunc, 0, imm)
    return DecUop(known=~kind_unknown, f=f.to(torch.int32), disp=disp,
                  imm=imm)


# ---------------------------------------------------------------------------
# Phase 1: per-lane blocks (lane-parallel)
# ---------------------------------------------------------------------------

_STATUS_NEED_DECODE = 8   # StatusCode.NEED_DECODE (core/results.py)
_STATUS_RUNNING = 0       # StatusCode.RUNNING
_STATUS_PAGE_FAULT = 7    # StatusCode.PAGE_FAULT

_N_META = NF + 3          # uoptable meta_i32 columns (fields, pfn0, pfn1, bp)
_F_OPC, _F_LENGTH = _IX["opc"], _IX["length"]
_F_SRC_KIND = _IX["src_kind"]


def _key_of(rip: torch.Tensor, tenant: torch.Tensor) -> torch.Tensor:
    """The probe key of (tenant, rip): uoptable.tag_key on tensors.  The
    port runs single-image batches (tenant 0), but the tag stays in the
    key as in the JAX package."""
    return rip ^ (tenant.long() << 48)


class LaneBlock(NamedTuple):
    """Each lane's phase-1 result: its miss outcome plus publish records
    (record 0 = the miss; the rest the prefetch walk, in walk order).
    Only needy lanes' blocks mean anything: the commit gates on `needy`,
    and a lane whose miss is already in the round-start table resumes
    without its records, so its walk is not run."""

    needy: torch.Tensor   # bool[L]: lane was NEED_DECODE
    fault: torch.Tensor   # bool[L]: the 15-byte fetch at the miss faulted
    parked: torch.Tensor  # bool[L]: miss or walk left the device subset
    rip: torch.Tensor     # int64[L] miss rip (fault_gva on the fault path)
    n: torch.Tensor       # int64[L] record count (0 on fault/park-at-miss)
    keys: torch.Tensor    # int64[L, RECS] tagged probe keys
    fi: torch.Tensor      # int32[L, RECS, NF+3] uoptable meta_i32 rows
    fu: torch.Tensor      # int64[L, RECS, 4] uoptable meta_u64 rows


def _fetch(image: MemImage, ov, cr3: torch.Tensor, at: torch.Tensor):
    """The code window at each lane's `at`: (bytes uint8[L, 15], fault,
    pfn0 int32[L], pfn14 int32[L]).  pfn14 is the frame of the window's
    last byte, pfn0 when that walk fails (JAX `gather_windows`)."""
    win, fault, t = paging.virt_read_walk(image, ov, cr3, at, MAX_LEN)
    pfns = I.shr(t.gpa, 12).to(torch.int32)
    pfn0 = pfns[:, 0]
    return win, fault, pfn0, torch.where(t.ok[:, 1], pfns[:, 1], pfn0)


def _pack_raw_u64(win: torch.Tensor, length: torch.Tensor):
    """Device `_pack_raw`: the first `length` window bytes LE-packed into
    (lo, hi), zero beyond — the host's ljust-with-NULs, since decode
    lengths never exceed MAX_LEN < 16.  A length of 0 gives a zero mask
    (the JAX `_M64 >> 64`), never all-ones."""
    w = win.long()
    k = torch.arange(8, device=w.device)
    lo = (w[:, :8] << (8 * k)).sum(1)
    hi = (w[:, 8:] << (8 * k[:MAX_LEN - 8])).sum(1)
    return (lo & I.size_mask(length.clamp(max=8)),
            hi & I.size_mask((length - 8).clamp(min=0)))


def _record_row(d: DecUop, pfn0, pfn14, at, win, bp_keys, n_bp, key):
    """The uoptable meta rows of decoded instructions: pfn1 (the frame of
    the last instruction byte, `runner._decode_at`), bp (pending-
    breakpoint membership) and the raw packing.  pfn1 is read off the
    fetch's two walks: a fetch that did not fault walked both pages, and
    the last instruction byte lies on the second one exactly when the
    instruction crosses the page; a faulting fetch publishes nothing."""
    length = d.f[:, _F_LENGTH].long()
    crosses = (at & 0xFFF) + (length - 1).clamp(min=0) >= 0x1000
    pfn1 = torch.where(crosses, pfn14, pfn0)
    live_bp = torch.arange(bp_keys.shape[0], device=key.device) < n_bp
    bp = (live_bp[None, :] & (bp_keys[None, :] == key[:, None])).any(1)
    fi = torch.cat([d.f, torch.stack([pfn0, pfn1, bp.to(torch.int32)], 1)],
                   1)
    lo, hi = _pack_raw_u64(win, length)
    return fi, torch.stack([d.disp, d.imm, lo, hi], 1)


def _succs(fi: torch.Tensor, fu: torch.Tensor, at: torch.Tensor):
    """`runner._prefetch_block.succs` -> (push_a, push_b, count) with the
    host's extend order (fallthrough pushed first, so the branch target
    pops first off the LIFO stack)."""
    opc = fi[:, _F_OPC].long()
    nxt = at + fi[:, _F_LENGTH].long()
    tgt = nxt + fu[:, MU_IMM]
    terminal = torch.isin(opc, _consts(opc.device)[2])
    is_imm = fi[:, _F_SRC_KIND] == U.K_IMM
    two = (opc == U.OPC_JCC) | ((opc == U.OPC_CALL) & is_imm)
    jmp = opc == U.OPC_JMP
    n = _sel(terminal, 0, _sel(two, 2, _sel(jmp, is_imm.long(), 1)))
    return torch.where(jmp, tgt, nxt), tgt, n


def _put(t: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
         mask: torch.Tensor) -> None:
    """t[l, col[l]] = val[l] where mask[l], in place (t is [L, K, ...])."""
    lanes = torch.arange(t.shape[0], device=t.device)
    old = t[lanes, col]
    m = mask.view((-1,) + (1,) * (val.dim() - 1))
    t[lanes, col] = torch.where(m, val, old)


def compute_blocks(tab: UopTable, image: MemImage, machine,
                   bp_keys: torch.Tensor, n_bp: int) -> LaneBlock:
    """Phase 1 over all lanes of `machine` (the JAX `lane_block`, vmapped
    by `compute_blocks`), against `tab`, the round-start table.
    `bp_keys` int64[B] holds the pending-breakpoint keys, the first
    `n_bp` of them live.  The walk runs while any lane still walks and
    at most WALK_ITERS iterations: an iteration in which no lane is
    active changes nothing, so stopping there is exact."""
    m = machine
    ov, cr3, rip = m.overlay, m.cr3, m.rip
    n_lanes = rip.shape[0]
    dev = rip.device
    tenant = image.tenant if image.tenant is not None else \
        torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    needy = m.status == _STATUS_NEED_DECODE

    win, fault, pfn0, pfn14 = _fetch(image, ov, cr3, rip)
    d = decode_window(win)
    key0 = _key_of(rip, tenant)
    fi0, fu0 = _record_row(d, pfn0, pfn14, rip, win, bp_keys, n_bp, key0)
    keys = torch.zeros((n_lanes, RECS), dtype=torch.int64, device=dev)
    fis = torch.zeros((n_lanes, RECS, _N_META), dtype=torch.int32,
                      device=dev)
    fus = torch.zeros((n_lanes, RECS, 4), dtype=torch.int64, device=dev)
    keys[:, 0], fis[:, 0], fus[:, 0] = key0, fi0, fu0
    parked = ~fault & ~d.known
    ok0 = ~fault & d.known

    # LIFO walk seeded with the miss uop's successors
    a, b, ns = _succs(fi0, fu0, rip)
    stack = torch.zeros((n_lanes, STACK), dtype=torch.int64, device=dev)
    stack[:, 0], stack[:, 1] = a, b
    walks = needy & ok0 & (uop_lookup(tab, key0) < 0)
    sp = _sel(walks, ns, 0)
    n = ok0.long()
    budget = torch.full_like(n, PREFETCH_BUDGET)
    rec_idx = torch.arange(RECS, device=dev)
    for it in range(WALK_ITERS):
        act = (sp > 0) & (budget > 0) & ~parked & (n < RECS)
        if it % _WALK_CHECK == 0 and not bool(act.any()):
            break
        at = stack.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0]
        sp2 = torch.where(act, sp - 1, sp)
        key = _key_of(at, tenant)
        seen = (uop_lookup(tab, key) >= 0) | (
            (rec_idx[None, :] < n[:, None]) & (keys == key[:, None])).any(1)
        w, f, p0, p14 = _fetch(image, ov, cr3, at)
        dd = decode_window(w)
        take = act & ~seen & ~f
        parked = parked | (take & ~dd.known)
        add = take & dd.known & (dd.f[:, _F_OPC] != U.OPC_INVALID)
        fi, fu = _record_row(dd, p0, p14, at, w, bp_keys, n_bp, key)
        slot = n.clamp(max=RECS - 1)
        _put(keys, slot, key, add)
        _put(fis, slot, fi, add)
        _put(fus, slot, fu, add)
        n = n + add.long()
        budget = budget - add.long()
        sa, sb, sn = _succs(fi, fu, at)
        push = _sel(add, sn, 0)
        _put(stack, sp2.clamp(max=STACK - 1), sa, push >= 1)
        _put(stack, (sp2 + 1).clamp(max=STACK - 1), sb, push >= 2)
        sp3 = sp2 + push
        # stack bound: net growth is +1 per published record, so STACK
        # cannot overflow before RECS does; park if it ever would
        parked = parked | (sp3 > STACK - 1)
        sp = sp3.clamp(max=STACK - 1)
    return LaneBlock(needy=needy, fault=fault & needy, parked=parked & needy,
                     rip=rip.clone(), n=_sel(ok0, n, 0), keys=keys, fi=fis,
                     fu=fus)


def gather_windows(image: MemImage, overlay, cr3: torch.Tensor,
                   rips: torch.Tensor, idx: torch.Tensor):
    """Code windows for the HOST service path (the `--device-decode`
    satellite of runner._service_decode): for each lane index in `idx`,
    the 15-byte fetch window at its rip plus the page-walk facts the host
    decode needs, in one device pass, so the host transfers k x 15 bytes
    instead of pulling overlay pages and walking page tables through the
    HostView.

    Returns (win uint8[k, 15], fault bool[k], pfn0 int32[k],
    pfn14 int32[k]): `fault` is HostView.virt_read's any-byte-faults
    contract; `pfn14` is the frame of the window's last byte (pfn0 unless
    the window crosses a page), all the host needs to reproduce
    `_decode_at`'s pfn1 without a second walk.  The window is read for
    every lane and the asked ones selected (the walk costs the same
    number of launches at any lane count)."""
    win, fault, pfn0, pfn14 = _fetch(image, overlay, cr3, rips)
    return win[idx], fault[idx], pfn0[idx], pfn14[idx]


# ---------------------------------------------------------------------------
# Phase 2: the commit (sequential in lane order)
# ---------------------------------------------------------------------------


class CommitOut(NamedTuple):
    """Phase-2 result: the table with the committed rows (a new one; the
    input table is not changed), its live count, per-lane machine deltas
    and the round's stats."""

    tab: UopTable
    count: int                  # live entries
    status: torch.Tensor        # int32[L] post-service status
    fault_gva: torch.Tensor     # int64[L]
    fault_mask: torch.Tensor    # bool[L] lanes whose fault fields apply
    mem_fault_inc: torch.Tensor  # int32[L] CTR_MEM_FAULT increments
    parked: torch.Tensor        # bool[L] lanes left for the host
    stats: Tuple[int, int, int]  # serviced lanes, published entries, parks


def _host_probe_slots(key: int, mask: int):
    """The probe sequence of `DecodeCache._hash_insert` (and of
    `uop_lookup`, which the walk and the gates probe with)."""
    h = splitmix64(key)
    return [(h + k) & mask for k in range(PROBES)]


def _i32_halves(key: torch.Tensor) -> torch.Tensor:
    """int64 keys -> [N, 2] int32 (lo, hi): the hash rows' key columns."""
    def s32(v):
        return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000

    return torch.stack([s32(key), s32(I.shr(key, 32))], 1).to(torch.int32)


def commit_blocks(tab: UopTable, count: int, blocks: LaneBlock,
                  statuses: torch.Tensor, capacity: int) -> CommitOut:
    """Phase 2: replay the needy lanes' blocks in lane order against the
    live table (the JAX `commit_blocks`), with its gates: the miss already
    published (the host `cache.has`: resume), the fetch fault (PAGE_FAULT,
    fault_gva = the miss rip, one CTR_MEM_FAULT), a block that left the
    device subset (park), a record another lane published this round or
    a full table or eight taken probe slots (the block is dropped and the
    lane parks), and the capacity margin before every record after the
    miss (the block's tail is dropped, the lane stays serviced).  Once a
    lane parks, every needy lane after it parks too, so the host services
    them in the publish order of a host-serviced run.

    The control is replayed on the host from one read of the needy lanes'
    keys and the round-start hash rows; the decoded rows move from the
    blocks into a copy of the table on its device, in one scatter."""
    dev = statuses.device
    n_lanes = statuses.shape[0]
    needy_t = blocks.needy & (statuses == _STATUS_NEED_DECODE)
    lanes_t = torch.nonzero(needy_t)[:, 0]
    status = statuses.clone()
    fault_mask = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    parked = torch.zeros_like(fault_mask)
    lanes = lanes_t.cpu().numpy()
    if len(lanes) == 0:
        return CommitOut(tab, count, status, torch.zeros_like(blocks.rip),
                         fault_mask, torch.zeros_like(statuses), parked,
                         (0, 0, 0))
    keys_t = blocks.keys[lanes_t]
    in_t0 = (uop_lookup(tab, keys_t.reshape(-1)) >= 0).view(keys_t.shape)
    host = [x.cpu().numpy() for x in (
        blocks.fault[lanes_t], blocks.parked[lanes_t], blocks.n[lanes_t],
        keys_t, in_t0, tab.hash_tab[:, 0])]
    fault, blk_parked, n_rec, keys, in_t0, entry = host
    keys = keys.view(np.uint64)
    entry = entry.copy()      # the replay's live slots (a CPU tab shares)
    mask = len(entry) - 1

    st = np.full(len(lanes), -1, dtype=np.int64)   # -1 = unchanged
    fmask = np.zeros(len(lanes), dtype=bool)
    pmask = np.zeros(len(lanes), dtype=bool)
    live = set()          # keys this round committed
    cnt = count
    park_rest = False
    rec_lane, rec_j, rec_slot = [], [], []
    serviced = published = parks = 0
    for r in range(len(lanes)):
        if park_rest:
            pmask[r] = True
            parks += 1
            continue
        if in_t0[r, 0] or int(keys[r, 0]) in live:
            st[r] = _STATUS_RUNNING           # the host `cache.has` gate
            continue
        if fault[r]:
            st[r] = _STATUS_PAGE_FAULT
            fmask[r] = True
            continue
        if blk_parked[r]:
            pmask[r] = park_rest = True
            parks += 1
            continue
        c, own, claimed, aborted = cnt, set(), [], False
        for j in range(int(n_rec[r])):
            # the host walk's margin, checked before every pop after the
            # miss: the rest of the block is dropped
            if j > 0 and c >= capacity - MARGIN:
                break
            key = int(keys[r, j])
            if j > 0 and (in_t0[r, j] or key in live or key in own):
                aborted = True            # walk diverged from the host's
                break
            if c >= capacity:
                aborted = True
                break
            slot = next((s for s in _host_probe_slots(key, mask)
                         if entry[s] < 0), None)
            if slot is None:
                aborted = True
                break
            entry[slot] = c
            own.add(key)
            claimed.append((j, slot))
            c += 1
        if aborted:
            for _, slot in claimed:       # drop every slot it claimed
                entry[slot] = -1
            pmask[r] = park_rest = True
            parks += 1
            continue
        live |= own
        cnt = c
        st[r] = _STATUS_RUNNING
        serviced += 1
        published += len(claimed)
        for j, slot in claimed:
            rec_lane.append(lanes[r])
            rec_j.append(j)
            rec_slot.append(slot)

    def up(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(dev)

    changed = st >= 0
    status[up(lanes[changed], np.int64)] = up(st[changed], np.int32)
    fault_mask[up(lanes[fmask], np.int64)] = True
    parked[up(lanes[pmask], np.int64)] = True
    if rec_lane:
        rl, rj = up(rec_lane, np.int64), up(rec_j, np.int64)
        entries = torch.arange(count, cnt, device=dev)
        new_keys = blocks.keys[rl, rj]
        hash_tab = tab.hash_tab.clone()
        hash_tab[up(rec_slot, np.int64)] = torch.cat(
            [entries.to(torch.int32)[:, None], _i32_halves(new_keys)], 1)
        rip = tab.rip.clone()
        rip[entries] = new_keys
        meta_i32 = tab.meta_i32.clone()
        meta_i32[entries] = blocks.fi[rl, rj]
        meta_u64 = tab.meta_u64.clone()
        meta_u64[entries] = blocks.fu[rl, rj]
        tab = UopTable(rip=rip, meta_i32=meta_i32, meta_u64=meta_u64,
                       hash_tab=hash_tab)
    fault_gva = torch.where(fault_mask, blocks.rip,
                            torch.zeros_like(blocks.rip))
    return CommitOut(tab, cnt, status, fault_gva, fault_mask,
                     fault_mask.to(torch.int32), parked,
                     (serviced, published, parks))

