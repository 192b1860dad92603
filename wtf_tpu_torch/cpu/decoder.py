"""Host-side x86-64 instruction decoder: bytes -> Uop.

Runs ONCE per unique guest code address (the decode cache in machine.py keeps
the result), so it is cold-path and written for clarity, not speed.  Covers
the long-mode integer subset that compiled Windows/Linux user and kernel code
actually executes, plus the XMM moves/bitops that show up in memcpy/strlen
paths; anything outside the subset decodes to OPC_INVALID and surfaces as a
per-lane UNSUPPORTED status instead of silently corrupting state (mirroring
how the reference's backends surface unknown situations as explicit results,
reference src/wtf/backend.h:12-31).

Decoding model: legacy prefixes -> REX -> opcode (1-byte map, 0F map,
0F 38 map) -> ModRM/SIB/disp -> immediate.  67h address-size overrides
decode (EA truncates to 32 bits; jecxz tests ECX) except on string ops,
whose 32-bit rsi/rdi/rcx semantics neither engine models — those refuse
loudly as OPC_INVALID.  Far/segment-load forms are out of scope (never
emitted by 64-bit compilers) and decode invalid.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from wtf_tpu_torch.cpu.uops import (
    ALU_ADC, ALU_ADD, ALU_AND, ALU_CMP, ALU_OR, ALU_SBB, ALU_SUB, ALU_TEST,
    ALU_XOR, BMI_ANDN, BMI_BEXTR, BMI_BLSI, BMI_BLSMSK, BMI_BLSR, BMI_BZHI,
    BMI_PDEP, BMI_PEXT_, BMI_RORX, BMI_SARX, BMI_SHLX, BMI_SHRX, BS_BSF,
    BS_BSR, BS_LZCNT, BS_POPCNT, BS_TZCNT, BT_BT, BT_BTC, BT_BTR, BT_BTS,
    DIV_S, DIV_U, FL_CLC, FL_CLD, FL_CLI, FL_CMC, FL_LAHF, FL_SAHF, FL_STC,
    FL_STD, FL_STI, K_IMM, K_MEM, K_NONE, K_REG, K_XMM, MUL_2OP, MUL_WIDE_S,
    MUL_WIDE_U, OPC_ALU, OPC_BITSCAN, OPC_BSWAP, OPC_BT, OPC_CALL,
    OPC_CMOVCC, OPC_CMPXCHG, OPC_CONVERT, OPC_CPUID, OPC_DIV, OPC_FENCE,
    OPC_FLAGOP, OPC_HLT, OPC_INT, OPC_INT1, OPC_INVALID, OPC_IRET, OPC_JCC,
    OPC_JMP,
    OPC_LEA, OPC_LEAVE, OPC_MOV, OPC_MOVCR, OPC_MUL, OPC_NOP, OPC_PEXT,
    OPC_POP, OPC_RDGSBASE,
    OPC_MSR, OPC_POPF, OPC_PUSH, OPC_PUSHF, OPC_RDRAND, OPC_RDTSC, OPC_RET,
    OPC_SETCC, OPC_SHIFT, OPC_SSEALU, OPC_SSEMOV, OPC_STRING, OPC_SYSCALL,
    OPC_SSEFP, OPC_UNARY, OPC_VZEROALL, OPC_XADD, OPC_XCHG, OPC_XGETBV,
    FP_ADD, FP_SUB, FP_MUL, FP_DIV, FP_MIN, FP_MAX, FP_SQRT, FP_UCOMI,
    FP_COMI, FP_CMP, FP_CVT_I2F, FP_CVT_F2I, FP_CVT_F2I_T, FP_CVT_F2F,
    FP_CVT_DQ2PS, FP_CVT_PS2DQ, FP_CVT_PS2DQ_T, FP_SHUF, FP_UNPCKL,
    FP_UNPCKH, FP_CVT_DQ2PD, FP_CVT_PD2DQ, FP_CVT_PD2DQ_T,
    OPC_X87, X87_ARITH_M, X87_ARITH_ST, X87_COM, X87_COMI, X87_EMMS,
    X87_FABS, X87_FCHS, X87_FFREE, X87_FILD, X87_FIST, X87_FIST_T,
    X87_FLDCW, X87_FLD_CONST, X87_FLD_M, X87_FLD_STI, X87_FNCLEX,
    X87_FNINIT, X87_FNSTCW, X87_FNSTSW_AX, X87_FNSTSW_M, X87_FST_M,
    X87_FST_STI, X87_FXCH, X87_FXRSTOR, X87_FXSAVE, X87_LDMXCSR,
    X87_XRSTOR, X87_XSAVE,
    X87_STMXCSR, X87_OP_ADD, X87_OP_COM, X87_OP_COMP, X87_OP_DIV,
    X87_OP_DIVR, X87_OP_MUL, X87_OP_SUB, X87_OP_SUBR,
    REG_AH_BASE, REG_NONE,
    REG_RIP, REP_NONE, REP_REP, REP_REPNE, SEG_FS, SEG_GS, SEG_NONE,
    SH_SHL, SH_SHLD, SH_SHRD, SSE_PADDB, SSE_PAND, SSE_PANDN, SSE_PCMPEQB,
    SSE_PCMPEQD,
    SSE_PCMPEQW, SSE_PMINUB, SSE_PMOVMSKB, SSE_PADDQ, SSE_POR, SSE_PSHUFD,
    SSE_PSLLDQ,
    SSE_PSLLQ_I, SSE_PSRLQ_I, SSE_PINSRW, SSE_PEXTRW,
    SSE_PSRLDQ, SSE_PSUBB, SSE_PTEST, SSE_PUNPCKLDQ, SSE_PUNPCKLQDQ, SSE_PXOR,
    SSE_XORPS, STR_CMPS,
    STR_LODS, STR_MOVS, STR_SCAS, STR_STOS, UN_DEC, UN_INC, UN_NEG, UN_NOT,
    Uop,
)

MASK64 = (1 << 64) - 1
MAX_INSN_LEN = 15


class _Cursor:
    """Byte cursor over the instruction window."""

    def __init__(self, code: bytes):
        self.code = code
        self.pos = 0

    def peek(self) -> int:
        if self.pos >= len(self.code):
            raise _Truncated()
        return self.code[self.pos]

    def u8(self) -> int:
        b = self.peek()
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.code):
            raise _Truncated()
        out = self.code[self.pos : self.pos + n]
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack("<b", self.bytes(1))[0]

    def i16(self) -> int:
        return struct.unpack("<h", self.bytes(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.bytes(4))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.bytes(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.bytes(8))[0]


class _Truncated(Exception):
    pass


class _Prefixes:
    def __init__(self):
        self.osize = False   # 66
        self.asize = False   # 67
        self.lock = False    # F0
        self.repne = False   # F2
        self.rep = False     # F3
        self.seg = SEG_NONE
        self.rex = 0         # 0 = no REX
        self.any_legacy = False   # any legacy prefix seen (VEX validity)
        self.rex_present = False  # a REX byte seen, even 0x40

    @property
    def rex_w(self) -> bool:
        return bool(self.rex & 8)

    @property
    def rex_r(self) -> int:
        return (self.rex >> 2) & 1

    @property
    def rex_x(self) -> int:
        return (self.rex >> 1) & 1

    @property
    def rex_b(self) -> int:
        return self.rex & 1

    def opsize(self) -> int:
        if self.rex_w:
            return 8
        if self.osize:
            return 2
        return 4


def _sx(value: int, bits: int) -> int:
    """Sign-extend `value` from `bits` to a Python int, then mask to 64."""
    sign = 1 << (bits - 1)
    return ((value ^ sign) - sign) & MASK64


def _gpr8(idx: int, pfx: _Prefixes) -> int:
    """8-bit register index: without REX, 4-7 encode ah/ch/dh/bh."""
    if pfx.rex == 0 and 4 <= idx <= 7:
        return REG_AH_BASE + (idx - 4)
    return idx


class _ModRM:
    """Parsed ModRM + SIB + displacement."""

    def __init__(self, cur: _Cursor, pfx: _Prefixes):
        byte = cur.u8()
        self.mod = byte >> 6
        self.reg = ((byte >> 3) & 7) | (pfx.rex_r << 3)
        rm = byte & 7
        self.is_mem = self.mod != 3
        self.rm_reg = rm | (pfx.rex_b << 3)
        self.base = REG_NONE
        self.index = REG_NONE
        self.scale = 1
        self.disp = 0

        if not self.is_mem:
            return

        if rm == 4:  # SIB
            sib = cur.u8()
            scale_bits = sib >> 6
            index = ((sib >> 3) & 7) | (pfx.rex_x << 3)
            base = (sib & 7) | (pfx.rex_b << 3)
            self.scale = 1 << scale_bits
            if index != 4:  # rsp can never be an index
                self.index = index
            if (base & 7) == 5 and self.mod == 0:
                self.disp = _sx(cur.u32(), 32)
            else:
                self.base = base
        elif rm == 5 and self.mod == 0:
            # RIP-relative
            self.base = REG_RIP
            self.disp = _sx(cur.u32(), 32)
            return
        else:
            self.base = rm | (pfx.rex_b << 3)

        if self.mod == 1:
            self.disp = _sx(cur.i8() & 0xFF, 8)
        elif self.mod == 2:
            self.disp = _sx(cur.u32(), 32)


def _apply_mem(uop: Uop, modrm: _ModRM, pfx: _Prefixes) -> None:
    uop.base_reg = modrm.base
    uop.idx_reg = modrm.index
    uop.scale = modrm.scale
    uop.disp = modrm.disp
    uop.seg = pfx.seg


def _rm_operand(uop: Uop, modrm: _ModRM, pfx: _Prefixes, is_dst: bool,
                size8: bool = False) -> None:
    """Set the r/m side (reg or mem) as dst or src."""
    if modrm.is_mem:
        _apply_mem(uop, modrm, pfx)
        if is_dst:
            uop.dst_kind = K_MEM
        else:
            uop.src_kind = K_MEM
    else:
        reg = _gpr8(modrm.rm_reg, pfx) if size8 else modrm.rm_reg
        if is_dst:
            uop.dst_kind, uop.dst_reg = K_REG, reg
        else:
            uop.src_kind, uop.src_reg = K_REG, reg


def _reg_operand(uop: Uop, modrm: _ModRM, pfx: _Prefixes, is_dst: bool,
                 size8: bool = False) -> None:
    reg = _gpr8(modrm.reg, pfx) if size8 else modrm.reg
    if is_dst:
        uop.dst_kind, uop.dst_reg = K_REG, reg
    else:
        uop.src_kind, uop.src_reg = K_REG, reg


def _imm_for(uop: Uop, cur: _Cursor, opsize: int, imm8: bool = False) -> None:
    """Standard immediate: imm8 sign-extended, else imm16/imm32 (imm32
    sign-extends to 64-bit opsize)."""
    uop.src_kind = K_IMM
    if imm8:
        uop.imm = _sx(cur.u8(), 8)
    elif opsize == 2:
        uop.imm = _sx(cur.u16(), 16)
    else:
        uop.imm = _sx(cur.u32(), 32)


def decode(code: bytes, gva: int = 0) -> Uop:
    """Decode one instruction from `code` (a window of up to 15 bytes at
    `gva`).  Always returns a Uop; undecodable input returns OPC_INVALID with
    length 1 so the executor can flag the lane rather than diverge."""
    try:
        uop = _decode_inner(code)
    except _Truncated:
        uop = Uop(opc=OPC_INVALID, length=1)
    except Exception:  # pragma: no cover - decoder bug guard
        uop = Uop(opc=OPC_INVALID, length=1)
    uop.raw = code[: uop.length]
    return uop


def _decode_prefixes(cur: _Cursor) -> _Prefixes:
    pfx = _Prefixes()
    while True:
        b = cur.peek()
        if b == 0x66:
            pfx.osize = True
        elif b == 0x67:
            pfx.asize = True
        elif b == 0xF0:
            pfx.lock = True
        elif b == 0xF2:
            pfx.repne = True
        elif b == 0xF3:
            pfx.rep = True
        elif b == 0x64:
            pfx.seg = SEG_FS
        elif b == 0x65:
            pfx.seg = SEG_GS
        elif b in (0x26, 0x2E, 0x36, 0x3E):
            pass  # es/cs/ss/ds overrides are no-ops in long mode
        else:
            break
        # only LOCK/66/F2/F3 #UD a following VEX; segment overrides are
        # legal before VEX (they scope its memory operand)
        if b in (0x66, 0xF0, 0xF2, 0xF3):
            pfx.any_legacy = True
        cur.pos += 1
    b = cur.peek()
    if 0x40 <= b <= 0x4F:
        pfx.rex = b & 0xF
        pfx.rex_present = True
        cur.pos += 1
    return pfx


def _decode_inner(code: bytes) -> Uop:
    cur = _Cursor(code[:MAX_INSN_LEN])
    pfx = _decode_prefixes(cur)
    op = cur.u8()
    uop = Uop()
    uop.a32 = int(pfx.asize)  # 67h: EA truncated to 32 bits (both engines)
    uop.lock = int(pfx.lock)

    if op in (0xC4, 0xC5) and not pfx.any_legacy and not pfx.rex_present:
        # VEX prefix (in long mode C4/C5 are always VEX; LES/LDS invalid).
        # Any legacy or REX prefix before VEX #UDs on hardware, so such
        # sequences fall through and decode invalid.
        _decode_vex(op, cur, pfx, uop)
    elif op == 0x0F:
        _decode_0f(cur, pfx, uop)
    else:
        _decode_primary(op, cur, pfx, uop)

    uop.length = cur.pos
    return uop


# ---------------------------------------------------------------------------
# VEX map — the BMI1/BMI2 scalar subset (AVX forms stay OPC_INVALID).
# Three-operand encoding convention: dst_reg = destination, the r/m goes
# through the normal src machinery (register or memory), and the VEX.vvvv
# register rides in `uop.cond` (unused by this opcode class otherwise).
# ---------------------------------------------------------------------------

def _decode_vex(op: int, cur: _Cursor, pfx: _Prefixes, uop: Uop) -> None:
    if op == 0xC5:  # 2-byte form: R.vvvv.L.pp, map = 0F
        b1 = cur.u8()
        r = (~b1 >> 7) & 1
        x = b = w = 0
        vvvv = (~b1 >> 3) & 0xF
        l_bit = (b1 >> 2) & 1
        pp = b1 & 3
        mmmmm = 1
    else:           # 3-byte form: RXB.mmmmm, W.vvvv.L.pp
        b1 = cur.u8()
        b2 = cur.u8()
        r = (~b1 >> 7) & 1
        x = (~b1 >> 6) & 1
        b = (~b1 >> 5) & 1
        mmmmm = b1 & 0x1F
        w = (b2 >> 7) & 1
        vvvv = (~b2 >> 3) & 0xF
        l_bit = (b2 >> 2) & 1
        pp = b2 & 3
    opc = cur.u8()
    # reuse the legacy ModRM machinery: VEX.RXB/W are REX-equivalent
    pfx.rex = (w << 3) | (r << 2) | (x << 1) | b
    opsize = 8 if w else 4

    if mmmmm == 1 and opc == 0x77 and pp == 0 and vvvv == 0:
        # pp/vvvv must be 0 — hardware #UDs otherwise.
        # L=1: vzeroall — zeroes the full registers (sub 0).
        # L=0: vzeroupper — zeroes only the upper YMM halves (sub 1);
        #      compilers emit it at AVX/SSE transition points.
        # Both execute on the device step (whole-file xmm limb writes,
        # step.py OPC_VZEROALL block).
        uop.opc, uop.sub = OPC_VZEROALL, (0 if l_bit else 1)
        return

    if l_bit:  # VEX.256 (AVX) — not in the scalar subset
        uop.opc = OPC_INVALID
        return

    if mmmmm == 1:
        # VEX.128 forms of the 0F map: delegate to the legacy decoder
        # with pp mapped onto the prefix flags.  Two-operand forms
        # (moves, packed converts, ucomis) require VEX.vvvv == 1111b
        # exactly like hardware; three-operand forms are accepted when
        # vvvv names the destination — src1 == dst degenerates to the
        # legacy read-modify-write semantics this pipeline models.  A
        # genuinely three-operand encoding (vvvv != dst) stays INVALID.
        pfx.osize = pp == 1
        pfx.rep = pp == 2
        pfx.repne = pp == 3
        _decode_0f_sse(opc, cur, pfx, uop)
        if uop.opc == OPC_INVALID:
            return
        mem = uop.mem_operand()
        three_op = opc in (0x51, 0x58, 0x59, 0x5C, 0x5D, 0x5E, 0x5F,
                           0xC2, 0x54, 0x55, 0x56, 0x57, 0x14, 0x15,
                           0xC6, 0x2A, 0xEF, 0xEB, 0xDB, 0xDF, 0x74,
                           0x75, 0x76, 0xF8, 0xFC, 0xDA, 0x6C, 0x62,
                           0xD4,
                           # 0x73: vpslldq/vpsrldq — VEX dst rides in vvvv,
                           # degenerate when it names the same register
                           0x73)
        scalar_regmov = opc in (0x10, 0x11) and pp in (2, 3) and not mem
        # scalar converts merge into vvvv (vcvtsd2ss etc.); packed 0x5A
        # forms are 2-operand
        scalar_cvt = opc == 0x5A and pp in (2, 3)
        # vmovlps/vmovhps: both the load (mem) and the hl/lh reg forms
        # merge into vvvv; the stores 0x13/0x17 are plain 2-operand
        half_mov = opc in (0x12, 0x16)
        if three_op or scalar_regmov or scalar_cvt or half_mov:
            ok = vvvv == uop.dst_reg
        else:
            ok = vvvv == 0
        if not ok:
            uop.opc = OPC_INVALID
        return

    if mmmmm == 2:  # 0F38 map
        if opc == 0xF2 and pp == 0:  # andn r, vvvv, r/m
            uop.opc, uop.sub, uop.opsize = OPC_PEXT, BMI_ANDN, opsize
            modrm = _ModRM(cur, pfx)
            _reg_operand(uop, modrm, pfx, is_dst=True)
            _rm_operand(uop, modrm, pfx, is_dst=False)
            uop.cond = vvvv
            return
        if opc == 0xF3 and pp == 0:  # blsr/blsmsk/blsi vvvv, r/m
            modrm = _ModRM(cur, pfx)
            group = {1: BMI_BLSR, 2: BMI_BLSMSK, 3: BMI_BLSI}
            digit = modrm.reg & 7  # opcode extension, not a register
            if digit not in group:
                uop.opc = OPC_INVALID
                return
            uop.opc, uop.sub, uop.opsize = OPC_PEXT, group[digit], opsize
            uop.dst_kind, uop.dst_reg = K_REG, vvvv
            _rm_operand(uop, modrm, pfx, is_dst=False)
            return
        if opc == 0xF5:  # bzhi (pp=0) / pext (F3) / pdep (F2): r, r/m, vvvv
            sub = {0: BMI_BZHI, 2: BMI_PEXT_, 3: BMI_PDEP}.get(pp)
            if sub is None:
                uop.opc = OPC_INVALID
                return
            uop.opc, uop.sub, uop.opsize = OPC_PEXT, sub, opsize
            modrm = _ModRM(cur, pfx)
            _reg_operand(uop, modrm, pfx, is_dst=True)
            _rm_operand(uop, modrm, pfx, is_dst=False)
            uop.cond = vvvv
            return
        if opc == 0xF7:  # bextr (pp=0) / shlx (66) / sarx (F3) / shrx (F2)
            sub = {0: BMI_BEXTR, 1: BMI_SHLX, 2: BMI_SARX, 3: BMI_SHRX}[pp]
            uop.opc, uop.sub, uop.opsize = OPC_PEXT, sub, opsize
            modrm = _ModRM(cur, pfx)
            _reg_operand(uop, modrm, pfx, is_dst=True)
            _rm_operand(uop, modrm, pfx, is_dst=False)
            uop.cond = vvvv
            return
        uop.opc = OPC_INVALID
        return
    if mmmmm == 3 and opc == 0xF0 and pp == 3:  # rorx r, r/m, imm8
        if vvvv != 0:  # encoded VEX.vvvv must be 1111b (hardware #UD)
            uop.opc = OPC_INVALID
            return
        uop.opc, uop.sub, uop.opsize = OPC_PEXT, BMI_RORX, opsize
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        uop.imm = cur.u8()
        return
    uop.opc = OPC_INVALID


# ---------------------------------------------------------------------------
# Primary (1-byte) opcode map
# ---------------------------------------------------------------------------

def _decode_primary(op: int, cur: _Cursor, pfx: _Prefixes, uop: Uop) -> None:
    opsize = pfx.opsize()

    # ALU block: 00-3D in groups of 8 per operation
    if op <= 0x3D and (op & 7) <= 5 and (op >> 3) <= 7:
        sub = op >> 3
        form = op & 7
        uop.opc, uop.sub = OPC_ALU, sub
        if form == 0:    # op r/m8, r8
            uop.opsize = 1
            modrm = _ModRM(cur, pfx)
            _rm_operand(uop, modrm, pfx, is_dst=True, size8=True)
            _reg_operand(uop, modrm, pfx, is_dst=False, size8=True)
        elif form == 1:  # op r/m, r
            uop.opsize = opsize
            modrm = _ModRM(cur, pfx)
            _rm_operand(uop, modrm, pfx, is_dst=True)
            _reg_operand(uop, modrm, pfx, is_dst=False)
        elif form == 2:  # op r8, r/m8
            uop.opsize = 1
            modrm = _ModRM(cur, pfx)
            _reg_operand(uop, modrm, pfx, is_dst=True, size8=True)
            _rm_operand(uop, modrm, pfx, is_dst=False, size8=True)
        elif form == 3:  # op r, r/m
            uop.opsize = opsize
            modrm = _ModRM(cur, pfx)
            _reg_operand(uop, modrm, pfx, is_dst=True)
            _rm_operand(uop, modrm, pfx, is_dst=False)
        elif form == 4:  # op al, imm8
            uop.opsize = 1
            uop.dst_kind, uop.dst_reg = K_REG, 0
            uop.src_kind, uop.imm = K_IMM, _sx(cur.u8(), 8)
        else:            # op rAX, imm
            uop.opsize = opsize
            uop.dst_kind, uop.dst_reg = K_REG, 0
            _imm_for(uop, cur, opsize)
        return

    if 0x50 <= op <= 0x57:  # push r64
        uop.opc = OPC_PUSH
        uop.opsize = 2 if pfx.osize else 8
        uop.src_kind, uop.src_reg = K_REG, (op & 7) | (pfx.rex_b << 3)
        return
    if 0x58 <= op <= 0x5F:  # pop r64
        uop.opc = OPC_POP
        uop.opsize = 2 if pfx.osize else 8
        uop.dst_kind, uop.dst_reg = K_REG, (op & 7) | (pfx.rex_b << 3)
        return

    if op == 0x63:  # movsxd r, r/m32
        uop.opc = OPC_MOV
        uop.opsize = opsize
        uop.srcsize, uop.sext = 4, 1
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return

    if op == 0x68:  # push imm32 (sx to 64)
        uop.opc = OPC_PUSH
        uop.opsize = 8
        uop.src_kind, uop.imm = K_IMM, _sx(cur.u32(), 32)
        return
    if op == 0x6A:  # push imm8
        uop.opc = OPC_PUSH
        uop.opsize = 8
        uop.src_kind, uop.imm = K_IMM, _sx(cur.u8(), 8)
        return
    if op in (0x69, 0x6B):  # imul r, r/m, imm
        uop.opc, uop.sub = OPC_MUL, MUL_2OP
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        # the r/m is the multiplicand; the immediate is the multiplier
        if op == 0x69:
            uop.imm = _sx(cur.u32() if opsize != 2 else cur.u16(),
                          32 if opsize != 2 else 16)
        else:
            uop.imm = _sx(cur.u8(), 8)
        # mark the 3-operand form: src2 = imm (exec checks sub+has imm flag)
        uop.sext = 2  # sentinel: "imm is second source"
        return

    if 0x70 <= op <= 0x7F:  # jcc rel8
        uop.opc, uop.cond = OPC_JCC, op & 0xF
        uop.opsize = 8
        uop.imm = _sx(cur.u8(), 8)
        return

    if op in (0x80, 0x81, 0x83):  # group 1
        modrm = _ModRM(cur, pfx)
        uop.opc, uop.sub = OPC_ALU, modrm.reg & 7
        if op == 0x80:
            uop.opsize = 1
            _rm_operand(uop, modrm, pfx, is_dst=True, size8=True)
            uop.src_kind, uop.imm = K_IMM, _sx(cur.u8(), 8)
        else:
            uop.opsize = opsize
            _rm_operand(uop, modrm, pfx, is_dst=True)
            _imm_for(uop, cur, opsize, imm8=(op == 0x83))
        return

    if op in (0x84, 0x85):  # test r/m, r
        uop.opc, uop.sub = OPC_ALU, ALU_TEST
        size8 = op == 0x84
        uop.opsize = 1 if size8 else opsize
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
        _reg_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        return

    if op in (0x86, 0x87):  # xchg r/m, r
        uop.opc = OPC_XCHG
        size8 = op == 0x86
        uop.opsize = 1 if size8 else opsize
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
        _reg_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        return

    if op in (0x88, 0x89, 0x8A, 0x8B):  # mov
        uop.opc = OPC_MOV
        size8 = op in (0x88, 0x8A)
        to_rm = op in (0x88, 0x89)
        uop.opsize = 1 if size8 else opsize
        modrm = _ModRM(cur, pfx)
        if to_rm:
            _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
            _reg_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        else:
            _reg_operand(uop, modrm, pfx, is_dst=True, size8=size8)
            _rm_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        return

    if op == 0x8D:  # lea
        uop.opc = OPC_LEA
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        if not modrm.is_mem:
            uop.opc = OPC_INVALID
            return
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _apply_mem(uop, modrm, pfx)
        uop.seg = SEG_NONE  # lea ignores segment bases
        return

    if op == 0x8F:  # pop r/m
        uop.opc = OPC_POP
        uop.opsize = 2 if pfx.osize else 8
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True)
        return

    if op == 0x90:
        # nop (also F3 90 = pause)
        uop.opc = OPC_NOP
        return
    if 0x91 <= op <= 0x97:  # xchg rAX, r
        uop.opc = OPC_XCHG
        uop.opsize = opsize
        uop.dst_kind, uop.dst_reg = K_REG, (op & 7) | (pfx.rex_b << 3)
        uop.src_kind, uop.src_reg = K_REG, 0
        return

    if op == 0x98:  # cbw/cwde/cdqe
        uop.opc, uop.sub = OPC_CONVERT, 0
        uop.opsize = opsize
        return
    if op == 0x99:  # cwd/cdq/cqo
        uop.opc, uop.sub = OPC_CONVERT, 1
        uop.opsize = opsize
        return

    if op == 0x9C:
        uop.opc, uop.opsize = OPC_PUSHF, 8
        return
    if op == 0x9D:
        uop.opc, uop.opsize = OPC_POPF, 8
        return
    if op == 0x9E:
        uop.opc, uop.sub = OPC_FLAGOP, FL_SAHF
        return
    if op == 0x9F:
        uop.opc, uop.sub = OPC_FLAGOP, FL_LAHF
        return

    if op in (0xA8, 0xA9):  # test al/rAX, imm
        uop.opc, uop.sub = OPC_ALU, ALU_TEST
        uop.dst_kind, uop.dst_reg = K_REG, 0
        if op == 0xA8:
            uop.opsize = 1
            uop.src_kind, uop.imm = K_IMM, _sx(cur.u8(), 8)
        else:
            uop.opsize = opsize
            _imm_for(uop, cur, opsize)
        return

    if op in (0xA4, 0xA5, 0xA6, 0xA7, 0xAA, 0xAB, 0xAC, 0xAD, 0xAE, 0xAF):
        table = {
            0xA4: (STR_MOVS, 1), 0xA5: (STR_MOVS, opsize),
            0xA6: (STR_CMPS, 1), 0xA7: (STR_CMPS, opsize),
            0xAA: (STR_STOS, 1), 0xAB: (STR_STOS, opsize),
            0xAC: (STR_LODS, 1), 0xAD: (STR_LODS, opsize),
            0xAE: (STR_SCAS, 1), 0xAF: (STR_SCAS, opsize),
        }
        uop.opc = OPC_STRING
        uop.sub, uop.opsize = table[op]
        if pfx.rep:
            uop.rep = REP_REP
        elif pfx.repne:
            uop.rep = REP_REPNE
        return

    if 0xB0 <= op <= 0xB7:  # mov r8, imm8
        uop.opc = OPC_MOV
        uop.opsize = 1
        uop.dst_kind = K_REG
        uop.dst_reg = _gpr8((op & 7) | (pfx.rex_b << 3), pfx) \
            if pfx.rex == 0 else (op & 7) | (pfx.rex_b << 3)
        uop.src_kind, uop.imm = K_IMM, cur.u8()
        return
    if 0xB8 <= op <= 0xBF:  # mov r, imm(16/32/64)
        uop.opc = OPC_MOV
        uop.opsize = opsize
        uop.dst_kind, uop.dst_reg = K_REG, (op & 7) | (pfx.rex_b << 3)
        uop.src_kind = K_IMM
        if opsize == 8:
            uop.imm = cur.u64()
        elif opsize == 2:
            uop.imm = cur.u16()
        else:
            uop.imm = cur.u32()
        return

    if op in (0xC0, 0xC1, 0xD0, 0xD1, 0xD2, 0xD3):  # shift group 2
        modrm = _ModRM(cur, pfx)
        uop.opc, uop.sub = OPC_SHIFT, modrm.reg & 7
        size8 = op in (0xC0, 0xD0, 0xD2)
        uop.opsize = 1 if size8 else opsize
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
        if op in (0xC0, 0xC1):
            uop.src_kind, uop.imm = K_IMM, cur.u8()
        elif op in (0xD0, 0xD1):
            uop.src_kind, uop.imm = K_IMM, 1
        else:  # D2/D3: count in cl
            uop.src_kind, uop.src_reg = K_REG, 1
            uop.srcsize = 1
        return

    if op == 0xC2:  # ret imm16
        uop.opc, uop.opsize = OPC_RET, 8
        uop.imm = cur.u16()
        return
    if op == 0xC3:
        uop.opc, uop.opsize = OPC_RET, 8
        return

    if op in (0xC6, 0xC7):  # mov r/m, imm
        modrm = _ModRM(cur, pfx)
        if modrm.reg & 7 != 0:
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_MOV
        if op == 0xC6:
            uop.opsize = 1
            _rm_operand(uop, modrm, pfx, is_dst=True, size8=True)
            uop.src_kind, uop.imm = K_IMM, cur.u8()
        else:
            uop.opsize = opsize
            _rm_operand(uop, modrm, pfx, is_dst=True)
            _imm_for(uop, cur, opsize)
        return

    if op == 0xC8:  # enter imm16, imm8 — level 0 only (nested frames are
        # a pre-386 idiom no 64-bit compiler emits); OPC_LEAVE sub 1
        size = cur.u16()
        level = cur.u8()
        if level != 0:
            uop.opc = OPC_INVALID
            return
        uop.opc, uop.sub, uop.opsize = OPC_LEAVE, 1, 8
        uop.imm = size
        return
    if op == 0xC9:
        uop.opc, uop.opsize = OPC_LEAVE, 8
        return

    if op == 0xCC:  # int3
        uop.opc, uop.sub = OPC_INT, 3
        return
    if op == 0xCD:  # int imm8
        uop.opc, uop.sub = OPC_INT, cur.u8()
        return
    if op in (0xCA, 0xCB):  # retf [imm16]: far return (sub 1)
        uop.opc, uop.sub = OPC_IRET, 1
        uop.opsize = 8  # 64-bit far returns pop qword rip + qword cs
        uop.imm = cur.u16() if op == 0xCA else 0
        return
    if op == 0xCF:  # iret / iretq (REX.W): kernel-mode interrupt return
        uop.opc = OPC_IRET
        uop.opsize = 8 if pfx.rex_w else 4
        return

    if op == 0xE3:  # jrcxz (67h: jecxz tests ECX — special cond 17)
        uop.opc, uop.cond = OPC_JCC, (17 if pfx.asize else 16)
        uop.opsize = 8
        uop.imm = _sx(cur.u8(), 8)
        return

    if op == 0xE8:  # call rel32
        uop.opc, uop.opsize = OPC_CALL, 8
        uop.src_kind, uop.imm = K_IMM, _sx(cur.u32(), 32)
        return
    if op == 0xE9:
        uop.opc, uop.opsize = OPC_JMP, 8
        uop.src_kind, uop.imm = K_IMM, _sx(cur.u32(), 32)
        return
    if op == 0xEB:
        uop.opc, uop.opsize = OPC_JMP, 8
        uop.src_kind, uop.imm = K_IMM, _sx(cur.u8(), 8)
        return

    if op == 0xF4:
        uop.opc = OPC_HLT
        return
    if op == 0xF5:
        uop.opc, uop.sub = OPC_FLAGOP, FL_CMC
        return

    if op in (0xF6, 0xF7):  # group 3
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        size8 = op == 0xF6
        size = 1 if size8 else pfx.opsize()
        if sub in (0, 1):  # test r/m, imm
            uop.opc, uop.sub = OPC_ALU, ALU_TEST
            uop.opsize = size
            _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
            if size8:
                uop.src_kind, uop.imm = K_IMM, _sx(cur.u8(), 8)
            else:
                _imm_for(uop, cur, size)
        elif sub in (2, 3):  # not / neg
            uop.opc = OPC_UNARY
            uop.sub = UN_NOT if sub == 2 else UN_NEG
            uop.opsize = size
            _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
        elif sub in (4, 5):  # mul / imul (widening)
            uop.opc = OPC_MUL
            uop.sub = MUL_WIDE_U if sub == 4 else MUL_WIDE_S
            uop.opsize = size
            _rm_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        else:  # div / idiv
            uop.opc = OPC_DIV
            uop.sub = DIV_U if sub == 6 else DIV_S
            uop.opsize = size
            _rm_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        return

    if op == 0xF8:
        uop.opc, uop.sub = OPC_FLAGOP, FL_CLC
        return
    if op == 0xF9:
        uop.opc, uop.sub = OPC_FLAGOP, FL_STC
        return
    if op == 0xFA:
        uop.opc, uop.sub = OPC_FLAGOP, FL_CLI
        return
    if op == 0xFB:
        uop.opc, uop.sub = OPC_FLAGOP, FL_STI
        return
    if op == 0xFC:
        uop.opc, uop.sub = OPC_FLAGOP, FL_CLD
        return
    if op == 0xFD:
        uop.opc, uop.sub = OPC_FLAGOP, FL_STD
        return

    if op == 0x9B:  # fwait: exception-check only; no deferred faults here
        uop.opc = OPC_NOP
        return

    if 0xD8 <= op <= 0xDF:  # x87 escape block
        _decode_x87(op, cur, pfx, uop)
        return

    if op == 0xFE:  # group 4: inc/dec r/m8
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        if sub > 1:
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_UNARY
        uop.sub = UN_INC if sub == 0 else UN_DEC
        uop.opsize = 1
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=True)
        return

    if op == 0xFF:  # group 5
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        if sub == 0 or sub == 1:
            uop.opc = OPC_UNARY
            uop.sub = UN_INC if sub == 0 else UN_DEC
            uop.opsize = pfx.opsize()
            _rm_operand(uop, modrm, pfx, is_dst=True)
        elif sub == 2:  # call r/m64
            uop.opc, uop.opsize = OPC_CALL, 8
            _rm_operand(uop, modrm, pfx, is_dst=False)
        elif sub == 4:  # jmp r/m64
            uop.opc, uop.opsize = OPC_JMP, 8
            _rm_operand(uop, modrm, pfx, is_dst=False)
        elif sub == 6:  # push r/m64
            uop.opc = OPC_PUSH
            uop.opsize = 2 if pfx.osize else 8
            _rm_operand(uop, modrm, pfx, is_dst=False)
        else:
            uop.opc = OPC_INVALID
        return

    uop.opc = OPC_INVALID


# ---------------------------------------------------------------------------
# 0F (two-byte) opcode map
# ---------------------------------------------------------------------------

def _decode_0f(cur: _Cursor, pfx: _Prefixes, uop: Uop) -> None:
    op = cur.u8()
    opsize = pfx.opsize()

    if op == 0x38:
        _decode_0f38(cur, pfx, uop)
        return

    if op == 0x05:
        uop.opc = OPC_SYSCALL
        return
    if op == 0x0B:  # ud2
        uop.opc, uop.sub = OPC_INT, 6  # #UD
        return
    if op == 0x01:
        b = cur.u8()
        if b == 0xD0:       # xgetbv
            uop.opc = OPC_XGETBV
        elif b == 0xF8:     # swapgs
            uop.opc, uop.sub = OPC_RDGSBASE, 4
        else:
            uop.opc = OPC_INVALID
        return
    if op == 0x07:  # sysret
        uop.opc, uop.sub = OPC_SYSCALL, 1
        return
    if op in (0x20, 0x22):  # mov r64, crN / mov crN, r64
        modrm = _ModRM(cur, pfx)
        uop.opc = OPC_MOVCR
        uop.opsize = 8
        uop.sub = modrm.reg  # control register number (incl. REX.R for cr8)
        if op == 0x20:
            uop.dst_kind, uop.dst_reg = K_REG, modrm.rm_reg
            uop.sext = 0  # read from cr
        else:
            uop.src_kind, uop.src_reg = K_REG, modrm.rm_reg
            uop.sext = 1  # write to cr
        return
    if op == 0x0D:  # prefetchw
        _ModRM(cur, pfx)
        uop.opc = OPC_NOP
        return
    if op in (0x18, 0x19, 0x1A, 0x1B, 0x1C, 0x1D, 0x1E, 0x1F):
        # hint nop / multi-byte nop with modrm
        _ModRM(cur, pfx)
        uop.opc = OPC_NOP
        return

    if op == 0x31:
        uop.opc = OPC_RDTSC
        return
    if op == 0x30:  # wrmsr
        uop.opc, uop.sub = OPC_MSR, 1
        return
    if op == 0x32:  # rdmsr
        uop.opc, uop.sub = OPC_MSR, 0
        return
    if op == 0xA2:
        uop.opc = OPC_CPUID
        return

    if 0x40 <= op <= 0x4F:  # cmovcc
        uop.opc, uop.cond = OPC_CMOVCC, op & 0xF
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return

    if 0x80 <= op <= 0x8F:  # jcc rel32
        uop.opc, uop.cond = OPC_JCC, op & 0xF
        uop.opsize = 8
        uop.imm = _sx(cur.u32(), 32)
        return

    if 0x90 <= op <= 0x9F:  # setcc r/m8
        uop.opc, uop.cond = OPC_SETCC, op & 0xF
        uop.opsize = 1
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=True)
        return

    if op in (0xA3, 0xAB, 0xB3, 0xBB):  # bt/bts/btr/btc r/m, r
        subs = {0xA3: BT_BT, 0xAB: BT_BTS, 0xB3: BT_BTR, 0xBB: BT_BTC}
        uop.opc, uop.sub = OPC_BT, subs[op]
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True)
        _reg_operand(uop, modrm, pfx, is_dst=False)
        return
    if op == 0xBA:  # group 8: bt r/m, imm8
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        if sub < 4:
            uop.opc = OPC_INVALID
            return
        uop.opc, uop.sub = OPC_BT, sub - 4
        uop.opsize = opsize
        _rm_operand(uop, modrm, pfx, is_dst=True)
        uop.src_kind, uop.imm = K_IMM, cur.u8()
        return

    if op in (0xA4, 0xA5, 0xAC, 0xAD):  # shld/shrd
        uop.opc = OPC_SHIFT
        uop.sub = SH_SHLD if op in (0xA4, 0xA5) else SH_SHRD
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True)
        _reg_operand(uop, modrm, pfx, is_dst=False)
        if op in (0xA4, 0xAC):
            uop.imm = cur.u8()
            uop.sext = 3  # sentinel: count in imm
        else:
            uop.sext = 4  # sentinel: count in cl
        return

    if op == 0xAE:
        # group 15: fences; ldmxcsr/stmxcsr and fxsave/fxrstor are real
        # state movers (oracle-serviced via OPC_X87); F3-prefixed
        # register forms are rd/wrfsbase+rd/wrgsbase
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        if pfx.rep and not modrm.is_mem and sub in (0, 1, 2, 3):
            # rdfsbase/rdgsbase/wrfsbase/wrgsbase r32/r64
            uop.opc, uop.sub = OPC_RDGSBASE, sub
            uop.opsize = 8 if pfx.rex_w else 4
            uop.dst_kind, uop.dst_reg = K_REG, modrm.rm_reg
        elif not modrm.is_mem and sub in (5, 6, 7):  # l/m/sfence
            uop.opc = OPC_FENCE
        elif modrm.is_mem and sub in (0, 1, 2, 3, 4, 5):
            uop.opc = OPC_X87
            uop.sub = {0: X87_FXSAVE, 1: X87_FXRSTOR,
                       2: X87_LDMXCSR, 3: X87_STMXCSR,
                       4: X87_XSAVE, 5: X87_XRSTOR}[sub]
            _apply_mem(uop, modrm, pfx)
            uop.src_kind = K_MEM  # address carrier
            if sub in (2, 3):
                uop.srcsize = 4  # mxcsr dword (device load/store width)
        else:
            uop.opc = OPC_INVALID  # clflush/clwb out of subset
        return

    if op == 0xAF:  # imul r, r/m
        uop.opc, uop.sub = OPC_MUL, MUL_2OP
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return

    if op in (0xB0, 0xB1):  # cmpxchg
        uop.opc = OPC_CMPXCHG
        size8 = op == 0xB0
        uop.opsize = 1 if size8 else opsize
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
        _reg_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        return

    if op in (0xB6, 0xB7, 0xBE, 0xBF):  # movzx / movsx
        uop.opc = OPC_MOV
        uop.opsize = opsize
        uop.srcsize = 1 if op in (0xB6, 0xBE) else 2
        uop.sext = 1 if op in (0xBE, 0xBF) else 0
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False, size8=(uop.srcsize == 1))
        return

    if op in (0xBC, 0xBD):  # bsf/bsr (F3: tzcnt/lzcnt)
        uop.opc = OPC_BITSCAN
        if pfx.rep:
            uop.sub = BS_TZCNT if op == 0xBC else BS_LZCNT
        else:
            uop.sub = BS_BSF if op == 0xBC else BS_BSR
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return

    if op == 0xB8 and pfx.rep:  # popcnt
        uop.opc, uop.sub = OPC_BITSCAN, BS_POPCNT
        uop.opsize = opsize
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return

    if op in (0xC0, 0xC1):  # xadd
        uop.opc = OPC_XADD
        size8 = op == 0xC0
        uop.opsize = 1 if size8 else opsize
        modrm = _ModRM(cur, pfx)
        _rm_operand(uop, modrm, pfx, is_dst=True, size8=size8)
        _reg_operand(uop, modrm, pfx, is_dst=False, size8=size8)
        return

    if op == 0xC7:  # group 9: rdrand / rdseed (/6, /7 reg forms)
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        if not modrm.is_mem and sub in (6, 7):
            uop.opc = OPC_RDRAND
            uop.opsize = opsize
            uop.dst_kind, uop.dst_reg = K_REG, modrm.rm_reg
        else:
            uop.opc = OPC_INVALID  # cmpxchg16b unsupported for now
        return

    if 0xC8 <= op <= 0xCF:  # bswap
        uop.opc = OPC_BSWAP
        uop.opsize = 8 if pfx.rex_w else 4
        uop.dst_kind, uop.dst_reg = K_REG, (op & 7) | (pfx.rex_b << 3)
        return

    _decode_0f_sse(op, cur, pfx, uop)


def _decode_x87(op: int, cur: _Cursor, pfx: _Prefixes, uop: Uop) -> None:
    """x87 escape block D8-DF (OPC_X87; executes on the device except
    the FXSAVE-class state movers, interp/step.py).

    Covers the load/store/arith/compare/control subset MSVC and CRT
    helpers emit around `long double` and legacy math paths; the
    transcendental/BCD/env instructions stay INVALID -> oracle
    UnsupportedInsn.  Census note (tools/decode_census.py): x87 is ~0% of
    modern Windows x64 .text — the x64 ABI is SSE-based and kernel code
    may not use the FPU at all — so this subset is about not
    false-crashing the stragglers, not about throughput."""
    uop.opc = OPC_X87
    modbyte = cur.peek()
    if modbyte < 0xC0:  # memory form: reg digit selects the operation
        modrm = _ModRM(cur, pfx)
        digit = modrm.reg & 7
        _apply_mem(uop, modrm, pfx)
        uop.src_kind = K_MEM  # address carrier for exec
        if op in (0xD8, 0xDC):  # fadd/fmul/fcom(p)/fsub(r)/fdiv(r) m32/m64
            uop.sub = X87_ARITH_M
            uop.cond = digit
            uop.srcsize = 4 if op == 0xD8 else 8
            if digit == X87_OP_COMP:
                uop.sext = 1  # fcomp pops
            return
        table = {
            (0xD9, 0): (X87_FLD_M, 4, 0), (0xD9, 2): (X87_FST_M, 4, 0),
            (0xD9, 3): (X87_FST_M, 4, 1), (0xD9, 5): (X87_FLDCW, 2, 0),
            (0xD9, 7): (X87_FNSTCW, 2, 0),
            (0xDD, 0): (X87_FLD_M, 8, 0), (0xDD, 2): (X87_FST_M, 8, 0),
            (0xDD, 3): (X87_FST_M, 8, 1), (0xDD, 7): (X87_FNSTSW_M, 2, 0),
            (0xDB, 0): (X87_FILD, 4, 0), (0xDB, 1): (X87_FIST_T, 4, 1),
            (0xDB, 2): (X87_FIST, 4, 0), (0xDB, 3): (X87_FIST, 4, 1),
            (0xDD, 1): (X87_FIST_T, 8, 1),
            (0xDF, 0): (X87_FILD, 2, 0), (0xDF, 2): (X87_FIST, 2, 0),
            (0xDF, 3): (X87_FIST, 2, 1), (0xDF, 5): (X87_FILD, 8, 0),
            (0xDF, 7): (X87_FIST, 8, 1),
        }
        entry = table.get((op, digit))
        if entry is None:  # m80, fldenv/fstenv, fbld... out of subset
            uop.opc = OPC_INVALID
            return
        uop.sub, uop.srcsize, uop.sext = entry
        return

    # register form
    cur.u8()  # consume the modrm byte
    i = modbyte & 7
    uop.imm = i
    _DSTI_SWAP = {X87_OP_SUB: X87_OP_SUBR, X87_OP_SUBR: X87_OP_SUB,
                  X87_OP_DIV: X87_OP_DIVR, X87_OP_DIVR: X87_OP_DIV}
    if op in (0xD8, 0xDC):  # arith st/st(i); DC: st(i) is the destination
        uop.sub = X87_ARITH_ST
        uop.cond = (modbyte >> 3) & 7
        uop.dst_reg = 1 if op == 0xDC else 0
        if op == 0xD8 and uop.cond == X87_OP_COMP:
            uop.sext = 1
        if op == 0xDC and uop.cond in (X87_OP_COM, X87_OP_COMP):
            uop.opc = OPC_INVALID  # DC D0+ forms are reserved
        if op == 0xDC:
            # the SDM's famous reversal: with st(i) as destination the
            # encoded digit means the OPPOSITE sub/div direction
            uop.cond = _DSTI_SWAP.get(uop.cond, uop.cond)
        return
    if op == 0xDE:
        if modbyte == 0xD9:  # fcompp
            uop.sub, uop.cond, uop.sext = X87_COM, 0, 2
            return
        if (modbyte >> 3) & 7 in (X87_OP_COM, X87_OP_COMP):
            uop.opc = OPC_INVALID
            return
        uop.sub = X87_ARITH_ST  # faddp/fmulp/fsub(r)p/fdiv(r)p st(i), st
        uop.cond = _DSTI_SWAP.get((modbyte >> 3) & 7, (modbyte >> 3) & 7)
        uop.dst_reg = 1
        uop.sext = 1
        return
    if op == 0xD9:
        if modbyte <= 0xC7:
            uop.sub = X87_FLD_STI
        elif modbyte <= 0xCF:
            uop.sub = X87_FXCH
        elif modbyte == 0xD0:
            uop.opc = OPC_NOP  # fnop
        elif modbyte == 0xE0:
            uop.sub = X87_FCHS
        elif modbyte == 0xE1:
            uop.sub = X87_FABS
        elif modbyte == 0xE8:
            uop.sub, uop.imm = X87_FLD_CONST, 0  # fld1
        elif modbyte == 0xEE:
            uop.sub, uop.imm = X87_FLD_CONST, 1  # fldz
        else:  # fptan/fsin/f2xm1... out of subset
            uop.opc = OPC_INVALID
        return
    if op == 0xDD:
        if 0xC0 <= modbyte <= 0xC7:
            uop.sub = X87_FFREE
        elif 0xD0 <= modbyte <= 0xD7:
            uop.sub = X87_FST_STI
        elif 0xD8 <= modbyte <= 0xDF:
            uop.sub, uop.sext = X87_FST_STI, 1
        elif 0xE0 <= modbyte <= 0xE7:
            uop.sub, uop.cond = X87_COM, 0  # fucom
        elif 0xE8 <= modbyte <= 0xEF:
            uop.sub, uop.cond, uop.sext = X87_COM, 0, 1  # fucomp
        else:
            uop.opc = OPC_INVALID
        return
    if op == 0xDB:
        if modbyte == 0xE2:
            uop.sub = X87_FNCLEX
        elif modbyte == 0xE3:
            uop.sub = X87_FNINIT
        elif 0xE8 <= modbyte <= 0xF7:  # fucomi / fcomi
            uop.sub = X87_COMI
        else:  # fcmovcc out of subset
            uop.opc = OPC_INVALID
        return
    if op == 0xDF:
        if modbyte == 0xE0:
            uop.sub = X87_FNSTSW_AX
        elif 0xE8 <= modbyte <= 0xF7:  # fucomip / fcomip
            uop.sub, uop.sext = X87_COMI, 1
        else:
            uop.opc = OPC_INVALID
        return
    if op == 0xDA:
        if modbyte == 0xE9:  # fucompp
            uop.sub, uop.cond, uop.sext = X87_COM, 0, 2
            return
        uop.opc = OPC_INVALID  # fcmovcc out of subset
        return
    uop.opc = OPC_INVALID


def _decode_0f_sse(op: int, cur: _Cursor, pfx: _Prefixes, uop: Uop) -> None:
    """XMM data movement + bitwise ops (the subset memcpy/strcmp-style code
    uses).  dst/src kind K_XMM means the register index refers to xmm0-15."""

    def xmm_rm(modrm: _ModRM, is_dst: bool) -> None:
        if modrm.is_mem:
            _apply_mem(uop, modrm, pfx)
            if is_dst:
                uop.dst_kind = K_MEM
            else:
                uop.src_kind = K_MEM
        else:
            if is_dst:
                uop.dst_kind, uop.dst_reg = K_XMM, modrm.rm_reg
            else:
                uop.src_kind, uop.src_reg = K_XMM, modrm.rm_reg

    def xmm_reg(modrm: _ModRM, is_dst: bool) -> None:
        if is_dst:
            uop.dst_kind, uop.dst_reg = K_XMM, modrm.reg
        else:
            uop.src_kind, uop.src_reg = K_XMM, modrm.reg

    if op == 0x77 and not (pfx.osize or pfx.rep or pfx.repne):
        uop.opc, uop.sub = OPC_X87, X87_EMMS  # clears the x87 tag word
        return

    # movlps/movhps family (66 = movlpd/movhpd, integer-identical; the
    # F3/F2 forms movsldup/movddup are out of the subset).  sub 4 = low
    # qword, sub 5 = high qword; reg forms are movhlps (src HIGH -> dst
    # low) and movlhps (src LOW -> dst high).
    if op in (0x12, 0x13, 0x16, 0x17):
        if pfx.rep or pfx.repne:
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_SSEMOV
        uop.opsize = 8
        uop.sub = 4 if op in (0x12, 0x13) else 5
        modrm = _ModRM(cur, pfx)
        if op in (0x12, 0x16):  # load (or reg-to-reg half move)
            if not modrm.is_mem and pfx.osize:
                uop.opc = OPC_INVALID  # movlpd/movhpd require memory
                return
            xmm_reg(modrm, is_dst=True)
            xmm_rm(modrm, is_dst=False)
        else:                   # store: memory only
            if not modrm.is_mem:
                uop.opc = OPC_INVALID
                return
            xmm_rm(modrm, is_dst=True)
            xmm_reg(modrm, is_dst=False)
        return

    # movups/movupd/movss/movsd and movaps/movapd (alignment not enforced)
    if op in (0x10, 0x28):
        uop.opc = OPC_SSEMOV
        uop.opsize = 16
        if op == 0x10 and pfx.rep:
            uop.opsize = 4    # movss
        elif op == 0x10 and pfx.repne:
            uop.opsize = 8    # movsd
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return
    if op in (0x11, 0x29):
        uop.opc = OPC_SSEMOV
        uop.opsize = 16
        if op == 0x11 and pfx.rep:
            uop.opsize = 4
        elif op == 0x11 and pfx.repne:
            uop.opsize = 8
        modrm = _ModRM(cur, pfx)
        xmm_rm(modrm, is_dst=True)
        xmm_reg(modrm, is_dst=False)
        return

    if op in (0x6F, 0x7F):  # movdqa/movdqu (66 / F3)
        uop.opc = OPC_SSEMOV
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        if op == 0x6F:
            xmm_reg(modrm, is_dst=True)
            xmm_rm(modrm, is_dst=False)
        else:
            xmm_rm(modrm, is_dst=True)
            xmm_reg(modrm, is_dst=False)
        return

    if op == 0x6E:  # movd/movq xmm, r/m
        uop.opc = OPC_SSEMOV
        uop.opsize = 8 if pfx.rex_w else 4
        uop.sub = 1  # gpr->xmm (zero upper)
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return
    if op == 0x7E:
        uop.opc = OPC_SSEMOV
        modrm = _ModRM(cur, pfx)
        if pfx.rep:  # movq xmm, xmm/m64 (zeroes the upper lane, unlike movsd)
            uop.opsize = 8
            uop.sub = 3
            xmm_reg(modrm, is_dst=True)
            xmm_rm(modrm, is_dst=False)
        else:  # movd/movq r/m, xmm
            uop.opsize = 8 if pfx.rex_w else 4
            uop.sub = 2  # xmm->gpr
            _rm_operand(uop, modrm, pfx, is_dst=True)
            xmm_reg(modrm, is_dst=False)
        return
    if op == 0xD6:  # movq xmm/m64, xmm (zeroes upper when dst is a register)
        uop.opc = OPC_SSEMOV
        uop.opsize = 8
        uop.sub = 3
        modrm = _ModRM(cur, pfx)
        xmm_rm(modrm, is_dst=True)
        xmm_reg(modrm, is_dst=False)
        return

    # ---- SSE/SSE2 floating point (OPC_SSEFP; oracle-serviced) ----------
    # The dominant decode gap measured on real Windows-PE codegen
    # (tools/decode_census.py).  Element width + packedness from
    # the prefix: F2 = sd, F3 = ss, 66 = pd, none = ps — stored in
    # srcsize (4/8) and sext (1 = packed).
    def fp_elem():
        if pfx.repne:
            return 8, 0   # scalar double
        if pfx.rep:
            return 4, 0   # scalar single
        if pfx.osize:
            return 8, 1   # packed double
        return 4, 1       # packed single

    _FP_ARITH = {0x51: FP_SQRT, 0x58: FP_ADD, 0x59: FP_MUL, 0x5C: FP_SUB,
                 0x5D: FP_MIN, 0x5E: FP_DIV, 0x5F: FP_MAX}
    if op in _FP_ARITH:
        uop.opc, uop.sub = OPC_SSEFP, _FP_ARITH[op]
        uop.srcsize, uop.sext = fp_elem()
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op in (0x2E, 0x2F):  # ucomiss/sd, comiss/sd: rflags only
        if pfx.rep or pfx.repne:
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_SSEFP
        uop.sub = FP_UCOMI if op == 0x2E else FP_COMI
        uop.srcsize, uop.sext = (8 if pfx.osize else 4), 0
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)  # compared reg; no writeback
        xmm_rm(modrm, is_dst=False)
        return

    if op == 0xC2:  # cmpps/ss/pd/sd imm8 predicate -> mask
        uop.opc, uop.sub = OPC_SSEFP, FP_CMP
        uop.srcsize, uop.sext = fp_elem()
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        uop.imm = cur.u8()
        return

    if op == 0x2A:  # cvtsi2ss/sd (gpr/mem int -> fp scalar)
        if not (pfx.rep or pfx.repne):
            uop.opc = OPC_INVALID  # MMX cvtpi2ps out of scope
            return
        uop.opc, uop.sub = OPC_SSEFP, FP_CVT_I2F
        uop.srcsize, uop.sext = (8 if pfx.repne else 4), 0
        uop.opsize = 8 if pfx.rex_w else 4  # integer operand width
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        _rm_operand(uop, modrm, pfx, is_dst=False)
        return

    if op in (0x2C, 0x2D):  # cvtt/cvt ss/sd -> gpr
        if not (pfx.rep or pfx.repne):
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_SSEFP
        uop.sub = FP_CVT_F2I_T if op == 0x2C else FP_CVT_F2I
        uop.srcsize, uop.sext = (8 if pfx.repne else 4), 0
        uop.opsize = 8 if pfx.rex_w else 4
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op == 0x5A:  # cvtss2sd/cvtsd2ss/cvtps2pd/cvtpd2ps
        uop.opc, uop.sub = OPC_SSEFP, FP_CVT_F2F
        uop.srcsize, uop.sext = fp_elem()  # SOURCE element type
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op == 0x5B:  # cvtdq2ps / cvtps2dq (66) / cvttps2dq (F3)
        if pfx.repne:
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_SSEFP
        uop.sub = (FP_CVT_PS2DQ_T if pfx.rep
                   else FP_CVT_PS2DQ if pfx.osize else FP_CVT_DQ2PS)
        uop.srcsize, uop.sext = 4, 1
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op == 0xE6:  # cvtdq2pd (F3) / cvtpd2dq (F2) / cvttpd2dq (66)
        if pfx.rep:
            sub = FP_CVT_DQ2PD
        elif pfx.repne:
            sub = FP_CVT_PD2DQ
        elif pfx.osize:
            sub = FP_CVT_PD2DQ_T
        else:
            uop.opc = OPC_INVALID  # bare E6 is MMX-era invalid
            return
        uop.opc, uop.sub = OPC_SSEFP, sub
        uop.srcsize, uop.sext = 8, 1
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op in (0x14, 0x15):  # unpcklps/pd, unpckhps/pd
        if pfx.rep or pfx.repne:
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_SSEFP
        uop.sub = FP_UNPCKL if op == 0x14 else FP_UNPCKH
        uop.srcsize, uop.sext = (8 if pfx.osize else 4), 1
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op == 0xC6:  # shufps/shufpd imm8
        if pfx.rep or pfx.repne:
            uop.opc = OPC_INVALID
            return
        uop.opc, uop.sub = OPC_SSEFP, FP_SHUF
        uop.srcsize, uop.sext = (8 if pfx.osize else 4), 1
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        uop.imm = cur.u8()
        return

    sse_table = {
        0x57: SSE_XORPS, 0xEF: SSE_PXOR, 0xEB: SSE_POR, 0xDB: SSE_PAND,
        0xDF: SSE_PANDN, 0x74: SSE_PCMPEQB, 0x75: SSE_PCMPEQW,
        0x76: SSE_PCMPEQD, 0xF8: SSE_PSUBB, 0xFC: SSE_PADDB,
        0xDA: SSE_PMINUB, 0x6C: SSE_PUNPCKLQDQ,
        # andps/andnps/orps and the pd forms: bitwise-identical to the
        # integer logicals for every prefix variant (like 0x57 above)
        0x54: SSE_PAND, 0x55: SSE_PANDN, 0x56: SSE_POR,
    }
    if op in (0x62, 0xD4):  # punpckldq / paddq: 66-prefixed only (no MMX)
        if not pfx.osize:
            uop.opc = OPC_INVALID
            return
        sse_table[0x62] = SSE_PUNPCKLDQ
        sse_table[0xD4] = SSE_PADDQ
    if op in sse_table:
        uop.opc, uop.sub = OPC_SSEALU, sse_table[op]
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        return

    if op == 0xC4 and pfx.osize:  # pinsrw xmm, r32/m16, imm8
        uop.opc, uop.sub = OPC_SSEALU, SSE_PINSRW
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        uop.dst_kind, uop.dst_reg = K_XMM, modrm.reg
        if modrm.is_mem:
            _apply_mem(uop, modrm, pfx)
            uop.src_kind = K_MEM
            uop.srcsize = 2
        else:
            uop.src_kind, uop.src_reg = K_REG, modrm.rm_reg
        uop.cond = cur.u8() & 7  # word index rides in cond (imm is data)
        return
    if op == 0xC5 and pfx.osize:  # pextrw r32, xmm, imm8
        modrm = _ModRM(cur, pfx)
        if modrm.is_mem:
            uop.opc = OPC_INVALID  # mem form is SSE4.1 (0F 3A 15)
            return
        uop.opc, uop.sub = OPC_SSEALU, SSE_PEXTRW
        uop.opsize = 4
        uop.dst_kind, uop.dst_reg = K_REG, modrm.reg
        uop.src_kind, uop.src_reg = K_XMM, modrm.rm_reg
        uop.cond = cur.u8() & 7
        return

    if op == 0xD7:  # pmovmskb r, xmm
        uop.opc, uop.sub = OPC_SSEALU, SSE_PMOVMSKB
        uop.opsize = 4
        modrm = _ModRM(cur, pfx)
        _reg_operand(uop, modrm, pfx, is_dst=True)
        if modrm.is_mem:
            uop.opc = OPC_INVALID
            return
        uop.src_kind, uop.src_reg = K_XMM, modrm.rm_reg
        return

    if op == 0x70 and pfx.osize:  # pshufd xmm, xmm/m128, imm8
        uop.opc, uop.sub = OPC_SSEALU, SSE_PSHUFD
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        xmm_reg(modrm, is_dst=True)
        xmm_rm(modrm, is_dst=False)
        uop.imm = cur.u8()
        return

    if op == 0x73 and pfx.osize:  # group 14: psrlq/psllq/psrldq/pslldq imm8
        modrm = _ModRM(cur, pfx)
        sub = modrm.reg & 7
        if modrm.is_mem or sub not in (2, 3, 6, 7):
            uop.opc = OPC_INVALID
            return
        uop.opc = OPC_SSEALU
        uop.sub = {2: SSE_PSRLQ_I, 3: SSE_PSRLDQ,
                   6: SSE_PSLLQ_I, 7: SSE_PSLLDQ}[sub]
        uop.opsize = 16
        uop.dst_kind, uop.dst_reg = K_XMM, modrm.rm_reg
        uop.src_kind, uop.imm = K_IMM, cur.u8()
        return

    uop.opc = OPC_INVALID


def _decode_0f38(cur: _Cursor, pfx: _Prefixes, uop: Uop) -> None:
    op = cur.u8()
    if op == 0x17 and pfx.osize:  # ptest
        uop.opc, uop.sub = OPC_SSEALU, SSE_PTEST
        uop.opsize = 16
        modrm = _ModRM(cur, pfx)
        if modrm.is_mem:
            _apply_mem(uop, modrm, pfx)
            uop.src_kind = K_MEM
        else:
            uop.src_kind, uop.src_reg = K_XMM, modrm.rm_reg
        uop.dst_kind, uop.dst_reg = K_XMM, modrm.reg
        uop.sext = 5  # sentinel: flag-only (no writeback)
        return
    uop.opc = OPC_INVALID
