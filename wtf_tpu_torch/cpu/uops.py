"""Decoded-instruction ("uop") encoding shared by host decoder and executors.

TPU-first design note: the reference interprets x86-64 by switching on raw
opcode bytes inside the emulator's hot loop (bochscpu's fetch-decode-execute;
reference src/libs/bochscpu-bins/include/bochscpu.hpp).  On TPU that per-byte
decode would be branchy, scalar work that maps terribly onto the VPU, so we
split the job the way a JIT does:

  - the HOST decodes each instruction ONCE (per unique guest address) into a
    fixed-width record — the "uop" — stored in device-resident parallel
    arrays (wtf_tpu/cpu/machine.py);
  - the DEVICE executes uops with a uniform pipeline (effective address →
    masked load → ALU select over op classes → masked store → writeback),
    fully vectorized over lanes, with no data-dependent shapes.

Every instruction becomes exactly one uop.  Complex x86 semantics (REP string
ops, partial-register merges, flag updates) are folded into the uop's class
semantics rather than expanded into multi-uop sequences, so `rip` advance
stays trivially per-instruction.

The encoding below is the contract between:
  decoder.py  (host: bytes -> Uop)
  emu.py      (host oracle: executes Uops in pure Python; the differential-
               testing reference, standing in for the role bochscpu rip
               traces play in the reference workflow, SURVEY.md §4)
  exec.py     (device: executes the same Uops in JAX)
"""

from __future__ import annotations

import dataclasses

MASK64 = (1 << 64) - 1

# ---------------------------------------------------------------------------
# Operation classes (Uop.opc).  Each is one branch of the device ALU select.
# ---------------------------------------------------------------------------
OPC_INVALID = 0    # undecodable -> lane status UNSUPPORTED
OPC_NOP = 1
OPC_MOV = 2        # mov / movzx / movsx / movsxd (extension via srcsize+sext)
OPC_LEA = 3
OPC_ALU = 4        # sub-op in ALU_*
OPC_SHIFT = 5      # sub-op in SH_*
OPC_UNARY = 6      # sub-op in UN_*
OPC_MUL = 7        # widening mul/imul (one-operand) and 2/3-operand imul
OPC_DIV = 8        # div/idiv
OPC_PUSH = 9
OPC_POP = 10
OPC_CALL = 11
OPC_RET = 12       # + imm16 stack adjustment
OPC_JMP = 13
OPC_JCC = 14
OPC_SETCC = 15
OPC_CMOVCC = 16
OPC_STRING = 17    # movs/stos/lods/scas/cmps, optionally REP — one iteration
                   # per uop execution; rip only advances when done
OPC_XCHG = 18
OPC_CONVERT = 19   # sub 0: cbw/cwde/cdqe ; sub 1: cwd/cdq/cqo
OPC_BT = 20        # sub-op BT_*
OPC_BITSCAN = 21   # sub-op BS_*
OPC_SYSCALL = 22   # traps to harness (lane pauses)
OPC_INT = 23       # int3 / int n / ud2 / into -> crash path
OPC_HLT = 24
OPC_RDTSC = 25
OPC_RDRAND = 26    # deterministic per-lane chain (reference
                   # bochscpu_backend.cc:874-885 uses a Blake3 chain)
OPC_CPUID = 27
OPC_LEAVE = 28
OPC_PUSHF = 29
OPC_POPF = 30
OPC_FLAGOP = 31    # sub-op FL_*: clc/stc/cmc/cld/std/cli/sti/sahf/lahf
OPC_BSWAP = 32
OPC_CMPXCHG = 33
OPC_XADD = 34
OPC_SSEMOV = 35    # vector-register moves/loads/stores (XMM only)
OPC_SSEALU = 36    # sub-op SSE_*: bitwise/compare XMM ops
OPC_FENCE = 37     # lfence/sfence/mfence/pause -> nop
OPC_XGETBV = 38
OPC_RDGSBASE = 39  # rd/wr fs/gs base (sub: 0 rdfs,1 rdgs,2 wrfs,3 wrgs)
OPC_MOVCR = 40     # mov to/from control register (cr3 writes -> Cr3Change)
OPC_INT1 = 41      # icebp/int1 -> crash
OPC_IRET = 42      # unsupported-class kernel returns (flagged)
OPC_SSECVT = 43    # scalar int<->float converts [minimal]
OPC_PCLMUL = 44    # reserved
OPC_PEXT = 45      # bmi: sub-op BMI_*
OPC_STACKSTR = 46  # push/pop of segment etc (rare; unsupported)
OPC_MSR = 47       # rdmsr/wrmsr (sub: 0 read, 1 write); oracle-serviced
OPC_VZEROALL = 48  # sub 0: vzeroall (whole vector file); sub 1:
                   # vzeroupper (upper YMM halves only) — both execute
                   # on the device as whole-file writes
OPC_SSEFP = 49     # SSE/SSE2 floating point (sub FP_*; srcsize = element
                   # width 4/8, sext = 1 for packed forms).  The dominant
                   # decode gap measured on real Windows-PE codegen
                   # (tools/decode_census.py); oracle-serviced — guests in
                   # the snapshot-fuzzing domain run integer-heavy paths,
                   # so FP trapping to the host costs little
OPC_X87 = 50       # x87 FPU subset (sub X87_*).  Values held in double
                   # precision — Windows runs the FPU with PC=53-bit
                   # (fpcw 0x27F), where add/sub/mul/div round
                   # identically to f64, so the model is bit-exact for
                   # the codegen that actually appears; 80-bit-extended
                   # corner cases (PC=64 + huge exponents) diverge.
                   # Executes on the DEVICE except the FXSAVE-class
                   # state movers (512+ byte images), which stay
                   # oracle-serviced

N_OPC = 51

# OPC_X87 sub-operations.  Field conventions: srcsize = memory operand
# width, sext = number of stack pops (0/1/2), imm = st(i) index or
# constant id, cond = arithmetic op digit, dst_reg = 1 when st(i) is the
# destination (DC/DE forms).
(X87_FLD_M, X87_FST_M, X87_FILD, X87_FIST, X87_FIST_T, X87_FLD_STI,
 X87_FST_STI, X87_FLD_CONST, X87_ARITH_M, X87_ARITH_ST, X87_FXCH,
 X87_FCHS, X87_FABS, X87_FNSTCW, X87_FLDCW, X87_FNSTSW_AX, X87_FNSTSW_M,
 X87_COMI, X87_COM, X87_FNINIT, X87_FNCLEX, X87_FFREE, X87_LDMXCSR,
 X87_STMXCSR, X87_FXSAVE, X87_FXRSTOR, X87_EMMS,
 X87_XSAVE, X87_XRSTOR) = range(29)

# X87_ARITH_* op digits (x87 /r encoding)
X87_OP_ADD, X87_OP_MUL, X87_OP_COM, X87_OP_COMP, X87_OP_SUB, \
    X87_OP_SUBR, X87_OP_DIV, X87_OP_DIVR = range(8)

# OPC_SSEFP sub-operations
FP_ADD = 0
FP_SUB = 1
FP_MUL = 2
FP_DIV = 3
FP_MIN = 4
FP_MAX = 5
FP_SQRT = 6
FP_UCOMI = 7      # ucomiss/ucomisd: rflags only
FP_COMI = 8       # comiss/comisd (same flag image; #IA differences N/A)
FP_CMP = 9        # cmpps/ss/pd/sd imm8 predicate -> all-ones/zeros mask
FP_CVT_I2F = 10   # cvtsi2ss/sd (gpr/mem int -> fp scalar)
FP_CVT_F2I = 11   # cvtss2si/cvtsd2si (rounded)
FP_CVT_F2I_T = 12 # cvttss2si/cvttsd2si (truncated)
FP_CVT_F2F = 13   # cvtss2sd/cvtsd2ss/cvtps2pd/cvtpd2ps
FP_CVT_DQ2PS = 14 # cvtdq2ps
FP_CVT_PS2DQ = 15 # cvtps2dq (rounded)
FP_CVT_PS2DQ_T = 16  # cvttps2dq
FP_SHUF = 17      # shufps/shufpd imm8
FP_UNPCKL = 18    # unpcklps/unpcklpd
FP_UNPCKH = 19    # unpckhps/unpckhpd
FP_CVT_DQ2PD = 20 # cvtdq2pd (F3 0F E6 is pd->dq; E6/5A family)
FP_CVT_PD2DQ = 21 # cvtpd2dq (F2 0F E6, rounded)
FP_CVT_PD2DQ_T = 22  # cvttpd2dq (66 0F E6)

# RFLAGS bits writable by flag-image restores (sysret r11, iretq frame):
# CF PF AF ZF SF TF IF DF OF IOPL NT AC VIF VIP ID.  RF (bit 16) and VM
# (bit 17) are intentionally masked — this is sysret's architectural
# 0x3C7FD7 mask, which we also apply to iretq (hardware iretq restores
# RF; this framework never single-steps via RF, so the difference is
# unobservable to guests and keeps one shared mask).
RF_WRITABLE = 0x3C7FD7

# ALU sub-ops (match x86 /r group encoding order, reference has the same
# ordering baked into its emulator tables)
ALU_ADD, ALU_OR, ALU_ADC, ALU_SBB, ALU_AND, ALU_SUB, ALU_XOR, ALU_CMP = range(8)
ALU_TEST = 8

# SHIFT sub-ops (group 2 /r order)
SH_ROL, SH_ROR, SH_RCL, SH_RCR, SH_SHL, SH_SHR, SH_SAL, SH_SAR = range(8)
SH_SHLD, SH_SHRD = 8, 9

# UNARY sub-ops
UN_INC, UN_DEC, UN_NOT, UN_NEG = range(4)

# MUL sub-ops
MUL_WIDE_U = 0     # mul r/m : rdx:rax = rax * r/m
MUL_WIDE_S = 1     # imul r/m
MUL_2OP = 2        # imul r, r/m (and 3-op imul r, r/m, imm via src=imm path)

# DIV sub-ops
DIV_U, DIV_S = 0, 1

# STRING sub-ops
STR_MOVS, STR_STOS, STR_LODS, STR_SCAS, STR_CMPS = range(5)
REP_NONE, REP_REP, REP_REPNE = 0, 1, 2

# BT sub-ops
BT_BT, BT_BTS, BT_BTR, BT_BTC = range(4)

# BITSCAN sub-ops
BS_BSF, BS_BSR, BS_POPCNT, BS_TZCNT, BS_LZCNT = range(5)

# FLAGOP sub-ops
FL_CLC, FL_STC, FL_CMC, FL_CLD, FL_STD, FL_CLI, FL_STI, FL_SAHF, FL_LAHF = range(9)

# SSEALU sub-ops
SSE_PXOR, SSE_POR, SSE_PAND, SSE_PANDN, SSE_XORPS, SSE_PCMPEQB, SSE_PMOVMSKB, \
    SSE_PSUBB, SSE_PADDB, SSE_PUNPCKLQDQ, SSE_PCMPEQW, SSE_PCMPEQD, SSE_PTEST, \
    SSE_PSHUFD, SSE_PSLLDQ, SSE_PSRLDQ, SSE_PMINUB, SSE_PUNPCKLDQ, \
    SSE_PADDQ, SSE_PSLLQ_I, SSE_PSRLQ_I, SSE_PINSRW, SSE_PEXTRW = range(23)

# BMI sub-ops
BMI_ANDN, BMI_BZHI, BMI_PEXT_, BMI_PDEP, BMI_BLSR, BMI_BLSMSK, BMI_BLSI, \
    BMI_BEXTR, BMI_SHLX, BMI_SHRX, BMI_SARX, BMI_RORX = range(12)

# Operand kinds
K_NONE, K_REG, K_MEM, K_IMM, K_XMM = range(5)

# Register indices: 0-15 = rax..r15 (x86 encoding order,
# core.cpustate.GPR_NAMES); 16-19 = ah/ch/dh/bh (high-byte views);
# REG_RIP used as mem base marker for RIP-relative addressing.
REG_AH_BASE = 16
REG_RIP = 24
REG_NONE = -1

# Segment override (only FS/GS matter in long mode)
SEG_NONE, SEG_FS, SEG_GS = 0, 1, 2

# Condition codes (x86 cc encoding 0x0-0xF: o,no,b,ae,e,ne,be,a,s,ns,p,np,l,ge,le,g)
CC_O, CC_NO, CC_B, CC_AE, CC_E, CC_NE, CC_BE, CC_A, CC_S, CC_NS, CC_P, CC_NP, \
    CC_L, CC_GE, CC_LE, CC_G = range(16)


@dataclasses.dataclass
class Uop:
    """One decoded instruction.  All fields are plain ints so the record can
    be packed into device int32/uint64 parallel arrays verbatim."""

    opc: int = OPC_INVALID
    sub: int = 0          # sub-operation within the class
    cond: int = 0         # condition code for JCC/SETCC/CMOVCC
    length: int = 1       # instruction length in bytes (rip advance)
    opsize: int = 8       # operation size in bytes: 1/2/4/8/16
    srcsize: int = 0      # source load size when != opsize (movzx/movsx); 0 = opsize
    sext: int = 0         # 1: sign-extend src from srcsize to opsize
    dst_kind: int = K_NONE
    dst_reg: int = 0
    src_kind: int = K_NONE
    src_reg: int = 0
    base_reg: int = REG_NONE   # memory operand base (REG_RIP = rip-relative)
    idx_reg: int = REG_NONE    # memory operand index
    scale: int = 1
    disp: int = 0              # sign-extended displacement
    imm: int = 0               # immediate, already sign/zero-extended to 64
    seg: int = SEG_NONE
    rep: int = REP_NONE
    lock: int = 0
    a32: int = 0               # 67h: effective address truncated to 32 bits
    raw: bytes = b""           # original bytes (debug / SMC verification)

    def mem_operand(self) -> bool:
        return self.dst_kind == K_MEM or self.src_kind == K_MEM


# Field order for array packing (machine.py / exec.py rely on this).
INT_FIELDS = (
    "opc", "sub", "cond", "length", "opsize", "srcsize", "sext",
    "dst_kind", "dst_reg", "src_kind", "src_reg",
    "base_reg", "idx_reg", "scale", "seg", "rep", "lock", "a32",
)
U64_FIELDS = ("disp", "imm")
