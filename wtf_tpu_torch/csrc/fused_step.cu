// The fused interpreter step for NVIDIA Hopper (sm_90a).
//
// Replaces wtf_tpu/interp/pstep.py::_build_kernel (the Pallas kernel the
// JAX package launches through fused_call_impl): every lane advances up to
// k_steps x86-64 instructions of the hot integer subset in one launch.
// Per step, in order: the decode-cache probe (low 32 bits of splitmix64 of
// the tenant-tagged key, plus k, masked; first live match of 8 probes),
// the breakpoint / bp_skip gate, the hot-opclass test, the SMC compare of
// the live code bytes (through the overlay) against the decode-time raw
// bytes, the effective address with fs/gs and a32, the 4-level page walks
// through the lane overlay (1G/2M pages, no A/D bits), the 3-word operand
// windows, the execute of MOV/LEA/ALU/UNARY/SHIFT/MUL/SETCC/CMOVCC/JCC/JMP/
// PUSH/POP/CALL/RET, the store into the lane overlay, and the icount /
// limit, coverage, edge and counter bookkeeping.  A lane parks (status
// NEEDS_XLA) BEFORE any state changes when the kernel cannot retire its
// next instruction; CTR_PARK_SUBSET and CTR_PARK_MEM count the two causes.
// The Python plain version is wtf_tpu_torch/interp/pstep.py
// fused_step_plain; chip_smoke.py holds the two bit-identical.
//
// Design.  One thread per lane, the K-step loop inside the thread, native
// 64-bit arithmetic on the int64 planes (the TPU kernel's u32 limbs exist
// only because Pallas on a TPU has no 64-bit integers).  The 13 state
// planes are updated in place in the tensors the runner holds, which is
// what the JAX kernel's input_output_aliases approximates; nothing is
// copied through.  A lane stops at the first step that changes its status,
// which is the same function as the JAX kernel's masked fori_loop.
//
// What bounds it.  Per step a lane touches a few hundred bytes: the hash
// rows and the uop row, up to 6 walks x 4 page-table words, 9 window words
// and up to 3 stored words, and for each of those words a linear scan of
// its overlay row index (slots x 4 bytes).  The accesses are dependent
// gathers from one thread per lane, so the kernel is latency-bound, far
// from both the card's memory rate and its integer rate.  Block size and
// occupancy are later work: at 4096 lanes with 128-thread blocks only 32
// blocks exist for 132 SMs, so the launch uses 64-thread blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "wtf_consts.h"

typedef uint64_t u64;
typedef int64_t i64;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint8_t u8;

#define PAGE_WORDS 512
#define PFN_OOB 0x7FFFFFFF
#define PHYS_MASK 0x000FFFFFFFFFF000ull
#define PHYS_MASK_1G 0x000FFFFFC0000000ull
#define PHYS_MASK_2M 0x000FFFFFFFE00000ull
#define FLAG_CF 0x1ull
#define FLAG_PF 0x4ull
#define FLAG_AF 0x10ull
#define FLAG_ZF 0x40ull
#define FLAG_SF 0x80ull
#define FLAG_OF 0x800ull
#define FLAGS_ARITH (FLAG_CF | FLAG_PF | FLAG_AF | FLAG_ZF | FLAG_SF | FLAG_OF)

struct Args {
  const i32* hash_tab; int hash_size;
  const i32* meta_i32; int meta_cols;
  const u64* meta_u64;
  const u64* pages;
  const i32* frame_table; int nframes;
  const i32* tenant; const u64* cr3; const u64* fs; const u64* gs;
  u64* gpr; u64* rip; u64* rflags; i32* status; u64* icount; i32* bp_skip;
  u32* ctr; u32* cov; int cov_words; u32* edge; int edge_words;
  i32* ov_pfn; u64* ov_data; u8* ov_valid; i32* ov_count; int slots;
  u64 limit; int n_lanes; int k_steps;
};

// ---- 64-bit helpers (counts >= 64 shift everything out; C++ leaves them
// undefined, so every variable shift goes through these) -----------------

__device__ __forceinline__ u64 shl(u64 a, u64 s) { return s >= 64 ? 0 : a << s; }
__device__ __forceinline__ u64 shr(u64 a, u64 s) { return s >= 64 ? 0 : a >> s; }
__device__ __forceinline__ u64 sar(u64 a, u64 s) {
  return (u64)((i64)a >> (s > 63 ? 63 : s));
}
__device__ __forceinline__ u64 size_mask(i64 n) {
  if (n >= 8) return ~0ull;
  if (n <= 0) return 0;
  return (1ull << (8 * n)) - 1;
}
__device__ __forceinline__ u64 zext(u64 a, i64 n) { return a & size_mask(n); }
__device__ __forceinline__ u64 sext(u64 a, i64 n) {
  if (n >= 8) return a;
  i64 bits = (n < 0 ? 0 : (n > 4 ? 4 : n)) * 8;
  if (bits == 0) return 0;
  int sh = 64 - (int)bits;
  return (u64)(((i64)(a << sh)) >> sh);
}
__device__ __forceinline__ bool msb(u64 a, i64 n) {
  if (n <= 0) return false;
  int bit = n >= 8 ? 63 : (int)((n > 4 ? 4 : n) * 8 - 1);
  return (a >> bit) & 1;
}
__device__ __forceinline__ bool parity_even(u64 r) {
  return (__popc((u32)(r & 0xFF)) & 1) == 0;
}
__device__ __forceinline__ u64 mkflags(bool cf, bool pf, bool af, bool zf,
                                       bool sf, bool of) {
  return (cf ? FLAG_CF : 0) | (pf ? FLAG_PF : 0) | (af ? FLAG_AF : 0) |
         (zf ? FLAG_ZF : 0) | (sf ? FLAG_SF : 0) | (of ? FLAG_OF : 0);
}
__device__ __forceinline__ u64 flags_add(u64 a, u64 b, u64 r, i64 n, bool carry) {
  u64 am = zext(a, n), rm = zext(r, n);
  bool cf = rm < am || (carry && rm == am);
  return mkflags(cf, parity_even(rm), ((a ^ b ^ r) & 0x10) != 0, rm == 0,
                 msb(rm, n), msb((a ^ r) & (b ^ r), n));
}
__device__ __forceinline__ u64 flags_sub(u64 a, u64 b, u64 r, i64 n, bool borrow) {
  u64 am = zext(a, n), bm = zext(b, n), rm = zext(r, n);
  bool cf = borrow ? am <= bm : am < bm;
  return mkflags(cf, parity_even(rm), ((a ^ b ^ r) & 0x10) != 0, rm == 0,
                 msb(rm, n), msb((a ^ b) & (a ^ r), n));
}
__device__ __forceinline__ u64 flags_logic(u64 r, i64 n) {
  u64 rm = zext(r, n);
  return mkflags(false, parity_even(rm), false, rm == 0, msb(rm, n), false);
}
__device__ __forceinline__ u64 mix64(u64 z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}
__device__ __forceinline__ u64 splitmix64(u64 x) { return mix64(x + 0x9E3779B97F4A7C15ull); }

__device__ __forceinline__ bool eval_cond(u64 rf, u64 rcx, i64 cc) {
  bool cf = rf & FLAG_CF, pf = rf & FLAG_PF, zf = rf & FLAG_ZF;
  bool sf = rf & FLAG_SF, of = rf & FLAG_OF;
  if (cc == 16) return rcx == 0;
  if (cc == 17) return (rcx & 0xFFFFFFFFull) == 0;
  switch (cc < 0 ? 0 : (cc > 15 ? 15 : cc)) {
    case 0: return of;           case 1: return !of;
    case 2: return cf;           case 3: return !cf;
    case 4: return zf;           case 5: return !zf;
    case 6: return cf || zf;     case 7: return !(cf || zf);
    case 8: return sf;           case 9: return !sf;
    case 10: return pf;          case 11: return !pf;
    case 12: return sf != of;    case 13: return sf == of;
    case 14: return zf || (sf != of);
    default: return !zf && (sf == of);
  }
}

// ---- register file -------------------------------------------------------

__device__ __forceinline__ u64 read64(const u64* g, i64 idx) {
  return (idx >= 0 && idx < 16) ? g[idx] : 0;
}
__device__ __forceinline__ u64 read_reg(const u64* g, i64 idx, i64 n) {
  bool high = idx >= REG_AH_BASE;
  i64 b = high ? idx - REG_AH_BASE : idx;
  b = b < 0 ? 0 : (b > 15 ? 15 : b);
  u64 v = g[b];
  return high ? (v >> 8) & 0xFF : zext(v, n);
}
// partial-register merge of cpu/emu.py write_reg: 32-bit writes
// zero-extend, 8/16-bit writes merge, AH-view writes hit bits 15:8
__device__ __forceinline__ void gpr_write(u64* g, i64 idx, u64 val, i64 n) {
  bool high = idx >= REG_AH_BASE;
  i64 b = high ? idx - REG_AH_BASE : idx;
  b = b < 0 ? 0 : (b > 15 ? 15 : b);
  u64 old = g[b], m = size_mask(n);
  if (high) g[b] = (old & ~0xFF00ull) | ((val & 0xFF) << 8);
  else if (n >= 8) g[b] = val;
  else if (n == 4) g[b] = val & 0xFFFFFFFFull;
  else g[b] = (old & ~m) | (val & m);
}

// ---- the integer classes (mirroring step.alu/unary/shift/mul) --------------

__device__ void do_alu(i64 sub, u64 a, u64 b, bool cf_in, i64 n, u64 rf,
                       u64* r_out, u64* rf_out, bool* writes) {
  u64 r;
  switch (sub) {
    case ALU_ADD: r = zext(a + b, n); break;
    case ALU_ADC: r = zext(a + b + (cf_in ? 1 : 0), n); break;
    case ALU_SUB: case ALU_CMP: r = zext(a - b, n); break;
    case ALU_SBB: r = zext(a - b - (cf_in ? 1 : 0), n); break;
    case ALU_AND: case ALU_TEST: r = a & b; break;
    case ALU_OR: r = a | b; break;
    case ALU_XOR: r = a ^ b; break;
    default: r = 0;
  }
  u64 fl;
  if (sub == ALU_ADD || sub == ALU_ADC)
    fl = flags_add(a, b, r, n, sub == ALU_ADC && cf_in);
  else if (sub == ALU_SUB || sub == ALU_SBB || sub == ALU_CMP)
    fl = flags_sub(a, b, r, n, sub == ALU_SBB && cf_in);
  else
    fl = flags_logic(r, n);
  *r_out = r;
  *rf_out = (rf & ~FLAGS_ARITH) | fl;
  *writes = !(sub == ALU_CMP || sub == ALU_TEST);
}

__device__ void do_unary(i64 sub, u64 a, bool cf_in, i64 n, u64 rf,
                         u64* r_out, u64* rf_out) {
  u64 r_inc = zext(a + 1, n), r_dec = zext(a - 1, n);
  u64 r_neg = zext(0 - a, n), r_not = zext(~a, n);
  u64 r = sub == UN_INC ? r_inc : sub == UN_DEC ? r_dec :
          sub == UN_NOT ? r_not : sub == UN_NEG ? r_neg : 0;
  u64 fl = sub == UN_INC ? flags_add(a, 1, r_inc, n, false) :
           sub == UN_DEC ? flags_sub(a, 1, r_dec, n, false) :
                           flags_sub(0, a, r_neg, n, false);
  bool cf = (sub == UN_INC || sub == UN_DEC) ? cf_in : zext(a, n) != 0;
  *r_out = r;
  *rf_out = sub == UN_NOT ? rf
      : (rf & ~FLAGS_ARITH) | (fl & ~FLAG_CF) | (cf ? FLAG_CF : 0);
}

__device__ void do_shift(i64 sub, i64 sext_f, u64 a, u64 filler, u64 cl,
                         u64 src, u64 imm, bool cf_in, i64 n, u64 rf,
                         u64* r_out, u64* rf_out, bool* writes) {
  // counts are u32 quantities, as in shift_limb
  u32 bits = (u32)n * 8;
  bool is_shxd = sub == SH_SHLD || sub == SH_SHRD;
  u32 cnt_src = is_shxd ? (sext_f == 3 ? (u32)imm : (u32)(cl & 0xFF)) : (u32)src;
  u32 count = cnt_src & (n >= 8 ? 0x3Fu : 0x1Fu);
  bool is_rc = sub == SH_RCL || sub == SH_RCR;
  // x % 0 == x, as XLA's unsigned remainder (bits is 0 only for uops that
  // are not shifts, so this never decides a result)
  if (is_rc) count = count % (bits + 1);
  if (is_shxd && count > bits && bits != 0) count = count % bits;
  bool cnz = count != 0;
  u64 am = zext(a, n), sa = sext(a, n);
  u64 cf01 = cf_in ? 1 : 0;
  u32 c1m = count - 1;
  u32 bmc = bits - count;
  u32 rot_c = bits != 0 ? count % bits : count;
  u64 r = 0;
  bool cf = false;
  u64 rol_r = rot_c == 0 ? am : zext(shl(am, rot_c) | shr(am, bits - rot_c), n);
  u64 ror_r = rot_c == 0 ? am : zext(shr(am, rot_c) | shl(am, bits - rot_c), n);
  u64 shld_r = zext(shl(am, count) | shr(filler, bmc), n);
  u64 shrd_r = zext(shr(am, count) | shl(filler, bmc), n);
  switch (sub) {
    case SH_SHL: case SH_SAL:
      r = zext(shl(am, count), n);
      cf = count <= bits && (shr(am, bmc) & 1);
      break;
    case SH_SHR:
      r = shr(am, count);
      cf = count <= bits && (shr(am, c1m) & 1);
      break;
    case SH_SAR:
      r = zext(sar(sa, count), n);
      cf = sar(sa, c1m) & 1;
      break;
    case SH_ROL: r = rol_r; cf = rol_r & 1; break;
    case SH_ROR: r = ror_r; cf = msb(ror_r, n); break;
    case SH_RCL:
      r = zext(shl(am, count) | shl(cf01, c1m) |
               (count > 1 ? shr(am, (u64)bits + 1 - count) : 0), n);
      cf = cnz ? (shr(am, bmc) & 1) : cf_in;
      break;
    case SH_RCR:
      r = zext(shr(am, count) | shl(cf01, bmc) |
               (count > 1 ? shl(am, (u64)bits + 1 - count) : 0), n);
      cf = cnz ? (shr(am, c1m) & 1) : cf_in;
      break;
    case SH_SHLD: r = shld_r; cf = shr(am, bmc) & 1; break;
    case SH_SHRD: r = shrd_r; cf = shr(am, c1m) & 1; break;
    default: r = 0; cf = false;
  }
  bool count1 = count == 1;
  bool of_keep = (rf & FLAG_OF) != 0;
  bool r_msb = msb(r, n), am_msb = msb(am, n);
  bool ror_b2 = shr(ror_r, (u32)(bits - 2)) & 1;
  bool of;
  switch (sub) {
    case SH_SHL: case SH_SAL: case SH_ROL: case SH_RCL:
      of = count1 ? r_msb != cf : of_keep; break;
    case SH_SHR: of = count1 ? am_msb : of_keep; break;
    case SH_SAR: of = count1 ? false : of_keep; break;
    case SH_ROR: of = count1 ? r_msb != ror_b2 : of_keep; break;
    case SH_RCR: of = count1 ? am_msb != cf_in : of_keep; break;
    case SH_SHLD: of = count1 ? msb(shld_r ^ am, n) : false; break;
    case SH_SHRD: of = count1 ? msb(shrd_r ^ am, n) : false; break;
    default: of = of_keep;
  }
  u64 full = mkflags(cf, parity_even(r), false, r == 0, r_msb, of);
  u64 mask = is_rc ? (FLAG_CF | FLAG_OF)
                   : (FLAG_CF | FLAG_OF | FLAG_ZF | FLAG_SF | FLAG_PF);
  *r_out = r;
  *rf_out = cnz ? (rf & ~mask) | (full & mask) : rf;
  *writes = cnz;
}

__device__ void do_mul(i64 sub, i64 sext_f, u64 a, u64 b, u64 rax, u64 imm,
                       i64 n, u64 rf, u64* w1, u64* w2, u64* rf_out) {
  u64 bits = (u64)n * 8;
  bool wide = n >= 8;
  u64 sb = sext(b, n);
  bool is_mul2 = sub == MUL_2OP;
  u64 mul2_a = sext_f == 2 ? b : a;
  u64 mul2_b = sext_f == 2 ? zext(imm, n) : b;
  u64 m2sa = sext(mul2_a, n), m2sb = sext(mul2_b, n);
  u64 m2_full = m2sa * m2sb;
  u64 mul2_lo = zext(m2_full, n);
  bool mul2_of = wide
      ? (u64)__mul64hi((i64)m2sa, (i64)m2sb) != (u64)((i64)mul2_lo >> 63)
      : m2_full != sext(mul2_lo, n);
  u64 muw_full_u = rax * b;
  u64 muw_u_lo = wide ? muw_full_u : zext(muw_full_u, n);
  u64 muw_u_hi = wide ? __umul64hi(rax, b) : zext(shr(muw_full_u, bits), n);
  u64 sax = sext(rax, n);
  u64 muw_full_s = sax * sb;
  u64 muw_s_small = zext(muw_full_s, n);
  u64 muw_s_hi64 = (u64)__mul64hi((i64)sax, (i64)sb);
  u64 muw_s_lo = wide ? muw_full_s : muw_s_small;
  u64 muw_s_hi = wide ? muw_s_hi64 : zext(shr(muw_full_s, bits), n);
  bool muw_s_of = wide ? muw_s_hi64 != (u64)((i64)muw_full_s >> 63)
                       : muw_full_s != sext(muw_s_small, n);
  bool signed_ = sub == MUL_WIDE_S;
  u64 muw_lo = signed_ ? muw_s_lo : muw_u_lo;
  u64 muw_hi = signed_ ? muw_s_hi : muw_u_hi;
  bool muw_of = signed_ ? muw_s_of : muw_u_hi != 0;
  bool mul_of = is_mul2 ? mul2_of : muw_of;
  u64 prod16 = (signed_ ? muw_full_s : muw_full_u) & 0xFFFF;
  *w1 = is_mul2 ? mul2_lo : (n == 1 ? prod16 : muw_lo);
  *w2 = muw_hi;
  *rf_out = is_mul2
      ? (rf & ~FLAGS_ARITH) | mkflags(mul_of, parity_even(mul2_lo), false,
                                      false, msb(mul2_lo, n), mul_of)
      : (rf & ~(FLAG_CF | FLAG_OF)) | (mul_of ? (FLAG_CF | FLAG_OF) : 0);
}

// ---- memory: the lane's overlay over the shared image ---------------------

struct Lane {
  const u64* pages;  // the shared image [image slots, PAGE_WORDS]
  int nframes;
  const i32* pfns;   // [slots]
  u64* data;         // [slots, PAGE_WORDS]
  u8* valid;         // [slots, PAGE_WORDS]
  const i32* ftab;   // the lane's tenant row of the frame table
  int slots;

  // the FIRST row holding pfn (row 0 on a miss; unused then)
  __device__ int lookup(i32 pfn, bool* hit) const {
    for (int s = 0; s < slots; ++s)
      if (pfns[s] == pfn) { *hit = true; return s; }
    *hit = false;
    return 0;
  }
  __device__ i64 slot_of(i32 pfn) const {
    return (pfn >= 0 && pfn < nframes) ? ftab[pfn] : 0;
  }
  __device__ i32 pfn_of(u64 addr) const {
    u64 p = addr >> 12;
    return p < (u64)nframes ? (i32)p : PFN_OOB;
  }
  // one overlay-aware aligned word: the overlay word when the row is hit
  // and its valid byte is set, else the image word
  __device__ u64 read_word(i32 pfn, int widx) const {
    bool hit;
    int row = lookup(pfn, &hit);
    if (hit && valid[(i64)row * PAGE_WORDS + widx])
      return data[(i64)row * PAGE_WORDS + widx];
    return pages[slot_of(pfn) * PAGE_WORDS + widx];
  }
  // 16 bytes at page offset off of frame pfn_a, straddling into pfn_b
  __device__ void win16(i32 pfn_a, i32 pfn_b, u64 off, u64* lo, u64* hi) const {
    int w0 = (int)(off >> 3);
    u64 w[3];
    for (int j = 0; j < 3; ++j) {
      bool on_first = w0 + j < PAGE_WORDS;
      w[j] = read_word(on_first ? pfn_a : pfn_b,
                       on_first ? w0 + j : w0 + j - PAGE_WORDS);
    }
    u64 sh = (off & 7) * 8, inv = 64 - sh;
    *lo = shr(w[0], sh) | shl(w[1], inv);
    *hi = shr(w[1], sh) | shl(w[2], inv);
  }
  __device__ u64 load8(u64 gpa0, u64 gpa1) const {
    u64 lo, hi;
    win16(pfn_of(gpa0), pfn_of(gpa1), gpa0 & 0xFFF, &lo, &hi);
    return lo;
  }
  // the 4-level long-mode walk (translate_vec_l's semantics)
  __device__ u64 walk(u64 cr3, u64 gva, bool* ok_out, bool* w_out) const {
    u64 top = gva >> 47;
    bool ok = top == 0 || top == 0x1FFFF;
    bool writable = true, done = false;
    u64 gpa = 0, table = cr3 & PHYS_MASK;
    const int shifts[4] = {39, 30, 21, 12};
    for (int lv = 0; lv < 4; ++lv) {
      int shift = shifts[lv];
      u64 addr = table + ((gva >> shift) & 0x1FF) * 8;
      u64 entry = read_word(pfn_of(addr), (int)((addr & 0xFFF) >> 3));
      bool present = entry & 1;
      ok = ok && (done || present);
      writable = writable && (done || (entry & 2));
      if (lv == 1 || lv == 2) {
        bool is_large = present && (entry & 0x80) && !done;
        if (is_large) {
          u64 lmask = lv == 1 ? PHYS_MASK_1G : PHYS_MASK_2M;
          gpa = (entry & lmask) | (gva & ((1ull << shift) - 1));
          done = true;
        }
      }
      if (lv == 3 && !done) gpa = (entry & PHYS_MASK) | (gva & 0xFFF);
      table = entry & PHYS_MASK;
    }
    *ok_out = ok;
    *w_out = writable;
    return gpa;
  }
};

// ---- the kernel --------------------------------------------------------------

__global__ void __launch_bounds__(256) fused_step_kernel(Args args) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= args.n_lanes) return;
  const Args& A = args;
  Lane L;
  L.pages = A.pages;
  L.nframes = A.nframes;
  L.slots = A.slots;
  L.pfns = A.ov_pfn + (i64)lane * A.slots;
  L.data = A.ov_data + (i64)lane * A.slots * PAGE_WORDS;
  L.valid = A.ov_valid + (i64)lane * A.slots * PAGE_WORDS;
  const i32 tenant = A.tenant[lane];
  L.ftab = A.frame_table + (i64)tenant * A.nframes;
  i32* pfns_w = A.ov_pfn + (i64)lane * A.slots;
  const u64 cr3 = A.cr3[lane], fs = A.fs[lane], gs = A.gs[lane];
  const u64 ttag = (u64)(u32)tenant << 48;
  const int hmask = A.hash_size - 1;
  const int ebits = A.edge_words * 32;

  u64 g[16];
  for (int i = 0; i < 16; ++i) g[i] = A.gpr[(i64)lane * 16 + i];
  u64 rip = A.rip[lane], rf = A.rflags[lane], ic = A.icount[lane];
  i32 status = A.status[lane], bpskip = A.bp_skip[lane];
  i32 count = A.ov_count[lane];
  u32* cov = A.cov + (i64)lane * A.cov_words;
  u32* edge = A.edge + (i64)lane * A.edge_words;
  u32 d_instr = 0, d_miss = 0, d_ps = 0, d_pm = 0;

  for (int step = 0; step < A.k_steps && status == ST_RUNNING; ++step) {
    // 1. decode-cache probe
    const u64 key = rip ^ ttag;
    const u32 h_lo = (u32)splitmix64(key);
    int idx = -1;
    for (int k = 0; k < PROBES; ++k) {
      const i32* row = A.hash_tab + (i64)((h_lo + (u32)k) & (u32)hmask) * 3;
      if (row[0] >= 0 && (u32)row[1] == (u32)key && (u32)row[2] == (u32)(key >> 32)) {
        idx = row[0];
        break;
      }
    }
    if (idx < 0) { status = ST_NEED_DECODE; ++d_miss; break; }
    const i32* f = A.meta_i32 + (i64)idx * A.meta_cols;
    const u64* mu = A.meta_u64 + (i64)idx * 4;
    const i64 opc = f[F_OPC], sub = f[F_SUB], cond = f[F_COND];
    const i64 length = f[F_LENGTH], opsize = f[F_OPSIZE];
    const i64 sext_f = f[F_SEXT];
    const i64 dk = f[F_DST_KIND], dr = f[F_DST_REG];
    const i64 sk = f[F_SRC_KIND], sr = f[F_SRC_REG];
    const i64 srcsize = f[F_SRCSIZE] == 0 ? opsize : f[F_SRCSIZE];
    const u64 disp = mu[MU_DISP], imm = mu[MU_IMM];

    // 2-3. breakpoint gate, hot-subset eligibility: park before anything
    const bool at_bp = f[M_BP] == 1 && bpskip == 0;
    const bool is_mov = opc == OPC_MOV, is_lea = opc == OPC_LEA;
    const bool is_alu = opc == OPC_ALU, is_shift = opc == OPC_SHIFT;
    const bool is_mul = opc == OPC_MUL, is_unary = opc == OPC_UNARY;
    const bool is_setcc = opc == OPC_SETCC, is_cmov = opc == OPC_CMOVCC;
    const bool is_jcc = opc == OPC_JCC, is_jmp = opc == OPC_JMP;
    const bool is_push = opc == OPC_PUSH, is_pop = opc == OPC_POP;
    const bool is_call = opc == OPC_CALL, is_ret = opc == OPC_RET;
    const bool hot = opc == OPC_NOP || opc == OPC_FENCE || is_mov || is_lea ||
        is_alu || is_shift || is_mul || is_unary || is_setcc || is_cmov ||
        is_jcc || is_jmp || is_push || is_pop || is_call || is_ret;
    if (at_bp || !hot) { status = ST_NEEDS_XLA; ++d_ps; break; }

    // 4b. SMC: live code bytes (through the overlay) vs decode-time raw
    {
      const u64 code_off = rip & 0xFFF;
      const bool crosses = code_off + 16 > 4096;
      u64 lo, hi;
      L.win16(f[M_PFN0], crosses ? f[M_PFN1] : f[M_PFN0], code_off, &lo, &hi);
      const u64 lm_lo = size_mask(length < 8 ? length : 8);
      const u64 lm_hi = size_mask(length - 8 > 0 ? length - 8 : 0);
      if (((lo ^ mu[MU_RAW_LO]) & lm_lo) || ((hi ^ mu[MU_RAW_HI]) & lm_hi)) {
        status = ST_NEEDS_XLA; ++d_ps; break;
      }
    }

    // 4. addresses
    const u64 next_rip = rip + (u64)length;
    const i64 breg = f[F_BASE_REG];
    const u64 base_val = breg == REG_RIP ? next_rip : read64(g, breg);
    const i64 scale = f[F_SCALE];
    const u64 iv = read64(g, f[F_IDX_REG]);
    const u64 idx_val = scale == 0 ? 0 : iv << (scale == 2 ? 1 : scale == 4 ? 2 : scale == 8 ? 3 : 0);
    const u64 seg = f[F_SEG] == SEG_FS ? fs : (f[F_SEG] == SEG_GS ? gs : 0);
    u64 flat = disp + base_val + idx_val;
    if (f[F_A32] != 0) flat &= 0xFFFFFFFFull;
    const u64 ea = flat + seg;
    const u64 rsp = g[4];
    const i64 push_size = is_call ? 8 : opsize;

    // 4a/4c. operand walks and loads (only where their values are used)
    bool park_mem = false;
    u64 l1 = 0, l2 = 0;
    if (sk == K_MEM || is_pop || is_ret) {
      const u64 addr = (is_pop || is_ret) ? rsp : ea;
      const i64 size = is_ret ? 8 : (is_pop ? opsize : srcsize);
      bool ok0, ok1, w;
      const u64 g0 = L.walk(cr3, addr, &ok0, &w);
      const u64 g1 = L.walk(cr3, addr + (u64)(size - 1), &ok1, &w);
      park_mem |= !(ok0 && ok1);
      l1 = L.load8(g0, g1);
    }
    if (dk == K_MEM) {
      bool ok0, ok1, w;
      const u64 g0 = L.walk(cr3, ea, &ok0, &w);
      const u64 g1 = L.walk(cr3, ea + (u64)(opsize - 1), &ok1, &w);
      if (is_alu || is_shift || is_unary) park_mem |= !(ok0 && ok1);
      l2 = L.load8(g0, g1);
    }

    // 5. execute
    const u64 src_raw = sk == K_REG ? read_reg(g, sr, srcsize)
                        : (sk == K_MEM ? zext(l1, srcsize) : 0);
    const u64 src_ext = sext_f == 1 ? zext(sext(src_raw, srcsize), opsize)
                                    : zext(src_raw, opsize);
    const u64 src_val = sk == K_IMM ? zext(imm, opsize) : src_ext;
    const u64 dst_val = dk == K_REG ? read_reg(g, dr, opsize)
                        : (dk == K_MEM ? zext(l2, opsize) : 0);
    const bool cf_in = rf & FLAG_CF;
    u64 r = 0, new_rf = rf, w2v = 0;
    bool writes = true;
    if (is_alu) do_alu(sub, dst_val, src_val, cf_in, opsize, rf, &r, &new_rf, &writes);
    else if (is_unary) do_unary(sub, dst_val, cf_in, opsize, rf, &r, &new_rf);
    else if (is_shift)
      do_shift(sub, sext_f, dst_val, read_reg(g, sr, opsize), g[1], src_val,
               imm, cf_in, opsize, rf, &r, &new_rf, &writes);
    else if (is_mul)
      do_mul(sub, sext_f, dst_val, src_val, read_reg(g, 0, opsize), imm,
             opsize, rf, &r, &w2v, &new_rf);
    const bool cc = eval_cond(rf, g[1], cond);
    const u64 jcc_t = next_rip + imm;
    const u64 pop_val = zext(l1, opsize);

    // 5a. store plan + the memory park decision (before any mutation)
    const bool mem_writes = is_mov || (is_alu && writes) ||
        (is_shift && writes) || is_unary || is_setcc || is_pop;
    const bool st_need = (dk == K_MEM && mem_writes) || is_push || is_call;
    const u64 st_addr = (is_push || is_call) ? rsp - (u64)push_size : ea;
    u64 stg0 = 0, s_off = 0;
    i32 s_pfn0 = 0, s_pfn1 = 0;
    bool crosses = false, hit0 = false, hit1 = false, st_alias = false;
    int row0 = 0, row1 = 0;
    if (st_need) {
      bool ok0, ok1, w0, w1;
      stg0 = L.walk(cr3, st_addr, &ok0, &w0);
      const u64 stg1 = L.walk(cr3, st_addr + (u64)(push_size - 1), &ok1, &w1);
      s_off = stg0 & 0xFFF;
      crosses = s_off + (u64)push_size > 4096;
      s_pfn0 = L.pfn_of(stg0);
      s_pfn1 = L.pfn_of(stg1);
      row0 = L.lookup(s_pfn0, &hit0);
      row1 = L.lookup(s_pfn1, &hit1);
      // aliased mappings: a page crossing can land both halves on ONE
      // frame — the second half then reuses the first's row
      st_alias = s_pfn1 == s_pfn0;
      const bool oob = s_pfn0 == PFN_OOB || (crosses && s_pfn1 == PFN_OOB);
      const int need_new = (hit0 ? 0 : 1) + ((crosses && !hit1 && !st_alias) ? 1 : 0);
      const bool can_alloc = count + need_new <= A.slots;
      park_mem |= !(ok0 && ok1 && w0 && w1) || oob || !can_alloc;
    }
    if (park_mem) { status = ST_NEEDS_XLA; ++d_pm; break; }

    // commit
    u64 rip_exec = next_rip;
    if (is_jmp || is_call) rip_exec = sk == K_IMM ? jcc_t : src_val;
    else if (is_jcc) rip_exec = cc ? jcc_t : next_rip;
    else if (is_ret) rip_exec = l1;

    // 5b. store: claim rows (clearing validity), then the <= 8-byte masked
    // read-modify-write over three words
    if (st_need) {
      const bool alloc0 = !hit0;
      const int rowa = alloc0 ? count : row0;
      if (alloc0) {
        pfns_w[rowa] = s_pfn0;
        for (int w = 0; w < PAGE_WORDS; ++w) L.valid[(i64)rowa * PAGE_WORDS + w] = 0;
      }
      const int cnt1 = count + (alloc0 ? 1 : 0);
      const bool alloc1 = crosses && !hit1 && !st_alias;
      const int rowb = alloc1 ? cnt1 : ((crosses && hit1) ? row1 : rowa);
      if (alloc1) {
        pfns_w[rowb] = s_pfn1;
        for (int w = 0; w < PAGE_WORDS; ++w) L.valid[(i64)rowb * PAGE_WORDS + w] = 0;
      }
      count = cnt1 + (alloc1 ? 1 : 0);
      u64 st_val = 0;
      if (is_mov || is_push) st_val = src_val;
      else if (is_alu || is_shift || is_unary) st_val = r;
      else if (is_setcc) st_val = cc ? 1 : 0;
      else if (is_pop) st_val = pop_val;
      else if (is_call) st_val = next_rip;
      const u64 sh = (s_off & 7) * 8;
      const u64 end_bit = sh + (u64)push_size * 8;
      const u64 v[3] = {shl(st_val, sh), shr(st_val, 64 - sh), 0};
      const int w0i = (int)(s_off >> 3);
      for (int j = 0; j < 3; ++j) {
        const u64 lo_bit = 64 * j;
        const u64 start_in = sh > lo_bit ? sh : lo_bit;
        const u64 end_in = end_bit < lo_bit + 64 ? end_bit : lo_bit + 64;
        const bool has = end_in > start_in;
        const u64 n_bits = has ? end_in - start_in : 0;
        const u64 off_in = has ? start_in - lo_bit : 0;
        // n_bits == 64 wraps (1 << 64 -> 0) to the all-ones mask
        const u64 mask = shl(shl(1, n_bits) - 1, off_in);
        const bool on_first = w0i + j < PAGE_WORDS;
        const int widx = on_first ? w0i + j : w0i + j - PAGE_WORDS;
        const int row = on_first ? rowa : rowb;
        const i64 at = (i64)row * PAGE_WORDS + widx;
        const u8 vbyte = L.valid[at];
        const u64 old = vbyte ? L.data[at]
            : A.pages[L.slot_of(on_first ? s_pfn0 : s_pfn1) * PAGE_WORDS + widx];
        L.data[at] = (old & ~mask) | (v[j] & mask);
        if (mask) L.valid[at] = vbyte | 1;
      }
    }

    // 5c. register writes in the precise step's order: rsp, aux, primary
    if (is_push || is_call) gpr_write(g, 4, rsp - (u64)push_size, 8);
    else if (is_pop) gpr_write(g, 4, rsp + (u64)opsize, 8);
    else if (is_ret) gpr_write(g, 4, rsp + 8 + imm, 8);
    const bool is_mul2 = sub == MUL_2OP;
    if (is_mul && !is_mul2 && opsize > 1) gpr_write(g, 2, w2v, opsize);
    const bool dk_reg = dk == K_REG;
    bool w1_cond = false;
    u64 w1_val = 0;
    if (is_mov) { w1_cond = dk_reg; w1_val = src_val; }
    else if (is_lea) { w1_cond = true; w1_val = ea; }
    else if (is_alu || is_shift) { w1_cond = writes && dk_reg; w1_val = r; }
    else if (is_unary) { w1_cond = dk_reg; w1_val = r; }
    else if (is_mul) { w1_cond = true; w1_val = r; }
    else if (is_pop) { w1_cond = dk_reg; w1_val = pop_val; }
    else if (is_setcc) { w1_cond = dk_reg; w1_val = cc ? 1 : 0; }
    else if (is_cmov) { w1_cond = true; w1_val = cc ? src_val : dst_val; }
    if (w1_cond) {
      const i64 w1_idx = is_mul ? (is_mul2 ? dr : 0) : dr;
      const i64 w1_size = is_mul ? (is_mul2 ? opsize : (opsize == 1 ? 2 : opsize))
                                 : opsize;
      gpr_write(g, w1_idx, w1_val, w1_size);
    }

    // 5d. rflags (bits 32+ pass through) / rip
    const u64 rf_cand = (is_alu || is_unary || is_shift || is_mul) ? new_rf : rf;
    rf = (rf & 0xFFFFFFFF00000000ull) | ((rf_cand | 0x2) & 0xFFFFFFFFull);
    const u64 prev_rip = rip;
    rip = rip_exec;

    // 6. bookkeeping: icount/limit, counters, coverage, edges
    ++ic;
    ++d_instr;
    bpskip = 0;
    cov[idx >> 5] |= 1u << (idx & 31);
    if (is_jmp || is_jcc || is_call || is_ret) {
      const u32 ei = ((u32)mix64(prev_rip) ^ (u32)rip_exec) & (u32)(ebits - 1);
      edge[ei >> 5] |= 1u << (ei & 31);
    }
    if (A.limit != 0 && !(ic < A.limit)) { status = ST_TIMEDOUT; break; }
  }

  for (int i = 0; i < 16; ++i) A.gpr[(i64)lane * 16 + i] = g[i];
  A.rip[lane] = rip;
  A.rflags[lane] = rf;
  A.icount[lane] = ic;
  A.status[lane] = status;
  A.bp_skip[lane] = bpskip;
  A.ov_count[lane] = count;
  u32* c = A.ctr + (i64)lane * N_CTRS;
  c[CTR_INSTR] += d_instr;
  c[CTR_DECODE_MISS] += d_miss;
  c[CTR_FUSED] += d_instr;  // every kernel-retired instruction is fused
  c[CTR_PARK_SUBSET] += d_ps;
  c[CTR_PARK_MEM] += d_pm;
}

extern "C" int wtf_fused_step(
    const void* hash_tab, int hash_size, const void* meta_i32, int meta_cols,
    const void* meta_u64, const void* pages, const void* frame_table,
    int nframes, const void* tenant, const void* cr3, const void* fs,
    const void* gs, void* gpr, void* rip, void* rflags, void* status,
    void* icount, void* bp_skip, void* ctr, void* cov, int cov_words,
    void* edge, int edge_words, void* ov_pfn, void* ov_data, void* ov_valid,
    void* ov_count, int slots, int64_t limit, int n_lanes, int k_steps,
    int block, void* stream) {
  Args a;
  a.hash_tab = (const i32*)hash_tab; a.hash_size = hash_size;
  a.meta_i32 = (const i32*)meta_i32; a.meta_cols = meta_cols;
  a.meta_u64 = (const u64*)meta_u64; a.pages = (const u64*)pages;
  a.frame_table = (const i32*)frame_table; a.nframes = nframes;
  a.tenant = (const i32*)tenant; a.cr3 = (const u64*)cr3;
  a.fs = (const u64*)fs; a.gs = (const u64*)gs;
  a.gpr = (u64*)gpr; a.rip = (u64*)rip; a.rflags = (u64*)rflags;
  a.status = (i32*)status; a.icount = (u64*)icount; a.bp_skip = (i32*)bp_skip;
  a.ctr = (u32*)ctr; a.cov = (u32*)cov; a.cov_words = cov_words;
  a.edge = (u32*)edge; a.edge_words = edge_words;
  a.ov_pfn = (i32*)ov_pfn; a.ov_data = (u64*)ov_data; a.ov_valid = (u8*)ov_valid;
  a.ov_count = (i32*)ov_count; a.slots = slots;
  a.limit = (u64)limit; a.n_lanes = n_lanes; a.k_steps = k_steps;
  if (n_lanes <= 0) return 0;
  if (block <= 0 || block > 256) return (int)cudaErrorInvalidValue;
  const int grid = (n_lanes + block - 1) / block;
  fused_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
