// Measured stand-in for the bochs-role denominator (VERDICT r4 item 6).
//
// The reference's slowest backend is bochscpu: a single-threaded C++
// fetch-decode-execute interpreter whose hot loop pays, per instruction,
// a coverage-set insert and hook dispatch (reference
// bochscpu_backend.cc:476-548), and per testcase a dirty-page restore.
// That library is a PREBUILT Rust/C++ artifact the reference downloads at
// build time — it cannot be built in this zero-egress environment, so
// `bench.py`'s vs_baseline was a modeled constant for four rounds.
//
// This file replaces the model with a measurement: a minimal C++
// interpreter of the demo_tlv guest running the SAME snapshot bytes, the
// same per-instruction coverage insert (open-addressed set, robin-map
// class), the same per-exec byte-exact restore.  It is deliberately
// FASTER than real bochs — tiny decoder, flat span memory instead of
// paging+TLB, no hook chain — so the exec/s it measures is an UPPER
// bound on the bochs role and the vs_baseline computed from it is
// conservative for the TPU side.
//
// Instruction coverage: the x86-64 subset MSVC-ish codegen and the
// demo_tlv parser use (REX, ModRM+SIB, mov/movzx/lea/add/sub/cmp/test/
// xor/inc/dec/push/pop/jcc/jmp/ret, AL-imm forms).  Unknown opcodes and
// unmapped fetches end the testcase as a crash — exactly what the
// fuzzed workload does when the planted stack smash fires.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Span {
  uint64_t base;
  uint64_t size;
  uint8_t *data;
};

struct DirtyByte {
  uint8_t *p;
  uint8_t old;
};

// open-addressed coverage set (the robin-map role): pow2 table, linear
// probe, epoch-tagged slots so the per-testcase clear (LastNewCoverage)
// is O(1) like clearing a small robin_map, not a full-table memset
struct CovSet {
  std::vector<uint64_t> slots;   // rip per slot
  std::vector<uint32_t> epochs;  // slot valid iff epochs[i] == epoch
  uint32_t epoch = 1;
  size_t mask;
  explicit CovSet(size_t pow2)
      : slots(pow2, 0), epochs(pow2, 0), mask(pow2 - 1) {}
  inline void insert(uint64_t rip) {
    size_t h = (rip * 0x9E3779B97F4A7C15ull) >> 40 & mask;
    while (true) {
      if (epochs[h] != epoch) {
        epochs[h] = epoch;
        slots[h] = rip;
        return;
      }
      if (slots[h] == rip) return;
      h = (h + 1) & mask;
    }
  }
  inline void clear() { epoch++; }
};

struct Vm {
  std::vector<Span> spans;
  std::vector<uint8_t> backing;
  std::vector<DirtyByte> dirty;
  CovSet cov{1 << 16};
  uint64_t gpr[16];
  uint64_t rip;
  bool zf, cf, sf, of;

  uint8_t *ptr(uint64_t gva, size_t len) {
    for (auto &s : spans)
      if (gva >= s.base && gva + len <= s.base + s.size)
        return s.data + (gva - s.base);
    return nullptr;
  }
};

inline uint64_t rd(Vm &vm, uint8_t *p, int size) {
  uint64_t v = 0;
  std::memcpy(&v, p, size);
  return v;
}

inline void wr(Vm &vm, uint8_t *p, int size, uint64_t v) {
  for (int i = 0; i < size; i++) vm.dirty.push_back({p + i, p[i]});
  std::memcpy(p, &v, size);
}

struct Mod {
  uint64_t gva;     // effective address (mod != 3)
  int reg;          // ModRM.reg (REX.R applied)
  int rm;           // ModRM.rm (REX.B applied); -1 when memory form
  int len;          // bytes consumed (modrm+sib+disp)
};

// decode ModRM+SIB+disp at code[0]; rex bits already split out
bool modrm(Vm &vm, const uint8_t *code, int rexr, int rexx, int rexb,
           Mod *out) {
  uint8_t m = code[0];
  int mod = m >> 6, reg = ((m >> 3) & 7) | (rexr << 3), rm = m & 7;
  int len = 1;
  uint64_t addr = 0;
  if (mod == 3) {
    *out = {0, reg, rm | (rexb << 3), 1};
    return true;
  }
  if (rm == 4) {  // SIB
    uint8_t sib = code[1];
    len = 2;
    int scale = sib >> 6, idx = ((sib >> 3) & 7) | (rexx << 3),
        base = (sib & 7) | (rexb << 3);
    if (idx != 4) addr += vm.gpr[idx] << scale;
    if ((sib & 7) == 5 && mod == 0) {
      addr += (int32_t)rd(vm, (uint8_t *)code + 2, 4);
      len += 4;
    } else {
      addr += vm.gpr[base];
    }
  } else if (rm == 5 && mod == 0) {  // rip-relative (disp applied later)
    addr = (int32_t)rd(vm, (uint8_t *)code + 1, 4);
    len = 5;  // caller adds rip-after
    *out = {addr, reg, -2, len};
    return true;
  } else {
    addr = vm.gpr[rm | (rexb << 3)];
  }
  if (mod == 1) {
    addr += (int8_t)code[len];
    len += 1;
  } else if (mod == 2) {
    addr += (int32_t)rd(vm, (uint8_t *)code + len, 4);
    len += 4;
  }
  *out = {addr, reg, -1, len};
  return true;
}

inline void flags_sub(Vm &vm, uint64_t a, uint64_t b, uint64_t r, int bits) {
  uint64_t msb = 1ull << (bits - 1);
  uint64_t mask = bits == 64 ? ~0ull : (1ull << bits) - 1;
  a &= mask; b &= mask; r &= mask;
  vm.zf = r == 0;
  vm.cf = a < b;
  vm.sf = (r & msb) != 0;
  vm.of = (((a ^ b) & (a ^ r)) & msb) != 0;
}

inline void flags_add(Vm &vm, uint64_t a, uint64_t b, uint64_t r, int bits) {
  uint64_t msb = 1ull << (bits - 1);
  uint64_t mask = bits == 64 ? ~0ull : (1ull << bits) - 1;
  a &= mask; b &= mask; r &= mask;
  vm.zf = r == 0;
  vm.cf = r < a;
  vm.sf = (r & msb) != 0;
  vm.of = (((a ^ r) & (b ^ r)) & msb) != 0;
}

inline void flags_logic(Vm &vm, uint64_t r, int bits) {
  uint64_t msb = 1ull << (bits - 1);
  uint64_t mask = bits == 64 ? ~0ull : (1ull << bits) - 1;
  r &= mask;
  vm.zf = r == 0;
  vm.cf = false;
  vm.sf = (r & msb) != 0;
  vm.of = false;
}

enum Result { RUNNING = 0, FINISHED = 1, CRASHED = 2, TIMEDOUT = 3 };

// one instruction; returns RUNNING/terminal
int step(Vm &vm, uint64_t finish) {
  if (vm.rip == finish) return FINISHED;
  uint8_t *code = vm.ptr(vm.rip, 16);
  if (!code) return CRASHED;
  vm.cov.insert(vm.rip);  // the per-instruction hook cost (bochs :479-505)

  const uint8_t *c = code;
  int rexw = 0, rexr = 0, rexx = 0, rexb = 0;
  if ((*c & 0xF0) == 0x40) {
    rexw = (*c >> 3) & 1; rexr = (*c >> 2) & 1;
    rexx = (*c >> 1) & 1; rexb = *c & 1;
    c++;
  }
  int osz = rexw ? 64 : 32;
  int osz_b = osz / 8;
  Mod m;
  uint8_t op = *c++;
  auto finish_len = [&](int extra) {
    vm.rip += (c - code) + extra;
  };
  auto mem = [&](int sz) -> uint8_t * {
    return vm.ptr(m.gva, sz);
  };

  switch (op) {
    case 0x50: case 0x51: case 0x52: case 0x53:
    case 0x54: case 0x55: case 0x56: case 0x57: {  // push r64
      int r = (op - 0x50) | (rexb << 3);
      vm.gpr[4] -= 8;
      uint8_t *p = vm.ptr(vm.gpr[4], 8);
      if (!p) return CRASHED;
      wr(vm, p, 8, vm.gpr[r]);
      finish_len(0);
      return RUNNING;
    }
    case 0x58: case 0x59: case 0x5A: case 0x5B:
    case 0x5C: case 0x5D: case 0x5E: case 0x5F: {  // pop r64
      int r = (op - 0x58) | (rexb << 3);
      uint8_t *p = vm.ptr(vm.gpr[4], 8);
      if (!p) return CRASHED;
      vm.gpr[r] = rd(vm, p, 8);
      vm.gpr[4] += 8;
      finish_len(0);
      return RUNNING;
    }
    case 0x01: case 0x29: case 0x31: case 0x39: case 0x85: {  // op r/m,r
      if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
      c += m.len;
      uint64_t b = vm.gpr[m.reg];
      uint64_t a;
      uint8_t *p = nullptr;
      if (m.rm >= 0) {
        a = vm.gpr[m.rm];
      } else {
        p = mem(osz_b);
        if (!p) return CRASHED;
        a = rd(vm, p, osz_b);
      }
      uint64_t r;
      if (op == 0x01) { r = a + b; flags_add(vm, a, b, r, osz); }
      else if (op == 0x29) { r = a - b; flags_sub(vm, a, b, r, osz); }
      else if (op == 0x31) { r = a ^ b; flags_logic(vm, r, osz); }
      else if (op == 0x39) { r = a - b; flags_sub(vm, a, b, r, osz);
                             finish_len(0); return RUNNING; }
      else { r = a & b; flags_logic(vm, r, osz);
             finish_len(0); return RUNNING; }
      if (osz == 32) r &= 0xFFFFFFFFull;
      if (m.rm >= 0) vm.gpr[m.rm] = r;
      else wr(vm, p, osz_b, r);
      finish_len(0);
      return RUNNING;
    }
    case 0x83: {  // grp1 r/m, imm8
      if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
      c += m.len;
      int64_t imm = (int8_t)*c;
      c++;
      uint64_t a;
      uint8_t *p = nullptr;
      if (m.rm >= 0) a = vm.gpr[m.rm];
      else { p = mem(osz_b); if (!p) return CRASHED; a = rd(vm, p, osz_b); }
      uint64_t r = a;
      switch (m.reg & 7) {
        case 0: r = a + imm; flags_add(vm, a, imm, r, osz); break;
        case 5: r = a - imm; flags_sub(vm, a, imm, r, osz); break;
        case 7: flags_sub(vm, a, imm, a - imm, osz);
                finish_len(0); return RUNNING;
        case 4: r = a & imm; flags_logic(vm, r, osz); break;
        case 1: r = a | imm; flags_logic(vm, r, osz); break;
        case 6: r = a ^ imm; flags_logic(vm, r, osz); break;
        default: return CRASHED;
      }
      if (osz == 32) r &= 0xFFFFFFFFull;
      if (m.rm >= 0) vm.gpr[m.rm] = r;
      else wr(vm, p, osz_b, r);
      finish_len(0);
      return RUNNING;
    }
    case 0x89: case 0x8B: {  // mov r/m,r / mov r,r/m
      if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
      c += m.len;
      if (op == 0x89) {
        if (m.rm >= 0) {
          vm.gpr[m.rm] = osz == 64 ? vm.gpr[m.reg]
                                   : (vm.gpr[m.reg] & 0xFFFFFFFFull);
        } else {
          uint8_t *p = mem(osz_b);
          if (!p) return CRASHED;
          wr(vm, p, osz_b, vm.gpr[m.reg]);
        }
      } else {
        uint64_t v;
        if (m.rm >= 0) v = vm.gpr[m.rm];
        else {
          uint8_t *p = mem(osz_b);
          if (!p) return CRASHED;
          v = rd(vm, p, osz_b);
        }
        vm.gpr[m.reg] = osz == 64 ? v : (v & 0xFFFFFFFFull);
      }
      finish_len(0);
      return RUNNING;
    }
    case 0x88: case 0x8A: {  // mov r/m8, r8 / mov r8, r/m8 (low bytes)
      if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
      c += m.len;
      if (op == 0x88) {
        uint8_t v = vm.gpr[m.reg] & 0xFF;
        if (m.rm >= 0) vm.gpr[m.rm] = (vm.gpr[m.rm] & ~0xFFull) | v;
        else { uint8_t *p = mem(1); if (!p) return CRASHED; wr(vm, p, 1, v); }
      } else {
        uint8_t v;
        if (m.rm >= 0) v = vm.gpr[m.rm] & 0xFF;
        else { uint8_t *p = mem(1); if (!p) return CRASHED; v = *p; }
        vm.gpr[m.reg] = (vm.gpr[m.reg] & ~0xFFull) | v;
      }
      finish_len(0);
      return RUNNING;
    }
    case 0x8D: {  // lea
      if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
      c += m.len;
      if (m.rm >= 0) return CRASHED;
      vm.gpr[m.reg] = osz == 64 ? m.gva : (m.gva & 0xFFFFFFFFull);
      finish_len(0);
      return RUNNING;
    }
    case 0x0F: {
      uint8_t op2 = *c++;
      if (op2 == 0xB6) {  // movzx r, r/m8
        if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
        c += m.len;
        uint8_t v;
        if (m.rm >= 0) v = vm.gpr[m.rm] & 0xFF;
        else { uint8_t *p = mem(1); if (!p) return CRASHED; v = *p; }
        vm.gpr[m.reg] = v;
        finish_len(0);
        return RUNNING;
      }
      return CRASHED;
    }
    case 0x3C: {  // cmp al, imm8
      uint8_t imm = *c++;
      flags_sub(vm, vm.gpr[0] & 0xFF, imm, (vm.gpr[0] & 0xFF) - imm, 8);
      finish_len(0);
      return RUNNING;
    }
    case 0xFF: {  // grp5: inc/dec r/m
      if (!modrm(vm, c, rexr, rexx, rexb, &m)) return CRASHED;
      c += m.len;
      if (m.rm < 0) return CRASHED;
      uint64_t a = vm.gpr[m.rm];
      if ((m.reg & 7) == 0) {
        uint64_t r = a + 1;
        bool keep_cf = vm.cf;
        flags_add(vm, a, 1, r, osz);
        vm.cf = keep_cf;
        vm.gpr[m.rm] = osz == 64 ? r : (r & 0xFFFFFFFFull);
      } else if ((m.reg & 7) == 1) {
        uint64_t r = a - 1;
        bool keep_cf = vm.cf;
        flags_sub(vm, a, 1, r, osz);
        vm.cf = keep_cf;
        vm.gpr[m.rm] = osz == 64 ? r : (r & 0xFFFFFFFFull);
      } else {
        return CRASHED;
      }
      finish_len(0);
      return RUNNING;
    }
    case 0xEB: {  // jmp rel8
      int8_t d = (int8_t)*c++;
      finish_len(0);
      vm.rip += d;
      return RUNNING;
    }
    case 0x72: case 0x73: case 0x74: case 0x75:
    case 0x76: case 0x77: case 0x78: case 0x79: {  // jcc rel8
      int8_t d = (int8_t)*c++;
      bool take = false;
      switch (op) {
        case 0x72: take = vm.cf; break;
        case 0x73: take = !vm.cf; break;
        case 0x74: take = vm.zf; break;
        case 0x75: take = !vm.zf; break;
        case 0x76: take = vm.cf || vm.zf; break;
        case 0x77: take = !(vm.cf || vm.zf); break;
        case 0x78: take = vm.sf; break;
        case 0x79: take = !vm.sf; break;
      }
      finish_len(0);
      if (take) vm.rip += d;
      return RUNNING;
    }
    case 0xC3: {  // ret
      uint8_t *p = vm.ptr(vm.gpr[4], 8);
      if (!p) return CRASHED;
      vm.rip = rd(vm, p, 8);
      vm.gpr[4] += 8;
      return RUNNING;
    }
    default:
      return CRASHED;  // outside the workload subset = the crash path
  }
}

}  // namespace

extern "C" {

// spans: n flat guest-memory windows (copied; the vm owns its backing)
void *bochsref_create(const uint64_t *bases, const uint64_t *sizes,
                      const uint8_t *const *datas, int n) {
  Vm *vm = new Vm();
  size_t total = 0;
  for (int i = 0; i < n; i++) total += sizes[i];
  vm->backing.resize(total);
  size_t off = 0;
  for (int i = 0; i < n; i++) {
    std::memcpy(vm->backing.data() + off, datas[i], sizes[i]);
    vm->spans.push_back({bases[i], sizes[i], vm->backing.data() + off});
    off += sizes[i];
  }
  return vm;
}

void bochsref_destroy(void *p) { delete (Vm *)p; }

// The per-testcase loop mirrors RunTestcaseAndRestore (client.cc:88-180):
// insert testcase -> run to finish/crash/limit (per-instruction coverage
// insert) -> byte-exact restore of every dirty location.  Returns total
// executed testcases; fills instr/crash counters.
void bochsref_campaign(void *p, uint64_t rip0, uint64_t rsp0,
                       uint64_t input_gva, uint64_t finish_gva,
                       uint64_t scratch_gva, const uint8_t *tcs,
                       const uint32_t *lens, int n_tc, uint64_t limit,
                       uint64_t repeat, uint64_t *out_execs,
                       uint64_t *out_instr, uint64_t *out_crashes) {
  Vm &vm = *(Vm *)p;
  uint64_t execs = 0, instr = 0, crashes = 0;
  const uint32_t *off = new uint32_t[n_tc];
  {
    uint32_t *o = (uint32_t *)off;
    uint32_t cur = 0;
    for (int i = 0; i < n_tc; i++) { o[i] = cur; cur += lens[i]; }
  }
  for (uint64_t rep = 0; rep < repeat; rep++) {
    for (int t = 0; t < n_tc; t++) {
      // insert testcase (a dirty write like VirtWriteDirty)
      uint8_t *in = vm.ptr(input_gva, lens[t]);
      if (in) {
        for (uint32_t i = 0; i < lens[t]; i++)
          vm.dirty.push_back({in + i, in[i]});
        std::memcpy(in, tcs + off[t], lens[t]);
      }
      std::memset(vm.gpr, 0, sizeof vm.gpr);
      vm.gpr[4] = rsp0;
      vm.gpr[6] = input_gva;   // rsi
      vm.gpr[2] = lens[t];     // rdx
      vm.gpr[15] = scratch_gva;
      vm.rip = rip0;
      vm.zf = vm.cf = vm.sf = vm.of = false;
      int res = RUNNING;
      uint64_t steps = 0;
      while (res == RUNNING) {
        res = step(vm, finish_gva);
        if (res == RUNNING && ++steps >= limit) res = TIMEDOUT;
      }
      instr += steps;
      if (res == CRASHED) crashes++;
      execs++;
      // restore: undo the dirty log newest-first (bochs rewrites dirty
      // GPAs from the dump, :730-797; byte-exact undo is the same
      // effect and FASTER, keeping the denominator conservative)
      for (size_t i = vm.dirty.size(); i-- > 0;)
        *vm.dirty[i].p = vm.dirty[i].old;
      vm.dirty.clear();
      vm.cov.clear();
    }
  }
  delete[] off;
  *out_execs = execs;
  *out_instr = instr;
  *out_crashes = crashes;
}

}  // extern "C"
