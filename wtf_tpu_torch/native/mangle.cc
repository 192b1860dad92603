// Native mutation engine (the honggfuzz-mangle role, SURVEY §2.6: the
// reference's mutator engines are compiled C++ — libFuzzer's
// MutationDispatcher and the vendored honggfuzz mangle port — because at
// fuzzing throughput a per-testcase interpreter-language mutation call
// dominates the host plane).
//
// Original implementation: a deterministic splitmix64-driven op table
// mutating a buffer in place.  The op set mirrors the roles of the
// honggfuzz mangle functions (bit/byte corruption, magic values, block
// shift/expand/shrink, ASCII digits, cross-over splice); it is NOT a port
// of their code.
//
// C ABI (ctypes): wtf_mangle mutates data[0..len) within capacity,
// returns the new length.

#include <cstdint>
#include <cstring>

namespace {

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    // splitmix64 (public domain algorithm), matching utils.hashing
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  uint64_t below(uint64_t bound) { return bound ? next() % bound : 0; }
};

const uint8_t kMagic1[] = {0x00, 0x01, 0x7F, 0x80, 0xFF};
const uint16_t kMagic2[] = {0x0000, 0x0001, 0x7FFF, 0x8000, 0xFFFF};
const uint32_t kMagic4[] = {0u, 1u, 0x7FFFFFFFu, 0x80000000u, 0xFFFFFFFFu};
const uint64_t kMagic8[] = {0ull, 1ull, 0x7FFFFFFFFFFFFFFFull,
                            0x8000000000000000ull, 0xFFFFFFFFFFFFFFFFull};

uint64_t mangle_once(uint8_t *data, uint64_t len, uint64_t cap, Rng &rng,
                     const uint8_t *cross, uint64_t cross_len) {
  const uint64_t op = rng.below(11);
  switch (op) {
  case 0: {  // bit flip
    if (!len) break;
    const uint64_t pos = rng.below(len);
    data[pos] ^= uint8_t(1u << rng.below(8));
    break;
  }
  case 1: {  // random byte
    if (!len) break;
    data[rng.below(len)] = uint8_t(rng.next());
    break;
  }
  case 2: {  // increment/decrement
    if (!len) break;
    const uint64_t pos = rng.below(len);
    data[pos] = uint8_t(data[pos] + (rng.below(2) ? 1 : 0xFF));
    break;
  }
  case 3: {  // magic value splice (1/2/4/8 bytes)
    if (!len) break;
    const uint64_t width = 1ull << rng.below(4);
    if (len < width) break;
    const uint64_t pos = rng.below(len - width + 1);
    const uint64_t pick = rng.below(5);
    switch (width) {
    case 1: data[pos] = kMagic1[pick]; break;
    case 2: std::memcpy(data + pos, &kMagic2[pick], 2); break;
    case 4: std::memcpy(data + pos, &kMagic4[pick], 4); break;
    default: std::memcpy(data + pos, &kMagic8[pick], 8); break;
    }
    break;
  }
  case 4: {  // copy block within
    if (len < 2) break;
    const uint64_t src = rng.below(len);
    const uint64_t count = 1 + rng.below(len - src > 32 ? 32 : len - src);
    const uint64_t dst = rng.below(len);
    const uint64_t n = (dst + count > len) ? len - dst : count;
    std::memmove(data + dst, data + src, n);
    break;
  }
  case 5: {  // insert (duplicate) block
    if (!len || len >= cap) break;
    const uint64_t count0 = 1 + rng.below(16);
    const uint64_t count = (len + count0 > cap) ? cap - len : count0;
    const uint64_t pos = rng.below(len);
    std::memmove(data + pos + count, data + pos, len - pos);
    const uint64_t src = rng.below(len);
    for (uint64_t i = 0; i < count; i++) {
      data[pos + i] = data[(src + i) % len];
    }
    len += count;
    break;
  }
  case 6: {  // shrink
    if (len < 2) break;
    const uint64_t start = rng.below(len);
    const uint64_t avail = len - start;
    const uint64_t count = 1 + rng.below(avail > 2 ? avail / 2 : 1);
    std::memmove(data + start, data + start + count, len - start - count);
    len -= count;
    break;
  }
  case 7: {  // ASCII digit rewrite
    if (!len) break;
    const uint64_t pos = rng.below(len);
    data[pos] = uint8_t('0' + rng.below(10));
    break;
  }
  case 8: {  // swap two bytes
    if (len < 2) break;
    const uint64_t a = rng.below(len), b = rng.below(len);
    const uint8_t t = data[a];
    data[a] = data[b];
    data[b] = t;
    break;
  }
  case 9: {  // printable ascii byte
    if (!len) break;
    data[rng.below(len)] = uint8_t(0x20 + rng.below(95));
    break;
  }
  default: {  // cross-over splice from the last coverage-finding input
    if (!cross || !cross_len || !len) break;
    const uint64_t pos = rng.below(len);
    const uint64_t room = cap - pos;
    uint64_t take = rng.below(cross_len + 1);
    if (take > room) take = room;
    std::memcpy(data + pos, cross, take);
    if (pos + take > len) len = pos + take;
    break;
  }
  }
  return len;
}

}  // namespace

extern "C" {

uint64_t wtf_mangle(uint8_t *data, uint64_t len, uint64_t capacity,
                    uint64_t seed, uint32_t n_mutations,
                    const uint8_t *cross, uint64_t cross_len) {
  Rng rng(seed);
  for (uint32_t i = 0; i < n_mutations; i++) {
    len = mangle_once(data, len, capacity, rng, cross, cross_len);
    if (len == 0) {
      data[0] = uint8_t(rng.next());
      len = 1;
    }
  }
  return len;
}

// Batch variant: one call mutates `count` buffers laid out in a flat
// arena (stride = capacity), cutting Python->C transition cost to one
// per DEVICE BATCH instead of one per testcase.  Each item draws its own
// mutation count in [1, max_mutations] so the batch output matches the
// distribution of `count` single calls.
void wtf_mangle_batch(uint8_t *arena, uint64_t *lens, uint64_t capacity,
                      uint64_t count, uint64_t seed, uint32_t max_mutations,
                      const uint8_t *cross, uint64_t cross_len) {
  for (uint64_t i = 0; i < count; i++) {
    Rng seeder(seed + i);
    const uint32_t n =
        1 + uint32_t(seeder.below(max_mutations ? max_mutations : 1));
    lens[i] = wtf_mangle(arena + i * capacity, lens[i], capacity,
                         seeder.next(), n, cross, cross_len);
  }
}

}  // extern "C"
