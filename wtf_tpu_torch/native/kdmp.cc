// Native Windows kernel crash-dump parser (kdmp-parser equivalent).
//
// Role: the reference loads guest physical memory from `mem.dmp` via the
// vendored C++ kdmp-parser (src/libs/kdmp-parser/src/lib/kdmp-parser.h,
// consumed at src/wtf/ram.h:96-152); SURVEY.md §2.6 keeps this component
// native in the rebuild.  This is an original implementation against the
// dump FORMAT (documented by the reference headers and the rekall
// project's reverse engineering): 64-bit full dumps (run list) and BMP
// dumps (present-page bitmap).
//
// C ABI surface (consumed by wtf_tpu/snapshot/kdmp.py over ctypes): the
// parser mmaps the file and returns (pfn, file_offset) pairs; Python
// slices page bytes straight out of its own mmap, so no page data crosses
// the FFI boundary.
//
// Build: g++ -O2 -shared -fPIC kdmp.cc -o libwtfkdmp.so   (see binding).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kPageSize = 0x1000;

// HEADER64 field offsets (layout fixed by the format; asserts in the
// reference headers pin these same numbers).
constexpr uint64_t kOffSignature = 0x00;       // 'PAGE'
constexpr uint64_t kOffValidDump = 0x04;       // 'DU64'
constexpr uint64_t kOffDirectoryTableBase = 0x10;
constexpr uint64_t kOffBugCheckCode = 0x38;
constexpr uint64_t kOffBugCheckParams = 0x40;  // 4 x u64
constexpr uint64_t kOffPhysmemDesc = 0x88;     // {u32 nruns, pad, u64 npages}
constexpr uint64_t kOffPhysmemRuns = 0x98;     // PHYSMEM_RUN[nruns]
constexpr uint64_t kOffContext = 0x348;        // CONTEXT (0xbb8 bytes)
constexpr uint64_t kOffDumpType = 0xf98;
constexpr uint64_t kOffBmpHeader = 0x2000;     // also: full-dump page data
// BMP_HEADER64 offsets relative to kOffBmpHeader
constexpr uint64_t kOffBmpSignature = 0x00;    // 'SDMP' | 'FDMP'
constexpr uint64_t kOffBmpValidDump = 0x04;    // 'DUMP'
constexpr uint64_t kOffBmpFirstPage = 0x20;
constexpr uint64_t kOffBmpTotalPresent = 0x28;
constexpr uint64_t kOffBmpPages = 0x30;
constexpr uint64_t kOffBmpBitmap = 0x38;

constexpr uint32_t kSigPage = 0x45474150;      // 'PAGE'
constexpr uint32_t kSigDu64 = 0x34365544;      // 'DU64'
constexpr uint32_t kBmpSdmp = 0x504D4453;      // 'SDMP'
constexpr uint32_t kBmpFdmp = 0x504D4446;      // 'FDMP'
constexpr uint32_t kBmpDump = 0x504D5544;      // 'DUMP'

constexpr uint32_t kFullDump = 1;
constexpr uint32_t kBmpDumpType = 5;

struct PagePair {
  uint64_t pfn;
  uint64_t file_offset;
};

struct Parser {
  int fd = -1;
  const uint8_t *map = nullptr;
  uint64_t size = 0;
  uint32_t dump_type = 0;
  std::vector<PagePair> pages;

  ~Parser() {
    if (map) munmap(const_cast<uint8_t *>(map), size);
    if (fd >= 0) close(fd);
  }

  template <typename T> bool read_at(uint64_t off, T *out) const {
    if (off + sizeof(T) > size) return false;
    std::memcpy(out, map + off, sizeof(T));
    return true;
  }

  bool parse() {
    uint32_t sig = 0, valid = 0;
    if (!read_at(kOffSignature, &sig) || !read_at(kOffValidDump, &valid))
      return false;
    if (sig != kSigPage || valid != kSigDu64) return false;
    if (!read_at(kOffDumpType, &dump_type)) return false;
    if (dump_type == kFullDump) return parse_full();
    if (dump_type == kBmpDumpType) return parse_bmp();
    return false;  // KernelDump (partial) not supported, like ram.h's use
  }

  // Full dump: run list; page data packed back-to-back from 0x2000 in run
  // order (holes between runs exist in PFN space, not in the file).
  bool parse_full() {
    uint32_t nruns = 0;
    uint64_t npages = 0;
    if (!read_at(kOffPhysmemDesc, &nruns)) return false;
    if (!read_at(kOffPhysmemDesc + 8, &npages)) return false;
    // 'PAGE'-poisoned descriptor = invalid (reference LooksGood check)
    if (nruns == 0x45474150u || nruns > 4096) return false;
    uint64_t file_off = kOffBmpHeader;
    for (uint32_t i = 0; i < nruns; i++) {
      uint64_t base = 0, count = 0;
      const uint64_t run_off = kOffPhysmemRuns + uint64_t(i) * 16;
      if (!read_at(run_off, &base) || !read_at(run_off + 8, &count))
        return false;
      for (uint64_t p = 0; p < count; p++) {
        if (file_off > size - kPageSize) return false;  // overflow-safe
        pages.push_back({base + p, file_off});
        file_off += kPageSize;
      }
    }
    return true;
  }

  // BMP dump: bitmap of present PFNs; page data packed from FirstPage in
  // ascending PFN order.
  bool parse_bmp() {
    uint32_t sig = 0, valid = 0;
    if (!read_at(kOffBmpHeader + kOffBmpSignature, &sig)) return false;
    if (!read_at(kOffBmpHeader + kOffBmpValidDump, &valid)) return false;
    if ((sig != kBmpSdmp && sig != kBmpFdmp) || valid != kBmpDump)
      return false;
    uint64_t first_page = 0, total_present = 0, bitmap_pages = 0;
    if (!read_at(kOffBmpHeader + kOffBmpFirstPage, &first_page)) return false;
    if (!read_at(kOffBmpHeader + kOffBmpTotalPresent, &total_present))
      return false;
    if (!read_at(kOffBmpHeader + kOffBmpPages, &bitmap_pages)) return false;
    const uint64_t bitmap_bytes = bitmap_pages / 8;
    const uint64_t bitmap_off = kOffBmpHeader + kOffBmpBitmap;
    if (bitmap_bytes > size || bitmap_off > size - bitmap_bytes) return false;
    if (first_page > size) return false;
    uint64_t file_off = first_page;
    for (uint64_t byte_idx = 0; byte_idx < bitmap_bytes; byte_idx++) {
      const uint8_t byte = map[bitmap_off + byte_idx];
      if (!byte) continue;
      for (uint8_t bit = 0; bit < 8; bit++) {
        if (!((byte >> bit) & 1)) continue;
        if (file_off > size - kPageSize) return false;  // overflow-safe
        pages.push_back({byte_idx * 8 + bit, file_off});
        file_off += kPageSize;
      }
    }
    return pages.size() == total_present;
  }
};

}  // namespace

extern "C" {

void *wtf_kdmp_open(const char *path) {
  auto *p = new Parser();
  p->fd = open(path, O_RDONLY);
  if (p->fd < 0) {
    delete p;
    return nullptr;
  }
  struct stat st {};
  if (fstat(p->fd, &st) != 0 || st.st_size < 0x2000) {
    delete p;
    return nullptr;
  }
  p->size = uint64_t(st.st_size);
  p->map = static_cast<const uint8_t *>(
      mmap(nullptr, p->size, PROT_READ, MAP_PRIVATE, p->fd, 0));
  if (p->map == MAP_FAILED) {
    p->map = nullptr;
    delete p;
    return nullptr;
  }
  if (!p->parse()) {
    delete p;
    return nullptr;
  }
  return p;
}

void wtf_kdmp_close(void *h) { delete static_cast<Parser *>(h); }

uint32_t wtf_kdmp_dump_type(void *h) {
  return static_cast<Parser *>(h)->dump_type;
}

uint64_t wtf_kdmp_n_pages(void *h) {
  return static_cast<Parser *>(h)->pages.size();
}

// Fill caller-allocated arrays (n_pages entries each) with the PFN ->
// file-offset index.
void wtf_kdmp_pages(void *h, uint64_t *pfns, uint64_t *offsets) {
  auto *p = static_cast<Parser *>(h);
  for (size_t i = 0; i < p->pages.size(); i++) {
    pfns[i] = p->pages[i].pfn;
    offsets[i] = p->pages[i].file_offset;
  }
}

uint64_t wtf_kdmp_dtb(void *h) {
  uint64_t dtb = 0;
  static_cast<Parser *>(h)->read_at(kOffDirectoryTableBase, &dtb);
  return dtb;
}

uint32_t wtf_kdmp_bugcheck_code(void *h) {
  uint32_t code = 0;
  static_cast<Parser *>(h)->read_at(kOffBugCheckCode, &code);
  return code;
}

// Copy the raw 0xbb8-byte CONTEXT record (register layout is decoded on
// the Python side).
int wtf_kdmp_context(void *h, uint8_t *out, uint64_t out_size) {
  auto *p = static_cast<Parser *>(h);
  const uint64_t ctx_size = 0xf00 - 0x348;
  if (out_size < ctx_size || kOffContext + ctx_size > p->size) return 0;
  std::memcpy(out, p->map + kOffContext, ctx_size);
  return 1;
}

}  // extern "C"
