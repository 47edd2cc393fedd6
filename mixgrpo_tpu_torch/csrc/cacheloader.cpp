// Native embedding-cache reader: mmap + readahead + fused f16->f32 gather.
//
// The port's copy of the repository's csrc/cacheloader.cpp, kept inside
// mixgrpo_tpu_torch so the package reaches into nothing outside itself.
// mixgrpo_tpu_torch/data/native_loader.py parses the safetensors header
// once and hands tensor byte ranges down; this library owns the hot path:
// zero-copy mmap, madvise readahead for upcoming rows, and a batched row
// gather with an in-loop half->float conversion (one pass, no intermediate
// numpy temporaries; ctypes releases the GIL around each call).
//
// Built with g++ at first use (native_loader.py); a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Handle {
  int fd;
  void* base;
  uint64_t size;
};

// IEEE 754 half -> float (bit-exact, handles subnormals/inf/nan).
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 0x1Fu) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

}  // namespace

extern "C" {

void* cl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  return new Handle{fd, base, (uint64_t)st.st_size};
}

void cl_close(void* h) {
  if (!h) return;
  Handle* hd = (Handle*)h;
  munmap(hd->base, hd->size);
  ::close(hd->fd);
  delete hd;
}

uint64_t cl_size(void* h) { return h ? ((Handle*)h)->size : 0; }

// Hint the kernel to read ahead a byte range (background prefetch of the
// next batch's rows).
void cl_prefetch(void* h, uint64_t offset, uint64_t len) {
  if (!h) return;
  Handle* hd = (Handle*)h;
  if (offset + len > hd->size) return;
  long page = sysconf(_SC_PAGESIZE);
  uint64_t start = offset & ~(uint64_t)(page - 1);
  madvise((char*)hd->base + start, len + (offset - start), MADV_WILLNEED);
}

// Raw copy out of the map.
int cl_read(void* h, uint64_t offset, uint64_t len, void* dst) {
  if (!h) return -1;
  Handle* hd = (Handle*)h;
  if (offset + len > hd->size) return -2;
  std::memcpy(dst, (char*)hd->base + offset, len);
  return 0;
}

// Gather n_rows rows of row_elems f16 values each, starting at tensor byte
// offset `base_off` with row stride `row_stride_bytes`, converting to f32
// into dst (n_rows * row_elems floats).  Row indices come from `rows`.
int cl_gather_f16_rows(void* h, uint64_t base_off, uint64_t row_stride_bytes,
                       uint64_t row_elems, const int64_t* rows,
                       int64_t n_rows, float* dst) {
  if (!h) return -1;
  Handle* hd = (Handle*)h;
  for (int64_t r = 0; r < n_rows; ++r) {
    uint64_t off = base_off + (uint64_t)rows[r] * row_stride_bytes;
    if (off + row_elems * 2 > hd->size) return -2;
    const uint16_t* src = (const uint16_t*)((char*)hd->base + off);
    float* out = dst + (uint64_t)r * row_elems;
    for (uint64_t i = 0; i < row_elems; ++i) out[i] = half_to_float(src[i]);
  }
  return 0;
}

}  // extern "C"
