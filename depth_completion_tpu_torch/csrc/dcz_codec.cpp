// dcz: compressed-array codec for depth maps (host C++, no libraries).
//
// The byte stream of the port's .dcz files (io/dcz.py holds the container:
// magic, dtype, shape, CRC32), the same stream the JAX package writes:
//
//   1. byte-plane shuffle: for element size E, gather byte k of every
//      element into plane k. Float depth maps have highly redundant
//      exponent/high-mantissa planes, which LZ4 then collapses.
//   2. LZ4 block compression (greedy hash-chain matcher, standard LZ4
//      block format: token | literals | 2-byte LE offset | match length).
//
// Exposed as a tiny C ABI for ctypes (built with g++ by _build.load):
//   size_t dcz_compress_bound(size_t n)
//   long   dcz_compress(const uint8_t* src, size_t n, size_t elem_size,
//                       uint8_t* dst, size_t dst_cap)
//   long   dcz_decompress(const uint8_t* src, size_t n,
//                         uint8_t* dst, size_t dst_n, size_t elem_size)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMinMatch = 4;
constexpr int kHashLog = 16;
constexpr int kHashSize = 1 << kHashLog;

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// ---------------------------------------------------------------------------
// byte-plane shuffle
// ---------------------------------------------------------------------------

void shuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t esize) {
  if (esize <= 1 || n % esize != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  const size_t count = n / esize;
  for (size_t k = 0; k < esize; ++k) {
    const uint8_t* s = src + k;
    uint8_t* d = dst + k * count;
    for (size_t i = 0; i < count; ++i) d[i] = s[i * esize];
  }
}

void unshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t esize) {
  if (esize <= 1 || n % esize != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  const size_t count = n / esize;
  for (size_t k = 0; k < esize; ++k) {
    const uint8_t* s = src + k * count;
    uint8_t* d = dst + k;
    for (size_t i = 0; i < count; ++i) d[i * esize] = s[i];
  }
}

// ---------------------------------------------------------------------------
// LZ4 block compress/decompress
// ---------------------------------------------------------------------------

size_t lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                    size_t dst_cap) {
  if (n == 0) return 0;
  std::vector<int64_t> table(kHashSize, -1);
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  // matches must end 12 bytes before the end (LZ4 format requirement)
  const uint8_t* const mflimit = (n > 12) ? iend - 12 : src;
  const uint8_t* anchor = src;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  auto emit = [&](const uint8_t* lit, size_t lit_len, size_t match_len,
                  uint16_t offset) -> bool {
    // token + extended literal length + literals + offset + ext match length
    size_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + match_len / 255 + 1;
    if (op + need > oend) return false;
    uint8_t* token = op++;
    size_t ll = lit_len;
    if (ll >= 15) {
      *token = 15 << 4;
      ll -= 15;
      while (ll >= 255) { *op++ = 255; ll -= 255; }
      *op++ = static_cast<uint8_t>(ll);
    } else {
      *token = static_cast<uint8_t>(ll << 4);
    }
    std::memcpy(op, lit, lit_len);
    op += lit_len;
    if (match_len == 0) return true;  // final literal run
    op[0] = static_cast<uint8_t>(offset & 0xff);
    op[1] = static_cast<uint8_t>(offset >> 8);
    op += 2;
    size_t ml = match_len - kMinMatch;
    if (ml >= 15) {
      *token |= 15;
      ml -= 15;
      while (ml >= 255) { *op++ = 255; ml -= 255; }
      *op++ = static_cast<uint8_t>(ml);
    } else {
      *token |= static_cast<uint8_t>(ml);
    }
    return true;
  };

  while (ip < mflimit) {
    uint32_t h = hash4(read32(ip));
    int64_t cand = table[h];
    table[h] = ip - src;
    if (cand >= 0 && (ip - src) - cand <= 0xffff &&
        read32(src + cand) == read32(ip)) {
      const uint8_t* match = src + cand;
      const uint8_t* p = ip + kMinMatch;
      const uint8_t* m = match + kMinMatch;
      const uint8_t* matchlimit = iend - 5;
      while (p < matchlimit && *p == *m) { ++p; ++m; }
      size_t match_len = static_cast<size_t>(p - ip);
      if (!emit(anchor, static_cast<size_t>(ip - anchor), match_len,
                static_cast<uint16_t>(ip - match)))
        return 0;  // incompressible for dst_cap
      ip += match_len;
      anchor = ip;
    } else {
      ++ip;
    }
  }
  if (!emit(anchor, static_cast<size_t>(iend - anchor), 0, 0)) return 0;
  return static_cast<size_t>(op - dst);
}

long lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                    size_t dst_n) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_n;

  while (ip < iend) {
    uint8_t token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last literal run
    if (ip + 2 > iend) return -1;
    uint16_t offset = static_cast<uint16_t>(ip[0] | (ip[1] << 8));
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    size_t ml = token & 15;
    if (ml == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        ml += b;
      } while (b == 255);
    }
    ml += kMinMatch;
    if (op + ml > oend) return -1;
    const uint8_t* match = op - offset;
    for (size_t i = 0; i < ml; ++i) op[i] = match[i];  // overlap-safe
    op += ml;
  }
  return static_cast<long>(op - dst);
}

}  // namespace

extern "C" {

size_t dcz_compress_bound(size_t n) {
  return n + n / 255 + 64;
}

long dcz_compress(const uint8_t* src, size_t n, size_t elem_size,
                  uint8_t* dst, size_t dst_cap) {
  std::vector<uint8_t> shuffled(n);
  shuffle(src, shuffled.data(), n, elem_size);
  size_t out = lz4_compress(shuffled.data(), n, dst, dst_cap);
  if (out == 0 && n > 0) return -1;
  return static_cast<long>(out);
}

long dcz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_n,
                    size_t elem_size) {
  std::vector<uint8_t> shuffled(dst_n);
  long out = lz4_decompress(src, n, shuffled.data(), dst_n);
  if (out < 0 || static_cast<size_t>(out) != dst_n) return -1;
  unshuffle(shuffled.data(), dst, dst_n, elem_size);
  return out;
}

}  // extern "C"
