// dcz: compressed-array codec for depth maps (host C++, no libraries).
//
// The byte stream of the port's .dcz files (io/dcz.py holds the container:
// magic, dtype, shape, CRC32), the same stream the JAX package writes:
//
//   1. byte-plane shuffle: for element size E, gather byte k of every
//      element into plane k (an array's bytes are whole elements).
//      Float depth maps have highly redundant exponent/high-mantissa
//      planes, which LZ4 then collapses.
//   2. LZ4 block compression (greedy hash-chain matcher, standard LZ4
//      block format: token | literals | 2-byte LE offset | match length).
//
// Exposed as a tiny C ABI for ctypes (built with g++ by _build.load):
//   size_t dcz_compress_bound(size_t n)
//   long   dcz_compress(const uint8_t* src, size_t n, size_t elem_size,
//                       uint8_t* dst, size_t dst_cap)
//   long   dcz_decompress(const uint8_t* src, size_t n,
//                         uint8_t* dst, size_t dst_n, size_t elem_size)
//
// and the primitives of the .bl2 chunk layer (io/bl2.py walks the blosc
// containers and calls zstd and zlib itself):
//   long bl2_lz4_compress(src, n, dst, dst_cap)      raw LZ4 block; 0: no fit
//   long bl2_lz4hc_compress(src, n, dst, dst_cap, clevel)
//     an LZ4 block from a hash-chain search of 2^(clevel-1) candidates
//     (at least 2) with one step of lazy matching, as LZ4HC searches
//   long bl2_blosclz_compress(src, n, dst, dst_cap, clevel)
//     a blosclz stream from the same search (1 candidate up to clevel 3,
//     then 2^(clevel-3)); 0 where the stream would not fit dst_cap
//   long bl2_lz4_decompress(src, n, dst, dst_n)      LZ4 and LZ4HC blocks
//   long bl2_blosclz_decompress(src, n, dst, dst_n)  blosc's FastLZ variant
//   void bl2_shuffle(src, dst, n, typesize)          the byte shuffle above;
//   void bl2_unshuffle(src, dst, n, typesize)        a block's tail past its
//                                                    whole elements copied
//   void bl2_bitunshuffle(src, dst, n, typesize, blosc2)
//     the bit transpose of the bitshuffle filter over the whole elements
//     (blosc2: the largest multiple of 8 of them; blosc1: all of them, or
//     none unless their count is a multiple of 8), the rest copied.

#include <algorithm>
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
// byte-plane shuffle (dcz's and blosc's): byte k of every whole element
// into plane k; the bytes after the last whole element stay in place
// ---------------------------------------------------------------------------

void shuffle_planes(const uint8_t* src, uint8_t* dst, size_t n, size_t esize, bool forward) {
  const size_t count = esize > 1 ? n / esize : 0;
  if (count == 0) {
    std::memcpy(dst, src, n);
    return;
  }
  for (size_t k = 0; k < esize; ++k)
    for (size_t i = 0; i < count; ++i) {
      if (forward)
        dst[k * count + i] = src[i * esize + k];
      else
        dst[i * esize + k] = src[k * count + i];
    }
  std::memcpy(dst + count * esize, src + count * esize, n - count * esize);
}

// ---------------------------------------------------------------------------
// LZ4 block compress/decompress
// ---------------------------------------------------------------------------

// Writes LZ4 sequences: a token, the literal count's extension, the
// literals, then (unless it is the final literal run, a match length of 0)
// the 2-byte LE offset and the match length's extension. false: no room.
struct Lz4Writer {
  uint8_t* op;
  uint8_t* const oend;

  bool put(const uint8_t* lit, size_t lit_len, size_t match_len, size_t offset) {
    const size_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + match_len / 255 + 1;
    if (static_cast<size_t>(oend - op) < need) return false;
    uint8_t* token = op++;
    size_t ll = lit_len;
    *token = static_cast<uint8_t>(std::min<size_t>(ll, 15) << 4);
    if (ll >= 15) {
      for (ll -= 15; ll >= 255; ll -= 255) *op++ = 255;
      *op++ = static_cast<uint8_t>(ll);
    }
    std::memcpy(op, lit, lit_len);
    op += lit_len;
    if (match_len == 0) return true;
    *op++ = static_cast<uint8_t>(offset & 0xff);
    *op++ = static_cast<uint8_t>(offset >> 8);
    size_t ml = match_len - kMinMatch;
    *token |= static_cast<uint8_t>(std::min<size_t>(ml, 15));
    if (ml >= 15) {
      for (ml -= 15; ml >= 255; ml -= 255) *op++ = 255;
      *op++ = static_cast<uint8_t>(ml);
    }
    return true;
  }
};

size_t lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                    size_t dst_cap) {
  if (n == 0) return 0;
  std::vector<int64_t> table(kHashSize, -1);
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  // matches must end 12 bytes before the end (LZ4 format requirement)
  const uint8_t* const mflimit = (n > 12) ? iend - 12 : src;
  const uint8_t* anchor = src;
  Lz4Writer out{dst, dst + dst_cap};

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
      if (!out.put(anchor, static_cast<size_t>(ip - anchor), match_len,
                   static_cast<size_t>(ip - match)))
        return 0;  // incompressible for dst_cap
      ip += match_len;
      anchor = ip;
    } else {
      ++ip;
    }
  }
  if (!out.put(anchor, static_cast<size_t>(iend - anchor), 0, 0)) return 0;
  return static_cast<size_t>(out.op - dst);
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

// ---------------------------------------------------------------------------
// hash-chain match search shared by the LZ4HC and blosclz encoders
// ---------------------------------------------------------------------------

constexpr size_t kLastLiterals = 5;  // LZ4: the last 5 bytes are literals
constexpr size_t kMfLimit = 12;      // LZ4: no match starts in the last 12 bytes

struct ChainSearch {
  const uint8_t* src;
  size_t n;
  size_t max_dist;
  int depth;
  std::vector<int32_t> head, prev;
  size_t inserted = 0;

  ChainSearch(const uint8_t* s, size_t len, size_t dist, int d)
      : src(s), n(len), max_dist(dist), depth(d), head(kHashSize, -1), prev(len, -1) {}

  void insert_upto(size_t pos) {
    for (; inserted < pos; ++inserted) {
      const uint32_t h = hash4(read32(src + inserted));
      prev[inserted] = head[h];
      head[h] = static_cast<int32_t>(inserted);
    }
  }

  // The longest match at ip (at least kMinMatch bytes, ending by limit);
  // 0 if none. dist receives its distance.
  size_t find(size_t ip, size_t limit, size_t* dist) {
    insert_upto(ip);
    const uint32_t want = read32(src + ip);
    int32_t cand = head[hash4(want)];
    size_t best = 0;
    for (int k = 0; k < depth && cand >= 0 && ip - static_cast<size_t>(cand) <= max_dist; ++k) {
      const size_t c = static_cast<size_t>(cand);
      if (read32(src + c) == want && (best == 0 || src[c + best] == src[ip + best])) {
        size_t len = kMinMatch;
        while (ip + len < limit && src[c + len] == src[ip + len]) ++len;
        if (len > best) {
          best = len;
          *dist = ip - c;
        }
      }
      cand = prev[c];
    }
    return best;
  }
};

// Greedy parsing with one step of lazy matching: a match at ip is taken
// unless the one at ip + 1 is longer. emit(literals, count, match length,
// distance) writes a sequence (a match length of 0: the final literals).
template <class Emit>
bool parse(const uint8_t* src, size_t n, size_t max_dist, int depth, Emit&& emit) {
  if (n > kMfLimit) {
    ChainSearch cs(src, n, max_dist, depth);
    const size_t mflimit = n - kMfLimit, matchlimit = n - kLastLiterals;
    size_t ip = 0, anchor = 0;
    while (ip < mflimit) {
      size_t dist = 0;
      size_t len = cs.find(ip, matchlimit, &dist);
      if (len == 0) {
        ++ip;
        continue;
      }
      while (depth > 1 && ip + 1 < mflimit) {
        size_t dist2 = 0;
        const size_t len2 = cs.find(ip + 1, matchlimit, &dist2);
        if (len2 <= len) break;
        ++ip;
        len = len2;
        dist = dist2;
      }
      if (!emit(src + anchor, ip - anchor, len, dist)) return false;
      ip += len;
      anchor = ip;
    }
    return emit(src + anchor, n - anchor, 0, 0);
  }
  return emit(src, n, 0, 0);
}

long lz4hc_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_cap, int clevel) {
  if (n == 0) return 0;
  Lz4Writer out{dst, dst + dst_cap};
  auto emit = [&](const uint8_t* lit, size_t lit_len, size_t match_len, size_t dist) {
    return out.put(lit, lit_len, match_len, dist);
  };
  if (!parse(src, n, 0xffff, clevel <= 1 ? 2 : 1 << (clevel - 1), emit)) return 0;
  return static_cast<long>(out.op - dst);
}

// The blosclz stream that blosclz_decompress below reads: literal runs of
// at most 32 bytes, matches of 3 or more bytes at distances up to
// 8191 + 65536 (kMaxDistance: the near form below it, the far form with a
// 16-bit distance beyond), the stream starting and ending with literals.
long blosclz_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_cap, int clevel) {
  constexpr size_t kMaxDistance = 8191, kMaxCopy = 32;
  if (n == 0) return 0;
  const int depth = clevel <= 3 ? 1 : 1 << (clevel - 3);
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  auto emit = [&](const uint8_t* lit, size_t lit_len, size_t match_len, size_t dist) -> bool {
    const size_t need = lit_len + (lit_len + kMaxCopy - 1) / kMaxCopy + match_len / 255 + 6;
    if (static_cast<size_t>(oend - op) < need) return false;
    for (size_t done = 0; done < lit_len;) {
      const size_t run = std::min(kMaxCopy, lit_len - done);
      *op++ = static_cast<uint8_t>(run - 1);
      std::memcpy(op, lit + done, run);
      op += run;
      done += run;
    }
    if (match_len == 0) return true;
    const size_t d = dist - 1;
    const bool far = d >= kMaxDistance;
    const size_t code = far ? 255 : d & 255;
    const uint8_t high = static_cast<uint8_t>(far ? 31 : d >> 8);
    const size_t len = match_len - 2;
    if (len < 7) {
      *op++ = static_cast<uint8_t>((len << 5) + high);
    } else {
      *op++ = static_cast<uint8_t>((7 << 5) + high);
      size_t rest = len - 7;
      for (; rest >= 255; rest -= 255) *op++ = 255;
      *op++ = static_cast<uint8_t>(rest);
    }
    *op++ = static_cast<uint8_t>(code);
    if (far) {
      *op++ = static_cast<uint8_t>((d - kMaxDistance) >> 8);
      *op++ = static_cast<uint8_t>((d - kMaxDistance) & 255);
    }
    return true;
  };
  if (!parse(src, n, kMaxDistance + 65536, depth, emit)) return 0;
  return static_cast<long>(op - dst);
}

// blosclz (c-blosc's FastLZ derivative): a literal run of ctrl+1 bytes
// for ctrl < 32, else a match of (ctrl >> 5) + 2 bytes (7 adds the bytes
// that follow, while they are 255) at distance ((ctrl & 31) << 8) + the
// next byte + 1; a distance byte of 255 under a high part of 31 means a
// 16-bit distance follows, beyond 8191. The first control byte is a
// literal run (its top three bits mark the FastLZ level).
long blosclz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_n) {
  constexpr size_t kMaxDistance = 8191;
  if (n == 0) return 0;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_n;
  uint32_t ctrl = *ip++ & 31u;
  for (;;) {
    if (ctrl >= 32) {
      size_t len = (ctrl >> 5) - 1;
      size_t ofs = (ctrl & 31u) << 8;
      if (len == 6) {
        uint8_t code;
        do {
          if (ip + 1 >= iend) return -1;
          code = *ip++;
          len += code;
        } while (code == 255);
      } else if (ip + 1 >= iend) {
        return -1;
      }
      const uint8_t code = *ip++;
      len += 3;
      size_t dist = ofs + code;
      if (code == 255 && ofs == (31u << 8)) {
        if (ip + 1 >= iend) return -1;
        dist = ((static_cast<size_t>(ip[0]) << 8) | ip[1]) + kMaxDistance;
        ip += 2;
      }
      dist += 1;
      if (static_cast<size_t>(oend - op) < len || static_cast<size_t>(op - dst) < dist) return -1;
      const uint8_t* ref = op - dist;
      for (size_t i = 0; i < len; ++i) op[i] = ref[i];  // overlap-safe
      op += len;
    } else {
      const size_t run = ctrl + 1;
      if (static_cast<size_t>(oend - op) < run || static_cast<size_t>(iend - ip) < run) return -1;
      std::memcpy(op, ip, run);
      op += run;
      ip += run;
    }
    if (ip >= iend) break;
    ctrl = *ip++;
  }
  return static_cast<long>(op - dst);
}

}  // namespace

extern "C" {

long bl2_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_cap) {
  return static_cast<long>(lz4_compress(src, n, dst, dst_cap));
}

long bl2_lz4hc_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_cap, int clevel) {
  return lz4hc_compress(src, n, dst, dst_cap, clevel);
}

long bl2_blosclz_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_cap,
                          int clevel) {
  return blosclz_compress(src, n, dst, dst_cap, clevel);
}

long bl2_lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_n) {
  return lz4_decompress(src, n, dst, dst_n);
}

long bl2_blosclz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_n) {
  return blosclz_decompress(src, n, dst, dst_n);
}

void bl2_shuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t typesize) {
  shuffle_planes(src, dst, n, typesize, true);
}

void bl2_unshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t typesize) {
  shuffle_planes(src, dst, n, typesize, false);
}

// The bitshuffle filter's rows: byte k, bit b of every element, 8 elements
// to a byte (element 8j+i in bit i of byte j), one row after another.
void bl2_bitunshuffle(const uint8_t* src, uint8_t* dst, size_t n, size_t typesize, int blosc2) {
  size_t count = typesize ? n / typesize : 0;
  if (blosc2)
    count -= count % 8;
  else if (count % 8)
    count = 0;
  const size_t row = count / 8;
  std::memset(dst, 0, count * typesize);
  for (size_t k = 0; k < typesize; ++k)
    for (size_t b = 0; b < 8; ++b) {
      const uint8_t* in = src + (k * 8 + b) * row;
      for (size_t j = 0; j < row; ++j) {
        const uint8_t v = in[j];
        if (!v) continue;
        for (size_t i = 0; i < 8; ++i)
          if ((v >> i) & 1) dst[(8 * j + i) * typesize + k] |= static_cast<uint8_t>(1u << b);
      }
    }
  std::memcpy(dst + count * typesize, src + count * typesize, n - count * typesize);
}

size_t dcz_compress_bound(size_t n) {
  return n + n / 255 + 64;
}

long dcz_compress(const uint8_t* src, size_t n, size_t elem_size,
                  uint8_t* dst, size_t dst_cap) {
  std::vector<uint8_t> shuffled(n);
  shuffle_planes(src, shuffled.data(), n, elem_size, true);
  size_t out = lz4_compress(shuffled.data(), n, dst, dst_cap);
  if (out == 0 && n > 0) return -1;
  return static_cast<long>(out);
}

long dcz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_n,
                    size_t elem_size) {
  std::vector<uint8_t> shuffled(dst_n);
  long out = lz4_decompress(src, n, shuffled.data(), dst_n);
  if (out < 0 || static_cast<size_t>(out) != dst_n) return -1;
  shuffle_planes(shuffled.data(), dst, dst_n, elem_size, false);
  return out;
}

}  // extern "C"
