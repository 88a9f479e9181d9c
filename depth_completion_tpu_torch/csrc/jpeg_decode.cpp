// JPEG decoder (host C++, no libraries) for io/jpeg.py.
//
// Decodes what libjpeg-turbo decodes with its defaults (the islow integer
// IDCT, fancy upsampling, jdcolor.c's fixed-point YCbCr->RGB), sample for
// sample, written from ITU T.81 (JPEG), the JFIF and Adobe APP14
// conventions and the integer arithmetic libjpeg documents:
//
//   - frames SOF0/SOF1 (Huffman, sequential) and SOF2 (progressive: DC and
//     AC first and refinement scans, EOB runs), 8-bit samples, 1, 3 or 4
//     components, any integral sampling factors, restart intervals;
//   - the IDCT of jidctint.c: CONST_BITS 13, PASS1_BITS 2, pass 1 descaled
//     by CONST_BITS - PASS1_BITS, pass 2 by CONST_BITS + PASS1_BITS + 3,
//     in the 16- and 32-bit lanes of libjpeg-turbo's SIMD version;
//   - chroma upsampling: h2v1 and h2v2 by the triangle filter when the
//     downsampled width exceeds 2 (h2v2 rounds with +8 and +7 on
//     alternate output columns), h1v2 by the triangle filter (bias 1 and
//     2), every other integral ratio by replication; the row above the
//     first and below the last real row repeat it;
//   - colour: Y/Cb/Cr through jdcolor.c's tables (16 fractional bits,
//     ONE_HALF folded into the Cb->G table), then range limiting; an
//     Adobe APP14 transform of 0 (without a JFIF APP0), or component ids
//     'R','G','B' without either marker, means RGB: no conversion. Four
//     components are CMYK (Adobe transform 0, or no Adobe marker) or YCCK
//     (any other transform: jdcolor.c's YCbCr->RGB, inverted, K kept),
//     then OpenCV's CMYK->BGR (icvCvt_CMYK2BGR_8u_C4C3R, which reads the
//     samples as Adobe's inverted CMYK): v = k - ((255 - v) * k >> 8);
//   - block smoothing (jdcoefct.c's decompress_smooth_data, libjpeg-turbo
//     2.1 and later): a progressive file whose coefficients 1-9 are not all
//     exact has those still zero estimated from the DC values of a 5x5
//     block neighbourhood (its DC too where no AC data arrived), capped
//     below 2^Al; rows past the iMCU row where the last scan's data ran
//     out use the progression status from before that scan.
//
// Output: BGR (3 channels, also for 4 components) or grey (1 channel), rows
// top to bottom.
//
// Data that ends early is read as libjpeg reads a file (cv2.imread): past
// the end, every read gives a fake EOI marker. Where a scan's data runs
// out, the missing bits are zeros, and every later MCU of the scan keeps
// the coefficients it had (zero, or those of earlier scans); a file that
// ends after its first scan has begun decodes, one that ends before it
// does not.
//
//   int jpeg_header(const uint8_t* data, size_t n, int* info, char* err,
//                   size_t err_cap)
//     info = {height, width, channels}; returns 0 or an error code.
//   int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
//                   size_t out_cap, char* err, size_t err_cap)
//     returns 0, or nonzero with a message in err. Refused (code 2):
//     arithmetic coding, lossless and hierarchical frames (named by SOF),
//     precision other than 8, and component counts other than 1, 3 and 4.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// position in the 8x8 block (row-major) of each zigzag index; the tail
// guards a corrupt run that steps past 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg, int code = 1) { throw Error{code, msg}; }

struct Huff {
  bool present = false;
  bool valid = false;  // the counts form a code (libjpeg's test, made when a scan uses it)
  int max_sym = 0;
  int maxcode[18];  // largest code of each length, -1 if none
  int valoff[17];   // index into vals of the first code of each length, minus that code
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer) and symbol
  uint8_t look_sym[512];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    present = true;
    valid = false;
    std::memcpy(vals, symbols, nsym);
    max_sym = nsym ? *std::max_element(symbols, symbols + nsym) : 0;
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoff[len] = k - code;
      // no code may be all ones: checked before any lookahead entry is written
      if (counts[len - 1] && code + counts[len - 1] >= (1 << len)) return;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
          if (len <= 9) {
            const int shift = 9 - len;
            for (int f = 0; f < (1 << shift); ++f) {
              look_len[(code << shift) | f] = static_cast<uint8_t>(len);
              look_sym[(code << shift) | f] = symbols[k];
            }
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    valid = true;
  }

  // libjpeg's checks when a scan starts that uses the table
  void check(bool is_dc) const {
    if (!present) fail("a scan uses an undefined Huffman table");
    if (!valid || (is_dc && max_sym > 15)) fail("bad Huffman table");
  }
};

// Entropy-coded data between two markers, restart markers inside it.
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;  // stopped at a marker (pos points at its 0xFF)
  bool insufficient = false;  // the data ran out: zero bits were read

  void fill() {
    while (cnt <= 56) {
      if (marker || pos >= n) return;
      uint8_t b = d[pos];
      if (b == 0xFF) {
        size_t p = pos + 1;
        while (p < n && d[p] == 0xFF) ++p;
        if (p < n && d[p] == 0) {
          pos = p + 1;
        } else {
          marker = true;
          pos = p - 1;  // the last 0xFF before the marker code
          return;
        }
      } else {
        ++pos;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  void need(int k) {
    if (cnt < k) {
      fill();
      if (cnt < k) {  // as libjpeg: the bits past the data are zeros
        insufficient = true;
        cnt = 64;
      }
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    need(k);
    const int v = static_cast<int>(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huff& h) {
    if (cnt < 9) fill();
    int code, len;
    if (cnt >= 9) {  // 9-bit lookahead
      const int look = static_cast<int>(buf >> 55);
      if (h.look_len[look]) {
        len = h.look_len[look];
        buf <<= len;
        cnt -= len;
        return h.look_sym[look];
      }
      code = get(9);
      len = 9;
    } else {  // near the end of the data: bit by bit
      code = bit();
      len = 1;
    }
    while (code > h.maxcode[len]) {
      code = (code << 1) | bit();
      if (++len > 16) return 0;  // corrupt: libjpeg substitutes 0
    }
    return h.vals[(h.valoff[len] + code) & 0xFF];
  }
  // Discard buffered bits and step past the next RSTn marker.
  void restart() {
    buf = 0;
    cnt = 0;
    for (;;) {
      if (!marker)
        while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) ++pos;
      marker = false;
      if (pos + 1 >= n) return;
      const uint8_t code = d[pos + 1];
      pos += 2;
      if (code >= 0xD0 && code <= 0xD7) {
        insufficient = false;
        return;
      }
    }
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// The DC predictor plus a difference, refused where it leaves int's range
// (libjpeg-turbo's JERR_BAD_DCT_COEF).
inline int add_dc(int pred, int diff) {
  const int64_t v = static_cast<int64_t>(pred) + diff;
  if (v > INT32_MAX || v < INT32_MIN) fail("corrupt JPEG: DC coefficient out of range");
  return static_cast<int>(v);
}

struct Component {
  int id, h, v, tq;
  int dw, dh;                // downsampled size
  int wblocks, hblocks;      // blocks holding real samples
  int bw, bh;                // blocks stored: whole MCUs
  std::vector<int16_t> coef; // bw*bh blocks of 64, natural order
  uint16_t qt[64];           // latched at the component's first scan
  bool latched = false;
  // progression status (libjpeg's coef_bits): the Al of the last scan
  // that carried each coefficient, -1 before any; prev_bits: the same
  // before the latest scan of this component (coefficients 0-9)
  int bits[64], prev_bits[10];
  int dc_pred = 0;
  std::vector<uint8_t> plane;  // wblocks*8 x hblocks*8 samples
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, precision = 0, sof = -1;
  bool progressive = false;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int eobrun = 0;
  int scans = 0;
  // the iMCU row in which the latest scan's data ran out (-1: it did not)
  int short_row = -1;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u16(size_t p) const {
    if (p + 2 > n) fail("truncated JPEG segment");
    return (d[p] << 8) | d[p + 1];
  }

  // Walks the markers; stops after SOF when header_only.
  void run(bool header_only) {
    size_t p = 2;
    for (;;) {
      while (p < n && d[p] != 0xFF) ++p;  // skip garbage between segments
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n || d[p] == 0xD9) {  // EOI, or the end of the file standing for it
        if (sof < 0) fail("no frame header before the end of the file");
        if (!header_only && scans == 0) fail("JPEG file with no image data");
        return;
      }
      const int m = d[p++];
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01 || m == 0x00) continue;
      const int len = u16(p);
      if (len < 2 || p + len > n) fail("truncated JPEG segment");
      const size_t body = p + 2, end = p + len;
      p = end;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        frame(m, body, end);
        if (header_only) return;
      } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
                 (m >= 0xCD && m <= 0xCF)) {
        char msg[160];
        const char* kind = m == 0xC3 ? "lossless" :
                           (m >= 0xC9 && m <= 0xCB) ? "arithmetic-coded" :
                           (m == 0xCF || m == 0xCD || m == 0xCE) ? "arithmetic-coded hierarchical"
                                                                 : "hierarchical";
        std::snprintf(msg, sizeof(msg), "%s JPEG (SOF%d) is not supported", kind, m - 0xC0);
        fail(msg, 2);
      } else if (m == 0xC4) {
        huffman(body, end);
      } else if (m == 0xDB) {
        quant(body, end);
      } else if (m == 0xDD) {
        restart_interval = u16(body);
      } else if (m == 0xE0) {
        if (end - body >= 14 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (end - body >= 12 && std::memcmp(d + body, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[body + 11];
        }
      } else if (m == 0xDA) {
        if (sof < 0) fail("scan before the frame header");
        if (header_only) return;
        p = scan(body, end);
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG (DAC) is not supported", 2);
      }
    }
  }

  void frame(int m, size_t b, size_t end) {
    if (sof >= 0) fail("more than one frame header");
    if (end - b < 6) fail("truncated frame header");
    sof = m - 0xC0;
    progressive = m == 0xC2;
    precision = d[b];
    height = u16(b + 1);
    width = u16(b + 3);
    const int nc = d[b + 5];
    char msg[120];
    if (precision != 8) {
      std::snprintf(msg, sizeof(msg), "%d-bit JPEG (SOF%d) is not supported", precision, sof);
      fail(msg, 2);
    }
    if (nc != 1 && nc != 3 && nc != 4) {
      std::snprintf(msg, sizeof(msg),
                    "JPEG with %d components is not supported (1, 3 and 4 are)", nc);
      fail(msg, 2);
    }
    if (width == 0 || height == 0) fail("JPEG with an empty frame (or a DNL height)");
    if (end - b < static_cast<size_t>(6 + 3 * nc)) fail("truncated frame header");
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = d[b + 6 + 3 * i];
      c.h = d[b + 7 + 3 * i] >> 4;
      c.v = d[b + 7 + 3 * i] & 15;
      c.tq = d[b + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad sampling factors");
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (Component& c : comps) {
      if (maxh % c.h || maxv % c.v) fail("non-integral sampling ratio", 2);
      c.dw = (width * c.h + maxh - 1) / maxh;
      c.dh = (height * c.v + maxv - 1) / maxv;
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      std::fill(c.bits, c.bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 10, -1);
    }
  }

  void huffman(size_t b, size_t end) {
    while (b < end) {
      if (end - b < 17) fail("truncated Huffman table");
      const int tc = d[b] >> 4, th = d[b] & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      int total = 0;
      for (int i = 0; i < 16; ++i) total += d[b + 1 + i];
      if (total > 256 || b + 17 + total > end) fail("bad Huffman table");
      (tc ? ac : dc)[th].build(d + b + 1, d + b + 17, total);
      b += 17 + total;
    }
  }

  void quant(size_t b, size_t end) {
    while (b < end) {
      const int pq = d[b] >> 4, tq = d[b] & 15;
      if (tq > 3 || pq > 1) fail("bad quantisation table");
      if (b + 1 + 64 * (pq + 1) > end) fail("truncated quantisation table");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = pq ? static_cast<uint16_t>(u16(b + 1 + 2 * k)) : d[b + 1 + k];
      qt_present[tq] = true;
      b += 1 + 64 * (pq + 1);
    }
  }

  // Decodes one scan; returns where the marker after its data starts.
  size_t scan(size_t b, size_t end) {
    const int ns = d[b];
    if (ns < 1 || ns > 4 || end - b < static_cast<size_t>(4 + 2 * ns)) fail("bad scan header");
    std::vector<Component*> sc;
    std::vector<int> td, ta;
    for (int i = 0; i < ns; ++i) {
      const int cid = d[b + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& x : comps)
        if (x.id == cid) c = &x;
      if (!c) fail("scan names an unknown component");
      sc.push_back(c);
      td.push_back(d[b + 2 + 2 * i] >> 4);
      ta.push_back(d[b + 2 + 2 * i] & 15);
      if (td.back() > 3 || ta.back() > 3) fail("bad Huffman table id in a scan");
      if (!c->latched) {
        if (!qt_present[c->tq]) fail("a component's quantisation table is missing");
        std::memcpy(c->qt, qt[c->tq], sizeof(c->qt));
        c->latched = true;
      }
    }
    const int ss = d[b + 1 + 2 * ns], se = d[b + 2 + 2 * ns];
    const int ah = d[b + 3 + 2 * ns] >> 4, al = d[b + 3 + 2 * ns] & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13 ||
          (ah != 0 && al != ah - 1))
        fail("bad progressive scan parameters");
    }  // a sequential scan's Ss, Se, Ah and Al are not read (libjpeg only warns)
    for (int i = 0; i < ns; ++i) {
      if (!progressive || (ss == 0 && ah == 0)) dc[td[i]].check(true);
      if (!progressive || ss > 0) ac[ta[i]].check(false);
    }
    ++scans;
    if (progressive)  // jdphuff.c's start_pass: the progression status
      for (Component* c : sc) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          if (k < 10) c->prev_bits[k] = scans > 1 ? c->bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->bits[k] = al;
      }
    // the entropy-coded data runs to the first marker other than RSTn
    size_t e = end;
    while (e + 1 < n && !(d[e] == 0xFF && d[e + 1] != 0 && d[e + 1] != 0xFF &&
                          !(d[e + 1] >= 0xD0 && d[e + 1] <= 0xD7)))
      ++e;
    if (e + 1 >= n) e = n;
    Bits bits{d, e, end};
    for (Component* c : sc) c->dc_pred = 0;
    eobrun = 0;
    short_row = -1;

    auto block = [&](Component& c, int by, int bx, int i) {
      int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
      if (!progressive) {
        sequential(bits, blk, c, dc[td[i]], ac[ta[i]]);
      } else if (ss == 0) {
        if (ah == 0) {
          const int s = bits.decode(dc[td[i]]);
          c.dc_pred = add_dc(c.dc_pred, s ? extend(bits.get(s), s) : 0);
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
        } else if (bits.bit()) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(bits, blk, ac[ta[i]], ss, se, al);
      } else {
        ac_refine(bits, blk, ac[ta[i]], ss, se, al);
      }
    };

    long mcu = 0;
    auto restart_check = [&]() {
      if (restart_interval && mcu > 0 && mcu % restart_interval == 0) {
        bits.restart();
        for (Component* c : sc) c->dc_pred = 0;
        eobrun = 0;
      }
      ++mcu;
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx) {
          restart_check();
          if (bits.insufficient) continue;
          block(c, by, bx, 0);
          if (bits.insufficient) short_row = by / c.v;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          restart_check();
          if (bits.insufficient) continue;  // libjpeg leaves the rest of the scan as it was
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) block(c, my * c.v + y, mx * c.h + x, i);
          }
          if (bits.insufficient) short_row = my;
        }
    }
    return e;
  }

  static void sequential(Bits& bits, int16_t* blk, Component& c, const Huff& dct,
                         const Huff& act) {
    int s = bits.decode(dct);
    c.dc_pred = add_dc(c.dc_pred, s ? extend(bits.get(s), s) : 0);
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = bits.decode(act);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void ac_first(Bits& bits, int16_t* blk, const Huff& act, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = bits.decode(act);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits.get(r);
        --eobrun;
        break;
      }
    }
  }

  void ac_refine(Bits& bits, int16_t* blk, const Huff& act, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (bits.bit() && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = bits.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.bit() ? p1 : m1;  // s is 1 in a valid stream
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;
        }
        // step over r zero coefficients, correcting the nonzero ones
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }
};

// The islow IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) as libjpeg-turbo's
// SIMD code computes it, which is what cv2 runs. On coefficients a valid
// file holds it equals jidctint.c sample for sample. Past that range (the
// garbage block where a truncated scan runs out of bits) the SIMD code's
// 16-bit lanes decide the result, so they are followed here: dequantised
// values and the sums in0 +- in4, in7 + in3 and in5 + in1 wrap at 16 bits,
// products and sums wrap at 32, each pass saturates its output to 16 bits
// and the second then to 8 (no wraparound range limit). A block whose rows
// 1-7 are zero takes the DC shortcut: each column's (in0 * q) << 2 at 16
// bits.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
// 32-bit lane arithmetic: products and sums modulo 2^32
inline int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
inline int32_t descale(int32_t x, int n) { return add32(x, int32_t{1} << (n - 1)) >> n; }

// One 1-D pass over 8 values in[0..7]; results in out[0..7], before descaling.
inline void idct_1d(const int16_t* in, int32_t* out) {
  const int32_t z2 = in[2], z3 = in[6];
  const int32_t tmp2 = add32(mul32(z2, F0_541), mul32(z3, F0_541 - F1_847));
  const int32_t tmp3 = add32(mul32(z2, F0_541 + F0_765), mul32(z3, F0_541));
  const int32_t tmp0 = mul32(wrap16(in[0] + in[4]), 1 << kConstBits);
  const int32_t tmp1 = mul32(wrap16(in[0] - in[4]), 1 << kConstBits);
  const int32_t t10 = add32(tmp0, tmp3), t13 = sub32(tmp0, tmp3);
  const int32_t t11 = add32(tmp1, tmp2), t12 = sub32(tmp1, tmp2);
  const int32_t o0 = in[7], o1 = in[5], o2 = in[3], o3 = in[1];
  const int32_t z3o = wrap16(o0 + o2), z4o = wrap16(o1 + o3);
  const int32_t z3s = add32(mul32(z3o, F1_175 - F1_961), mul32(z4o, F1_175));
  const int32_t z4s = add32(mul32(z3o, F1_175), mul32(z4o, F1_175 - F0_390));
  const int32_t p0 = add32(add32(mul32(o0, F0_298 - F0_899), mul32(o3, -F0_899)), z3s);
  const int32_t p1 = add32(add32(mul32(o1, F2_053 - F2_562), mul32(o2, -F2_562)), z4s);
  const int32_t p2 = add32(add32(mul32(o1, -F2_562), mul32(o2, F3_072 - F2_562)), z3s);
  const int32_t p3 = add32(add32(mul32(o0, -F0_899), mul32(o3, F1_501 - F0_899)), z4s);
  out[0] = add32(t10, p3);
  out[7] = sub32(t10, p3);
  out[1] = add32(t11, p2);
  out[6] = sub32(t11, p2);
  out[2] = add32(t12, p1);
  out[5] = sub32(t12, p1);
  out[3] = add32(t13, p0);
  out[4] = sub32(t13, p0);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int16_t deq[64], ws[64], in[8];
  int32_t res[8];
  bool dc_only = true;
  for (int k = 0; k < 64; ++k) {
    deq[k] = wrap16(coef[k] * static_cast<int32_t>(q[k]));
    if (k >= 8 && coef[k]) dc_only = false;
  }
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    if (dc_only) {
      const int16_t v = wrap16(deq[c] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
      continue;
    }
    for (int r = 0; r < 8; ++r) in[r] = deq[r * 8 + c];
    idct_1d(in, res);
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(descale(res[r], kConstBits - kPass1Bits));
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    idct_1d(ws + r * 8, res);
    for (int c = 0; c < 8; ++c) {
      const int v = sat16(descale(res[c], kConstBits + kPass1Bits + 3));
      out[r * stride + c] = static_cast<uint8_t>((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
}

// Block smoothing (libjpeg-turbo 2.1+'s decompress_smooth_data, which cv2's
// bundled libjpeg-turbo 3.1 runs): where a progressive file's first ten
// coefficients are not all known to full precision, each still-zero one of
// AC01..AC30 is estimated from the DC values of the block's 5x5
// neighbourhood; where no AC data arrived at all, the DC is smoothed too.
// The natural positions of zigzag coefficients 0-9:
constexpr int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// libjpeg's smoothing_ok: a progressive file, every component's table
// latched with nonzero Q00..Q30, its DC begun, and some coefficient of
// 1-9 not yet exact.
bool smoothing_ok(const std::vector<Component>& comps, bool progressive) {
  if (!progressive) return false;
  bool useful = false;
  for (const Component& c : comps) {
    if (!c.latched || c.bits[0] < 0) return false;
    for (int k = 0; k < 10; ++k)
      if (c.qt[kQ[k]] == 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.bits[k] != 0) useful = true;
  }
  return useful;
}

// One coefficient's estimate: num / (Q << 8) rounded half away from zero,
// its magnitude capped below 2^Al when Al > 0.
inline int16_t estimate(int64_t num, int64_t q, int al) {
  const bool neg = num < 0;
  int pred = static_cast<int>(((q << 7) + (neg ? -num : num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(neg ? -pred : pred);
}

// The smoothed coefficients of one block into ws (a copy of the block):
// dc[0..24] are the DC values of rows above-above .. below-below (the
// rows chosen by the caller) and columns X-2 .. X+2 (clamped), row-major.
void smooth_block(const int* dc, const int* bits, const uint16_t* q, int16_t* ws) {
  auto D = [&](int i) { return static_cast<int64_t>(dc[i - 1]); };
  bool change_dc = true;
  for (int k = 1; k < 10; ++k)
    if (bits[k] != -1) change_dc = false;
  const int64_t q00 = q[0];
  auto apply = [&](int k, int64_t sum) {
    const int pos = kQ[k];
    if (bits[k] != 0 && ws[pos] == 0) ws[pos] = estimate(q00 * sum, q[pos], bits[k]);
  };
  if (change_dc) {
    apply(1, -D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) + 3 * D(10) -
             3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
             13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25));
    apply(2, -D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) + 38 * D(8) +
             13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) - 13 * D(19) + D(20) + D(21) +
             3 * D(22) + 3 * D(23) + 3 * D(24) + D(25));
    apply(3, D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) - 5 * D(14) +
             2 * D(17) + 7 * D(18) + 2 * D(19) + D(23));
    apply(4, -D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) - D(25));
    apply(5, 2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) + 7 * D(14) +
             D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19));
    apply(6, D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19));
    apply(7, D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19));
    apply(8, D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19));
    apply(9, D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19));
    ws[0] = estimate(q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) -
                            6 * D(6) + 6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) -
                            8 * D(11) + 42 * D(12) + 152 * D(13) + 42 * D(14) - 8 * D(15) -
                            6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19) - 6 * D(20) -
                            2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25)),
                     q00, 0);
  } else {
    apply(1, -7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15));
    apply(2, -7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23));
    apply(3, -D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23));
    apply(4, D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) - D(24) + D(4) -
             D(6) + 10 * D(7) - 10 * D(9));
    apply(5, -D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15));
  }
}

// jdcolor.c's YCbCr->RGB tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// The component's samples at full size for output row y: one row of
// `width` values.
void upsample_row(const Component& c, int fx, int fy, int y, int width, uint8_t* row) {
  const int stride = c.wblocks * 8;
  auto src = [&](int r) { return &c.plane[static_cast<size_t>(r) * stride]; };
  const bool fancy_h = fx == 2 && c.dw > 2;
  if (fx == 1 && fy == 1) {
    std::memcpy(row, src(y), width);
  } else if (fx == 2 && fy == 1 && fancy_h) {  // h2v1_fancy_upsample
    const uint8_t* in = src(y);
    std::vector<uint8_t> o(2 * c.dw);
    o[0] = in[0];
    o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int j = 1; j < c.dw - 1; ++j) {
      const int v = in[j] * 3;
      o[2 * j] = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
      o[2 * j + 1] = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
    }
    const int j = c.dw - 1;
    o[2 * j] = static_cast<uint8_t>((in[j] * 3 + in[j - 1] + 1) >> 2);
    o[2 * j + 1] = in[j];
    std::memcpy(row, o.data(), width);
  } else if (fy == 2 && (fx == 1 || fancy_h)) {  // h1v2 / h2v2 fancy
    const int i = y / 2, below = y % 2;
    const int nb = below ? std::min(i + 1, c.dh - 1) : std::max(i - 1, 0);
    const uint8_t *in0 = src(i), *in1 = src(nb);
    if (fx == 1) {
      const int bias = below ? 2 : 1;
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {
      std::vector<uint8_t> o(2 * c.dw);
      int last, cur = in0[0] * 3 + in1[0], next = in0[1] * 3 + in1[1];
      o[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
      for (int j = 1; j < c.dw - 1; ++j) {
        next = in0[j + 1] * 3 + in1[j + 1];
        o[2 * j] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
        o[2 * j + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
      const int j = c.dw - 1;
      o[2 * j] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
      o[2 * j + 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
      std::memcpy(row, o.data(), width);
    }
  } else {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
    const uint8_t* in = src(y / fy);
    for (int x = 0; x < width; ++x) row[x] = in[x / fx];
  }
}

void finish(Decoder& dec, uint8_t* out) {
  for (Component& c : dec.comps)  // a component no scan carried: zero
    if (!c.latched) std::memset(c.qt, 0, sizeof(c.qt));  // coefficients and multipliers
  const bool smooth = smoothing_ok(dec.comps, dec.progressive);
  const int imcu_rows = dec.mcuy;
  for (Component& c : dec.comps) {
    const int stride = c.wblocks * 8;
    c.plane.assign(static_cast<size_t>(stride) * c.hblocks * 8, 0);
    // the rows past the one where the last scan's data ran out keep what
    // the scans before it gave: their status is the one before that scan
    // (libjpeg's latch: -1 for coefficients 1-9 when it is the first)
    const int last_good = dec.short_row >= 0 ? dec.short_row : imcu_rows;
    int before[10];
    for (int k = 0; k < 10; ++k) before[k] = dec.scans > 1 ? c.prev_bits[k] : -1;
    auto blk = [&](int by, int bx) { return &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]; };
    for (int r = 0; r < imcu_rows; ++r) {
      // libjpeg's rows of this iMCU row and its neighbour rule: the
      // last iMCU row holds its real block rows only, and its index
      // arithmetic counts them as if every iMCU row had as few
      int block_rows = c.v;
      if (r == imcu_rows - 1) block_rows = c.hblocks % c.v ? c.hblocks % c.v : c.v;
      for (int br = 0; br < block_rows; ++br) {
        const int by = r * c.v + br;
        if (by >= c.hblocks) break;
        const int ib = r * block_rows + br, ibs = block_rows * imcu_rows;
        const int prev = ib > 0 ? by - 1 : by, pprev = ib > 1 ? by - 2 : prev;
        const int next = ib < ibs - 1 ? by + 1 : by, nnext = ib < ibs - 2 ? by + 2 : next;
        const int rows[5] = {pprev, prev, by, next, nnext};
        for (int bx = 0; bx < c.wblocks; ++bx) {
          uint8_t* dst = &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8];
          if (!smooth) {
            idct_islow(blk(by, bx), c.qt, dst, stride);
            continue;
          }
          int dc[25];
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j)
              dc[i * 5 + j] = blk(rows[i], std::clamp(bx + j - 2, 0, c.wblocks - 1))[0];
          int16_t ws[64];
          std::memcpy(ws, blk(by, bx), sizeof(ws));
          smooth_block(dc, r > last_good ? before : c.bits, c.qt, ws);
          idct_islow(ws, c.qt, dst, stride);
        }
      }
    }
  }
  const int w = dec.width, h = dec.height, nc = static_cast<int>(dec.comps.size());
  if (nc == 1) {
    const Component& c = dec.comps[0];
    for (int y = 0; y < h; ++y)
      upsample_row(c, dec.maxh / c.h, dec.maxv / c.v, y, w, out + static_cast<size_t>(y) * w);
    return;
  }
  // four components: CMYK unless an Adobe marker says otherwise (transform
  // 2, or any but 0: YCCK), as libjpeg decides; three: RGB or YCbCr
  bool rgb, ycck = false;
  if (nc == 4) {
    rgb = false;
    ycck = dec.adobe && dec.adobe_transform != 0;
  } else if (dec.jfif) {
    rgb = false;
  } else if (dec.adobe) {
    rgb = dec.adobe_transform == 0;
  } else {
    rgb = dec.comps[0].id == 'R' && dec.comps[1].id == 'G' && dec.comps[2].id == 'B';
  }
  std::vector<uint8_t> rows(static_cast<size_t>(nc) * w);
  for (int y = 0; y < h; ++y) {
    for (int i = 0; i < nc; ++i) {
      const Component& c = dec.comps[i];
      upsample_row(c, dec.maxh / c.h, dec.maxv / c.v, y, w, &rows[static_cast<size_t>(i) * w]);
    }
    const uint8_t *c0 = rows.data(), *c1 = c0 + w, *c2 = c1 + w, *c3 = c2 + w;
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x, o += 3) {
      if (nc == 4) {
        // libjpeg's CMYK samples (jdcolor.c's ycck_cmyk_convert: YCbCr to
        // RGB, inverted, K kept), then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R,
        // which takes them as Adobe's inverted CMYK: v = k - (255 - v) k / 256
        int cc = c0[x], mm = c1[x], yy = c2[x];
        const int k = c3[x];
        if (ycck) {
          const int yv = c0[x], cb = c1[x], cr = c2[x];
          cc = 255 - clamp255(yv + kYcc.cr_r[cr]);
          mm = 255 - clamp255(yv + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
          yy = 255 - clamp255(yv + kYcc.cb_b[cb]);
        }
        o[2] = static_cast<uint8_t>(k - (((255 - cc) * k) >> 8));
        o[1] = static_cast<uint8_t>(k - (((255 - mm) * k) >> 8));
        o[0] = static_cast<uint8_t>(k - (((255 - yy) * k) >> 8));
      } else if (rgb) {
        o[0] = c2[x];
        o[1] = c1[x];
        o[2] = c0[x];
      } else {
        const int yy = c0[x], cb = c1[x], cr = c2[x];
        o[2] = clamp255(yy + kYcc.cr_r[cr]);
        o[1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[0] = clamp255(yy + kYcc.cb_b[cb]);
      }
    }
  }
}

// libjpeg's file source, through which cv2.imread reads, returns a fake EOI
// marker for every read past the end of the file: the data is read with
// enough of them appended to fill the longest segment and end it.
std::vector<uint8_t> with_eof(const uint8_t* data, size_t n) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI)");
  std::vector<uint8_t> v(data, data + n);
  v.reserve(n + 65538);
  for (int i = 0; i < 32769; ++i) {
    v.push_back(0xFF);
    v.push_back(0xD9);
  }
  return v;
}

void set_err(char* err, size_t cap, const std::string& msg) {
  if (err && cap) {
    std::strncpy(err, msg.c_str(), cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, size_t n, int* info, char* err, size_t err_cap) {
  try {
    const std::vector<uint8_t> buf = with_eof(data, n);
    Decoder dec(buf.data(), buf.size());
    dec.run(true);
    if (dec.sof < 0) fail("no frame header");
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = dec.comps.size() == 4 ? 3 : static_cast<int>(dec.comps.size());  // CMYK -> BGR
    return 0;
  } catch (const Error& e) {
    set_err(err, err_cap, e.msg);
    return e.code;
  }
}

int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, size_t out_cap, char* err,
                size_t err_cap) {
  try {
    const std::vector<uint8_t> buf = with_eof(data, n);
    Decoder dec(buf.data(), buf.size());
    dec.run(false);
    if (dec.sof < 0) fail("no frame header");
    const size_t need = static_cast<size_t>(dec.width) * dec.height *
                        std::min<size_t>(dec.comps.size(), 3);
    if (out_cap < need) fail("output buffer too small");
    finish(dec, out);
    return 0;
  } catch (const Error& e) {
    set_err(err, err_cap, e.msg);
    return e.code;
  }
}

}  // extern "C"
