// Host JPEG decoder whose pixels are libjpeg's (and so PIL's) bit for bit.
//
// Built by g++ at first use (`utils/jpeg.py`), bound with ctypes. It decodes
// what ITU-T T.81 calls sequential (SOF0, SOF1) and progressive (SOF2)
// Huffman-coded JPEG at 8 bits a sample with 1 or 3 components, sampling
// factors 1 or 2, restart intervals and partial MCUs. The arithmetic follows
// libjpeg's defaults, which PIL decodes with:
//   - the ISLOW integer IDCT of jidctint.c (13-bit constants, 2 pass-1 bits,
//     the post-IDCT range-limit table of jdmaster.c indexed & 1023);
//   - jdsample.c's fancy upsampling: the h2v1 and h2v2 triangle filters with
//     their alternating biases (box replication where the downsampled width
//     is 2 or less), h1v2 for vertical-only subsampling; the component plane
//     is cropped to its downsampled size and its edges replicated, as
//     jdmainct.c's context rows do;
//   - jdcolor.c's fixed-point YCbCr->RGB tables (16 fraction bits);
//   - jdapimin.c's colour-space decision: JFIF, then the Adobe APP14
//     transform flag, then component IDs 1,2,3 (YCbCr) or 'R','G','B'.
// Everything else is refused with a message: arithmetic coding, lossless and
// hierarchical frames, 12-bit samples, 2- and 4-component files, sampling
// factors above 2, DNL heights, and progressive files whose scans leave one
// of the first nine AC coefficients of a component unrefined (libjpeg block-
// smooths those, jdcoefct.c::smoothing_ok).
//
// C interface:
//   int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out, size_t cap,
//                   int *h, int *w, int *c, char *msg, int msglen);
// reads the header into h, w, c and, when cap >= h * w * c, decodes into out
// (row-major, interleaved channels). Returns 0 on success, 1 when out was too
// small (only the header was read), -1 for corrupt data and -2 for a file
// outside what is decoded; msg then says what was found.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Zig-zag index -> natural (row-major) index, with 16 guard entries as
// libjpeg's jpeg_natural_order has.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t vals[256] = {};
  int maxcode[17] = {};
  int valoffset[18] = {};
  uint8_t look_len[1 << kLookBits] = {};
  uint8_t look_sym[1 << kLookBits] = {};

  void build(const uint8_t counts[17], const uint8_t *symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len]; ++i, ++k, ++code) {
        // jdhuff.c: no code may be all ones, so every code fits in len bits
        if (code + 1 >= (1 << len)) throw Corrupt("bad Huffman table");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = static_cast<uint8_t>(len);
            look_sym[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[len] = counts[len] ? code - 1 : -1;
      code <<= 1;
    }
    present = true;
  }
};

class BitReader {
 public:
  BitReader(const uint8_t *d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }

  uint32_t peek(int k) {
    if (cnt_ < k) fill();
    return static_cast<uint32_t>(buf_ >> (64 - k));
  }
  void skip(int k) {
    if (cnt_ - k < fake_) throw Corrupt("entropy-coded data ends early");
    buf_ <<= k;
    cnt_ -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  int bit() { return get(1); }

  int decode(const Huffman &h) {
    if (!h.present) throw Corrupt("scan uses an undefined Huffman table");
    uint32_t look = peek(16);
    int len = h.look_len[look >> (16 - kLookBits)];
    if (len) {
      skip(len);
      return h.look_sym[look >> (16 - kLookBits)];
    }
    int code = static_cast<int>(look >> (16 - kLookBits));
    len = kLookBits;
    while (code > h.maxcode[len]) {
      ++len;
      if (len > 16) throw Corrupt("bad Huffman code");
      code = static_cast<int>(look >> (16 - len));
    }
    skip(len);
    return h.vals[h.valoffset[len] + code];
  }

  // After a scan's last MCU or at a restart: drop the partial byte, then
  // return the marker that follows (0 at end of data).
  int take_marker() {
    buf_ = 0;
    cnt_ = 0;
    fake_ = 0;
    if (marker_) {
      int m = marker_;
      marker_ = 0;
      pos_ += 2;
      return m;
    }
    // the entropy data ended on a byte boundary: skip to the marker
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF))
      ++pos_;
    if (pos_ + 1 >= n_) return 0;
    int m = d_[pos_ + 1];
    pos_ += 2;
    return m;
  }

  // Byte-stuffed data into the buffer; at a marker or the end of the data
  // the buffer fills with zeros that may be peeked but not consumed.
  void fill() {
    while (cnt_ <= 56) {
      uint64_t b = 0;
      if (marker_ || pos_ >= n_) {
        fake_ += 8;
      } else if (d_[pos_] != 0xFF) {
        b = d_[pos_++];
      } else {
        size_t q = pos_ + 1;
        while (q < n_ && d_[q] == 0xFF) ++q;  // fill bytes
        if (q >= n_) {
          pos_ = n_;
          fake_ += 8;
        } else if (d_[q] == 0x00) {
          b = 0xFF;
          pos_ = q + 1;
        } else {
          pos_ = q - 1;  // at the marker's 0xFF
          marker_ = d_[q];
          fake_ += 8;
        }
      }
      buf_ |= b << (56 - cnt_);
      cnt_ += 8;
    }
  }

 private:
  const uint8_t *d_;
  size_t n_, pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0, fake_ = 0, marker_ = 0;
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;        // downsampled width and height (pixels)
  int bw = 0, bh = 0;        // blocks of the component itself
  int pbw = 0, pbh = 0;      // blocks of the padded MCU grid
  std::vector<int16_t> coef;  // pbw * pbh blocks of 64, natural order
  uint16_t quant[64] = {};
  bool latched = false;
  int dc_pred = 0;
  int coef_bits[64];
};

class Decoder {
 public:
  Decoder(const uint8_t *d, size_t n) : d_(d), n_(n) {}

  int height = 0, width = 0, ncomp = 0;

  void read_header();
  void decode(uint8_t *out);

 private:
  int u8() {
    if (pos_ >= n_) throw Corrupt("file ends inside a marker segment");
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  int next_marker();
  void segment(int marker);
  void read_sof(int marker, int len);
  void read_dht(int len);
  void read_dqt(int len);
  void read_sos(int len);
  void read_app(int marker, int len);
  void decode_scan(const std::vector<int> &comps, int ss, int se, int ah, int al);
  void decode_block(BitReader &br, Component &c, int16_t *blk, int ss, int se, int ah,
                    int al, int &eobrun);
  void finish(uint8_t *out);

  const uint8_t *d_;
  size_t n_;
  size_t pos_ = 0;
  bool progressive_ = false, frame_ = false, jfif_ = false, adobe_ = false;
  bool eoi_ = false;
  int adobe_transform_ = 0, restart_interval_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  uint16_t qt_[4][64] = {};
  bool qt_present_[4] = {};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comp_;
};

int Decoder::next_marker() {
  // skip anything up to the next 0xFF, then fill bytes
  while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
  while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
  if (pos_ >= n_) return -1;
  return d_[pos_++];
}

void Decoder::read_header() {
  if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) throw Corrupt("not a JPEG file (no SOI)");
  pos_ = 2;
  while (!frame_) {
    int m = next_marker();
    if (m < 0) throw Corrupt("no frame header before the end of the file");
    if (m == 0xDA || m == 0xD9) throw Corrupt("scan or EOI before the frame header");
    segment(m);
  }
}

void Decoder::segment(int m) {
  if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) return;  // TEM, stray RSTn: no length
  int len = u16();
  if (len < 2 || pos_ + len - 2 > n_) throw Corrupt("marker segment runs past the end");
  size_t end = pos_ + len - 2;
  switch (m) {
    case 0xC0:
    case 0xC1:
    case 0xC2:
      read_sof(m, len);
      break;
    case 0xC3:
      throw Unsupported("lossless JPEG (SOF3)");
    case 0xC5:
    case 0xC6:
    case 0xC7:
      throw Unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    case 0xC9:
    case 0xCA:
    case 0xCB:
    case 0xCD:
    case 0xCE:
    case 0xCF:
      throw Unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    case 0xCC:
      throw Unsupported("arithmetic-coding conditioning table (DAC)");
    case 0xDE:
    case 0xDF:
      throw Unsupported("hierarchical JPEG (DHP/EXP marker)");
    case 0xC4:
      read_dht(len);
      break;
    case 0xDB:
      read_dqt(len);
      break;
    case 0xDD:
      if (len != 4) throw Corrupt("bad DRI length");
      restart_interval_ = u16();
      break;
    case 0xDC:
      throw Unsupported("a DNL marker (height defined after the first scan)");
    default:
      if (m >= 0xE0 && m <= 0xEF) read_app(m, len);
      break;
  }
  pos_ = end;
}

void Decoder::read_app(int m, int len) {
  const uint8_t *p = d_ + pos_;
  int dlen = len - 2;
  if (m == 0xE0 && dlen >= 14 && !std::memcmp(p, "JFIF\0", 5)) jfif_ = true;
  if (m == 0xEE && dlen >= 12 && !std::memcmp(p, "Adobe", 5)) {
    adobe_ = true;
    adobe_transform_ = p[11];
  }
}

void Decoder::read_sof(int m, int len) {
  if (frame_) throw Corrupt("a second frame header");
  int precision = u8();
  height = u16();
  width = u16();
  ncomp = u8();
  if (precision != 8)
    throw Unsupported(std::to_string(precision) + "-bit samples");
  if (height == 0) throw Unsupported("a DNL marker (height 0 in the frame header)");
  if (width == 0) throw Corrupt("image width 0");
  if (ncomp == 4) throw Unsupported("4-component (CMYK/YCCK) JPEG");
  if (ncomp != 1 && ncomp != 3)
    throw Unsupported(std::to_string(ncomp) + "-component JPEG");
  if (len != 8 + 3 * ncomp) throw Corrupt("bad frame header length");
  comp_.resize(ncomp);
  for (auto &c : comp_) {
    c.id = u8();
    int hv = u8();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = u8();
    if (c.h < 1 || c.v < 1 || c.h > 4 || c.v > 4 || c.tq > 3) throw Corrupt("bad component");
    if (c.h > 2 || c.v > 2)
      throw Unsupported("sampling factor " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                        " (above 2)");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  progressive_ = m == 0xC2;
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  if (static_cast<double>(width) * height > 1.0e9) throw Unsupported("an image over 1e9 pixels");
  for (auto &c : comp_) {
    c.dw = (width * c.h + hmax_ - 1) / hmax_;
    c.dh = (height * c.v + vmax_ - 1) / vmax_;
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.pbw = mcux_ * c.h;
    c.pbh = mcuy_ * c.v;
    for (int &b : c.coef_bits) b = -1;
  }
  frame_ = true;
}

void Decoder::read_dht(int len) {
  int left = len - 2;
  while (left > 0) {
    int tc_th = u8();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) throw Corrupt("bad Huffman table class or index");
    uint8_t counts[17] = {};
    int total = 0;
    for (int i = 1; i <= 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
    if (total > 256 || 17 + total > left) throw Corrupt("bad Huffman table size");
    uint8_t sym[256];
    for (int i = 0; i < total; ++i) sym[i] = static_cast<uint8_t>(u8());
    (tc ? ac_[th] : dc_[th]).build(counts, sym, total);
    left -= 17 + total;
  }
}

void Decoder::read_dqt(int len) {
  int left = len - 2;
  while (left > 0) {
    int pq_tq = u8();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (pq > 1 || tq > 3) throw Corrupt("bad quantization table");
    for (int k = 0; k < 64; ++k) qt_[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
    qt_present_[tq] = true;
    left -= 1 + (pq ? 128 : 64);
  }
  if (left != 0) throw Corrupt("bad DQT length");
}

void Decoder::read_sos(int len) {
  int ns = u8();
  if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw Corrupt("bad scan header");
  std::vector<int> comps;
  for (int i = 0; i < ns; ++i) {
    int id = u8(), t = u8();
    int ci = -1;
    for (int k = 0; k < ncomp; ++k)
      if (comp_[k].id == id) ci = k;
    if (ci < 0) throw Corrupt("scan names an unknown component");
    comp_[ci].td = t >> 4;
    comp_[ci].ta = t & 15;
    if (comp_[ci].td > 3 || comp_[ci].ta > 3) throw Corrupt("bad Huffman table index");
    comps.push_back(ci);
  }
  int ss = u8(), se = u8(), a = u8();
  int ah = a >> 4, al = a & 15;
  if (progressive_) {
    bool dc = ss == 0;
    if (dc ? se != 0 : (se < ss || se > 63 || ns != 1)) throw Corrupt("bad progression parameters");
    if (al > 13 || ah > 13) throw Corrupt("bad successive approximation");
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  if (ns > 1) {
    int blocks = 0;
    for (int ci : comps) blocks += comp_[ci].h * comp_[ci].v;
    if (blocks > 10) throw Corrupt("too many blocks in an MCU");
  }
  for (int ci : comps) {
    Component &c = comp_[ci];
    if (!c.latched) {
      if (!qt_present_[c.tq]) throw Corrupt("component uses an undefined quantization table");
      std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.latched = true;
      c.coef.assign(static_cast<size_t>(c.pbw) * c.pbh * 64, 0);
    }
    // jdphuff.c's bookkeeping of what each coefficient's bits are
    for (int k = ss; k <= se; ++k) {
      int expected = c.coef_bits[k] < 0 ? 0 : c.coef_bits[k];
      if (progressive_ && ah != expected && !(ah == 0 && c.coef_bits[k] < 0))
        throw Corrupt("successive approximation out of order");
      c.coef_bits[k] = al;
    }
  }
  decode_scan(comps, ss, se, ah, al);
}

void Decoder::decode_block(BitReader &br, Component &c, int16_t *blk, int ss, int se, int ah,
                           int al, int &eobrun) {
  if (!progressive_) {
    int s = br.decode(dc_[c.td]);
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    const Huffman &h = ac_[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Corrupt("AC coefficient index past 63");
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (ss == 0) {  // DC scans
    if (ah == 0) {
      int s = br.decode(dc_[c.td]);
      int diff = s ? extend(br.get(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
    } else if (br.bit()) {
      blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    }
    return;
  }
  const Huffman &h = ac_[c.ta];
  if (ah == 0) {  // AC first
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Corrupt("AC coefficient index past 63");
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
    return;
  }
  // AC refinement (jdphuff.c decode_mcu_AC_refine)
  int p1 = 1 << al, m1 = -1 * (1 << al);
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) throw Corrupt("bad refinement coefficient size");
        s = br.bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        break;
      }
      do {
        int16_t *coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.bit() && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se);
      if (s) {
        if (k > 63) throw Corrupt("AC coefficient index past 63");
        blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t *coef = blk + kNatural[k];
      if (*coef != 0 && br.bit() && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --eobrun;
  }
}

void Decoder::decode_scan(const std::vector<int> &comps, int ss, int se, int ah, int al) {
  BitReader br(d_, n_, pos_);
  int eobrun = 0;
  for (int ci : comps) comp_[ci].dc_pred = 0;
  bool single = comps.size() == 1;
  int mx = single ? comp_[comps[0]].bw : mcux_;
  int my = single ? comp_[comps[0]].bh : mcuy_;
  long total = static_cast<long>(mx) * my;
  int restarts = 0;
  for (long m = 0; m < total; ++m) {
    if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
      int marker = br.take_marker();
      if (marker != 0xD0 + (restarts & 7)) throw Corrupt("missing or out-of-order restart marker");
      ++restarts;
      eobrun = 0;
      for (int ci : comps) comp_[ci].dc_pred = 0;
      BitReader fresh(d_, n_, br.pos());
      br = fresh;
    }
    int row = static_cast<int>(m / mx), col = static_cast<int>(m % mx);
    for (int ci : comps) {
      Component &c = comp_[ci];
      int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
      for (int y = 0; y < bh; ++y)
        for (int x = 0; x < bw; ++x) {
          int by = single ? row : row * c.v + y;
          int bx = single ? col : col * c.h + x;
          int16_t *blk = c.coef.data() + (static_cast<size_t>(by) * c.pbw + bx) * 64;
          decode_block(br, c, blk, ss, se, ah, al, eobrun);
        }
    }
  }
  int marker = br.take_marker();
  pos_ = br.pos();
  if (marker == 0) throw Corrupt("no EOI marker: the file is truncated");  // as PIL refuses it
  if (marker >= 0xD0 && marker <= 0xD7) marker = next_marker();  // a trailing RSTn
  if (marker == 0xD9) {
    eoi_ = true;
  } else {
    pos_ -= 2;  // let the marker loop read it
  }
}

void Decoder::decode(uint8_t *out) {
  while (!eoi_) {
    int m = next_marker();
    if (m < 0) throw Corrupt("no EOI marker: the file is truncated");
    if (m == 0xD9) break;
    if (m == 0xDA) {
      int len = u16();
      if (pos_ + len - 2 > n_) throw Corrupt("scan header runs past the end");
      read_sos(len);
      continue;
    }
    segment(m);
  }
  for (auto &c : comp_)
    if (!c.latched) throw Corrupt("a component with no scan");
  if (progressive_) {
    for (auto &c : comp_) {
      if (c.coef_bits[0] < 0) throw Corrupt("a component with no DC scan");
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          throw Unsupported(
              "a progressive JPEG whose scans leave AC coefficients unrefined (libjpeg's block "
              "smoothing)");
    }
  }
  finish(out);
}

// ---------------------------------------------------------------- IDCT ----

// jdmaster.c's prepare_range_limit_table, seen from IDCT_range_limit.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 384) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = static_cast<uint8_t>(v);
    }
  }
};
const RangeLimit kRange;

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c jpeg_idct_islow: dequantize, two 1-D passes, range limit.
void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t *ip = in + col;
    const uint16_t *qp = q + col;
    int *wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(static_cast<unsigned>(ip[0] * qp[0]) << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int row = 0; row < 8; ++row) {
    const int *wp = ws + 8 * row;
    uint8_t *op = out + static_cast<size_t>(row) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = kRange.t[descale(wp[0], kPass1Bits + 3) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits + kPass1Bits + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------- upsampling ----

// A component plane cropped to its downsampled size; rows and columns past
// its edges read the edge (jdmainct.c's context rows, jdsample.c's edges).
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  const uint8_t *row(int y) const {
    y = std::min(std::max(y, 0), h - 1);
    return px.data() + static_cast<size_t>(y) * w;
  }
};

// One row of the h2v1 triangle filter (or box at widths <= 2) into out[2w].
void h2_row(const uint8_t *in, int w, bool fancy, uint8_t *out) {
  if (!fancy) {
    for (int x = 0; x < w; ++x) out[2 * x] = out[2 * x + 1] = in[x];
    return;
  }
  out[0] = in[0];
  out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
  for (int x = 1; x < w - 1; ++x) {
    int v = in[x] * 3;
    out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
    out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
  }
  out[2 * w - 2] = static_cast<uint8_t>((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
  out[2 * w - 1] = in[w - 1];
}

// The component at full size (W x H), from its cropped plane.
std::vector<uint8_t> upsample(const Plane &p, int hr, int vr, int W, int H) {
  std::vector<uint8_t> out(static_cast<size_t>(W) * H);
  int ow = p.w * hr;
  std::vector<uint8_t> line(static_cast<size_t>(ow) + 2);
  std::vector<int> colsum(static_cast<size_t>(p.w));
  bool fancy_h = p.w > 2;
  for (int y = 0; y < H; ++y) {
    uint8_t *dst = out.data() + static_cast<size_t>(y) * W;
    if (vr == 1) {
      const uint8_t *src = p.row(y);
      if (hr == 1) {
        std::memcpy(dst, src, W);
      } else {
        h2_row(src, p.w, fancy_h, line.data());
        std::memcpy(dst, line.data(), W);
      }
      continue;
    }
    int r = y >> 1;
    bool below = y & 1;
    const uint8_t *near = p.row(r);
    const uint8_t *far = p.row(below ? r + 1 : r - 1);
    if (hr == 1) {  // h1v2_fancy_upsample
      int bias = below ? 2 : 1;
      for (int x = 0; x < W; ++x) dst[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      continue;
    }
    if (!fancy_h) {  // h2v2_upsample: box
      for (int x = 0; x < W; ++x) dst[x] = near[x >> 1];
      continue;
    }
    // h2v2_fancy_upsample
    for (int x = 0; x < p.w; ++x) colsum[x] = near[x] * 3 + far[x];
    uint8_t *o = line.data();
    int w = p.w;
    o[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
    o[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
    for (int x = 1; x < w - 1; ++x) {
      o[2 * x] = static_cast<uint8_t>((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
      o[2 * x + 1] = static_cast<uint8_t>((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
    }
    o[2 * w - 2] = static_cast<uint8_t>((colsum[w - 1] * 3 + colsum[w - 2] + 8) >> 4);
    o[2 * w - 1] = static_cast<uint8_t>((colsum[w - 1] * 4 + 7) >> 4);
    std::memcpy(dst, o, W);
  }
  return out;
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void Decoder::finish(uint8_t *out) {
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Component &c = comp_[ci];
    int pw = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.pbw + bx) * 64, c.quant,
                   plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8, pw);
    Plane p;
    p.w = c.dw;
    p.h = c.dh;
    p.px.resize(static_cast<size_t>(c.dw) * c.dh);
    for (int y = 0; y < c.dh; ++y)
      std::memcpy(p.px.data() + static_cast<size_t>(y) * c.dw, plane.data() + static_cast<size_t>(y) * pw,
                  c.dw);
    full[ci] = upsample(p, hmax_ / c.h, vmax_ / c.v, width, height);
  }
  size_t npx = static_cast<size_t>(width) * height;
  if (ncomp == 1) {
    std::memcpy(out, full[0].data(), npx);
    return;
  }
  bool ycc;
  if (jfif_) {
    ycc = true;
  } else if (adobe_) {
    ycc = adobe_transform_ != 0;
  } else {
    int a = comp_[0].id, b = comp_[1].id, c = comp_[2].id;
    ycc = !(a == 82 && b == 71 && c == 66);
  }
  if (!ycc) {
    for (size_t i = 0; i < npx; ++i)
      for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    return;
  }
  // jdcolor.c build_ycc_rgb_table
  constexpr int kScale = 16;
  constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
  auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
  for (size_t i = 0; i < npx; ++i) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i] = clamp255(y + cr_r[cr]);
    out[3 * i + 1] = clamp255(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
    out[3 * i + 2] = clamp255(y + cb_b[cb]);
  }
}

void put_msg(char *msg, int msglen, const char *text) {
  if (msg && msglen > 0) std::snprintf(msg, static_cast<size_t>(msglen), "%s", text);
}

}  // namespace

extern "C" int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out, size_t cap, int *h, int *w,
                           int *c, char *msg, int msglen) {
  try {
    Decoder dec(data, n);
    dec.read_header();
    *h = dec.height;
    *w = dec.width;
    *c = dec.ncomp;
    if (!out || cap < static_cast<size_t>(dec.height) * dec.width * dec.ncomp) return 1;
    dec.decode(out);
    return 0;
  } catch (const Unsupported &e) {
    put_msg(msg, msglen, e.what());
    return -2;
  } catch (const Corrupt &e) {
    put_msg(msg, msglen, e.what());
    return -1;
  } catch (const std::exception &e) {
    put_msg(msg, msglen, e.what());
    return -1;
  }
}
