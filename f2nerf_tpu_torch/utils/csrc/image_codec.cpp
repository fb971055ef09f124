// The port's image codec: JPEG and the pixel stage of PNG, decoded on the
// host to the uint8 RGB pixels that PIL's ``Image.open(p).convert("RGB")``
// gives (the JAX package reads images that way).
//
// JPEG: baseline, extended-sequential and progressive Huffman files
// (SOF0, SOF1, SOF2) of 8-bit precision with one or three components,
// sampling factors 1 to 4 at whole ratios. PIL decodes with libjpeg-turbo,
// and this follows its defaults: the Annex K Huffman tables where a file
// defines none (``jstdhuff.c``), the ``JDCT_ISLOW`` integer IDCT
// (``jidctint.c``), block smoothing of progressive files whose scans leave
// a low AC coefficient unrefined (``jdcoefct.c``), fancy upsampling and
// integer replication (``jdsample.c``) and the fixed-point YCbCr -> RGB of
// ``jdcolor.c``. Data that runs out inside a restart interval reads as
// zero bits for the MCU where it ran out and leaves the interval's later
// MCUs untouched, as libjpeg does. On corrupt entropy data PIL's pixels
// can differ still (the plain Python decoder agrees with this one there).
// Lossless, hierarchical and arithmetic-coded files, 12-bit precision,
// 2- or 4-component files and fractional sampling ratios raise, naming
// the gap.
//
// PNG: the caller parses the chunks and inflates IDAT; this undoes the
// five row filters and Adam7 interlacing and converts every colour type
// at every bit depth the standard allows as PIL's modes do: grey at 1 bit
// is 0 / 255, at 2 and 4 bits scaled by 85 and 17, at 16 bits saturated
// at 255 (PIL's ``I;16`` -> ``RGB``); 16-bit RGB, RGBA and grey + alpha
// keep the high byte of each sample; a palette index past the PLTE entries
// (any index, where there is no PLTE) is black; alpha and tRNS are
// dropped.
//
// Plain C interface for ctypes; errors come back as a message in ``err``.
// Build: c++ -std=c++17 -O2 -shared -fPIC -o image_codec.so image_codec.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw CodecError(what); }

// -- JPEG -------------------------------------------------------------------

// natural (row-major) index of each zigzag position, padded with 16 entries
// of 63: a corrupt run past a block's end writes position 63, as libjpeg's
// padded table makes it
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K's tables, which libjpeg-turbo puts in slots 0 and 1 of a file
// that defines none there (Motion-JPEG frames leave them out)
constexpr uint8_t kStdDcCounts[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdDcSymbols[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcCounts[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
constexpr uint8_t kStdAcSymbols[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// what each start-of-frame marker other than SOF0-2 codes
const char* sof_gap(int marker) {
  switch (marker) {
    case 0xC3: return "lossless JPEG (SOF3)";
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC9: return "arithmetic-coded JPEG (SOF9)";
    case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive JPEG (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
    default: return nullptr;
  }
}

// A canonical Huffman code as a 16-bit lookahead: for every 16-bit window
// of the stream, (length of the code it starts with) << 8 | symbol.
// Windows that start with no code decode as symbol 0 after 17 bits, as
// libjpeg fakes a zero for a bad code once its search reaches the
// sentinel length 17.
struct Huffman {
  std::vector<uint16_t> look;

  bool defined() const { return !look.empty(); }

  void build(const uint8_t* counts, const uint8_t* symbols, bool dc) {
    look.assign(65536, uint16_t(17 << 8));
    uint32_t code = 0;
    int i = 0;
    for (int n = 1; n <= 16; ++n) {
      for (int j = 0; j < counts[n - 1]; ++j, ++i, ++code) {
        uint32_t lo = code << (16 - n), hi = (code + 1) << (16 - n);
        if (hi > 65536)
          fail("corrupt JPEG: a Huffman table assigns more codes than its "
               "lengths allow");
        if (dc && symbols[i] > 15)
          fail("corrupt JPEG: a DC Huffman table has a symbol above 15");
        std::fill(look.begin() + lo, look.begin() + hi,
                  uint16_t(n << 8 | symbols[i]));
      }
      code <<= 1;
    }
  }
};

// The bits of one restart interval's unstuffed bytes, read through a 64-bit
// buffer; reading past the end reads zeros, as libjpeg does once it meets a
// marker.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t next = 0;   // the next byte to load
  uint64_t acc = 0;  // the unread bits, left-aligned
  int have = 0;      // bits in acc
  size_t used = 0;   // bits consumed

  void fill() {
    while (have <= 56) {
      acc |= uint64_t(next < n ? d[next] : 0) << (56 - have);
      ++next;
      have += 8;
    }
  }
  void skip(int k) {
    acc <<= k;
    have -= k;
    used += k;
  }
  int bits(int k) {  // k <= 16
    if (k == 0) return 0;
    if (have < k) fill();
    int v = int(acc >> (64 - k));
    skip(k);
    return v;
  }
  int decode(const Huffman& t) {
    if (have < 17) fill();
    uint16_t e = t.look[acc >> 48];
    skip(e >> 8);
    return e & 0xFF;
  }
  bool exhausted() const { return used > 8 * n; }
};

// HUFF_EXTEND: s magnitude bits -> the signed value
inline int extend(int x, int s) {
  return s == 0 ? 0 : (x < (1 << (s - 1)) ? x - (1 << s) + 1 : x);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  bool latched = false;   // quantization table latched at its first scan
  uint16_t q[64] = {};    // natural order
  int bw = 0, bh = 0;     // blocks stored (whole MCUs)
  int wb = 0, hb = 0;     // blocks holding image samples
  int dw = 0, dh = 0;     // samples (downsampled size)
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
  int coef_bits[64];      // progressive: Al of the last scan, -1 for none
  int16_t* block(int r, int c) {
    return coef.data() + (size_t(r) * bw + c) * 64;
  }
};

struct Jpeg {
  const uint8_t* buf;
  size_t n;
  int height = 0, width = 0;
  bool frame = false, progressive = false;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1, mx = 0, my = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false;
  int adobe = -1;
  bool std_tables_done = false;

  Jpeg(const uint8_t* b, size_t len) : buf(b), n(len) {}

  uint16_t be16(size_t at) const {
    return uint16_t(buf[at] << 8 | buf[at + 1]);
  }

  // Parse markers (and decode scans unless ``header_only``) up to EOI, or
  // up to the frame header when ``header_only``.
  void run(bool header_only);
  void read_frame(const uint8_t* seg, size_t len, int marker);
  void read_dht(const uint8_t* seg, size_t len);
  void read_dqt(const uint8_t* seg, size_t len);
  size_t read_scan(const uint8_t* seg, size_t len, size_t pos);
  void output(uint8_t* out);
};

void Jpeg::run(bool header_only) {
  if (n < 2 || buf[0] != 0xFF || buf[1] != 0xD8) fail("not a JPEG file");
  size_t pos = 2;
  for (;;) {
    // fill bytes and stray bytes before a marker are skipped, as libjpeg
    // skips them
    while (pos < n && buf[pos] != 0xFF) ++pos;
    while (pos < n && buf[pos] == 0xFF) ++pos;
    if (pos >= n) fail("corrupt JPEG: the file ends before EOI");
    int marker = buf[pos++];
    if (marker == 0xD9) break;
    if (marker == 0x01 || marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7))
      continue;
    if (pos + 2 > n) fail("corrupt JPEG: a marker segment is truncated");
    size_t len = be16(pos);
    if (len < 2 || pos + len > n) {
      char msg[80];
      std::snprintf(msg, sizeof msg,
                    "corrupt JPEG: marker 0x%02X segment is truncated", marker);
      fail(msg);
    }
    const uint8_t* seg = buf + pos + 2;
    size_t seg_len = len - 2;
    pos += len;
    if (const char* gap = sof_gap(marker))
      fail(std::string(gap) + " is not supported: only baseline, "
           "extended-sequential and progressive Huffman JPEGs (SOF0, SOF1, "
           "SOF2) are read");
    if (marker == 0xC8 || marker == 0xCC)
      fail("arithmetic-coded JPEG (DAC / JPG marker) is not supported: only "
           "Huffman coding is read");
    if (marker >= 0xC0 && marker <= 0xC2) {
      read_frame(seg, seg_len, marker);
      if (header_only) return;
    } else if (marker == 0xC4) {
      read_dht(seg, seg_len);
    } else if (marker == 0xDB) {
      read_dqt(seg, seg_len);
    } else if (marker == 0xDD) {
      if (seg_len < 2) fail("corrupt JPEG: bad DRI segment");
      restart = seg[0] << 8 | seg[1];
    } else if (marker == 0xE0 && seg_len >= 14 &&
               std::memcmp(seg, "JFIF\0", 5) == 0) {
      jfif = true;
    } else if (marker == 0xEE && seg_len >= 12 &&
               std::memcmp(seg, "Adobe", 5) == 0) {
      adobe = seg[11];
    } else if (marker == 0xDA) {
      if (!frame) fail("corrupt JPEG: a scan before the frame header");
      if (header_only) return;
      pos = read_scan(seg, seg_len, pos);
    }
  }
  if (!frame) fail("corrupt JPEG: no frame header");
}

void Jpeg::read_frame(const uint8_t* seg, size_t len, int marker) {
  if (frame) fail("corrupt JPEG: two frame headers");
  if (len < 6) fail("corrupt JPEG: bad frame header");
  int prec = seg[0];
  height = seg[1] << 8 | seg[2];
  width = seg[3] << 8 | seg[4];
  int nc = seg[5];
  if (prec != 8)
    fail(std::to_string(prec) + "-bit JPEG is not supported: only 8-bit "
         "precision is read");
  if (nc != 1 && nc != 3)
    fail(std::to_string(nc) + "-component JPEG" +
         (nc == 4 ? " (CMYK / YCCK)" : "") +
         " is not supported: only grey (1) and 3 components are read");
  if (height == 0 || width == 0)
    fail("JPEG with a zero or DNL-defined size is not supported");
  if (len < size_t(6 + 3 * nc)) fail("corrupt JPEG: bad frame header");
  comps.resize(nc);
  for (int i = 0; i < nc; ++i) {
    Component& c = comps[i];
    c.id = seg[6 + 3 * i];
    c.h = seg[7 + 3 * i] >> 4;
    c.v = seg[7 + 3 * i] & 15;
    c.tq = seg[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
      fail("corrupt JPEG: sampling factors " + std::to_string(c.h) + "x" +
           std::to_string(c.v) + " (each is 1 to 4)");
    if (c.tq > 3) fail("corrupt JPEG: quantization table index above 3");
    hmax = std::max(hmax, c.h);
    vmax = std::max(vmax, c.v);
  }
  for (auto& c : comps)
    if (hmax % c.h || vmax % c.v)
      fail("JPEG sampling factors " + std::to_string(c.h) + "x" +
           std::to_string(c.v) + " against " + std::to_string(hmax) + "x" +
           std::to_string(vmax) + " are not supported: the upsampling "
           "ratio is fractional, which libjpeg does not implement either");
  mx = (width + 8 * hmax - 1) / (8 * hmax);
  my = (height + 8 * vmax - 1) / (8 * vmax);
  for (auto& c : comps) {
    c.dw = (width * c.h + hmax - 1) / hmax;
    c.dh = (height * c.v + vmax - 1) / vmax;
    c.wb = (c.dw + 7) / 8;
    c.hb = (c.dh + 7) / 8;
    c.bw = mx * c.h;
    c.bh = my * c.v;
    c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    std::fill(c.coef_bits, c.coef_bits + 64, -1);
  }
  progressive = marker == 0xC2;
  frame = true;
}

void Jpeg::read_dht(const uint8_t* seg, size_t len) {
  size_t i = 0;
  while (i < len) {
    if (i + 17 > len) fail("corrupt JPEG: bad DHT segment");
    int tc = seg[i] >> 4, th = seg[i] & 15;
    const uint8_t* counts = seg + i + 1;
    size_t total = 0;
    for (int k = 0; k < 16; ++k) total += counts[k];
    if (tc > 1 || th > 3 || total > 256 || i + 17 + total > len)
      fail("corrupt JPEG: bad DHT segment");
    (tc ? ac : dc)[th].build(counts, seg + i + 17, tc == 0);
    i += 17 + total;
  }
}

void Jpeg::read_dqt(const uint8_t* seg, size_t len) {
  size_t i = 0;
  while (i < len) {
    int pq = seg[i] >> 4, tq = seg[i] & 15;
    size_t size = pq ? 128 : 64;
    if (tq > 3 || i + 1 + size > len) fail("corrupt JPEG: bad DQT segment");
    for (int k = 0; k < 64; ++k)
      qt[tq][kNatural[k]] = pq ? uint16_t(seg[i + 1 + 2 * k] << 8 |
                                          seg[i + 2 + 2 * k])
                               : seg[i + 1 + k];
    qt_defined[tq] = true;
    i += 1 + size;
  }
}

// One block of a sequential scan: its DC difference and AC run/values.
void decode_sequential(BitReader& br, int16_t* blk, const Huffman& dct,
                       const Huffman& act, int& pred) {
  int s = br.decode(dct);
  pred += extend(br.bits(s), s);
  blk[0] = int16_t(pred);
  for (int k = 1; k < 64; ++k) {
    int rs = br.decode(act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = int16_t(extend(br.bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void decode_dc_first(BitReader& br, int16_t* blk, const Huffman& dct,
                     int& pred, int al) {
  int s = br.decode(dct);
  pred += extend(br.bits(s), s);
  blk[0] = int16_t(unsigned(pred) << al);
}

void decode_ac_first(BitReader& br, int16_t* blk, const Huffman& act, int ss,
                     int se, int al, int& eobrun) {
  if (eobrun > 0) {
    --eobrun;
    return;
  }
  for (int k = ss; k <= se; ++k) {
    int rs = br.decode(act);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = int16_t(unsigned(extend(br.bits(s), s)) << al);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun = (1 << r) + br.bits(r) - 1;
      break;
    }
  }
}

// a correction bit for an already nonzero coefficient
inline void refine(BitReader& br, int16_t* c, int p1) {
  if (br.bits(1) && (*c & p1) == 0) *c = int16_t(*c + (*c >= 0 ? p1 : -p1));
}

void decode_ac_refine(BitReader& br, int16_t* blk, const Huffman& act, int ss,
                      int se, int al, int& eobrun) {
  const int p1 = 1 << al;
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.bits(1) ? p1 : -p1;
      } else if (r != 15) {
        eobrun = (1 << r) + br.bits(r);
        break;
      }
      // skip the nonzero coefficients (refining them) and r zero ones
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          refine(br, c, p1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) blk[kNatural[k]] = int16_t(s);
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* c = blk + kNatural[k];
      if (*c != 0) refine(br, c, p1);
    }
    --eobrun;
  }
}

size_t Jpeg::read_scan(const uint8_t* seg, size_t len, size_t pos) {
  if (len < 1) fail("corrupt JPEG: bad SOS segment");
  int ns = seg[0];
  if (ns < 1 || ns > 4 || len < size_t(4 + 2 * ns))
    fail("corrupt JPEG: bad SOS segment");
  std::vector<int> sc(ns), tdc(ns), tac(ns);
  for (int i = 0; i < ns; ++i) {
    int cid = seg[1 + 2 * i], t = seg[2 + 2 * i];
    int found = -1;
    for (size_t k = 0; k < comps.size(); ++k)
      if (comps[k].id == cid) found = int(k);
    for (int j = 0; j < i; ++j)
      if (sc[j] == found) found = -1;
    if (found < 0 || (t >> 4) > 3 || (t & 15) > 3)
      fail("corrupt JPEG: a scan names an undefined component or Huffman "
           "table");
    sc[i] = found;
    tdc[i] = t >> 4;
    tac[i] = t & 15;
  }
  if (ns > 1) {
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += comps[sc[i]].h * comps[sc[i]].v;
    if (blocks > 10) fail("corrupt JPEG: more than 10 blocks in an MCU");
  }
  int ss = seg[1 + 2 * ns], se = seg[2 + 2 * ns];
  int ah = seg[3 + 2 * ns] >> 4, al = seg[3 + 2 * ns] & 15;

  // libjpeg-turbo fills the empty slots 0 and 1 with Annex K's tables
  if (!std_tables_done) {
    for (int t = 0; t < 2; ++t) {
      if (!dc[t].defined()) dc[t].build(kStdDcCounts[t], kStdDcSymbols, true);
      if (!ac[t].defined())
        ac[t].build(kStdAcCounts[t], kStdAcSymbols[t], false);
    }
    std_tables_done = true;
  }
  bool dc_scan = ss == 0;
  if (progressive) {
    bool bad = dc_scan ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13 || bad)
      fail("corrupt JPEG: invalid progressive scan parameters Ss=" +
           std::to_string(ss) + " Se=" + std::to_string(se) + " Ah=" +
           std::to_string(ah) + " Al=" + std::to_string(al));
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  for (int i = 0; i < ns; ++i) {
    Component& c = comps[sc[i]];
    bool need_dc = !progressive || (dc_scan && ah == 0);
    bool need_ac = !progressive || !dc_scan;
    if ((need_dc && !dc[tdc[i]].defined()) ||
        (need_ac && !ac[tac[i]].defined()))
      fail("corrupt JPEG: a scan names an undefined component or Huffman "
           "table");
    if (!c.latched) {
      if (!qt_defined[c.tq])
        fail("corrupt JPEG: quantization table " + std::to_string(c.tq) +
             " is not defined");
      std::memcpy(c.q, qt[c.tq], sizeof c.q);
      c.latched = true;
    }
    if (progressive)
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
  }

  // the entropy-coded data up to the next marker that is not a restart,
  // unstuffed (0xFF 0x00 -> 0xFF, fill bytes dropped), split at restarts
  std::vector<uint8_t> data;
  data.reserve(n - pos);
  std::vector<size_t> starts{0};
  size_t end = n;
  while (pos < n) {
    uint8_t b = buf[pos];
    if (b != 0xFF) {
      data.push_back(b);
      ++pos;
      continue;
    }
    size_t q = pos + 1;
    while (q < n && buf[q] == 0xFF) ++q;
    if (q >= n) {
      pos = n;
      break;
    }
    if (buf[q] == 0x00) {
      data.push_back(0xFF);
      pos = q + 1;
    } else if (buf[q] >= 0xD0 && buf[q] <= 0xD7) {
      starts.push_back(data.size());
      pos = q + 1;
    } else {
      end = q - 1;
      break;
    }
  }
  if (pos >= n) end = n;
  starts.push_back(data.size());

  // the MCUs: one block each in a one-component scan, else every
  // component's h x v blocks
  long n_mcu;
  if (ns == 1) {
    const Component& c = comps[sc[0]];
    n_mcu = long(c.wb) * c.hb;
  } else {
    n_mcu = long(mx) * my;
  }
  long per = restart ? restart : n_mcu;
  long n_int = n_mcu ? (n_mcu + per - 1) / per : 0;
  long mcu = 0;
  for (long j = 0; j < n_int; ++j) {
    BitReader br;
    if (size_t(j) + 1 < starts.size()) {
      br.d = data.data() + starts[j];
      br.n = starts[j + 1] - starts[j];
    }
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    bool insufficient = false;
    for (long m = 0; m < per && mcu < n_mcu; ++m, ++mcu) {
      if (insufficient) continue;
      for (int i = 0; i < ns; ++i) {
        Component& c = comps[sc[i]];
        int rows = ns == 1 ? 1 : c.v, cols = ns == 1 ? 1 : c.h;
        for (int by = 0; by < rows; ++by) {
          for (int bx = 0; bx < cols; ++bx) {
            int16_t* blk;
            if (ns == 1)
              blk = c.block(int(mcu / c.wb), int(mcu % c.wb));
            else
              blk = c.block(int(mcu / mx) * c.v + by, int(mcu % mx) * c.h + bx);
            if (!progressive)
              decode_sequential(br, blk, dc[tdc[i]], ac[tac[i]], pred[i]);
            else if (dc_scan && ah == 0)
              decode_dc_first(br, blk, dc[tdc[i]], pred[i], al);
            else if (dc_scan)
              blk[0] = int16_t(blk[0] | (br.bits(1) << al));
            else if (ah == 0)
              decode_ac_first(br, blk, ac[tac[i]], ss, se, al, eobrun);
            else
              decode_ac_refine(br, blk, ac[tac[i]], ss, se, al, eobrun);
          }
        }
      }
      // data ran out in this MCU: libjpeg leaves the interval's later MCUs
      // as they are
      if (br.exhausted()) insufficient = true;
    }
  }
  return end;
}

// -- reconstruction ---------------------------------------------------------

// One pass of jpeg_idct_islow (CONST_BITS 13) over x[0], x[step], ...,
// descaled by ``shift`` bits.
inline void idct_1d(const int64_t* x, int step, int shift, int64_t* out,
                    int ostep) {
  int64_t x0 = x[0], x1 = x[step], x2 = x[2 * step], x3 = x[3 * step];
  int64_t x4 = x[4 * step], x5 = x[5 * step], x6 = x[6 * step],
          x7 = x[7 * step];
  int64_t z1 = (x2 + x6) * 4433;          // FIX_0_541196100
  int64_t tmp2 = z1 + x6 * -15137;        // FIX_1_847759065
  int64_t tmp3 = z1 + x2 * 6270;          // FIX_0_765366865
  int64_t tmp0 = (x0 + x4) * 8192;
  int64_t tmp1 = (x0 - x4) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x7, t1 = x5, t2 = x3, t3 = x1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * 9633;          // FIX_1_175875602
  t0 *= 2446;                             // FIX_0_298631336
  t1 *= 16819;                            // FIX_2_053119869
  t2 *= 25172;                            // FIX_3_072711026
  t3 *= 12299;                            // FIX_1_501321110
  z1 *= -7373;                            // FIX_0_899976223
  z2 *= -20995;                           // FIX_2_562915447
  z3 = z3 * -16069 + z5;                  // FIX_1_961570560
  z4 = z4 * -3196 + z5;                   // FIX_0_390180644
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  int64_t half = int64_t(1) << (shift - 1);
  out[0] = (tmp10 + t3 + half) >> shift;
  out[7 * ostep] = (tmp10 - t3 + half) >> shift;
  out[1 * ostep] = (tmp11 + t2 + half) >> shift;
  out[6 * ostep] = (tmp11 - t2 + half) >> shift;
  out[2 * ostep] = (tmp12 + t1 + half) >> shift;
  out[5 * ostep] = (tmp12 - t1 + half) >> shift;
  out[3 * ostep] = (tmp13 + t0 + half) >> shift;
  out[4 * ostep] = (tmp13 - t0 + half) >> shift;
}

// libjpeg's post-IDCT table, indexed by the descaled value & 1023: the value
// + 128 clamped to [0, 255] for values in [-512, 511]; values outside wrap
// as the table's mask makes them
inline uint8_t range_limit(int64_t v) {
  int x = int(v & 1023);
  return uint8_t(x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896);
}

// dequantize (16-bit coefficients and multipliers, as in libjpeg) and
// inverse-transform one block into ``out`` (row stride ``stride``)
// inverse-transform one block into ``out`` (row stride ``stride``). A column
// or row whose AC inputs are all zero takes libjpeg's shortcut, which gives
// the same values: the DC descaled alone.
void idct_block(const int16_t* blk, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int64_t in[64], ws[64], px[64];
  for (int i = 0; i < 64; ++i) in[i] = int64_t(blk[i]) * int16_t(q[i]);
  for (int col = 0; col < 8; ++col) {
    const int64_t* x = in + col;
    if ((x[8] | x[16] | x[24] | x[32] | x[40] | x[48] | x[56]) == 0) {
      for (int r = 0; r < 8; ++r) ws[8 * r + col] = x[0] * 4;  // PASS1_BITS
    } else {
      idct_1d(x, 8, 13 - 2, ws + col, 8);
    }
  }
  for (int row = 0; row < 8; ++row) {
    const int64_t* x = ws + 8 * row;
    if ((x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]) == 0) {
      std::fill(px + 8 * row, px + 8 * row + 8, (x[0] + 16) >> 5);
    } else {
      idct_1d(x, 1, 13 + 2 + 3, px + 8 * row, 1);
    }
  }
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      out[r * stride + c] = range_limit(px[8 * r + c]);
}

// libjpeg-turbo's block smoothing (jdcoefct.c, decompress_smooth_data):
// where a scan script leaves one of the first nine AC coefficients of a
// component unrefined, each block's zero estimates of them are filled from
// the 5x5 neighbourhood of DC values; a component with no AC data at all
// has its DC interpolated too.
bool smoothing_ok(const std::vector<Component>& comps) {
  static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (const auto& c : comps) {
    if (!c.latched) return false;
    for (int p : pos)
      if (c.q[p] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

inline int smooth_pred(int64_t num, int64_t q00, int64_t q, int al,
                       bool clamp) {
  num *= q00;
  int pred;
  if (num >= 0) {
    pred = int(((q << 7) + num) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = int(((q << 7) - num) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

void smooth_component(Component& c, int total_imcu_rows) {
  const int* bits = c.coef_bits;
  bool change_dc = true;
  for (int k = 1; k < 10; ++k)
    if (bits[k] != -1) change_dc = false;
  const int64_t q00 = c.q[0];
  auto qv = [&](int p) { return int64_t(c.q[p]); };
  std::vector<int16_t> out(c.coef);
  const int last_imcu = total_imcu_rows - 1;
  const int last_col = c.wb - 1;
  for (int imcu = 0; imcu < total_imcu_rows; ++imcu) {
    int block_rows = c.v;
    if (imcu == last_imcu) {
      block_rows = c.hb % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    for (int br = 0; br < block_rows; ++br) {
      int row = imcu * c.v + br;
      // libjpeg-turbo counts rows by this iMCU row's block rows, which
      // are fewer than v_samp in the last one
      const int image_row = imcu * block_rows + br;
      const int image_rows = block_rows * total_imcu_rows;
      int prev = image_row > 0 ? row - 1 : row;
      int prev2 = image_row > 1 ? row - 2 : prev;
      int next = image_row < image_rows - 1 ? row + 1 : row;
      int next2 = image_row < image_rows - 2 ? row + 2 : next;
      const int rows[5] = {prev2, prev, row, next, next2};
      for (int col = 0; col <= last_col; ++col) {
        int dcv[26];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) {
            int cc = std::min(std::max(col + j - 2, 0), last_col);
            dcv[1 + 5 * i + j] = c.coef[(size_t(rows[i]) * c.bw + cc) * 64];
          }
        const int *D = dcv;
        int16_t* w = out.data() + (size_t(row) * c.bw + col) * 64;
        int al;
        if ((al = bits[1]) != 0 && w[1] == 0) {
          int64_t num = change_dc
              ? -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] -
                    13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] -
                    38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                    13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]
              : -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15];
          w[1] = int16_t(smooth_pred(num, q00, qv(1), al, true));
        }
        if ((al = bits[2]) != 0 && w[8] == 0) {
          int64_t num = change_dc
              ? -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                    13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                    13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                    3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]
              : -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23];
          w[8] = int16_t(smooth_pred(num, q00, qv(8), al, true));
        }
        if ((al = bits[3]) != 0 && w[16] == 0) {
          int64_t num = change_dc
              ? D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                    14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] +
                    2 * D[19] + D[23]
              : -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23];
          w[16] = int16_t(smooth_pred(num, q00, qv(16), al, true));
        }
        if ((al = bits[4]) != 0 && w[9] == 0) {
          int64_t num = change_dc
              ? -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                    D[21] - D[25]
              : D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] +
                    D[22] - D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9];
          w[9] = int16_t(smooth_pred(num, q00, qv(9), al, true));
        }
        if ((al = bits[5]) != 0 && w[2] == 0) {
          int64_t num = change_dc
              ? 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                    14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] +
                    2 * D[19]
              : -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15];
          w[2] = int16_t(smooth_pred(num, q00, qv(2), al, true));
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && w[3] == 0)
            w[3] = int16_t(smooth_pred(D[7] - D[9] + 2 * D[12] - 2 * D[14] +
                                           D[17] - D[19],
                                       q00, qv(3), al, true));
          if ((al = bits[7]) != 0 && w[10] == 0)
            w[10] = int16_t(smooth_pred(D[7] - 3 * D[8] + D[9] - D[17] +
                                            3 * D[18] - D[19],
                                        q00, qv(10), al, true));
          if ((al = bits[8]) != 0 && w[17] == 0)
            w[17] = int16_t(smooth_pred(D[7] - D[9] - 3 * D[12] + 3 * D[14] +
                                            D[17] - D[19],
                                        q00, qv(17), al, true));
          if ((al = bits[9]) != 0 && w[24] == 0)
            w[24] = int16_t(smooth_pred(D[7] + 2 * D[8] + D[9] - D[17] -
                                            2 * D[18] - D[19],
                                        q00, qv(24), al, true));
          int64_t num =
              -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
              6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
              8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] -
              6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] -
              2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25];
          w[0] = int16_t(smooth_pred(num, q00, q00, 0, false));
        }
      }
    }
  }
  c.coef.swap(out);
}

// libjpeg-turbo's upsampling of a component whose real size is dh x dw by
// the integers (fy, fx): h2v1 / h1v2 / h2v2 fancy upsampling, plain
// replication for the other ratios (int_upsample) and for h2v1 / h2v2
// where dw <= 2; the edges replicated from the real samples, not the MCU
// padding. ``plane`` has row stride ``stride``; the result is
// (fy * dh) x (fx * dw).
std::vector<uint8_t> upsample(const uint8_t* plane, size_t stride, int dh,
                              int dw, int fy, int fx) {
  const int oh = fy * dh, ow = fx * dw;
  std::vector<uint8_t> out(size_t(oh) * ow);
  auto at = [&](int r, int c) -> int {
    r = std::min(std::max(r, 0), dh - 1);
    c = std::min(std::max(c, 0), dw - 1);
    return plane[size_t(r) * stride + c];
  };
  if (fy == 1 && fx == 1) {
    for (int r = 0; r < dh; ++r)
      std::memcpy(out.data() + size_t(r) * ow, plane + size_t(r) * stride, dw);
  } else if (fx > 2 || fy > 2 || (fx == 2 && dw <= 2)) {
    for (int r = 0; r < oh; ++r)
      for (int c = 0; c < ow; ++c)
        out[size_t(r) * ow + c] = uint8_t(at(r / fy, c / fx));
  } else if (fx == 1) {
    for (int r = 0; r < dh; ++r)
      for (int c = 0; c < dw; ++c) {
        int x = 3 * at(r, c);
        out[size_t(2 * r) * ow + c] = uint8_t((x + at(r - 1, c) + 1) >> 2);
        out[size_t(2 * r + 1) * ow + c] = uint8_t((x + at(r + 1, c) + 2) >> 2);
      }
  } else if (fy == 1) {
    for (int r = 0; r < dh; ++r) {
      uint8_t* o = out.data() + size_t(r) * ow;
      for (int c = 0; c < dw; ++c) {
        int x = 3 * at(r, c);
        o[2 * c] = uint8_t((x + at(r, c - 1) + 1) >> 2);
        o[2 * c + 1] = uint8_t((x + at(r, c + 1) + 2) >> 2);
      }
    }
  } else {
    std::vector<int> sum(dw + 2);
    for (int r = 0; r < dh; ++r) {
      for (int half = 0; half < 2; ++half) {
        int nb = half ? r + 1 : r - 1;
        for (int c = -1; c <= dw; ++c) sum[c + 1] = 3 * at(r, c) + at(nb, c);
        uint8_t* o = out.data() + size_t(2 * r + half) * ow;
        for (int c = 0; c < dw; ++c) {
          int x = 3 * sum[c + 1];
          o[2 * c] = uint8_t((x + sum[c] + 8) >> 4);
          o[2 * c + 1] = uint8_t((x + sum[c + 2] + 7) >> 4);
        }
      }
    }
  }
  return out;
}

void Jpeg::output(uint8_t* out) {
  if (progressive && smoothing_ok(comps)) {
    int total = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) smooth_component(c, total);
  }
  const int h = height, w = width;
  std::vector<std::vector<uint8_t>> planes;
  std::vector<int> widths;
  for (auto& c : comps) {
    // a component no scan reached has no multipliers: every sample is 128
    size_t stride = size_t(c.wb) * 8;
    std::vector<uint8_t> plane(stride * c.hb * 8);
    for (int r = 0; r < c.hb; ++r)
      for (int col = 0; col < c.wb; ++col)
        idct_block(c.block(r, col), c.q,
                   plane.data() + size_t(r) * 8 * stride + col * 8, stride);
    int fy = vmax / c.v, fx = hmax / c.h;
    planes.push_back(upsample(plane.data(), stride, c.dh, c.dw, fy, fx));
    widths.push_back(fx * c.dw);
  }
  if (planes.size() == 1) {
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        uint8_t y = planes[0][size_t(r) * widths[0] + c];
        uint8_t* o = out + (size_t(r) * w + c) * 3;
        o[0] = o[1] = o[2] = y;
      }
    return;
  }
  // libjpeg's guess of the colour space: JFIF means YCbCr, else an Adobe
  // marker's transform says, else component ids 'R', 'G', 'B'
  bool rgb;
  if (jfif)
    rgb = false;
  else if (adobe >= 0)
    rgb = adobe == 0;
  else
    rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  // jdcolor.c's tables (SCALEBITS 16)
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int x = i - 128, half = 1 << 15;
    cr_r[i] = (int(1.40200 * 65536 + 0.5) * x + half) >> 16;
    cb_b[i] = (int(1.77200 * 65536 + 0.5) * x + half) >> 16;
    cr_g[i] = -int(0.71414 * 65536 + 0.5) * x;
    cb_g[i] = -int(0.34414 * 65536 + 0.5) * x + half;
  }
  auto clamp = [](int v) { return uint8_t(std::min(std::max(v, 0), 255)); };
  for (int r = 0; r < h; ++r) {
    const uint8_t* py = planes[0].data() + size_t(r) * widths[0];
    const uint8_t* pb = planes[1].data() + size_t(r) * widths[1];
    const uint8_t* pr = planes[2].data() + size_t(r) * widths[2];
    uint8_t* o = out + size_t(r) * w * 3;
    for (int c = 0; c < w; ++c, o += 3) {
      if (rgb) {
        o[0] = py[c];
        o[1] = pb[c];
        o[2] = pr[c];
      } else {
        const int y = py[c];
        o[0] = clamp(y + cr_r[pr[c]]);
        o[1] = clamp(y + ((cb_g[pb[c]] + cr_g[pr[c]]) >> 16));
        o[2] = clamp(y + cb_b[pb[c]]);
      }
    }
  }
}

// -- PNG --------------------------------------------------------------------

bool png_depth_ok(int colour, int depth) {
  switch (colour) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

struct Pass {
  int x0, y0, dx, dy;
};
constexpr Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                            {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                            {0, 1, 1, 2}};

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

void png_pixels(const uint8_t* raw, size_t n, int w, int h, int depth,
                int colour, int interlace, const uint8_t* palette,
                int n_palette, uint8_t* out) {
  if (w <= 0 || h <= 0) fail("PNG with a zero width or height");
  if (!png_depth_ok(colour, depth))
    fail("PNG colour type " + std::to_string(colour) + " at bit depth " +
         std::to_string(depth) + " is not defined");
  if (interlace != 0 && interlace != 1)
    fail("PNG interlace method " + std::to_string(interlace) +
         " is not defined");
  const int channels = colour == 0 || colour == 3 ? 1 : colour == 4 ? 2
                       : colour == 2 ? 3 : 4;
  const int pixel_bits = channels * depth;
  const int bpp = std::max(1, pixel_bits / 8);
  const Pass whole{0, 0, 1, 1};
  const Pass* passes = interlace ? kAdam7 : &whole;
  const int n_pass = interlace ? 7 : 1;
  size_t need = 0;
  for (int i = 0; i < n_pass; ++i) {
    const Pass& ps = passes[i];
    size_t pw = w > ps.x0 ? size_t(w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    size_t ph = h > ps.y0 ? size_t(h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (pw && ph) need += ph * (1 + (pw * pixel_bits + 7) / 8);
  }
  if (n < need)
    fail("PNG image data holds " + std::to_string(n) + " bytes, expected " +
         std::to_string(need));
  std::vector<uint8_t> prev, cur;
  size_t at = 0;
  const int mask = (1 << depth) - 1;
  for (int i = 0; i < n_pass; ++i) {
    const Pass& ps = passes[i];
    int pw = w > ps.x0 ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    int ph = h > ps.y0 ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (!pw || !ph) continue;  // an empty pass has no rows, not even filters
    const size_t row_bytes = (size_t(pw) * pixel_bits + 7) / 8;
    prev.assign(row_bytes, 0);
    cur.resize(row_bytes);
    for (int r = 0; r < ph; ++r) {
      int filter = raw[at];
      const uint8_t* src = raw + at + 1;
      at += 1 + row_bytes;
      if (filter > 4)
        fail("PNG row filter type " + std::to_string(filter) +
             " is not one of the five defined (0-4)");
      for (size_t k = 0; k < row_bytes; ++k) {
        int a = k >= size_t(bpp) ? cur[k - bpp] : 0;
        int b = prev[k];
        int c = k >= size_t(bpp) ? prev[k - bpp] : 0;
        int pred = filter == 0 ? 0 : filter == 1 ? a : filter == 2 ? b
                   : filter == 3 ? (a + b) >> 1 : paeth(a, b, c);
        cur[k] = uint8_t(src[k] + pred);
      }
      const int y = ps.y0 + r * ps.dy;
      for (int x = 0; x < pw; ++x) {
        uint8_t* o = out + (size_t(y) * w + ps.x0 + size_t(x) * ps.dx) * 3;
        if (depth < 8) {
          size_t bit = size_t(x) * depth;
          int v = (cur[bit >> 3] >> (8 - depth - int(bit & 7))) & mask;
          if (colour == 3) {
            for (int k = 0; k < 3; ++k)
              o[k] = v < n_palette ? palette[3 * v + k] : 0;
          } else {
            o[0] = o[1] = o[2] = uint8_t(depth == 1 ? v * 255 : depth == 2
                                                               ? v * 85
                                                               : v * 17);
          }
          continue;
        }
        const uint8_t* s = cur.data() + size_t(x) * bpp;
        const int step = depth / 8;  // the high byte of each 16-bit sample
        switch (colour) {
          case 0:
            o[0] = o[1] = o[2] = depth == 8 ? s[0] : (s[0] ? 255 : s[1]);
            break;
          case 3:
            for (int k = 0; k < 3; ++k)
              o[k] = s[0] < n_palette ? palette[3 * s[0] + k] : 0;
            break;
          case 4:
            o[0] = o[1] = o[2] = s[0];
            break;
          default:
            o[0] = s[0];
            o[1] = s[step];
            o[2] = s[2 * step];
        }
      }
      std::swap(prev, cur);
      cur.resize(row_bytes);
    }
  }
}

int report(const char* what, char* err, size_t err_len) {
  if (err && err_len) {
    std::strncpy(err, what, err_len - 1);
    err[err_len - 1] = '\0';
  }
  return 1;
}

template <class F>
int guarded(F&& body, char* err, size_t err_len) {
  try {
    body();
    return 0;
  } catch (const CodecError& e) {
    return report(e.what(), err, err_len);
  } catch (const std::bad_alloc&) {
    report("out of memory", err, err_len);
    return 2;
  }
}

}  // namespace

extern "C" {

// The JPEG's height and width from its frame header (raises on the kinds
// that are not read). Returns 0, or 1 with a message in ``err``.
int f2_jpeg_size(const uint8_t* buf, size_t n, int* height, int* width,
                 char* err, size_t err_len) {
  return guarded([&] {
    Jpeg j(buf, n);
    j.run(true);
    *height = j.height;
    *width = j.width;
  }, err, err_len);
}

// Decode a JPEG into ``out``, uint8 [height, width, 3] RGB, whose size the
// caller took from f2_jpeg_size. Returns 0, 1 (message in ``err``) or 2
// (out of memory).
int f2_jpeg_decode(const uint8_t* buf, size_t n, uint8_t* out, int height,
                   int width, char* err, size_t err_len) {
  return guarded([&] {
    Jpeg j(buf, n);
    j.run(false);
    if (j.height != height || j.width != width)
      fail("JPEG size differs from the buffer's");
    j.output(out);
  }, err, err_len);
}

// The pixels of a PNG from its inflated IDAT stream ``raw`` and IHDR
// fields, into ``out``, uint8 [height, width, 3] RGB; ``palette`` holds
// ``n_palette`` RGB entries of PLTE. Returns as f2_jpeg_decode.
int f2_png_decode(const uint8_t* raw, size_t n, int width, int height,
                  int depth, int colour, int interlace,
                  const uint8_t* palette, int n_palette, uint8_t* out,
                  char* err, size_t err_len) {
  return guarded([&] {
    png_pixels(raw, n, width, height, depth, colour, interlace, palette,
               n_palette, out);
  }, err, err_len);
}

}  // extern "C"
