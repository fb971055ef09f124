// The port's decoder of compressed MCAP chunks: Zstandard frames (RFC 8878)
// and LZ4 frames (the LZ4 frame format 1.6.x, as ``lz4.frame.compress``
// writes them), decoded on the host to the bytes that ``zstandard`` and
// ``lz4.frame`` give (the JAX package reads bags with those modules).
//
// Zstandard: every Frame_Content_Size width, Single_Segment and the window
// descriptor; raw, RLE and compressed blocks; raw, RLE, Huffman-coded
// (1 or 4 streams) and treeless literals, the Huffman description with
// FSE-compressed or direct 4-bit weights; predefined, RLE, FSE-compressed
// and repeat tables for the three sequence codes; the three repeat
// offsets; matches into earlier blocks of the frame; concatenated and
// skippable frames (their contents are concatenated, as libzstd's
// ``ZSTD_decompress`` gives them); Content_Checksum (the low 32 bits of
// XXH64, seed 0) verified. A frame with a Dictionary_ID and a legacy
// (v0.x) frame raise, naming the gap.
//
// LZ4: FLG / BD with the header checksum byte (XXH32 >> 8), the optional
// content size, compressed and stored blocks, linked and independent
// blocks, the optional block and content checksums (XXH32, seed 0);
// concatenated and skippable frames. A frame with a dictionary raises.
//
// Every read and write is checked against its buffer: corrupt or truncated
// input raises, and output past the caller's capacity is an error, never an
// overrun. Plain C interface for ctypes; errors come back as a message in
// ``err``. The codec also counts the modes it decoded (``f2_chunk_modes``),
// so that the tests can show that each branch was reached.
//
// Build: c++ -std=c++17 -O2 -shared -fPIC -o chunk_codec.so chunk_codec.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "chunk_codec.cpp reads little-endian words with memcpy"
#endif

namespace {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw CodecError(what); }

// -- the modes decoded (a count each, read by the tests) ---------------------

#define F2_CHUNK_MODES(X)                                                    \
  X(zstd_frame) X(zstd_skippable_frame) X(zstd_single_segment)               \
  X(zstd_window_descriptor) X(zstd_fcs_none) X(zstd_fcs_1) X(zstd_fcs_2)     \
  X(zstd_fcs_4) X(zstd_fcs_8) X(zstd_checksum) X(block_raw) X(block_rle)     \
  X(block_compressed) X(literals_raw) X(literals_rle)                        \
  X(literals_compressed) X(literals_treeless) X(huffman_1_stream)            \
  X(huffman_4_streams) X(huffman_weights_fse) X(huffman_weights_direct)      \
  X(ll_predefined) X(ll_rle) X(ll_fse) X(ll_repeat) X(of_predefined)         \
  X(of_rle) X(of_fse) X(of_repeat) X(ml_predefined) X(ml_rle) X(ml_fse)      \
  X(ml_repeat) X(sequences_none) X(sequences_count_1) X(sequences_count_2)   \
  X(sequences_count_3) X(offset_new) X(offset_repeat) X(offset_repeat_ll0)   \
  X(offset_rep1_minus_1) X(match_across_blocks) X(lz4_frame)                 \
  X(lz4_skippable_frame) X(lz4_linked) X(lz4_independent)                    \
  X(lz4_block_compressed) X(lz4_block_stored) X(lz4_block_checksum)          \
  X(lz4_content_checksum) X(lz4_content_size) X(lz4_literal_extension)       \
  X(lz4_match_extension) X(lz4_overlap) X(lz4_match_across_blocks)

enum Mode : int {
#define F2_ENUM(name) k_##name,
  F2_CHUNK_MODES(F2_ENUM)
#undef F2_ENUM
  kModeCount
};

constexpr const char* kModeNames =
#define F2_NAME(name) #name ","
    F2_CHUNK_MODES(F2_NAME)
#undef F2_NAME
    "";

std::atomic<long long> g_modes[kModeCount];

// the per-call tally, added to the shared counts once per call
struct Tally {
  long long n[kModeCount] = {};
  void operator()(Mode m, long long k = 1) { n[m] += k; }
  ~Tally() {
    for (int i = 0; i < kModeCount; ++i)
      if (n[i]) g_modes[i].fetch_add(n[i], std::memory_order_relaxed);
  }
};

// -- little-endian reads and the two hashes ---------------------------------

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0
inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

constexpr uint64_t kP64[5] = {11400714785074694791ULL, 14029467366897019727ULL,
                              1609587929392839161ULL, 9650029242287828579ULL,
                              2870177450012600261ULL};

inline uint64_t xxh64_round(uint64_t acc, uint64_t in) {
  acc += in * kP64[1];
  return rotl64(acc, 31) * kP64[0];
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {seed + kP64[0] + kP64[1], seed + kP64[1], seed,
                     seed - kP64[0]};
    for (; end - p >= 32; p += 32)
      for (int i = 0; i < 4; ++i) v[i] = xxh64_round(v[i], rd64(p + 8 * i));
    h = rotl64(v[0], 1) + rotl64(v[1], 7) + rotl64(v[2], 12) + rotl64(v[3], 18);
    for (int i = 0; i < 4; ++i) h = (h ^ xxh64_round(0, v[i])) * kP64[0] + kP64[3];
  } else {
    h = seed + kP64[4];
  }
  h += n;
  for (; end - p >= 8; p += 8)
    h = rotl64(h ^ xxh64_round(0, rd64(p)), 27) * kP64[0] + kP64[3];
  if (end - p >= 4) {
    h = rotl64(h ^ (uint64_t(rd32(p)) * kP64[0]), 23) * kP64[1] + kP64[2];
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ (*p * kP64[4]), 11) * kP64[0];
  h ^= h >> 33;
  h *= kP64[1];
  h ^= h >> 29;
  h *= kP64[2];
  return h ^ (h >> 32);
}

constexpr uint32_t kP32[5] = {2654435761U, 2246822519U, 3266489917U,
                              668265263U, 374761393U};

uint32_t xxh32(const uint8_t* p, size_t n, uint32_t seed) {
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v[4] = {seed + kP32[0] + kP32[1], seed + kP32[1], seed,
                     seed - kP32[0]};
    for (; end - p >= 16; p += 16)
      for (int i = 0; i < 4; ++i)
        v[i] = rotl32(v[i] + rd32(p + 4 * i) * kP32[1], 13) * kP32[0];
    h = rotl32(v[0], 1) + rotl32(v[1], 7) + rotl32(v[2], 12) + rotl32(v[3], 18);
  } else {
    h = seed + kP32[4];
  }
  h += uint32_t(n);
  for (; end - p >= 4; p += 4) h = rotl32(h + rd32(p) * kP32[2], 17) * kP32[3];
  for (; p < end; ++p) h = rotl32(h + *p * kP32[4], 11) * kP32[0];
  h ^= h >> 15;
  h *= kP32[1];
  h ^= h >> 13;
  h *= kP32[2];
  return h ^ (h >> 16);
}

void need(size_t have, size_t want, const char* what) {
  if (want > have) fail(std::string("truncated ") + what);
}

// the output: writes are checked against the capacity the caller gave
struct Out {
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;
  void room(size_t k) const {
    if (k > cap - pos)
      fail("the output exceeds the expected size of " + std::to_string(cap) +
           " bytes");
  }
};

// -- bit readers --------------------------------------------------------------

// up to 57 bits of ``p[0, n)`` from bit ``at`` on (little-endian bit order);
// bytes past ``n`` read as zero
inline uint64_t load_bits(const uint8_t* p, size_t n, uint64_t at) {
  size_t b = size_t(at >> 3);
  uint64_t v = 0;
  if (b + 8 <= n) {
    v = rd64(p + b);
  } else {
    for (size_t k = 0; b + k < n && k < 8; ++k) v |= uint64_t(p[b + k]) << (8 * k);
  }
  return v >> (at & 7);
}

inline uint64_t low_bits(uint64_t v, int nb) {
  return nb == 0 ? 0 : v & (~uint64_t(0) >> (64 - nb));
}

// A Zstandard bitstream read backward: from the bit below the end marker
// (the highest set bit of the last byte) down to bit 0. Bits below 0 read
// as zero; ``pos`` < 0 after a read means the stream was overrun.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  BackBits(const uint8_t* p_, size_t n_, const char* what) : p(p_), n(n_) {
    if (n == 0) fail(std::string("empty ") + what + " bitstream");
    if (p[n - 1] == 0) fail(std::string(what) + " bitstream has no end marker");
    pos = int64_t(n - 1) * 8 + highbit(p[n - 1]);
  }
  // the next ``nb`` (<= 56) bits, the first one read as the highest
  uint64_t peek(int nb) const {
    int64_t lo = pos - nb;
    if (lo >= 0) return low_bits(load_bits(p, n, uint64_t(lo)), nb);
    if (pos <= 0) return 0;
    return low_bits(load_bits(p, n, 0), int(pos)) << (-lo);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// -- FSE tables ---------------------------------------------------------------

struct FseCell {
  uint16_t base;     // the next state, before the bits read are added
  uint8_t symbol;
  uint8_t nbits;
};

struct FseTable {
  int log = 0;
  bool valid = false;
  std::vector<FseCell> cells;
};

// Build the decoding table of the normalized counts ``norm`` (-1: "less
// than 1") at accuracy ``log`` (RFC 8878 4.1.1).
void build_fse(FseTable& t, const int16_t* norm, int n_symbols, int log) {
  const int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseCell{0, 0, 0});
  uint16_t next[256];
  int high = size - 1;
  for (int s = 0; s < n_symbols; ++s)
    if (norm[s] == -1) {
      if (high < 0) fail("corrupt FSE table: too many low-probability symbols");
      t.cells[high--].symbol = uint8_t(s);
      next[s] = 1;
    }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("corrupt FSE table: the symbol spread does not close");
  for (int u = 0; u < size; ++u) {
    FseCell& c = t.cells[u];
    uint32_t x = next[c.symbol]++;
    c.nbits = uint8_t(log - highbit(x));
    c.base = uint16_t((x << c.nbits) - size);
  }
  t.valid = true;
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.cells.assign(1, FseCell{0, symbol, 0});
  t.valid = true;
}

// Read an FSE table description (RFC 8878 4.1.1) at ``p[0, n)`` into
// ``t``; returns the bytes it takes.
size_t read_fse(FseTable& t, const uint8_t* p, size_t n, int max_symbol,
                int max_log, const char* what) {
  int16_t norm[256] = {};
  uint64_t bit = 0;
  auto get = [&](int nb) { return uint32_t(low_bits(load_bits(p, n, bit), nb)); };
  const int log = int(get(4)) + 5;
  bit = 4;
  if (log > max_log)
    fail(std::string(what) + " table: accuracy log " + std::to_string(log) +
         " above " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = get(2);
        bit += 2;
        n0 += int(r);
        if (r != 3) break;
        if (n0 > max_symbol) break;
      }
      if (n0 > max_symbol) fail(std::string(what) + " table: too many symbols");
      while (sym < n0) norm[sym++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    const uint32_t v = get(nbits);
    int count;
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      bit += nbits - 1;
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail(std::string(what) + " table: counts overflow");
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(std::string(what) + " table: counts do not sum up");
  const size_t bytes = size_t((bit + 7) >> 3);
  if (bytes > n) fail(std::string("truncated ") + what + " table");
  build_fse(t, norm, sym, log);
  return bytes;
}

// -- the RFC's fixed tables -----------------------------------------------------

constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2,  2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,  2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr int sum_abs(const int16_t* v, int n) {
  int s = 0;
  for (int i = 0; i < n; ++i) s += v[i] < 0 ? -v[i] : v[i];
  return s;
}
static_assert(sum_abs(kLLDefault, 36) == 64, "literal-length defaults");
static_assert(sum_abs(kMLDefault, 53) == 64, "match-length defaults");
static_assert(sum_abs(kOFDefault, 29) == 32, "offset defaults");

constexpr uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,    16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int kMaxLL = 35, kMaxML = 52, kMaxOF = 31;
constexpr int kLogLL = 9, kLogML = 9, kLogOF = 8, kLogWeights = 6;
constexpr size_t kBlockMax = 128 * 1024;
constexpr int kHufMaxBits = 11;

struct Defaults {
  FseTable ll, ml, of;
  Defaults() {
    build_fse(ll, kLLDefault, 36, 6);
    build_fse(ml, kMLDefault, 53, 6);
    build_fse(of, kOFDefault, 29, 5);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// -- Huffman literals -------------------------------------------------------------

struct HufTable {
  bool valid = false;
  int max_bits = 0;
  std::vector<uint16_t> cells;   // symbol | nbits << 8, indexed by max_bits bits
};

// Read the Huffman tree description at ``p[0, n)``; returns its bytes.
size_t read_huffman(HufTable& h, const uint8_t* p, size_t n, Tally& tally) {
  need(n, 1, "Huffman tree description");
  uint8_t w[256] = {};
  int nw = 0;
  size_t used;
  const int hb = p[0];
  if (hb >= 128) {
    tally(k_huffman_weights_direct);
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    need(n, used, "Huffman weights");
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  } else {
    tally(k_huffman_weights_fse);
    used = 1 + size_t(hb);
    need(n, used, "Huffman weights");
    FseTable t;
    const size_t desc = read_fse(t, p + 1, hb, 255, kLogWeights, "Huffman weight");
    if (desc >= size_t(hb)) fail("Huffman weights: no bitstream after the table");
    BackBits br(p + 1 + desc, hb - desc, "Huffman weight");
    // two interleaved states; the stream ends when a read overruns it, and
    // the other state then gives the last weight
    uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
    constexpr int kCap = 255;
    for (;;) {
      if (nw > kCap - 2) fail("Huffman weights: too many symbols");
      w[nw++] = t.cells[s1].symbol;
      s1 = t.cells[s1].base + uint32_t(br.read(t.cells[s1].nbits));
      if (br.pos < 0) {
        w[nw++] = t.cells[s2].symbol;
        break;
      }
      if (nw > kCap - 2) fail("Huffman weights: too many symbols");
      w[nw++] = t.cells[s2].symbol;
      s2 = t.cells[s2].base + uint32_t(br.read(t.cells[s2].nbits));
      if (br.pos < 0) {
        w[nw++] = t.cells[s1].symbol;
        break;
      }
    }
  }
  // the last weight is implied: it completes the sum to a power of 2
  uint32_t total = 0;
  int rank1 = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kHufMaxBits) fail("Huffman weight above the maximum code length");
    if (w[i]) total += 1u << (w[i] - 1);
    rank1 += w[i] == 1;
  }
  if (total == 0) fail("Huffman weights are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman code longer than 11 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not sum to a power of 2");
  w[nw++] = uint8_t(highbit(rest) + 1);
  rank1 += w[nw - 1] == 1;
  if (rank1 < 2 || (rank1 & 1)) fail("corrupt Huffman weights");
  h.max_bits = max_bits;
  h.cells.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt)
    for (int s = 0; s < nw; ++s)
      if (w[s] == wt) {
        const size_t len = size_t(1) << (wt - 1);
        std::fill(h.cells.begin() + pos, h.cells.begin() + pos + len,
                  uint16_t(s | ((max_bits + 1 - wt) << 8)));
        pos += len;
      }
  h.valid = true;
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out,
                    size_t count) {
  BackBits br(p, n, "Huffman");
  for (size_t i = 0; i < count; ++i) {
    const uint16_t c = h.cells[br.peek(h.max_bits)];
    out[i] = uint8_t(c);
    br.pos -= c >> 8;
  }
  if (br.pos != 0) fail("Huffman stream does not end where its literals do");
}

// -- Zstandard frames -----------------------------------------------------------

struct Frame {
  size_t start;             // the frame's first output byte
  uint64_t window;
  bool single_segment;
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lit;
};

// The literals section of a compressed block; returns its bytes and points
// ``lits`` / ``n_lits`` at the literals.
size_t literals(Frame& f, const uint8_t* p, size_t n, const uint8_t** lits,
                size_t* n_lits, Tally& tally) {
  need(n, 1, "literals section");
  const int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  size_t rs, cs = 0, hs;
  int streams = 1;
  if (type < 2) {
    if (fmt == 1) {
      hs = 2;
      need(n, hs, "literals header");
      rs = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else if (fmt == 3) {
      hs = 3;
      need(n, hs, "literals header");
      rs = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    } else {
      hs = 1;
      rs = p[0] >> 3;
    }
  } else {
    hs = fmt < 2 ? 3 : fmt == 2 ? 4 : 5;
    need(n, hs, "literals header");
    streams = fmt == 0 ? 1 : 4;
    if (fmt < 2) {
      rs = (p[0] >> 4) + (size_t(p[1] & 0x3F) << 4);
      cs = (p[1] >> 6) + (size_t(p[2]) << 2);
    } else if (fmt == 2) {
      rs = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2] & 3) << 12);
      cs = (p[2] >> 2) + (size_t(p[3]) << 6);
    } else {
      rs = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2] & 0x3F) << 12);
      cs = (p[2] >> 6) + (size_t(p[3]) << 2) + (size_t(p[4]) << 10);
    }
  }
  if (rs > kBlockMax) fail("literals larger than a block");
  *n_lits = rs;
  if (type == 0) {
    tally(k_literals_raw);
    need(n, hs + rs, "raw literals");
    *lits = p + hs;
    return hs + rs;
  }
  f.lit.resize(rs);
  *lits = f.lit.data();
  if (type == 1) {
    tally(k_literals_rle);
    need(n, hs + 1, "RLE literals");
    std::memset(f.lit.data(), p[hs], rs);
    return hs + 1;
  }
  need(n, hs + cs, "Huffman literals");
  const uint8_t* q = p + hs;
  size_t m = cs;
  if (type == 2) {
    tally(k_literals_compressed);
    const size_t used = read_huffman(f.huf, q, m, tally);
    q += used;
    m -= used;
  } else {
    tally(k_literals_treeless);
    if (!f.huf.valid) fail("treeless literals without an earlier Huffman table");
  }
  if (streams == 1) {
    tally(k_huffman_1_stream);
    huffman_stream(f.huf, q, m, f.lit.data(), rs);
  } else {
    tally(k_huffman_4_streams);
    need(m, 6, "Huffman jump table");
    const size_t s[3] = {rd16(q), rd16(q + 2), rd16(q + 4)};
    const size_t seg = (rs + 3) / 4;
    if (rs < 6 || rs < 3 * seg) fail("too few literals for 4 Huffman streams");
    if (s[0] + s[1] + s[2] > m - 6) fail("Huffman jump table past the literals");
    const uint8_t* sp = q + 6;
    size_t left = m - 6;
    for (int k = 0; k < 4; ++k) {
      const size_t len = k < 3 ? s[k] : left;
      const size_t cnt = k < 3 ? seg : rs - 3 * seg;
      huffman_stream(f.huf, sp, len, f.lit.data() + k * seg, cnt);
      sp += len;
      left -= len;
    }
  }
  return hs + cs;
}

// Choose a sequence code's table for this block; returns the bytes read.
size_t table_mode(FseTable& t, int mode, const FseTable& predefined, const uint8_t* p,
                  size_t n, int max_symbol, int max_log, const char* what,
                  Mode base, Tally& tally) {
  tally(Mode(base + mode));
  switch (mode) {
    case 0:
      t = predefined;
      return 0;
    case 1:
      need(n, 1, what);
      if (p[0] > max_symbol) fail(std::string(what) + ": RLE symbol out of range");
      rle_fse(t, p[0]);
      return 1;
    case 2:
      return read_fse(t, p, n, max_symbol, max_log, what);
    default:
      if (!t.valid) fail(std::string(what) + ": repeat mode without an earlier table");
      return 0;
  }
}

void sequences(Frame& f, const uint8_t* p, size_t n, const uint8_t* lits, size_t n_lits,
               Out& out, Tally& tally) {
  need(n, 1, "sequences section");
  size_t nseq, pos;
  if (p[0] == 0) {
    tally(k_sequences_none);
    if (n != 1) fail("bytes after an empty sequences section");
    nseq = 0;
    pos = 1;
  } else if (p[0] < 128) {
    tally(k_sequences_count_1);
    nseq = p[0];
    pos = 1;
  } else if (p[0] < 255) {
    tally(k_sequences_count_2);
    need(n, 2, "sequence count");
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    pos = 2;
  } else {
    tally(k_sequences_count_3);
    need(n, 3, "sequence count");
    nseq = rd16(p + 1) + 0x7F00;
    pos = 3;
  }
  size_t lit_at = 0;
  if (nseq) {
    need(n, pos + 1, "sequence modes");
    const int modes = p[pos++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    const Defaults& d = defaults();
    pos += table_mode(f.ll, modes >> 6, d.ll, p + pos, n - pos, kMaxLL, kLogLL,
                      "literal-length", k_ll_predefined, tally);
    pos += table_mode(f.of, (modes >> 4) & 3, d.of, p + pos, n - pos, kMaxOF, kLogOF,
                      "offset", k_of_predefined, tally);
    pos += table_mode(f.ml, (modes >> 2) & 3, d.ml, p + pos, n - pos, kMaxML, kLogML,
                      "match-length", k_ml_predefined, tally);
    BackBits br(p + pos, n - pos, "sequence");
    uint32_t sll = uint32_t(br.read(f.ll.log));
    uint32_t sof = uint32_t(br.read(f.of.log));
    uint32_t sml = uint32_t(br.read(f.ml.log));
    const size_t block_start = out.pos;
    long long n_new = 0, n_rep = 0, n_rep0 = 0, n_minus1 = 0, n_across = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const int of_code = f.of.cells[sof].symbol;
      const int ll_code = f.ll.cells[sll].symbol;
      const int ml_code = f.ml.cells[sml].symbol;
      const uint64_t of_value = (uint64_t(1) << of_code) + br.read(of_code);
      const size_t ml = kMLBase[ml_code] + size_t(br.read(kMLBits[ml_code]));
      const size_t ll = kLLBase[ll_code] + size_t(br.read(kLLBits[ll_code]));
      uint64_t offset;
      if (of_value > 3) {
        ++n_new;
        offset = of_value - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = uint32_t(offset);
      } else {
        // with no literals, 1-3 name rep2, rep3 and rep1 - 1
        const int idx = int(of_value) - 1 + (ll == 0);
        ++n_rep;
        n_rep0 += ll == 0;
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          n_minus1 += idx == 3;
          offset = idx == 3 ? uint64_t(f.rep[0]) - 1 : f.rep[idx];
          if (offset == 0) fail("repeat offset of 0");
          if (idx != 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {
        sll = f.ll.cells[sll].base + uint32_t(br.read(f.ll.cells[sll].nbits));
        sml = f.ml.cells[sml].base + uint32_t(br.read(f.ml.cells[sml].nbits));
        sof = f.of.cells[sof].base + uint32_t(br.read(f.of.cells[sof].nbits));
      }
      if (br.pos < 0) fail("sequence bitstream overrun");
      if (ll > n_lits - lit_at) fail("a sequence takes more literals than the block has");
      out.room(ll);
      std::memcpy(out.dst + out.pos, lits + lit_at, ll);
      out.pos += ll;
      lit_at += ll;
      if (offset > out.pos - f.start) fail("match offset before the frame's start");
      if (!f.single_segment && offset > f.window) fail("match offset beyond the window");
      n_across += offset > out.pos - block_start;
      out.room(ml);
      uint8_t* d = out.dst + out.pos;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.pos += ml;
    }
    if (br.pos != 0) fail("sequence bitstream does not end with its last sequence");
    tally(k_offset_new, n_new);
    tally(k_offset_repeat, n_rep);
    tally(k_offset_repeat_ll0, n_rep0);
    tally(k_offset_rep1_minus_1, n_minus1);
    tally(k_match_across_blocks, n_across);
  }
  const size_t rest = n_lits - lit_at;
  out.room(rest);
  std::memcpy(out.dst + out.pos, lits + lit_at, rest);
  out.pos += rest;
}

// One Zstandard frame from ``p[0, n)`` (past its magic number); returns the
// bytes it takes.
size_t zstd_frame(const uint8_t* p, size_t n, Out& out, Tally& tally) {
  tally(k_zstd_frame);
  need(n, 1, "frame header");
  const int fhd = p[0];
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  Frame f;
  f.start = out.pos;
  f.single_segment = (fhd >> 5) & 1;
  const bool checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail("reserved bit set in the frame header");
  size_t pos = 1;
  if (!f.single_segment) {
    tally(k_zstd_window_descriptor);
    need(n, pos + 1, "window descriptor");
    const int exponent = p[pos] >> 3, mantissa = p[pos] & 7;
    const uint64_t base = uint64_t(1) << (10 + exponent);
    f.window = base + (base / 8) * mantissa;
    ++pos;
  } else {
    tally(k_zstd_single_segment);
  }
  const int dict_bytes = dict_flag == 3 ? 4 : dict_flag;
  need(n, pos + dict_bytes, "dictionary id");
  uint32_t dict_id = 0;
  for (int k = 0; k < dict_bytes; ++k) dict_id |= uint32_t(p[pos + k]) << (8 * k);
  pos += dict_bytes;
  if (dict_id != 0)
    fail("zstd frame needs dictionary " + std::to_string(dict_id) +
         ": dictionaries are not supported");
  const int fcs_bytes = fcs_flag == 0 ? (f.single_segment ? 1 : 0) : 1 << fcs_flag;
  need(n, pos + fcs_bytes, "frame content size");
  bool has_size = fcs_bytes > 0;
  uint64_t content = 0;
  switch (fcs_bytes) {
    case 0: tally(k_zstd_fcs_none); break;
    case 1: tally(k_zstd_fcs_1); content = p[pos]; break;
    case 2: tally(k_zstd_fcs_2); content = rd16(p + pos) + 256; break;
    case 4: tally(k_zstd_fcs_4); content = rd32(p + pos); break;
    default: tally(k_zstd_fcs_8); content = rd64(p + pos); break;
  }
  pos += fcs_bytes;
  if (f.single_segment) f.window = content;
  const size_t block_max = size_t(std::min<uint64_t>(f.window, kBlockMax));
  if (has_size && content > out.cap - out.pos)
    fail("the frame's content size " + std::to_string(content) +
         " exceeds the expected size of " + std::to_string(out.cap) + " bytes");
  for (bool last = false; !last;) {
    need(n, pos + 3, "block header");
    const uint32_t bh = rd24(p + pos);
    pos += 3;
    last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > block_max) fail("block larger than the block maximum");
    const size_t block_start = out.pos;
    if (type == 0) {
      tally(k_block_raw);
      need(n, pos + size, "raw block");
      out.room(size);
      std::memcpy(out.dst + out.pos, p + pos, size);
      out.pos += size;
      pos += size;
    } else if (type == 1) {
      tally(k_block_rle);
      need(n, pos + 1, "RLE block");
      out.room(size);
      std::memset(out.dst + out.pos, p[pos], size);
      out.pos += size;
      pos += 1;
    } else {
      tally(k_block_compressed);
      need(n, pos + size, "compressed block");
      const uint8_t* lits;
      size_t n_lits;
      const size_t used = literals(f, p + pos, size, &lits, &n_lits, tally);
      sequences(f, p + pos + used, size - used, lits, n_lits, out, tally);
      if (out.pos - block_start > kBlockMax) fail("block decodes past the block maximum");
      pos += size;
    }
  }
  const size_t produced = out.pos - f.start;
  if (has_size && produced != content)
    fail("zstd frame decodes to " + std::to_string(produced) + " bytes, its header says " +
         std::to_string(content));
  if (checksum) {
    tally(k_zstd_checksum);
    need(n, pos + 4, "content checksum");
    const uint32_t want = rd32(p + pos);
    const uint32_t got = uint32_t(xxh64(out.dst + f.start, produced, 0));
    if (want != got) fail("zstd content checksum mismatch");
    pos += 4;
  }
  return pos;
}

size_t zstd_decompress(const uint8_t* src, size_t n, Out& out) {
  Tally tally;
  size_t pos = 0;
  int frames = 0;
  while (pos < n) {
    need(n - pos, 4, "zstd magic number");
    const uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      tally(k_zstd_skippable_frame);
      need(n - pos, 8, "skippable frame header");
      const size_t size = rd32(src + pos + 4);
      need(n - pos - 8, size, "skippable frame");
      pos += 8 + size;
      continue;
    }
    if (magic >= 0xFD2FB522u && magic <= 0xFD2FB527u)
      fail("legacy zstd frame (format v0.x): not supported");
    if (magic != 0xFD2FB528u) {
      char buf[64];
      std::snprintf(buf, sizeof buf, "not a zstd frame (magic 0x%08X)", magic);
      fail(buf);
    }
    pos += 4;
    pos += zstd_frame(src + pos, n - pos, out, tally);
    ++frames;
  }
  if (frames == 0) fail("no zstd frame");
  return out.pos;
}

// -- LZ4 frames ---------------------------------------------------------------------

// One LZ4 block into ``out``; ``floor`` is the earliest byte a match may
// reach (the block's start, or the frame's for linked blocks).
void lz4_block(const uint8_t* p, size_t n, Out& out, size_t floor, size_t block_max,
               Tally& tally) {
  const size_t start = out.pos;
  size_t pos = 0;
  long long lit_ext = 0, match_ext = 0, overlap = 0, across = 0;
  for (;;) {
    need(n, pos + 1, "LZ4 sequence");
    const int token = p[pos++];
    size_t ll = token >> 4;
    if (ll == 15) {
      ++lit_ext;
      for (;;) {
        need(n, pos + 1, "LZ4 literal length");
        const uint8_t b = p[pos++];
        ll += b;
        if (b != 255) break;
      }
    }
    need(n, pos + ll, "LZ4 literals");
    if (ll > block_max - (out.pos - start)) fail("LZ4 block decodes past its maximum");
    out.room(ll);
    std::memcpy(out.dst + out.pos, p + pos, ll);
    out.pos += ll;
    pos += ll;
    if (pos == n) break;       // the last sequence holds literals only
    need(n, pos + 2, "LZ4 match offset");
    const size_t offset = rd16(p + pos);
    pos += 2;
    size_t ml = token & 15;
    if (ml == 15) {
      ++match_ext;
      for (;;) {
        need(n, pos + 1, "LZ4 match length");
        const uint8_t b = p[pos++];
        ml += b;
        if (b != 255) break;
      }
    }
    ml += 4;
    if (offset == 0 || offset > out.pos - floor) fail("LZ4 match offset out of range");
    if (ml > block_max - (out.pos - start)) fail("LZ4 block decodes past its maximum");
    out.room(ml);
    across += offset > out.pos - start;
    uint8_t* d = out.dst + out.pos;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      ++overlap;
      for (size_t k = 0; k < ml; ++k) d[k] = s[k];
    }
    out.pos += ml;
  }
  tally(k_lz4_literal_extension, lit_ext);
  tally(k_lz4_match_extension, match_ext);
  tally(k_lz4_overlap, overlap);
  tally(k_lz4_match_across_blocks, across);
}

size_t lz4_frame(const uint8_t* p, size_t n, Out& out, Tally& tally) {
  tally(k_lz4_frame);
  need(n, 3, "LZ4 frame descriptor");
  const int flg = p[0], bd = p[1];
  if ((flg >> 6) != 1) fail("LZ4 frame version is not 01");
  if (flg & 2) fail("reserved bit set in the LZ4 FLG byte");
  if ((bd & 0x8F) != 0) fail("reserved bits set in the LZ4 BD byte");
  const bool independent = (flg >> 5) & 1, block_sum = (flg >> 4) & 1;
  const bool has_size = (flg >> 3) & 1, content_sum = (flg >> 2) & 1;
  const int bsid = (bd >> 4) & 7;
  if (bsid < 4) fail("LZ4 block maximum size id below 4");
  const size_t block_max = size_t(1) << (8 + 2 * bsid);
  size_t pos = 2;
  uint64_t content = 0;
  if (has_size) {
    tally(k_lz4_content_size);
    need(n, pos + 8, "LZ4 content size");
    content = rd64(p + pos);
    pos += 8;
  }
  if (flg & 1) fail("LZ4 frame needs a dictionary: dictionaries are not supported");
  need(n, pos + 1, "LZ4 header checksum");
  if (((xxh32(p, pos, 0) >> 8) & 0xFF) != p[pos]) fail("LZ4 header checksum mismatch");
  ++pos;
  tally(independent ? k_lz4_independent : k_lz4_linked);
  const size_t start = out.pos;
  if (has_size && content > out.cap - out.pos)
    fail("the LZ4 frame's content size " + std::to_string(content) +
         " exceeds the expected size of " + std::to_string(out.cap) + " bytes");
  for (;;) {
    need(n, pos + 4, "LZ4 block size");
    const uint32_t word = rd32(p + pos);
    pos += 4;
    if (word == 0) break;                   // the end mark
    const bool stored = word >> 31;
    const size_t size = word & 0x7FFFFFFFu;
    if (size > block_max) fail("LZ4 block larger than the frame's block maximum");
    need(n, pos + size + (block_sum ? 4 : 0), "LZ4 block");
    if (block_sum) {
      tally(k_lz4_block_checksum);
      if (xxh32(p + pos, size, 0) != rd32(p + pos + size))
        fail("LZ4 block checksum mismatch");
    }
    if (stored) {
      tally(k_lz4_block_stored);
      out.room(size);
      std::memcpy(out.dst + out.pos, p + pos, size);
      out.pos += size;
    } else {
      tally(k_lz4_block_compressed);
      const size_t floor = independent ? out.pos : start;
      lz4_block(p + pos, size, out, floor, block_max, tally);
    }
    pos += size + (block_sum ? 4 : 0);
  }
  const size_t produced = out.pos - start;
  if (has_size && produced != content)
    fail("LZ4 frame decodes to " + std::to_string(produced) + " bytes, its header says " +
         std::to_string(content));
  if (content_sum) {
    tally(k_lz4_content_checksum);
    need(n, pos + 4, "LZ4 content checksum");
    if (xxh32(out.dst + start, produced, 0) != rd32(p + pos))
      fail("LZ4 content checksum mismatch");
    pos += 4;
  }
  return pos;
}

size_t lz4_decompress(const uint8_t* src, size_t n, Out& out) {
  Tally tally;
  size_t pos = 0;
  int frames = 0;
  while (pos < n) {
    need(n - pos, 4, "LZ4 magic number");
    const uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      tally(k_lz4_skippable_frame);
      need(n - pos, 8, "skippable frame header");
      const size_t size = rd32(src + pos + 4);
      need(n - pos - 8, size, "skippable frame");
      pos += 8 + size;
      continue;
    }
    if (magic != 0x184D2204u) {
      char buf[64];
      std::snprintf(buf, sizeof buf, "not an LZ4 frame (magic 0x%08X)", magic);
      fail(buf);
    }
    pos += 4;
    pos += lz4_frame(src + pos, n - pos, out, tally);
    ++frames;
  }
  if (frames == 0) fail("no LZ4 frame");
  return out.pos;
}

template <class F>
long long guarded(F&& fn, char* err, size_t err_len) {
  try {
    return static_cast<long long>(fn());
  } catch (const CodecError& e) {
    std::snprintf(err, err_len, "%s", e.what());
    return -1;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
    return -2;
  } catch (const std::exception& e) {
    std::snprintf(err, err_len, "%s", e.what());
    return -1;
  }
}

}  // namespace

extern "C" {

// Decode every frame of ``src[0, n)`` into ``dst[0, cap)``: the bytes
// written, or -1 (corrupt or unsupported input; ``err`` says why) or -2 (out
// of memory).
long long f2_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                             char* err, size_t err_len) {
  return guarded([&] {
    Out out{dst, cap};
    return zstd_decompress(src, n, out);
  }, err, err_len);
}

long long f2_lz4f_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                             char* err, size_t err_len) {
  return guarded([&] {
    Out out{dst, cap};
    return lz4_decompress(src, n, out);
  }, err, err_len);
}

uint32_t f2_xxh32(const uint8_t* p, size_t n, uint32_t seed) { return xxh32(p, n, seed); }

// The names of the counted modes, comma-separated, in the order of
// ``f2_chunk_modes``.
const char* f2_chunk_mode_names() { return kModeNames; }

// Copy the counts of the modes decoded so far in this process into
// ``counts[0, n)``; returns the number of modes.
int f2_chunk_modes(long long* counts, int n) {
  for (int i = 0; i < kModeCount && i < n; ++i) counts[i] = g_modes[i].load();
  return kModeCount;
}

}  // extern "C"
