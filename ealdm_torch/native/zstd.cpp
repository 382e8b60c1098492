// A Zstandard decoder (RFC 8878) and CRC-32C, with a plain C interface for
// ctypes (`ealdm_torch/utils/zstd.py`). The port reads the JAX package's
// orbax checkpoints with it: OCDBT's manifests and B+tree nodes and zarr's
// chunks are zstd frames, and OCDBT's records carry a CRC-32C.
//
// Decoded: zstd and skippable frames, concatenated; the frame header
// (window descriptor, content size, no dictionary); raw, RLE and compressed
// blocks; literals raw, RLE, Huffman-compressed (one or four streams, the
// tree's weights direct or FSE-compressed) and treeless (the previous
// block's tree); sequences with literal-length, offset and match-length
// tables predefined, RLE, FSE-compressed or repeated from the previous
// block; the three repeat offsets; the content checksum (XXH64's low 32
// bits), which is verified. A frame is decoded into the caller's buffer
// whole, so a match reaches back into everything decoded before it (the
// window is the frame). Anything else (a dictionary, a reserved field, a
// bitstream that does not end where its block does, a match before the
// start, output past the buffer) returns an error with its reason.
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Error{what}; }

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed = 0) {
  const uint8_t* end = p + n;
  uint64_t acc;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    acc = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    acc = xmerge(acc, v1);
    acc = xmerge(acc, v2);
    acc = xmerge(acc, v3);
    acc = xmerge(acc, v4);
  } else {
    acc = seed + P5;
  }
  acc += n;
  for (; p + 8 <= end; p += 8) acc = rotl(acc ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    acc = rotl(acc ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) acc = rotl(acc ^ (uint64_t(*p) * P5), 11) * P1;
  acc ^= acc >> 33;
  acc *= P2;
  acc ^= acc >> 29;
  acc *= P3;
  acc ^= acc >> 32;
  return acc;
}

// ---------------------------------------------------------------- CRC-32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};
const Crc32cTable kCrc;

uint32_t crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t v = rd64(p) ^ crc;
    crc = kCrc.t[7][v & 0xFF] ^ kCrc.t[6][(v >> 8) & 0xFF] ^ kCrc.t[5][(v >> 16) & 0xFF] ^
          kCrc.t[4][(v >> 24) & 0xFF] ^ kCrc.t[3][(v >> 32) & 0xFF] ^
          kCrc.t[2][(v >> 40) & 0xFF] ^ kCrc.t[1][(v >> 48) & 0xFF] ^ kCrc.t[0][v >> 56];
  }
  for (; n; --n, ++p) crc = kCrc.t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// ------------------------------------------------------------ bitstreams
// Forward, least significant bit first (the FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int k) const {
    uint64_t v = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (bit & 7)) & ((1ull << k) - 1));
  }
  void skip(int k) {
    bit += k;
    if (bit > 8 * n) fail("an FSE table description runs past its block");
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward (Huffman streams and FSE bitstreams): written forwards, read from
// the end; the last byte's highest set bit marks where the data ends. Bits
// read past the start are zeros, and `pos` goes negative.
struct BackwardBits {
  const uint8_t* p;
  int64_t pos;  // bits left to read
  BackwardBits(const uint8_t* p_, size_t n, const char* what) : p(p_) {
    if (n == 0) fail(std::string(what) + ": empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail(std::string(what) + ": bitstream without its end mark");
    pos = int64_t(8 * (n - 1)) + highbit(last);
  }
  uint64_t peek(int k) const {  // k <= 56
    if (k == 0) return 0;
    int64_t lo = pos - k;
    uint64_t v;
    if (lo >= 0) {
      size_t byte = size_t(lo) >> 3;
      v = 0;
      // the bytes holding bits [lo, pos)
      size_t last = size_t(pos - 1) >> 3;
      for (size_t b = last + 1; b-- > byte;) v = (v << 8) | p[b];
      v >>= (lo & 7);
    } else {
      if (pos <= 0) return 0;
      v = 0;
      size_t last = size_t(pos - 1) >> 3;
      for (size_t b = last + 1; b-- > 0;) v = (v << 8) | p[b];
      v <<= -lo;
    }
    return v & ((1ull << k) - 1);
  }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ------------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
  bool valid = false;
};

void fse_build(FseTable& t, const int16_t* freq, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size;
  for (int s = 0; s < nsym; ++s) {
    if (freq[s] == -1) {
      t.e[--high].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(freq[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < freq[s]; ++i) {
      t.e[pos].symbol = uint16_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("an FSE distribution does not fill its table");
  for (int i = 0; i < size; ++i) {
    uint16_t s = t.e[i].symbol;
    uint32_t n = next[s]++;
    int bits = log - highbit(n);
    t.e[i].bits = uint8_t(bits);
    t.e[i].base = uint16_t((n << bits) - size);
  }
  t.valid = true;
}

void fse_rle(FseTable& t, uint16_t symbol) {
  t.log = 0;
  t.e.assign(1, FseEntry{symbol, 0, 0});
  t.valid = true;
}

// Reads a table description; returns the bytes it took.
size_t fse_read(FseTable& t, const uint8_t* p, size_t n, int max_log, int max_sym,
                const char* what) {
  ForwardBits in(p, n);
  if (n == 0) fail(std::string(what) + ": empty FSE table description");
  int log = int(in.read(4)) + 5;
  if (log > max_log) fail(std::string(what) + ": FSE accuracy log " + std::to_string(log) +
                          " above " + std::to_string(max_log));
  int remaining = 1 << log;
  std::vector<int16_t> freq(max_sym + 1, 0);
  int s = 0;
  while (remaining > 0 && s <= max_sym) {
    int bits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.peek(bits);
    const uint32_t lower = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      val &= lower;
      in.skip(bits - 1);
    } else {
      if (val > lower) val -= threshold;
      in.skip(bits);
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[s++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        int repeat = int(in.read(2));
        for (int i = 0; i < repeat; ++i) {
          if (s > max_sym) fail(std::string(what) + ": FSE zero run past the last symbol");
          freq[s++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0) fail(std::string(what) + ": FSE probabilities do not sum to the table");
  fse_build(t, freq.data(), s, log);
  return in.bytes_used();
}

// ---------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<uint16_t> e;  // symbol << 8 | bits, 1 << max_bits entries
  bool valid = false;
};

// Reads the tree description at p; returns the bytes it took.
size_t huf_read(HufTable& h, const uint8_t* p, size_t n) {
  if (n == 0) fail("Huffman tree description missing");
  uint8_t weights[256];
  int nw;
  size_t used;
  int head = p[0];
  if (head >= 128) {
    nw = head - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) fail("Huffman weights run past the literals section");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    size_t csize = size_t(head);
    if (1 + csize > n) fail("FSE-compressed Huffman weights run past the literals section");
    FseTable t;
    size_t hdr = fse_read(t, p + 1, csize, 6, 255, "Huffman weights");
    if (hdr >= csize) fail("Huffman weights: no bitstream after the FSE table");
    BackwardBits in(p + 1 + hdr, csize - hdr, "Huffman weights");
    uint32_t s1 = uint32_t(in.read(t.log)), s2 = uint32_t(in.read(t.log));
    nw = 0;
    for (;;) {
      if (nw >= 255) fail("Huffman weights: more than 255");
      weights[nw++] = uint8_t(t.e[s1].symbol);
      s1 = t.e[s1].base + uint32_t(in.read(t.e[s1].bits));
      if (in.pos < 0) {
        weights[nw++] = uint8_t(t.e[s2].symbol);
        break;
      }
      if (nw >= 255) fail("Huffman weights: more than 255");
      weights[nw++] = uint8_t(t.e[s2].symbol);
      s2 = t.e[s2].base + uint32_t(in.read(t.e[s2].bits));
      if (in.pos < 0) {
        if (nw >= 255) fail("Huffman weights: more than 255");
        weights[nw++] = uint8_t(t.e[s1].symbol);
        break;
      }
    }
    used = 1 + csize;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights leave no power of two for the last symbol");
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  weights[nw++] = uint8_t(highbit(rest) + 1);
  h.max_bits = max_bits;
  h.e.assign(size_t(1) << max_bits, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      uint32_t count = 1u << (w - 1);
      uint16_t v = uint16_t((s << 8) | (max_bits + 1 - w));
      for (uint32_t i = 0; i < count; ++i) h.e[pos + i] = v;
      pos += count;
    }
  }
  h.valid = true;
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackwardBits in(p, n, "Huffman literals");
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    uint16_t v = h.e[in.peek(mb)];
    out[i] = uint8_t(v >> 8);
    in.pos -= (v & 0xFF);
  }
  if (in.pos != 0) fail("a Huffman literal stream does not end with its literals");
}

// -------------------------------------------------------------- sequences
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,   12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23,  24,  25,   26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39,  41,  43,   47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

// Builds one of the three tables by its mode; returns the bytes it took.
size_t seq_table(FseTable& t, int mode, const uint8_t* p, size_t n, const int16_t* deflt,
                 int ndeflt, int deflt_log, int max_log, int max_sym, const char* what) {
  switch (mode) {
    case 0:
      fse_build(t, deflt, ndeflt, deflt_log);
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + ": RLE symbol missing");
      if (p[0] > max_sym) fail(std::string(what) + ": RLE symbol above the largest code");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, max_log, max_sym, what);
    default:
      if (!t.valid) fail(std::string(what) + ": repeat mode with no earlier table");
      return 0;
  }
}

// Decodes a compressed block into out[pos, cap); returns the new pos.
size_t compressed_block(FrameState& fs, const uint8_t* p, size_t n, uint8_t* out, size_t pos,
                        size_t cap) {
  // literals section
  if (n < 1) fail("empty compressed block");
  const int ltype = p[0] & 3, sfmt = (p[0] >> 2) & 3;
  size_t regen, csize = 0, hdr;
  std::vector<uint8_t> litbuf;
  const uint8_t* lit;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      regen = p[0] >> 3;
      hdr = 1;
    } else if (sfmt == 1) {
      if (n < 2) fail("literals header truncated");
      regen = (p[0] >> 4) | (size_t(p[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) fail("literals header truncated");
      regen = (p[0] >> 4) | (size_t(p[1]) << 4) | (size_t(p[2]) << 12);
      hdr = 3;
    }
    if (ltype == 0) {
      if (hdr + regen > n) fail("raw literals run past the block");
      lit = p + hdr;
      hdr += regen;
    } else {
      if (hdr + 1 > n) fail("RLE literal missing");
      litbuf.assign(regen, p[hdr]);
      lit = litbuf.data();
      hdr += 1;
    }
  } else {
    int streams = sfmt == 0 ? 1 : 4;
    uint64_t v = 0;
    int bits;
    if (sfmt < 2) {
      hdr = 3, bits = 10;
    } else if (sfmt == 2) {
      hdr = 4, bits = 14;
    } else {
      hdr = 5, bits = 18;
    }
    if (n < hdr) fail("literals header truncated");
    for (size_t i = 0; i < hdr; ++i) v |= uint64_t(p[i]) << (8 * i);
    regen = size_t((v >> 4) & ((1u << bits) - 1));
    csize = size_t((v >> (4 + bits)) & ((1u << bits) - 1));
    if (hdr + csize > n) fail("compressed literals run past the block");
    const uint8_t* q = p + hdr;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = huf_read(fs.huf, q, qn);
      q += used;
      qn -= used;
    } else if (!fs.huf.valid) {
      fail("treeless literals with no earlier Huffman tree");
    }
    litbuf.resize(regen);
    if (streams == 1) {
      huf_stream(fs.huf, q, qn, litbuf.data(), regen);
    } else {
      if (qn < 6) fail("Huffman jump table truncated");
      size_t s1 = q[0] | (size_t(q[1]) << 8), s2 = q[2] | (size_t(q[3]) << 8),
             s3 = q[4] | (size_t(q[5]) << 8);
      if (6 + s1 + s2 + s3 > qn) fail("Huffman streams run past the literals");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t each = (regen + 3) / 4;
      if (3 * each > regen) fail("four Huffman streams for too few literals");
      const uint8_t* d = q + 6;
      huf_stream(fs.huf, d, s1, litbuf.data(), each);
      huf_stream(fs.huf, d + s1, s2, litbuf.data() + each, each);
      huf_stream(fs.huf, d + s1 + s2, s3, litbuf.data() + 2 * each, each);
      huf_stream(fs.huf, d + s1 + s2 + s3, s4, litbuf.data() + 3 * each, regen - 3 * each);
    }
    lit = litbuf.data();
    hdr += csize;
  }
  const uint8_t* litend = lit + regen;
  // sequences section
  const uint8_t* s = p + hdr;
  size_t sn = n - hdr;
  if (sn < 1) fail("sequences header missing");
  size_t nseq;
  size_t k;
  if (s[0] < 128) {
    nseq = s[0], k = 1;
  } else if (s[0] < 255) {
    if (sn < 2) fail("sequences header truncated");
    nseq = (size_t(s[0] - 128) << 8) + s[1], k = 2;
  } else {
    if (sn < 3) fail("sequences header truncated");
    nseq = s[1] + (size_t(s[2]) << 8) + 0x7F00, k = 3;
  }
  if (nseq == 0) {
    if (k != sn) fail("bytes after an empty sequences section");
    if (regen > cap - pos) fail("output past the buffer");
    memcpy(out + pos, lit, regen);
    return pos + regen;
  }
  if (k >= sn) fail("sequence modes missing");
  const int modes = s[k++];
  if (modes & 3) fail("reserved bits of the sequence modes set");
  k += seq_table(fs.ll, modes >> 6, s + k, sn - k, kLLDefault, 36, 6, 9, 35,
                 "literal lengths table");
  k += seq_table(fs.of, (modes >> 4) & 3, s + k, sn - k, kOFDefault, 29, 5, 8, 31,
                 "offsets table");
  k += seq_table(fs.ml, (modes >> 2) & 3, s + k, sn - k, kMLDefault, 53, 6, 9, 52,
                 "match lengths table");
  if (k >= sn) fail("sequence bitstream missing");
  BackwardBits in(s + k, sn - k, "sequences");
  uint32_t sll = uint32_t(in.read(fs.ll.log)), sof = uint32_t(in.read(fs.of.log)),
           sml = uint32_t(in.read(fs.ml.log));
  uint32_t* rep = fs.rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry &ell = fs.ll.e[sll], &eof = fs.of.e[sof], &eml = fs.ml.e[sml];
    const uint32_t ofc = eof.symbol, mlc = eml.symbol, llc = ell.symbol;
    if (ofc > 31) fail("offset code above 31");
    uint64_t ofv = (uint64_t(1) << ofc) + in.read(int(ofc));
    uint64_t ml = kMLBase[mlc] + in.read(kMLBits[mlc]);
    uint64_t ll = kLLBase[llc] + in.read(kLLBits[llc]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1], rep[1] = rep[0], rep[0] = uint32_t(offset);
    } else {
      uint32_t idx = uint32_t(ofv - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      }
    }
    if (i + 1 < nseq) {
      sll = ell.base + uint32_t(in.read(ell.bits));
      sml = eml.base + uint32_t(in.read(eml.bits));
      sof = eof.base + uint32_t(in.read(eof.bits));
    }
    if (ll > size_t(litend - lit)) fail("a sequence takes more literals than the block has");
    if (ll + ml > cap - pos) fail("output past the buffer");
    memcpy(out + pos, lit, ll);
    lit += ll;
    pos += ll;
    if (offset == 0 || offset > pos) fail("a match reaches before the start of the frame");
    uint8_t* d = out + pos;
    const uint8_t* src = d - offset;
    if (offset >= ml) {
      memcpy(d, src, ml);
    } else {
      for (uint64_t j = 0; j < ml; ++j) d[j] = src[j];
    }
    pos += ml;
  }
  if (in.pos != 0) fail("the sequence bitstream does not end with its sequences");
  size_t left = size_t(litend - lit);
  if (left > cap - pos) fail("output past the buffer");
  memcpy(out + pos, lit, left);
  return pos + left;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

struct FrameHeader {
  size_t size;             // header bytes
  int64_t content;         // -1 when not stated
  bool checksum;
};

FrameHeader frame_header(const uint8_t* p, size_t n) {
  if (n < 5) fail("frame header truncated");
  FrameHeader h{};
  const uint8_t d = p[4];
  const int fcs_flag = d >> 6, single = (d >> 5) & 1, dict_flag = d & 3;
  if (d & 8) fail("reserved bit of the frame header set");
  h.checksum = (d >> 2) & 1;
  size_t k = 5;
  if (!single) ++k;  // window descriptor: the whole frame is the window here
  const int dict_bytes[4] = {0, 1, 2, 4};
  uint32_t dict = 0;
  if (k + dict_bytes[dict_flag] > n) fail("frame header truncated");
  for (int i = 0; i < dict_bytes[dict_flag]; ++i) dict |= uint32_t(p[k + i]) << (8 * i);
  k += dict_bytes[dict_flag];
  if (dict) fail("the frame needs dictionary " + std::to_string(dict));
  const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
  const int fb = fcs_bytes[fcs_flag];
  if (k + fb > n) fail("frame header truncated");
  if (fb == 0) {
    h.content = -1;
  } else {
    uint64_t v = 0;
    for (int i = 0; i < fb; ++i) v |= uint64_t(p[k + i]) << (8 * i);
    if (fb == 2) v += 256;
    h.content = int64_t(v);
  }
  h.size = k + fb;
  return h;
}

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// Decodes every frame of src into dst; returns the bytes written.
size_t decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t in = 0, pos = 0;
  if (n == 0) fail("no frame");
  while (in < n) {
    if (n - in < 4) fail("trailing bytes after the last frame");
    uint32_t magic = rd32(src + in);
    if (skippable(magic)) {
      if (n - in < 8) fail("skippable frame truncated");
      size_t len = rd32(src + in + 4);
      if (len > n - in - 8) fail("skippable frame truncated");
      in += 8 + len;
      continue;
    }
    if (magic != kMagic) fail("not a zstd frame (magic " + std::to_string(magic) + ")");
    FrameHeader h = frame_header(src + in, n - in);
    in += h.size;
    const size_t start = pos;
    FrameState fs;
    for (bool last = false; !last;) {
      if (n - in < 3) fail("block header truncated");
      uint32_t bh = src[in] | (uint32_t(src[in + 1]) << 8) | (uint32_t(src[in + 2]) << 16);
      in += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (size > (1u << 17)) fail("block larger than 128 KiB");
      switch (type) {
        case 0:
          if (size > n - in) fail("raw block truncated");
          if (size > cap - pos) fail("output past the buffer");
          memcpy(dst + pos, src + in, size);
          pos += size, in += size;
          break;
        case 1:
          if (n - in < 1) fail("RLE block truncated");
          if (size > cap - pos) fail("output past the buffer");
          memset(dst + pos, src[in], size);
          pos += size, in += 1;
          break;
        case 2:
          if (size > n - in) fail("compressed block truncated");
          pos = compressed_block(fs, src + in, size, dst, pos, cap);
          in += size;
          break;
        default:
          fail("unknown block type 3 (reserved)");
      }
    }
    if (h.content >= 0 && uint64_t(pos - start) != uint64_t(h.content))
      fail("the frame decodes to " + std::to_string(pos - start) + " bytes, its header says " +
           std::to_string(h.content));
    if (h.checksum) {
      if (n - in < 4) fail("content checksum truncated");
      uint32_t want = rd32(src + in), got = uint32_t(xxh64(dst + start, pos - start));
      if (want != got) fail("bad content checksum (XXH64)");
      in += 4;
    }
  }
  return pos;
}

void set_error(char* err, size_t len, const std::string& what) {
  if (!err || !len) return;
  size_t k = what.size() < len - 1 ? what.size() : len - 1;
  memcpy(err, what.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

// The summed content size of src's frames: -1 where a frame does not state
// it, -2 (and err) where a header does not parse.
int64_t ealdm_zstd_content_size(const uint8_t* src, size_t n, char* err, size_t errlen) {
  try {
    size_t in = 0;
    int64_t total = 0;
    while (in < n) {
      if (n - in < 4) fail("trailing bytes after the last frame");
      uint32_t magic = rd32(src + in);
      if (skippable(magic)) {
        if (n - in < 8) fail("skippable frame truncated");
        in += 8 + size_t(rd32(src + in + 4));
        continue;
      }
      if (magic != kMagic) fail("not a zstd frame");
      FrameHeader h = frame_header(src + in, n - in);
      if (h.content < 0) return -1;
      total += h.content;
      // walk the blocks to the next frame
      in += h.size;
      for (bool last = false; !last;) {
        if (n - in < 3) fail("block header truncated");
        uint32_t bh = src[in] | (uint32_t(src[in + 1]) << 8) | (uint32_t(src[in + 2]) << 16);
        in += 3;
        last = bh & 1;
        const int type = (bh >> 1) & 3;
        size_t size = type == 1 ? 1 : (bh >> 3);
        if (type == 3) fail("unknown block type 3 (reserved)");
        if (size > n - in) fail("block truncated");
        in += size;
      }
      if (h.checksum) in += 4;
    }
    return total;
  } catch (const Error& e) {
    set_error(err, errlen, e.what);
    return -2;
  }
}

// Decodes src into dst (cap bytes); returns the bytes written, or -1 with
// the reason in err.
int64_t ealdm_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                              char* err, size_t errlen) {
  try {
    return int64_t(decode(src, n, dst, cap));
  } catch (const Error& e) {
    set_error(err, errlen, e.what);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

uint32_t ealdm_crc32c(uint32_t crc, const uint8_t* p, size_t n) { return crc32c(crc, p, n); }

}  // extern "C"
