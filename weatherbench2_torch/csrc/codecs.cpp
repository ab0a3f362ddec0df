// Host codecs of the port's Zarr layer (weatherbench2_torch/xds/io_zarr.py).
//
// Zarr v2 stores written by the JAX package (tensorstore) or by zarr-python
// compress their chunks with blosc1: a 16-byte header, a table of block
// starts, then each block as one stream or as `typesize` streams ("split"),
// compressed by one of five codecs after an optional byte or bit shuffle.
// This file decodes every such chunk and encodes blosc-lz4 for the writer:
//
//   blosc1 frame   header, bstarts, memcpyed chunks, split blocks, the
//                  leftover last block, byte and bit unshuffle (c-blosc's
//                  rules, held bit for bit to tensorstore by
//                  tests/test_torch_blosc.py)
//   BloscLZ        decoder
//   LZ4 / LZ4HC    block-format decoder; a greedy hash-table encoder (one
//                  level: the metadata's clevel does not change it), a
//                  chunk's blocks encoded on several threads
//   Snappy         decoder
//   zlib           RFC 1950 wrapper and RFC 1951 inflate, written here (the
//                  library links nothing but the C++ runtime), Adler-32
//                  checked
//   zstd           frame decoder to RFC 8878 (raw, RLE and compressed
//                  blocks; raw, RLE, Huffman and treeless literals in 1 or 4
//                  streams; FSE tables predefined, RLE, compressed and
//                  repeated; repeat offsets); the content checksum is read,
//                  not verified; no dictionaries
//
// Plain C++17 with a C ABI, built with the host's C++ compiler and loaded
// with ctypes (xds/_codec.py).  Every entry point returns an error code (0
// on success); every read is bounded by its source's length and every write
// by its destination's, so a truncated, forged or corrupt chunk is an error,
// never garbage.  No state is shared between calls: threads decode chunks in
// parallel.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

enum Error : int {
  kOk = 0,
  kTruncated = 1,
  kBadHeader = 2,
  kBadVersion = 3,
  kUnknownCodec = 4,
  kSizeMismatch = 5,
  kBadBloscLZ = 6,
  kBadLZ4 = 7,
  kBadSnappy = 8,
  kBadZlib = 9,
  kBadZstd = 10,
  kZstdDictionary = 11,
  kBadArgument = 12,
  kResources = 13,
  kNumErrors = 14,
};

const char* const kErrorStrings[kNumErrors] = {
    "ok",
    "the chunk is shorter than its blosc header says (truncated)",
    "corrupt blosc header or block table",
    "unsupported blosc format version",
    "unknown blosc codec in the chunk's flags",
    "the chunk's blosc header gives another decoded size than the array's "
    "chunk",
    "corrupt BloscLZ stream",
    "corrupt LZ4 stream",
    "corrupt Snappy stream",
    "corrupt zlib stream",
    "corrupt zstd stream",
    "zstd stream needs a dictionary",
    "bad argument",
    "out of memory or threads",
};

// blosc1 header flags and codec numbers (bits 5-7 of the flags)
constexpr uint8_t kByteShuffle = 0x01;
constexpr uint8_t kMemcpyed = 0x02;
constexpr uint8_t kBitShuffle = 0x04;
constexpr uint8_t kDontSplit = 0x10;
enum Codec { kBloscLZ = 0, kLZ4 = 1, kSnappy = 2, kZlib = 3, kZstd = 4 };
constexpr int64_t kHeader = 16;
constexpr int64_t kMaxSplits = 16;      // c-blosc's MAX_SPLITS
constexpr int64_t kMinBufferSize = 128;  // c-blosc's MIN_BUFFERSIZE

inline uint32_t load16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t load24(const uint8_t* p) { return load16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t load32(const uint8_t* p) { return load24(p) | (uint32_t(p[3]) << 24); }
inline void store32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8); p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// op[0, len) = the `len` bytes that start `dist` back; the regions may
// overlap (a repeating pattern), which doubles the copied period each step.
// The caller checks 0 < dist <= bytes before op and len <= room after it.
inline void copy_match(uint8_t* op, size_t dist, size_t len) {
  if (dist >= len) {
    std::memcpy(op, op - dist, len);
    return;
  }
  if (dist == 1) {
    std::memset(op, op[-1], len);
    return;
  }
  size_t step = dist;
  while (len > 0) {
    size_t n = len < step ? len : step;
    std::memcpy(op, op - step, n);
    op += n;
    len -= n;
    step += n;  // everything since the match's source is one pattern
  }
}

// -- LZ4 block format ---------------------------------------------------------

int lz4_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out) {
  size_t ip = 0, op = 0;
  for (;;) {
    if (ip >= n) return kBadLZ4;
    const unsigned token = src[ip++];
    size_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= n) return kBadLZ4;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (lit > n - ip || lit > cap - op) return kBadLZ4;
    if (lit <= 16 && n - ip >= 16 && cap - op >= 16)
      std::memcpy(dst + op, src + ip, 16);  // short runs: one fixed copy
    else
      std::memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip == n) break;  // the last sequence holds literals only
    if (n - ip < 2) return kBadLZ4;
    const size_t dist = load16(src + ip);
    ip += 2;
    if (dist == 0 || dist > op) return kBadLZ4;
    size_t len = token & 15;
    if (len == 15) {
      unsigned b;
      do {
        if (ip >= n) return kBadLZ4;
        b = src[ip++];
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (len > cap - op) return kBadLZ4;
    if (dist >= 8 && cap - op >= len + 8) {
      // 8 bytes a step; a pattern of 8 or more bytes repeats correctly
      uint8_t* d = dst + op;
      const uint8_t* s = d - dist;
      for (size_t i = 0; i < len; i += 8) std::memcpy(d + i, s + i, 8);
    } else {
      copy_match(dst + op, dist, len);
    }
    op += len;
  }
  *out = op;
  return kOk;
}

// Greedy LZ4 encoder: a hash of the next four bytes finds one candidate, the
// match is taken when its four bytes agree.  The block format's end rules
// hold: the last match starts at least 12 bytes before the end and the last
// 5 bytes are literals.  Returns the compressed size, or 0 when it would not
// fit in `cap` bytes.
size_t lz4_encode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  constexpr int kHashLog = 12;  // LZ4's default table: 16 KiB
  constexpr size_t kMinMatch = 4, kLastLiterals = 5, kMatchFindLimit = 12;
  int32_t table[1 << kHashLog];
  std::fill(table, table + (1 << kHashLog), -1);
  auto hash = [](uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); };
  // LZ4's acceleration: after 2^kSkipTrigger misses in a row the step
  // grows, so data that does not compress passes quickly
  constexpr int kSkipTrigger = 6;
  size_t op = 0, anchor = 0, ip = 0, misses = 0;
  auto put_length = [&](size_t len) -> bool {  // len >= 15 already in the token
    len -= 15;
    while (len >= 255) {
      if (op >= cap) return false;
      dst[op++] = 255;
      len -= 255;
    }
    if (op >= cap) return false;
    dst[op++] = uint8_t(len);
    return true;
  };
  auto put_sequence = [&](size_t lit_end, size_t dist, size_t len) -> bool {
    const size_t lit = lit_end - anchor;
    if (op >= cap) return false;
    const size_t token_at = op++;
    uint8_t token = uint8_t((lit >= 15 ? 15 : lit) << 4);
    if (lit >= 15 && !put_length(lit)) return false;
    if (lit > cap - op) return false;
    std::memcpy(dst + op, src + anchor, lit);
    op += lit;
    if (len > 0) {  // not the closing literal run
      if (cap - op < 2) return false;
      dst[op++] = uint8_t(dist);
      dst[op++] = uint8_t(dist >> 8);
      const size_t ml = len - kMinMatch;
      token |= uint8_t(ml >= 15 ? 15 : ml);
      if (ml >= 15 && !put_length(ml)) return false;
    }
    dst[token_at] = token;
    return true;
  };
  if (n > kMatchFindLimit) {
    const size_t limit = n - kMatchFindLimit;  // a match starts before this
    const size_t match_end = n - kLastLiterals;  // and ends before this
    while (ip < limit) {
      uint32_t v;
      std::memcpy(&v, src + ip, 4);
      const uint32_t h = hash(v);
      const int32_t ref = table[h];
      table[h] = int32_t(ip);
      uint32_t w;
      if (ref < 0 || ip - size_t(ref) > 65535 ||
          (std::memcpy(&w, src + ref, 4), w != v)) {
        ip += 1 + (misses++ >> kSkipTrigger);
        continue;
      }
      misses = 0;
      size_t len = kMinMatch;
      while (ip + len < match_end && src[ref + len] == src[ip + len]) ++len;
      if (!put_sequence(ip, ip - size_t(ref), len)) return 0;
      ip += len;
      anchor = ip;
    }
  }
  if (!put_sequence(n, 0, 0)) return 0;
  return op;
}

// -- BloscLZ ------------------------------------------------------------------

int blosclz_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out) {
  constexpr size_t kMaxDistance = 8191;
  size_t ip = 0, op = 0;
  if (n == 0) return kBadBloscLZ;
  uint32_t ctrl = src[ip++] & 31u;  // the first instruction is a literal run
  for (;;) {
    if (ctrl >= 32) {  // a match: length in the top 3 bits, distance below
      size_t len = (ctrl >> 5) - 1;
      const size_t hi = size_t(ctrl & 31u) << 8;
      if (len == 6) {
        uint8_t b;
        do {
          if (ip >= n) return kBadBloscLZ;
          b = src[ip++];
          len += b;
        } while (b == 255);
      }
      if (ip >= n) return kBadBloscLZ;
      const uint8_t code = src[ip++];
      len += 3;
      size_t dist = hi + code;
      if (code == 255 && hi == (31u << 8)) {  // a 16-bit far distance follows
        if (n - ip < 2) return kBadBloscLZ;
        dist = ((size_t(src[ip]) << 8) | src[ip + 1]) + kMaxDistance;
        ip += 2;
      }
      dist += 1;
      if (dist > op || len > cap - op) return kBadBloscLZ;
      copy_match(dst + op, dist, len);
      op += len;
    } else {
      const size_t lit = ctrl + 1;
      if (lit > n - ip || lit > cap - op) return kBadBloscLZ;
      std::memcpy(dst + op, src + ip, lit);
      ip += lit;
      op += lit;
    }
    if (ip >= n) break;
    ctrl = src[ip++];
  }
  *out = op;
  return kOk;
}

// -- Snappy -------------------------------------------------------------------

int snappy_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out) {
  size_t ip = 0;
  uint64_t total = 0;
  for (int shift = 0;; shift += 7) {  // the preamble: decoded length, varint
    if (ip >= n || shift > 28) return kBadSnappy;
    const uint8_t b = src[ip++];
    total |= uint64_t(b & 127) << shift;
    if (!(b & 128)) break;
  }
  if (total > cap) return kBadSnappy;
  size_t op = 0;
  while (ip < n) {
    const uint8_t tag = src[ip++];
    size_t len, dist;
    switch (tag & 3) {
      case 0: {  // literal
        len = tag >> 2;
        if (len >= 60) {
          const size_t nb = len - 59;
          if (n - ip < nb) return kBadSnappy;
          len = 0;
          for (size_t i = 0; i < nb; ++i) len |= size_t(src[ip + i]) << (8 * i);
          ip += nb;
        }
        len += 1;
        if (len > n - ip || len > total - op) return kBadSnappy;
        std::memcpy(dst + op, src + ip, len);
        ip += len;
        op += len;
        continue;
      }
      case 1:  // copy, 11-bit distance
        if (ip >= n) return kBadSnappy;
        len = 4 + ((tag >> 2) & 7);
        dist = (size_t(tag >> 5) << 8) | src[ip++];
        break;
      case 2:  // copy, 16-bit distance
        if (n - ip < 2) return kBadSnappy;
        len = 1 + (tag >> 2);
        dist = load16(src + ip);
        ip += 2;
        break;
      default:  // copy, 32-bit distance
        if (n - ip < 4) return kBadSnappy;
        len = 1 + (tag >> 2);
        dist = load32(src + ip);
        ip += 4;
        break;
    }
    if (dist == 0 || dist > op || len > total - op) return kBadSnappy;
    copy_match(dst + op, dist, len);
    op += len;
  }
  if (op != total) return kBadSnappy;
  *out = op;
  return kOk;
}

// -- zlib: RFC 1950 around RFC 1951 -------------------------------------------

struct InflateBits {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int count = 0;
  bool overrun = false;
  uint32_t bits(int need) {  // need <= 16
    while (count < need) {
      if (pos >= n) {
        overrun = true;
        return 0;
      }
      buf |= uint64_t(p[pos++]) << count;
      count += 8;
    }
    const uint32_t v = uint32_t(buf & ((1u << need) - 1));
    buf >>= need;
    count -= need;
    return v;
  }
};

struct Huffman {  // canonical code: counts by length, symbols by code
  int16_t count[16];
  int16_t symbol[288];
};

// Returns 0 for a complete code, > 0 for an incomplete one, < 0 for an
// over-subscribed one.
int huffman_build(Huffman* h, const uint8_t* lengths, int n) {
  std::memset(h->count, 0, sizeof(h->count));
  for (int s = 0; s < n; ++s) h->count[lengths[s]]++;
  if (h->count[0] == n) return 0;
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h->count[len];
    if (left < 0) return left;
  }
  int16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h->count[len];
  for (int s = 0; s < n; ++s)
    if (lengths[s]) h->symbol[offs[lengths[s]]++] = int16_t(s);
  return left;
}

int huffman_decode(InflateBits* s, const Huffman& h) {
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= int(s->bits(1));
    if (s->overrun) return -1;
    const int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

constexpr int16_t kLengthBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                                     31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr int8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                     2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr int16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                   193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                   6145, 8193, 12289, 16385, 24577};
constexpr int8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                   6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

int inflate_codes(InflateBits* s, const Huffman& lit, const Huffman& dist, uint8_t* dst,
                  size_t cap, size_t* op) {
  for (;;) {
    int sym = huffman_decode(s, lit);
    if (sym < 0) return kBadZlib;
    if (sym < 256) {
      if (*op >= cap) return kBadZlib;
      dst[(*op)++] = uint8_t(sym);
    } else if (sym == 256) {
      return kOk;
    } else {
      sym -= 257;
      if (sym >= 29) return kBadZlib;
      const size_t len = kLengthBase[sym] + s->bits(kLengthExtra[sym]);
      const int dsym = huffman_decode(s, dist);
      if (dsym < 0 || dsym >= 30) return kBadZlib;
      const size_t d = kDistBase[dsym] + s->bits(kDistExtra[dsym]);
      if (s->overrun || d > *op || len > cap - *op) return kBadZlib;
      copy_match(dst + *op, d, len);
      *op += len;
    }
  }
}

int inflate_dynamic_tables(InflateBits* s, Huffman* lit, Huffman* dist) {
  static constexpr uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                         11, 4, 12, 3, 13, 2, 14, 1, 15};
  const int nlen = int(s->bits(5)) + 257, ndist = int(s->bits(5)) + 1;
  const int ncode = int(s->bits(4)) + 4;
  if (s->overrun || nlen > 286 || ndist > 30) return kBadZlib;
  uint8_t lengths[320] = {0};
  for (int i = 0; i < ncode; ++i) lengths[kOrder[i]] = uint8_t(s->bits(3));
  Huffman code;
  if (s->overrun || huffman_build(&code, lengths, 19) != 0) return kBadZlib;
  int i = 0;
  while (i < nlen + ndist) {
    int sym = huffman_decode(s, code);
    if (sym < 0) return kBadZlib;
    if (sym < 16) {
      lengths[i++] = uint8_t(sym);
      continue;
    }
    uint8_t value = 0;
    int repeat;
    if (sym == 16) {
      if (i == 0) return kBadZlib;
      value = lengths[i - 1];
      repeat = 3 + int(s->bits(2));
    } else if (sym == 17) {
      repeat = 3 + int(s->bits(3));
    } else {
      repeat = 11 + int(s->bits(7));
    }
    if (s->overrun || i + repeat > nlen + ndist) return kBadZlib;
    while (repeat--) lengths[i++] = value;
  }
  if (lengths[256] == 0) return kBadZlib;  // no end-of-block code
  const int lerr = huffman_build(lit, lengths, nlen);
  if (lerr < 0 || (lerr > 0 && nlen - lit->count[0] != 1)) return kBadZlib;
  const int derr = huffman_build(dist, lengths + nlen, ndist);
  if (derr < 0 || (derr > 0 && ndist - dist->count[0] != 1)) return kBadZlib;
  return kOk;
}

int zlib_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out) {
  if (n < 6) return kBadZlib;
  const uint32_t cmf = src[0], flg = src[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20))
    return kBadZlib;
  InflateBits s{src + 2, n - 6};
  size_t op = 0;
  int last;
  do {
    last = int(s.bits(1));
    const int type = int(s.bits(2));
    if (s.overrun) return kBadZlib;
    if (type == 0) {  // stored: from the next byte boundary
      s.buf = 0;
      s.count = 0;
      if (s.n - s.pos < 4) return kBadZlib;
      const size_t len = load16(s.p + s.pos);
      if ((len ^ 0xffff) != load16(s.p + s.pos + 2)) return kBadZlib;
      s.pos += 4;
      if (len > s.n - s.pos || len > cap - op) return kBadZlib;
      std::memcpy(dst + op, s.p + s.pos, len);
      s.pos += len;
      op += len;
    } else if (type == 1) {
      static const auto fixed = [] {
        std::pair<Huffman, Huffman> t;
        uint8_t lengths[320];
        int i = 0;
        for (; i < 144; ++i) lengths[i] = 8;
        for (; i < 256; ++i) lengths[i] = 9;
        for (; i < 280; ++i) lengths[i] = 7;
        for (; i < 288; ++i) lengths[i] = 8;
        for (; i < 318; ++i) lengths[i] = 5;
        huffman_build(&t.first, lengths, 288);
        huffman_build(&t.second, lengths + 288, 30);
        return t;
      }();
      const int err = inflate_codes(&s, fixed.first, fixed.second, dst, cap, &op);
      if (err) return err;
    } else if (type == 2) {
      Huffman lit, dist;
      int err = inflate_dynamic_tables(&s, &lit, &dist);
      if (!err) err = inflate_codes(&s, lit, dist, dst, cap, &op);
      if (err) return err;
    } else {
      return kBadZlib;
    }
  } while (!last);
  // the Adler-32 of the decoded bytes follows, big-endian, byte-aligned
  if (s.pos != s.n) return kBadZlib;
  const uint8_t* a = src + n - 4;
  const uint32_t want = (uint32_t(a[0]) << 24) | (uint32_t(a[1]) << 16) |
                        (uint32_t(a[2]) << 8) | a[3];
  uint32_t s1 = 1, s2 = 0;
  for (size_t i = 0; i < op;) {
    const size_t end = i + 5552 < op ? i + 5552 : op;
    for (; i < end; ++i) {
      s1 += dst[i];
      s2 += s1;
    }
    s1 %= 65521;
    s2 %= 65521;
  }
  if (((s2 << 16) | s1) != want) return kBadZlib;
  *out = op;
  return kOk;
}

// -- zstd (RFC 8878) ----------------------------------------------------------

constexpr size_t kZstdBlockMax = 128 * 1024;

// A backward bitstream: read from the end towards the start, most
// significant bits first; the last byte's highest set bit marks the end.
// Bits below the stream's start read as zeros and drive `pos` negative,
// which the callers test.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits left
  bool init(const uint8_t* src, size_t len) {
    if (len == 0 || src[len - 1] == 0) return false;
    p = src;
    n = len;
    pos = int64_t(8 * (len - 1)) + highbit(src[len - 1]);
    return true;
  }
  uint64_t word(size_t byte) const {  // up to 8 bytes from `byte`, zero-padded
    uint64_t w = 0;
    if (byte + 8 <= n) {
      std::memcpy(&w, p + byte, 8);
      return w;
    }
    for (size_t i = 0; byte + i < n && i < 8; ++i) w |= uint64_t(p[byte + i]) << (8 * i);
    return w;
  }
  uint64_t peek(int nb) const {  // bits [pos - nb, pos); nb <= 56
    if (nb == 0) return 0;
    const int64_t start = pos - nb;
    const uint64_t mask = (uint64_t(1) << nb) - 1;
    if (start >= 0) return (word(size_t(start) >> 3) >> (start & 7)) & mask;
    if (pos <= 0) return 0;
    return (word(0) & ((uint64_t(1) << pos) - 1)) << (-start);
  }
  uint64_t read(int nb) {
    const uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

struct FseEntry {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  FseEntry e[512];
};

// FSE table description (forward bitstream, LSB first); returns the bytes
// used or 0 on a corrupt description.
size_t fse_read_counts(const uint8_t* src, size_t n, int max_symbol, int max_log,
                       int16_t* counts, int* nsym, int* log) {
  size_t bp = 0;
  auto peek = [&](int nb) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      const size_t b = bp + i;
      if ((b >> 3) < n) v |= uint32_t((src[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  };
  *log = int(peek(4)) + 5;
  bp += 4;
  if (*log > max_log) return 0;
  int remaining = (1 << *log) + 1, threshold = 1 << *log, nbits = *log + 1;
  int sym = 0;
  bool previous_zero = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (previous_zero) {
      int zeros = 0;
      for (;;) {
        const int r = int(peek(2));
        bp += 2;
        zeros += r;
        if (r != 3) break;
        if (zeros > 255) return 0;
      }
      if (sym + zeros > max_symbol + 1) return 0;
      while (zeros--) counts[sym++] = 0;
      if (sym > max_symbol) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const int v = int(peek(nbits));
    if ((v & (threshold - 1)) < max) {
      count = v & (threshold - 1);
      bp += nbits - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= max;
      bp += nbits;
    }
    count -= 1;  // -1: a "less than one" probability
    remaining -= count < 0 ? -count : count;
    counts[sym++] = int16_t(count);
    previous_zero = count == 0;
    if (remaining < 1) return 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || sym > max_symbol + 1) return 0;
  const size_t used = (bp + 7) >> 3;
  if (used > n) return 0;
  *nsym = sym;
  return used;
}

bool fse_build(FseTable* t, const int16_t* counts, int nsym, int log) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  t->log = log;
  for (int s = 0; s < nsym; ++s) {
    if (counts[s] == -1) {
      t->e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(counts[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      t->e[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    const uint32_t x = next[t->e[u].symbol]++;
    if (x == 0) return false;
    const int nb = log - highbit(x);
    t->e[u].nbits = uint8_t(nb);
    t->e[u].base = uint16_t((x << nb) - size);
  }
  return true;
}

void fse_rle(FseTable* t, uint8_t symbol) {
  t->log = 0;
  t->e[0] = {symbol, 0, 0};
}

struct FseState {
  const FseTable* t;
  uint32_t s;
  void init(BackBits* b) { s = uint32_t(b->read(t->log)); }
  uint8_t symbol() const { return t->e[s].symbol; }
  void update(BackBits* b) { s = t->e[s].base + uint32_t(b->read(t->e[s].nbits)); }
};

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  uint8_t symbol[1 << kHufMaxBits];
  uint8_t nbits[1 << kHufMaxBits];
};

// Huffman tree description; returns the bytes used or 0 if corrupt.
size_t huf_read(const uint8_t* src, size_t n, HufTable* h) {
  if (n < 1) return 0;
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const int hb = src[0];
  if (hb >= 128) {  // direct: 4-bit weights, two a byte
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) return 0;
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + size_t(hb);
    if (used > n || hb == 0) return 0;
    int16_t counts[256];
    int nsym, log;
    const size_t hdr = fse_read_counts(src + 1, hb, 255, 6, counts, &nsym, &log);
    if (hdr == 0) return 0;
    std::unique_ptr<FseTable> t(new FseTable);
    if (!fse_build(t.get(), counts, nsym, log)) return 0;
    BackBits b;
    if (!b.init(src + 1 + hdr, size_t(hb) - hdr)) return 0;
    FseState s1{t.get(), 0}, s2{t.get(), 0};
    s1.init(&b);
    s2.init(&b);
    if (b.pos < 0) return 0;
    for (;;) {
      if (nw > 253) return 0;
      w[nw++] = s1.symbol();
      s1.update(&b);
      if (b.pos < 0) {
        w[nw++] = s2.symbol();
        break;
      }
      w[nw++] = s2.symbol();
      s2.update(&b);
      if (b.pos < 0) {
        w[nw++] = s1.symbol();
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kHufMaxBits + 1) return 0;
    if (w[i]) total += uint32_t(1) << (w[i] - 1);
  }
  if (total == 0 || nw > 255) return 0;
  const int max_bits = highbit(total) + 1;
  const uint32_t rest = (uint32_t(1) << max_bits) - total;
  if (rest & (rest - 1)) return 0;
  w[nw++] = uint8_t(highbit(rest) + 1);  // the last weight is implied
  if (max_bits > kHufMaxBits) return 0;
  h->max_bits = max_bits;
  uint32_t pos = 0;
  for (int weight = 1; weight <= max_bits; ++weight) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != weight) continue;
      const uint32_t len = uint32_t(1) << (weight - 1);
      if (pos + len > (uint32_t(1) << max_bits)) return 0;
      std::memset(h->symbol + pos, s, len);
      std::memset(h->nbits + pos, max_bits + 1 - weight, len);
      pos += len;
    }
  }
  if (pos != (uint32_t(1) << max_bits)) return 0;
  return used;
}

bool huf_stream(const uint8_t* src, size_t n, const HufTable& h, uint8_t* dst, size_t count) {
  BackBits b;
  if (!b.init(src, n)) return false;
  for (size_t i = 0; i < count; ++i) {
    const uint32_t v = uint32_t(b.peek(h.max_bits));
    dst[i] = h.symbol[v];
    b.pos -= h.nbits[v];
    if (b.pos < 0) return false;
  }
  return b.pos == 0;
}

// the baselines and extra bits of the literal-length and match-length codes
constexpr uint32_t kLLBase[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                  12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                                  17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                                  31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// the predefined distributions
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct ZstdFrame {  // what carries over from block to block
  HufTable huf;
  bool huf_valid = false;
  FseTable ll, of, ml;
  bool ll_valid = false, of_valid = false, ml_valid = false;
  uint32_t rep[3] = {1, 4, 8};
  uint8_t literals[kZstdBlockMax];
};

// The literals section; sets *lit_len and returns the bytes used, 0 if corrupt.
size_t zstd_literals(const uint8_t* src, size_t n, ZstdFrame* f, size_t* lit_len) {
  if (n < 1) return 0;
  const int type = src[0] & 3, format = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    size_t size, hdr;
    if (format == 0 || format == 2) {
      size = src[0] >> 3;
      hdr = 1;
    } else if (format == 1) {
      if (n < 2) return 0;
      size = (src[0] >> 4) | (size_t(src[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) return 0;
      size = (src[0] >> 4) | (size_t(src[1]) << 4) | (size_t(src[2]) << 12);
      hdr = 3;
    }
    if (size > kZstdBlockMax) return 0;
    *lit_len = size;
    if (type == 0) {
      if (size > n - hdr) return 0;
      std::memcpy(f->literals, src + hdr, size);
      return hdr + size;
    }
    if (n - hdr < 1) return 0;
    std::memset(f->literals, src[hdr], size);
    return hdr + 1;
  }
  size_t hdr, regen, comp;
  const bool four = format != 0;
  if (format <= 1) {
    if (n < 3) return 0;
    const uint32_t h = load24(src);
    hdr = 3;
    regen = (h >> 4) & 1023;
    comp = (h >> 14) & 1023;
  } else if (format == 2) {
    if (n < 4) return 0;
    const uint32_t h = load32(src);
    hdr = 4;
    regen = (h >> 4) & 16383;
    comp = h >> 18;
  } else {
    if (n < 5) return 0;
    const uint64_t h = load32(src) | (uint64_t(src[4]) << 32);
    hdr = 5;
    regen = (h >> 4) & 262143;
    comp = size_t(h >> 22);
  }
  if (regen > kZstdBlockMax || comp > n - hdr) return 0;
  const uint8_t* p = src + hdr;
  size_t left = comp;
  if (type == 2) {
    const size_t tree = huf_read(p, left, &f->huf);
    if (tree == 0) return 0;
    f->huf_valid = true;
    p += tree;
    left -= tree;
  } else if (!f->huf_valid) {
    return 0;  // treeless literals with no earlier tree
  }
  if (!four) {
    if (!huf_stream(p, left, f->huf, f->literals, regen)) return 0;
  } else {
    if (left < 6) return 0;
    const size_t s1 = load16(p), s2 = load16(p + 2), s3 = load16(p + 4);
    if (s1 + s2 + s3 > left - 6) return 0;
    const size_t sizes[4] = {s1, s2, s3, left - 6 - s1 - s2 - s3};
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) return 0;
    const uint8_t* q = p + 6;
    for (int i = 0; i < 4; ++i) {
      const size_t count = i < 3 ? seg : regen - 3 * seg;
      if (!huf_stream(q, sizes[i], f->huf, f->literals + i * seg, count)) return 0;
      q += sizes[i];
    }
  }
  *lit_len = regen;
  return hdr + comp;
}

// One of the three symbol tables of the sequences section; returns the bytes
// used (0 allowed) or -1 if corrupt.
int64_t zstd_table(const uint8_t* src, size_t n, int mode, FseTable* t, bool* valid,
                   const int16_t* defaults, int ndefault, int default_log, int max_symbol,
                   int max_log) {
  switch (mode) {
    case 0:
      fse_build(t, defaults, ndefault, default_log);
      *valid = true;
      return 0;
    case 1:
      if (n < 1 || src[0] > max_symbol) return -1;
      fse_rle(t, src[0]);
      *valid = true;
      return 1;
    case 2: {
      int16_t counts[256];
      int nsym, log;
      const size_t used = fse_read_counts(src, n, max_symbol, max_log, counts, &nsym, &log);
      if (used == 0 || !fse_build(t, counts, nsym, log)) return -1;
      *valid = true;
      return int64_t(used);
    }
    default:
      return *valid ? 0 : -1;
  }
}

int zstd_block(const uint8_t* src, size_t n, ZstdFrame* f, uint8_t* dst, size_t cap,
               size_t frame_start, size_t* op) {
  size_t lit_len = 0;
  const size_t lit_used = zstd_literals(src, n, f, &lit_len);
  if (lit_used == 0) return kBadZstd;
  size_t ip = lit_used;
  if (ip >= n) return kBadZstd;
  size_t nseq = src[ip++];
  if (nseq >= 128) {
    if (nseq == 255) {
      if (n - ip < 2) return kBadZstd;
      nseq = load16(src + ip) + 0x7F00;
      ip += 2;
    } else {
      if (ip >= n) return kBadZstd;
      nseq = ((nseq - 128) << 8) + src[ip++];
    }
  }
  size_t lp = 0;  // literals consumed
  if (nseq > 0) {
    if (ip >= n) return kBadZstd;
    const uint8_t modes = src[ip++];
    if (modes & 3) return kBadZstd;
    int64_t used = zstd_table(src + ip, n - ip, modes >> 6, &f->ll, &f->ll_valid, kLLDefault,
                              36, 6, 35, 9);
    if (used < 0) return kBadZstd;
    ip += size_t(used);
    used = zstd_table(src + ip, n - ip, (modes >> 4) & 3, &f->of, &f->of_valid, kOFDefault, 29,
                      5, 31, 8);
    if (used < 0) return kBadZstd;
    ip += size_t(used);
    used = zstd_table(src + ip, n - ip, (modes >> 2) & 3, &f->ml, &f->ml_valid, kMLDefault,
                      53, 6, 52, 9);
    if (used < 0) return kBadZstd;
    ip += size_t(used);
    BackBits b;
    if (!b.init(src + ip, n - ip)) return kBadZstd;
    FseState ll{&f->ll, 0}, of{&f->of, 0}, ml{&f->ml, 0};
    ll.init(&b);
    of.init(&b);
    ml.init(&b);
    for (size_t i = 0; i < nseq; ++i) {
      const uint8_t ofc = of.symbol(), mlc = ml.symbol(), llc = ll.symbol();
      if (ofc > 31 || mlc > 52 || llc > 35) return kBadZstd;
      uint64_t offset = (uint64_t(1) << ofc) + b.read(ofc);
      const size_t mlen = kMLBase[mlc] + size_t(b.read(kMLBits[mlc]));
      const size_t llen = kLLBase[llc] + size_t(b.read(kLLBits[llc]));
      if (offset > 3) {
        offset -= 3;
        f->rep[2] = f->rep[1];
        f->rep[1] = f->rep[0];
        f->rep[0] = uint32_t(offset);
      } else {  // a repeat offset; a zero literal length shifts the choice
        const size_t k = size_t(offset) - (llen != 0 ? 1 : 0);
        if (k == 0) {
          offset = f->rep[0];
        } else {
          offset = k == 3 ? uint64_t(f->rep[0]) - 1 : f->rep[k];
          if (k != 1) f->rep[2] = f->rep[1];
          f->rep[1] = f->rep[0];
          f->rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {
        ll.update(&b);
        ml.update(&b);
        of.update(&b);
      }
      if (b.pos < 0) return kBadZstd;
      if (llen > lit_len - lp || llen > cap - *op) return kBadZstd;
      std::memcpy(dst + *op, f->literals + lp, llen);
      lp += llen;
      *op += llen;
      if (offset == 0 || offset > *op - frame_start || mlen > cap - *op) return kBadZstd;
      copy_match(dst + *op, size_t(offset), mlen);
      *op += mlen;
    }
    if (b.pos != 0) return kBadZstd;
  } else if (ip != n) {
    return kBadZstd;
  }
  const size_t rest = lit_len - lp;
  if (rest > cap - *op) return kBadZstd;
  std::memcpy(dst + *op, f->literals + lp, rest);
  *op += rest;
  return kOk;
}

int zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out) {
  size_t ip = 0, op = 0;
  std::unique_ptr<ZstdFrame> f;
  while (ip < n) {
    if (n - ip < 4) return kBadZstd;
    const uint32_t magic = load32(src + ip);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // a skippable frame
      if (n - ip < 8 || load32(src + ip + 4) > n - ip - 8) return kBadZstd;
      ip += 8 + load32(src + ip + 4);
      continue;
    }
    if (magic != 0xFD2FB528u) return kBadZstd;
    ip += 4;
    if (ip >= n) return kBadZstd;
    const uint8_t fhd = src[ip++];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    const int dict_flag = fhd & 3;
    if (fhd & 0x08) return kBadZstd;  // reserved bit
    if (!single) {
      if (ip >= n) return kBadZstd;
      ++ip;  // the window descriptor: the whole output is in memory
    }
    static constexpr int kDictBytes[4] = {0, 1, 2, 4};
    const int dict_bytes = kDictBytes[dict_flag];
    if (n - ip < size_t(dict_bytes)) return kBadZstd;
    uint32_t dict_id = 0;
    for (int i = 0; i < dict_bytes; ++i) dict_id |= uint32_t(src[ip + i]) << (8 * i);
    if (dict_id != 0) return kZstdDictionary;
    ip += dict_bytes;
    static constexpr int kFcsBytes[4] = {0, 2, 4, 8};
    const int fcs_bytes = fcs_flag == 0 ? single : kFcsBytes[fcs_flag];
    if (n - ip < size_t(fcs_bytes)) return kBadZstd;
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(src[ip + i]) << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    ip += fcs_bytes;
    if (!f) f.reset(new ZstdFrame);
    f->huf_valid = f->ll_valid = f->of_valid = f->ml_valid = false;
    f->rep[0] = 1;
    f->rep[1] = 4;
    f->rep[2] = 8;
    const size_t frame_start = op;
    for (bool last = false; !last;) {
      if (n - ip < 3) return kBadZstd;
      const uint32_t bh = load24(src + ip);
      ip += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 0) {
        if (size > n - ip || size > cap - op) return kBadZstd;
        std::memcpy(dst + op, src + ip, size);
        ip += size;
        op += size;
      } else if (type == 1) {
        if (ip >= n || size > cap - op) return kBadZstd;
        std::memset(dst + op, src[ip++], size);
        op += size;
      } else if (type == 2) {
        if (size > n - ip || size > kZstdBlockMax) return kBadZstd;
        const int err = zstd_block(src + ip, size, f.get(), dst, cap, frame_start, &op);
        if (err) return err;
        ip += size;
      } else {
        return kBadZstd;
      }
    }
    if (checksum) {  // the content checksum is skipped, not verified
      if (n - ip < 4) return kBadZstd;
      ip += 4;
    }
    if (fcs_bytes && fcs != op - frame_start) return kBadZstd;
  }
  *out = op;
  return kOk;
}

// -- the blosc1 frame ---------------------------------------------------------

inline uint64_t transpose8x8(uint64_t x) {  // bit (8i + j) <-> bit (8j + i)
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// Byte shuffle of one block: byte j of element i at j * n + i.  The bytes
// past the last whole element stay where they are.
template <bool kForward, size_t kTs>
void byte_shuffle_fixed(const uint8_t* src, uint8_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j < kTs; ++j) {
      if (kForward)
        dst[j * n + i] = src[i * kTs + j];
      else
        dst[i * kTs + j] = src[j * n + i];
    }
  }
}

template <bool kForward>
void byte_shuffle(const uint8_t* src, uint8_t* dst, size_t ts, size_t size) {
  const size_t n = size / ts;
  switch (ts) {  // the common typesizes unrolled
    case 2: byte_shuffle_fixed<kForward, 2>(src, dst, n); break;
    case 4: byte_shuffle_fixed<kForward, 4>(src, dst, n); break;
    case 8: byte_shuffle_fixed<kForward, 8>(src, dst, n); break;
    default:
      for (size_t j = 0; j < ts; ++j) {
        for (size_t i = 0; i < n; ++i) {
          if (kForward)
            dst[j * n + i] = src[i * ts + j];
          else
            dst[i * ts + j] = src[j * n + i];
        }
      }
  }
  std::memcpy(dst + n * ts, src + n * ts, size - n * ts);
}

// Bit shuffle of one block (c-blosc1's rule): bit k of byte j of element
// 8b + q at bit q of byte b of row 8j + k, rows of n / 8 bytes.  A block
// whose element count is not a multiple of 8 is stored as it is; the bytes
// past the last whole element stay where they are.
template <bool kForward>
void bit_shuffle(const uint8_t* src, uint8_t* dst, size_t ts, size_t size) {
  const size_t n = size / ts;
  if (n % 8 != 0) {
    std::memcpy(dst, src, size);
    return;
  }
  const size_t row = n / 8;
  for (size_t j = 0; j < ts; ++j) {
    for (size_t b = 0; b < row; ++b) {
      uint64_t x = 0;
      for (size_t k = 0; k < 8; ++k) {
        const uint8_t v = kForward ? src[(8 * b + k) * ts + j] : src[(8 * j + k) * row + b];
        x |= uint64_t(v) << (8 * k);
      }
      x = transpose8x8(x);
      for (size_t k = 0; k < 8; ++k) {
        const uint8_t v = uint8_t(x >> (8 * k));
        if (kForward)
          dst[(8 * j + k) * row + b] = v;
        else
          dst[(8 * b + k) * ts + j] = v;
      }
    }
  }
  std::memcpy(dst + n * ts, src + n * ts, size - n * ts);
}

// One stream of a block, which must decode to exactly `want` bytes.
int decode_stream(int codec, const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  using Decoder = int (*)(const uint8_t*, size_t, uint8_t*, size_t, size_t*);
  static constexpr Decoder kDecoders[5] = {blosclz_decode, lz4_decode, snappy_decode,
                                           zlib_decode, zstd_decode};
  static constexpr int kCorrupt[5] = {kBadBloscLZ, kBadLZ4, kBadSnappy, kBadZlib, kBadZstd};
  size_t got = 0;
  const int err = kDecoders[codec](src, n, dst, want, &got);
  if (err) return err;
  return got == want ? kOk : kCorrupt[codec];
}

// Whether c-blosc splits a block into `typesize` streams.
inline bool splits(uint8_t flags, size_t ts, size_t bsize, bool leftover) {
  return !(flags & kDontSplit) && ts <= size_t(kMaxSplits) &&
         bsize / ts >= size_t(kMinBufferSize) && !leftover;
}

// One block of the writer into out[0, bsize + 4 * typesize): shuffled, then
// each of its streams after its int32 size, compressed when that makes it
// shorter and raw otherwise.  Returns the bytes written.
size_t encode_block(const uint8_t* src, size_t bsize, size_t ts, int shuffle, uint8_t flags,
                    bool leftover, uint8_t* out, std::vector<uint8_t>* tmp) {
  const uint8_t* block = src;
  if (shuffle == 1 && ts > 1) {
    tmp->resize(bsize);
    byte_shuffle<true>(src, tmp->data(), ts, bsize);
    block = tmp->data();
  } else if (shuffle == 2 && bsize >= ts) {
    tmp->resize(bsize);
    bit_shuffle<true>(src, tmp->data(), ts, bsize);
    block = tmp->data();
  }
  const size_t nsplits = splits(flags, ts, bsize, leftover) ? ts : 1;
  const size_t neblock = bsize / nsplits;
  size_t p = 0;
  for (size_t s = 0; s < nsplits; ++s) {
    // a stream of exactly its raw size reads as raw: compressed only when
    // shorter
    size_t cs = neblock > 1 ? lz4_encode(block + s * neblock, neblock, out + p + 4, neblock - 1)
                            : 0;
    if (cs == 0) {
      std::memcpy(out + p + 4, block + s * neblock, neblock);
      cs = neblock;
    }
    store32(out + p, uint32_t(cs));
    p += 4 + cs;
  }
  return p;
}

}  // namespace

extern "C" {

const char* wb2_codec_error_string(int err) {
  return err >= 0 && err < kNumErrors ? kErrorStrings[err] : "unknown error";
}

// Decodes the blosc1 chunk src[0, len) into dst[0, dst_len); the chunk must
// decode to exactly dst_len bytes.
int wb2_blosc_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t dst_len) {
  if (len < 0 || dst_len < 0) return kBadArgument;
  if (len < kHeader) return kTruncated;
  const uint8_t version = src[0], flags = src[2];
  const size_t ts = src[3];
  const int64_t nbytes = int32_t(load32(src + 4)), blocksize = int32_t(load32(src + 8));
  const int64_t cbytes = int32_t(load32(src + 12));
  if (version == 0 || version > 2) return kBadVersion;
  if (nbytes < 0 || cbytes < kHeader) return kBadHeader;
  if (cbytes > len) return kTruncated;
  if (cbytes < len) return kBadHeader;
  if (nbytes != dst_len) return kSizeMismatch;
  if (flags & kMemcpyed) {
    if (cbytes - kHeader < nbytes) return kTruncated;
    if (cbytes - kHeader > nbytes) return kBadHeader;
    std::memcpy(dst, src + kHeader, size_t(nbytes));
    return kOk;
  }
  if (nbytes == 0) return kOk;
  if (ts == 0 || blocksize <= 0) return kBadHeader;
  const int codec = flags >> 5;
  if (codec > kZstd) return kUnknownCodec;
  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const int64_t table_end = kHeader + 4 * nblocks;
  if (table_end > len) return kTruncated;
  try {
  std::vector<uint8_t> tmp;
  for (int64_t j = 0; j < nblocks; ++j) {
    const bool leftover = j == nblocks - 1 && nbytes % blocksize != 0;
    const size_t bsize = size_t(leftover ? nbytes % blocksize : blocksize);
    const bool unshuffle = (flags & kByteShuffle) && ts > 1;
    const bool unbitshuffle = !unshuffle && (flags & kBitShuffle) && bsize >= ts;
    uint8_t* block = dst + j * blocksize;
    if (unshuffle || unbitshuffle) {
      tmp.resize(bsize);
      block = tmp.data();
    }
    const int64_t start = int32_t(load32(src + kHeader + 4 * j));
    if (start < table_end || start > len) return kBadHeader;
    const size_t nsplits = splits(flags, ts, bsize, leftover) ? ts : 1;
    const size_t neblock = bsize / nsplits;
    if (neblock * nsplits != bsize) return kBadHeader;
    int64_t p = start;
    for (size_t s = 0; s < nsplits; ++s) {
      if (len - p < 4) return kTruncated;
      const int64_t cs = int32_t(load32(src + p));
      p += 4;
      if (cs < 0) return kBadHeader;
      if (cs > len - p) return kTruncated;
      uint8_t* out = block + s * neblock;
      if (size_t(cs) == neblock) {
        std::memcpy(out, src + p, neblock);
      } else {
        const int err = decode_stream(codec, src + p, size_t(cs), out, neblock);
        if (err) return err;
      }
      p += cs;
    }
    if (unshuffle)
      byte_shuffle<false>(tmp.data(), dst + j * blocksize, ts, bsize);
    else if (unbitshuffle)
      bit_shuffle<false>(tmp.data(), dst + j * blocksize, ts, bsize);
  }
  } catch (...) {  // memory
    return kResources;
  }
  return kOk;
}

// Encodes src[0, n) as a blosc1 chunk with the LZ4 codec into dst[0, cap);
// cap must be at least n + 16 (a chunk that does not compress is stored
// raw, "memcpyed").  shuffle: 0 none, 1 byte, 2 bit.  blocksize 0 picks
// 256 KiB.  Up to `threads` threads (the caller's among them) encode the
// blocks.  Writes the chunk's length to *out_len.
int wb2_blosc_encode_lz4(const uint8_t* src, int64_t n, int typesize, int shuffle,
                         int64_t blocksize, int threads, uint8_t* dst, int64_t cap,
                         int64_t* out_len) {
  if (n < 0 || n > INT32_MAX - kHeader || cap < n + kHeader || typesize < 1 || shuffle < 0 ||
      shuffle > 2 || blocksize < 0 || threads < 1)
    return kBadArgument;
  const size_t ts = typesize > 255 ? 1 : size_t(typesize);
  uint8_t flags = uint8_t(kLZ4 << 5);
  if (shuffle == 1) flags |= kByteShuffle;
  if (shuffle == 2) flags |= kBitShuffle;
  int64_t bs = blocksize ? blocksize : 256 * 1024;
  if (bs > n) bs = n;
  bs -= bs % int64_t(ts);
  if (bs <= 0) bs = n;
  auto header = [&](uint8_t f, int64_t cbytes) {
    dst[0] = 2;  // blosc format version
    dst[1] = 1;  // LZ4 format version
    dst[2] = f;
    dst[3] = uint8_t(ts);
    store32(dst + 4, uint32_t(n));
    store32(dst + 8, uint32_t(bs));
    store32(dst + 12, uint32_t(cbytes));
  };
  auto memcpyed = [&]() {
    header(flags | kMemcpyed, n + kHeader);
    std::memcpy(dst + kHeader, src, size_t(n));
    *out_len = n + kHeader;
    return kOk;
  };
  const int64_t nblocks = n > 0 ? (n + bs - 1) / bs : 0;
  const int64_t table_end = kHeader + 4 * nblocks;
  if (n < kMinBufferSize || table_end >= n + kHeader) return memcpyed();
  try {
    // each block into its slot of one scratch buffer, then packed into dst
    const size_t slot = size_t(bs) + 4 * ts;
    std::unique_ptr<uint8_t[]> scratch(new uint8_t[size_t(nblocks) * slot]);
    std::vector<size_t> sizes(static_cast<size_t>(nblocks));
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto work = [&]() {
      try {
        std::vector<uint8_t> tmp;
        for (int64_t j; (j = next++) < nblocks;) {
          const bool leftover = j == nblocks - 1 && n % bs != 0;
          sizes[size_t(j)] = encode_block(src + j * bs, size_t(leftover ? n % bs : bs), ts,
                                          shuffle, flags, leftover,
                                          scratch.get() + size_t(j) * slot, &tmp);
        }
      } catch (...) {
        failed = true;
      }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < threads && t < nblocks; ++t) pool.emplace_back(work);
    work();
    for (auto& t : pool) t.join();
    if (failed) return kResources;
    int64_t p = table_end;
    for (const size_t size : sizes) p += int64_t(size);
    if (p >= n + kHeader) return memcpyed();
    p = table_end;
    for (int64_t j = 0; j < nblocks; ++j) {
      store32(dst + kHeader + 4 * j, uint32_t(p));
      std::memcpy(dst + p, scratch.get() + size_t(j) * slot, sizes[size_t(j)]);
      p += int64_t(sizes[size_t(j)]);
    }
    header(flags, p);
    *out_len = p;
    return kOk;
  } catch (...) {  // memory or threads
    return kResources;
  }
}

}  // extern "C"
