// Host codecs of the port's Zarr layer (weatherbench2_torch/xds/io_zarr.py).
//
// Zarr v2 stores written by the JAX package (tensorstore) or by zarr-python
// compress their chunks with blosc1: a 16-byte header, a table of block
// starts, then each block as one stream or as `typesize` streams ("split"),
// compressed by one of five codecs after an optional byte or bit shuffle.
// This file decodes every such chunk, whole or a range of its blocks, and
// encodes blosc-lz4 and blosc-zstd for the writer:
//
//   blosc1 frame   header, bstarts, memcpyed chunks, split blocks, the
//                  leftover last block, byte and bit unshuffle (c-blosc's
//                  rules, held bit for bit to tensorstore by
//                  tests/test_torch_blosc.py); the writer's header as
//                  c-blosc1 writes it (its default blocksize by codec,
//                  clevel and typesize; do-not-split for zstd)
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
//                  not verified; no dictionaries.  An encoder of the same
//                  format: a hash-chain matcher (greedy, lazy, lazy2 by
//                  level; a price-driven optimal parse at clevel 6-9),
//                  Huffman literals, FSE-coded sequences (tests/
//                  test_torch_zstd_writer.py holds its chunks to
//                  tensorstore's: headers equal, bytes within 1.10x at
//                  clevel 1-5 and 1.20x at 6-9)
//
// Plain C++17 with a C ABI, built with the host's C++ compiler and loaded
// with ctypes (xds/_codec.py).  Every entry point returns an error code (0
// on success); every read is bounded by its source's length and every write
// by its destination's, so a truncated, forged or corrupt chunk is an error,
// never garbage.  No state is shared between calls: threads decode and
// encode chunks in parallel.

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
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
  size_t i = 0;
  // four symbols a load while 57 bits lie below the position: a 64-bit
  // window ending at it, read from its top (4 x kHufMaxBits <= 57)
  const uint64_t mask = (uint64_t(1) << h.max_bits) - 1;
  while (b.pos >= 64 && count - i >= 4) {
    const int64_t byte = (b.pos - 57) >> 3;
    uint64_t w;
    std::memcpy(&w, src + byte, 8);
    int avail = int(b.pos - 8 * byte);  // 57..64 valid bits of w
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = uint32_t((w >> (avail - h.max_bits)) & mask);
      dst[i++] = h.symbol[v];
      avail -= h.nbits[v];
    }
    b.pos = 8 * byte + avail;
  }
  for (; i < count; ++i) {
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

// -- zstd encoder (RFC 8878) --------------------------------------------------
//
// One frame a call: single segment, the content size in the header, no
// dictionary, no checksum.  Blocks of at most 128 KiB: all-equal bytes as
// an RLE block, a block that does not shrink raw, the others compressed:
// literals Huffman-coded (1 stream up to 1023 bytes, else 4) or raw or RLE,
// whichever is shortest; sequences from a hash-chain matcher (greedy, lazy
// or lazy2 by level, zstd's gain rules, repeat offsets) coded with the
// predefined, an RLE or a compressed FSE table per symbol type, whichever
// costs fewest bits.  The decoder above reads every frame this writes.

// A forward bitstream, least significant bit first: the decoder reads it
// backward from the end mark that close() appends.
struct BitOut {
  uint8_t* p;
  size_t cap, pos = 0;
  uint64_t acc = 0;
  int n = 0;
  bool full = false;
  BitOut(uint8_t* dst, size_t c) : p(dst), cap(c) {}
  void add(uint64_t v, int nb) {  // nb <= 56
    acc |= (v & ((uint64_t(1) << nb) - 1)) << n;
    n += nb;
    const int bytes = n >> 3;
    if (cap - pos >= 8) {
      std::memcpy(p + pos, &acc, 8);  // little-endian: the low bytes first
    } else if (cap - pos >= size_t(bytes)) {
      for (int i = 0; i < bytes; ++i) p[pos + i] = uint8_t(acc >> (8 * i));
    } else {
      full = true;
      pos = cap;
      acc = 0;
      n = 0;
      return;
    }
    pos += size_t(bytes);
    acc >>= 8 * bytes;
    n &= 7;
  }
  // the end mark, then the partial last byte; 0 when the stream did not fit
  size_t close() {
    add(1, 1);
    for (; n > 0 && !full; n -= 8, acc >>= 8) {
      if (pos >= cap) full = true;
      else p[pos++] = uint8_t(acc);
    }
    return full ? 0 : pos;
  }
};

// FSE encoding table (zstd's FSE_buildCTable): the states of each symbol in
// the order of their positions, and per symbol the transform from a state
// to its bit count and next state.  -1 counts ("less than one") are laid
// out as the decoder's fse_build lays them out.
struct FseCTable {
  int log = 0;
  uint16_t state[512];
  uint32_t delta_nbits[256];
  int32_t delta_state[256];
};

void fse_build_ctable(FseCTable* ct, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log, mask = size - 1;
  int high = size - 1;
  uint8_t spread[512];
  int cumul[257];
  cumul[0] = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      spread[high--] = uint8_t(s);
      cumul[s + 1] = cumul[s] + 1;
    } else {
      cumul[s + 1] = cumul[s] + norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      spread[pos] = uint8_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  int next[256];
  for (int s = 0; s < nsym; ++s) next[s] = cumul[s];
  for (int u = 0; u < size; ++u) ct->state[next[spread[u]]++] = uint16_t(size + u);
  ct->log = log;
  int total = 0;
  for (int s = 0; s < nsym; ++s) {
    const int c = norm[s];
    if (c == 0) {
      ct->delta_nbits[s] = uint32_t(((log + 1) << 16) - size);
      ct->delta_state[s] = 0;
    } else if (c == -1 || c == 1) {
      ct->delta_nbits[s] = uint32_t((log << 16) - size);
      ct->delta_state[s] = total - 1;
      total += 1;
    } else {
      const int max_out = log - highbit(uint32_t(c - 1));
      ct->delta_nbits[s] = uint32_t((max_out << 16) - (c << max_out));
      ct->delta_state[s] = total - c;
      total += c;
    }
  }
}

struct FseCState {
  const FseCTable* t;
  uint32_t value;
  // the state of `symbol` that the decoder reads most bits from next
  // (zstd's FSE_initCState2): a symbol of count < 2^log reads at least one
  void init(int symbol) {
    const uint32_t nb = (t->delta_nbits[symbol] + (1 << 15)) >> 16;
    const uint32_t v = (nb << 16) - t->delta_nbits[symbol];
    value = t->state[int32_t(v >> nb) + t->delta_state[symbol]];
  }
  void encode(BitOut* b, int symbol) {
    const uint32_t nb = (value + t->delta_nbits[symbol]) >> 16;
    b->add(value, int(nb));
    value = t->state[int32_t(value >> nb) + t->delta_state[symbol]];
  }
  void flush(BitOut* b) { b->add(value, t->log); }
};

// zstd's FSE_optimalTableLog: fewer states for few symbols to code.
int fse_table_log(int max_log, size_t total, int max_symbol) {
  const int src_max = highbit(uint32_t(total - 1)) - 2;
  const int min_bits = std::min(highbit(uint32_t(total)) + 1, highbit(uint32_t(max_symbol)) + 2);
  int log = max_log;
  if (src_max < log) log = src_max;
  if (min_bits > log) log = min_bits;
  return std::max(5, std::min(log, max_log));
}

// Counts scaled to sum 2^log, every present symbol at least 1 (no -1
// counts): rounded down, then the missing states given one at a time where
// they save most bits and surplus ones taken where they cost least.
void fse_normalize(const uint32_t* count, int nsym, size_t total, int log, int16_t* norm) {
  const int size = 1 << log;
  int sum = 0;
  for (int s = 0; s < nsym; ++s) {
    norm[s] = count[s] ? int16_t(std::max<uint64_t>(1, uint64_t(count[s]) * size / total)) : 0;
    sum += norm[s];
  }
  while (sum != size) {
    int best = -1;
    double best_v = 0;
    for (int s = 0; s < nsym; ++s) {
      if (!count[s] || (sum > size && norm[s] <= 1)) continue;
      // bits saved by one more state, or lost by one fewer
      const double v = sum < size ? count[s] * std::log2((norm[s] + 1.0) / norm[s])
                                  : -count[s] * std::log2(norm[s] / (norm[s] - 1.0));
      if (best < 0 || v > best_v) {
        best = s;
        best_v = v;
      }
    }
    norm[best] += sum < size ? 1 : -1;
    sum += sum < size ? 1 : -1;
  }
}

// FSE_writeNCount: the table description that fse_read_counts reads;
// returns the bytes written or 0 when they do not fit.
size_t fse_write_counts(const int16_t* norm, int nsym, int log, uint8_t* dst, size_t cap) {
  while (nsym > 0 && norm[nsym - 1] == 0) --nsym;
  std::vector<uint8_t> bits;  // one a bit, then packed
  auto put = [&](uint32_t v, int nb) {
    for (int i = 0; i < nb; ++i) bits.push_back(uint8_t((v >> i) & 1));
  };
  put(uint32_t(log - 5), 4);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  bool previous_zero = false;
  for (int s = 0; s < nsym && remaining > 1;) {
    if (previous_zero) {
      int zeros = 0;
      while (s + zeros < nsym && norm[s + zeros] == 0) ++zeros;
      s += zeros;
      for (; zeros >= 3; zeros -= 3) put(3, 2);
      put(uint32_t(zeros), 2);
    }
    int count = norm[s++];
    const int max = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count += 1;
    if (count >= threshold) count += max;
    put(uint32_t(count), nbits - (count < max ? 1 : 0));
    previous_zero = count == 1;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  const size_t n = (bits.size() + 7) / 8;
  if (n > cap) return 0;
  std::memset(dst, 0, n);
  for (size_t i = 0; i < bits.size(); ++i) dst[i >> 3] |= uint8_t(bits[i] << (i & 7));
  return n;
}

// Bits that `norm` (of table size 2^log) spends on symbols of these counts;
// infinite when a present symbol has no state.
double fse_cost(const uint32_t* count, int nsym, const int16_t* norm, int nnorm, int log) {
  double bits = 0;
  for (int s = 0; s < nsym; ++s) {
    if (!count[s]) continue;
    if (s >= nnorm || norm[s] == 0) return 1e300;
    bits += count[s] * (norm[s] == -1 ? double(log) : log - std::log2(double(norm[s])));
  }
  return bits;
}

// -- Huffman literals --

struct HufCode {
  int max_bits = 0;
  int last = 0;  // the highest symbol present: its weight is implied
  uint16_t code[256];
  uint8_t len[256];  // 0: absent
};

// A Huffman code over `count` (at least two symbols present), complete and
// at most kHufMaxBits long (lengths above it moved up as JPEG's Annex K.3
// does), in the decoder's canonical order.
void huf_build(const uint32_t* count, HufCode* h) {
  int sym[256], n = 0;
  for (int s = 0; s < 256; ++s)
    if (count[s]) sym[n++] = s;
  std::sort(sym, sym + n, [&](int a, int b) {
    return count[a] != count[b] ? count[a] < count[b] : a < b;
  });
  // two queues: the leaves in sorted order, the inner nodes as made
  uint64_t w[512];
  int parent[512];
  for (int i = 0; i < n; ++i) w[i] = count[sym[i]];
  int leaf = 0, inner = n;
  for (int k = n; k < 2 * n - 1; ++k) {
    int pick[2];
    for (int& p : pick) p = (leaf < n && (inner >= k || w[leaf] <= w[inner])) ? leaf++ : inner++;
    w[k] = w[pick[0]] + w[pick[1]];
    parent[pick[0]] = parent[pick[1]] = k;
  }
  int depth[512];
  depth[2 * n - 2] = 0;
  int bl[512] = {0};
  for (int k = 2 * n - 3; k >= 0; --k) depth[k] = depth[parent[k]] + 1;
  int max_len = 0;
  for (int i = 0; i < n; ++i) {
    bl[depth[i]]++;
    max_len = std::max(max_len, depth[i]);
  }
  for (int i = max_len; i > kHufMaxBits; --i) {
    while (bl[i] > 0) {
      int j = i - 2;
      while (bl[j] == 0) --j;
      bl[i] -= 2;
      bl[i - 1] += 1;
      bl[j + 1] += 2;
      bl[j] -= 1;
    }
  }
  // the shortest lengths to the most frequent symbols
  std::memset(h->len, 0, sizeof(h->len));
  int len = 1, i = n - 1;
  h->max_bits = 0;
  for (; i >= 0; --i) {
    while (bl[len] == 0) ++len;
    bl[len]--;
    h->len[sym[i]] = uint8_t(len);
    h->max_bits = len;
  }
  // codes as huf_read lays out its table: weight 1 (the longest) first,
  // symbols in order within a weight
  uint32_t pos = 0;
  for (int l = h->max_bits; l >= 1; --l) {
    for (int s = 0; s < 256; ++s) {
      if (h->len[s] != l) continue;
      h->code[s] = uint16_t(pos >> (h->max_bits - l));
      pos += uint32_t(1) << (h->max_bits - l);
    }
  }
  h->last = 0;
  for (int s = 0; s < 256; ++s)
    if (h->len[s]) h->last = s;
}

// The weights of symbols 0..last-1 compressed with FSE (two interleaved
// states, zstd's FSE_compress_usingCTable); 0 when that does not pay.
size_t huf_fse_weights(const uint8_t* wts, int nw, uint8_t* dst, size_t cap) {
  if (nw < 3) return 0;
  uint32_t count[16] = {0};
  int max_symbol = 0;
  for (int i = 0; i < nw; ++i) {
    count[wts[i]]++;
    max_symbol = std::max(max_symbol, int(wts[i]));
  }
  for (int s = 0; s <= max_symbol; ++s)
    if (count[s] == uint32_t(nw)) return 0;  // one symbol: FSE cannot
  const int log = 6;
  int16_t norm[16];
  fse_normalize(count, max_symbol + 1, size_t(nw), log, norm);
  const size_t hdr = fse_write_counts(norm, max_symbol + 1, log, dst, cap);
  if (hdr == 0) return 0;
  FseCTable ct;
  fse_build_ctable(&ct, norm, max_symbol + 1, log);
  BitOut b(dst + hdr, cap - hdr);
  FseCState s1{&ct, 0}, s2{&ct, 0};
  int i;
  if (nw & 1) {
    s1.init(wts[nw - 1]);
    s2.init(wts[nw - 2]);
    s1.encode(&b, wts[nw - 3]);
    i = nw - 3;
  } else {
    s2.init(wts[nw - 1]);
    s1.init(wts[nw - 2]);
    i = nw - 2;
  }
  while (i > 0) {
    s2.encode(&b, wts[--i]);
    s1.encode(&b, wts[--i]);
  }
  s2.flush(&b);
  s1.flush(&b);
  const size_t body = b.close();
  return body ? hdr + body : 0;
}

// The tree description huf_read reads: FSE-compressed weights or 4-bit
// direct ones, whichever is shorter; 0 when neither can be written.
size_t huf_write_tree(const HufCode& h, uint8_t* dst, size_t cap) {
  uint8_t wts[256];
  const int nw = h.last;
  for (int s = 0; s < nw; ++s) wts[s] = h.len[s] ? uint8_t(h.max_bits + 1 - h.len[s]) : 0;
  uint8_t fse[128];
  const size_t fse_size = huf_fse_weights(wts, nw, fse, 127);
  const size_t direct = nw <= 128 ? 1 + size_t(nw + 1) / 2 : 0;
  if (fse_size && (!direct || fse_size + 1 < direct)) {
    if (fse_size + 1 > cap) return 0;
    dst[0] = uint8_t(fse_size);
    std::memcpy(dst + 1, fse, fse_size);
    return fse_size + 1;
  }
  if (!direct || direct > cap) return 0;
  dst[0] = uint8_t(127 + nw);
  for (int i = 0; i < nw; i += 2)
    dst[1 + i / 2] = uint8_t((wts[i] << 4) | (i + 1 < nw ? wts[i + 1] : 0));
  return direct;
}

// One Huffman stream, its last symbol written first.
size_t huf_write_stream(const uint8_t* src, size_t n, const HufCode& h, uint8_t* dst,
                        size_t cap) {
  BitOut b(dst, cap);
  for (size_t i = n; i-- > 0;) b.add(h.code[src[i]], h.len[src[i]]);
  return b.close();
}

// A raw or RLE literals header of `size`; returns its length.
size_t literals_header(int type, size_t size, uint8_t* dst) {
  if (size < 32) {
    dst[0] = uint8_t(type | (size << 3));
    return 1;
  }
  if (size < 4096) {
    dst[0] = uint8_t(type | (1 << 2) | ((size & 15) << 4));
    dst[1] = uint8_t(size >> 4);
    return 2;
  }
  dst[0] = uint8_t(type | (3 << 2) | ((size & 15) << 4));
  dst[1] = uint8_t(size >> 4);
  dst[2] = uint8_t(size >> 12);
  return 3;
}

// zstd's ZSTD_minGain: a coded form must save this much on `n` raw bytes,
// or the raw form is kept (it decodes as a copy).
inline size_t min_gain(size_t n) { return (n >> 6) + 2; }

// The literals section, the shortest of raw, RLE and Huffman (which must
// save min_gain); 0 when it does not fit in `cap`.
size_t zstd_write_literals(const uint8_t* lit, size_t n, uint8_t* dst, size_t cap) {
  uint8_t hdr[5];
  if (n > 0 && std::all_of(lit, lit + n, [&](uint8_t c) { return c == lit[0]; })) {
    const size_t h = literals_header(1, n, hdr);
    if (h + 1 > cap) return 0;
    std::memcpy(dst, hdr, h);
    dst[h] = lit[0];
    return h + 1;
  }
  const size_t raw = literals_header(0, n, hdr) + n;
  if (n >= 32) {
    uint32_t count[256] = {0};
    for (size_t i = 0; i < n; ++i) count[lit[i]]++;
    HufCode h;
    huf_build(count, &h);
    uint8_t tree[129];
    const size_t tsize = huf_write_tree(h, tree, sizeof(tree));
    uint64_t bits = 0;
    for (int s = 0; s < 256; ++s) bits += uint64_t(count[s]) * h.len[s];
    const bool single = n <= 1023;
    const size_t hsize = single ? 3 : n <= 16383 ? 4 : 5;
    const size_t estimate = hsize + tsize + bits / 8 + (single ? 1 : 10);
    if (tsize && estimate + min_gain(n) < raw && estimate <= cap) {
      const size_t room = std::min(cap, raw) - hsize;
      uint8_t* p = dst + hsize;
      std::memcpy(p, tree, tsize);
      size_t comp = tsize;
      bool ok = true;
      if (single) {
        const size_t s = huf_write_stream(lit, n, h, p + comp, room - comp);
        ok = s != 0;
        comp += s;
      } else {
        const size_t seg = (n + 3) / 4;
        ok = room - comp >= 6;
        uint8_t* jump = p + comp;
        comp += ok ? 6 : 0;
        for (int i = 0; ok && i < 4; ++i) {
          const size_t cnt = i < 3 ? seg : n - 3 * seg;
          const size_t s = huf_write_stream(lit + i * seg, cnt, h, p + comp, room - comp);
          ok = s != 0 && (i == 3 || s <= 0xFFFF);
          if (ok && i < 3) {
            jump[2 * i] = uint8_t(s);
            jump[2 * i + 1] = uint8_t(s >> 8);
          }
          comp += s;
        }
      }
      const size_t limit = hsize == 3 ? 1023 : hsize == 4 ? 16383 : 262143;
      if (ok && comp <= limit && hsize + comp + min_gain(n) < raw) {
        // type 2; size format 0 (one stream), 2 or 3 (four)
        const uint64_t v = uint64_t(2) | (uint64_t(single ? 0 : hsize - 2) << 2) |
                           (uint64_t(n) << 4) |
                           (uint64_t(comp) << (hsize == 3 ? 14 : hsize == 4 ? 18 : 22));
        for (size_t i = 0; i < hsize; ++i) dst[i] = uint8_t(v >> (8 * i));
        return hsize + comp;
      }
    }
  }
  if (raw > cap) return 0;
  const size_t h = literals_header(0, n, dst);
  std::memcpy(dst + h, lit, n);
  return raw;
}

// -- sequences --

struct Sequence {
  uint32_t lit;      // literal length
  uint32_t off_base;  // offset + 3, or a repeat code 1-3
  uint32_t match;    // match length (>= 3)
};

inline int ll_code(uint32_t ll) {
  static const auto table = [] {
    std::array<uint8_t, 64> t{};
    for (uint32_t v = 0, c = 0; v < 64; ++v) {
      while (c + 1 < 36 && kLLBase[c + 1] <= v) ++c;
      t[v] = uint8_t(c);
    }
    return t;
  }();
  return ll < 64 ? table[ll] : highbit(ll) + 19;
}

inline int ml_code(uint32_t ml) {
  static const auto table = [] {
    std::array<uint8_t, 128> t{};
    for (uint32_t v = 0, c = 0; v < 128; ++v) {
      while (c + 1 < 53 && kMLBase[c + 1] - 3 <= v) ++c;
      t[v] = uint8_t(c);
    }
    return t;
  }();
  const uint32_t base = ml - 3;
  return base < 128 ? table[base] : highbit(base) + 36;
}

// The encoding of the repeat offsets, as zstd_block decodes them: the
// cheapest code for `offset` after `lit` literals, and the state after it.
uint32_t off_base_for(uint32_t offset, uint32_t lit, uint32_t* rep) {
  uint32_t code;
  if (lit != 0) {
    code = offset == rep[0] ? 1 : offset == rep[1] ? 2 : offset == rep[2] ? 3 : offset + 3;
  } else {
    code = offset == rep[1] ? 1 : offset == rep[2] ? 2 : (rep[0] > 1 && offset == rep[0] - 1) ? 3
                                                                                             : offset + 3;
  }
  if (code > 3) {
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = offset;
  } else {
    const uint32_t k = code - (lit != 0 ? 1 : 0);
    if (k != 0) {
      if (k != 1) rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    }
  }
  return code;
}

// One symbol type's table: its mode (0 predefined, 1 RLE, 2 compressed)
// and description, chosen by the bits each would spend.
struct SeqTable {
  int mode = 0;
  FseCTable ct;
  uint8_t desc[64];
  size_t desc_size = 0;
};

void choose_table(const uint32_t* count, int max_symbol, size_t nseq, const FseCTable& predef,
                  const int16_t* def_norm, int ndef, int def_log, int max_log, SeqTable* t) {
  int present = 0, last = 0;
  for (int s = 0; s <= max_symbol; ++s)
    if (count[s]) {
      present++;
      last = s;
    }
  if (present == 1) {  // RLE: one byte, no bits
    t->mode = 1;
    t->desc[0] = uint8_t(last);
    t->desc_size = 1;
    t->ct.log = 0;
    return;
  }
  const double predef_bits = fse_cost(count, last + 1, def_norm, ndef, def_log);
  double comp_bits = 1e300;
  int16_t norm[64];
  int log = 0;
  size_t desc = 0;
  if (present > 1) {
    log = fse_table_log(max_log, nseq, last);
    while ((1 << log) < present) ++log;
    fse_normalize(count, last + 1, nseq, log, norm);
    desc = fse_write_counts(norm, last + 1, log, t->desc, sizeof(t->desc));
    if (desc) comp_bits = fse_cost(count, last + 1, norm, last + 1, log) + 8.0 * desc;
  }
  if (predef_bits <= comp_bits) {
    t->mode = 0;
    t->desc_size = 0;
    t->ct = predef;
  } else {
    t->mode = 2;
    t->desc_size = desc;
    fse_build_ctable(&t->ct, norm, last + 1, log);
  }
}

// The sequences section; 0 when it does not fit in `cap`.
size_t zstd_write_sequences(const Sequence* seqs, size_t nseq, uint8_t* dst, size_t cap,
                            std::vector<uint8_t>* codes) {
  static const auto predef = [] {
    std::array<FseCTable, 3> t;
    fse_build_ctable(&t[0], kLLDefault, 36, 6);
    fse_build_ctable(&t[1], kOFDefault, 29, 5);
    fse_build_ctable(&t[2], kMLDefault, 53, 6);
    return t;
  }();
  if (cap < 4) return 0;
  size_t op;
  if (nseq < 128) {
    dst[0] = uint8_t(nseq);
    op = 1;
  } else if (nseq < 0x7F00) {
    dst[0] = uint8_t((nseq >> 8) + 0x80);
    dst[1] = uint8_t(nseq);
    op = 2;
  } else {
    dst[0] = 0xFF;
    dst[1] = uint8_t(nseq - 0x7F00);
    dst[2] = uint8_t((nseq - 0x7F00) >> 8);
    op = 3;
  }
  if (nseq == 0) return op;
  codes->resize(3 * nseq);
  uint8_t* llc = codes->data();
  uint8_t* ofc = llc + nseq;
  uint8_t* mlc = ofc + nseq;
  uint32_t cll[36] = {0}, cof[32] = {0}, cml[53] = {0};
  for (size_t i = 0; i < nseq; ++i) {
    llc[i] = uint8_t(ll_code(seqs[i].lit));
    ofc[i] = uint8_t(highbit(seqs[i].off_base));
    mlc[i] = uint8_t(ml_code(seqs[i].match));
    cll[llc[i]]++;
    cof[ofc[i]]++;
    cml[mlc[i]]++;
  }
  std::unique_ptr<SeqTable[]> t(new SeqTable[3]);
  choose_table(cll, 35, nseq, predef[0], kLLDefault, 36, 6, 9, &t[0]);
  choose_table(cof, 31, nseq, predef[1], kOFDefault, 29, 5, 8, &t[1]);
  choose_table(cml, 52, nseq, predef[2], kMLDefault, 53, 6, 9, &t[2]);
  if (cap - op < 1 + t[0].desc_size + t[1].desc_size + t[2].desc_size) return 0;
  dst[op++] = uint8_t((t[0].mode << 6) | (t[1].mode << 4) | (t[2].mode << 2));
  for (int k = 0; k < 3; ++k) {
    std::memcpy(dst + op, t[k].desc, t[k].desc_size);
    op += t[k].desc_size;
  }
  // sequences last to first, so that the decoder reads them first to last
  BitOut b(dst + op, cap - op);
  FseCState ll{&t[0].ct, 0}, of{&t[1].ct, 0}, ml{&t[2].ct, 0};
  const bool rle[3] = {t[0].mode == 1, t[1].mode == 1, t[2].mode == 1};
  auto extras = [&](size_t i) {
    b.add(seqs[i].lit - kLLBase[llc[i]], kLLBits[llc[i]]);
    b.add(seqs[i].match - kMLBase[mlc[i]], kMLBits[mlc[i]]);
    b.add(seqs[i].off_base - (uint32_t(1) << ofc[i]), ofc[i]);
  };
  size_t i = nseq - 1;
  if (!rle[2]) ml.init(mlc[i]);
  if (!rle[1]) of.init(ofc[i]);
  if (!rle[0]) ll.init(llc[i]);
  extras(i);
  while (i-- > 0) {
    if (!rle[1]) of.encode(&b, ofc[i]);
    if (!rle[2]) ml.encode(&b, mlc[i]);
    if (!rle[0]) ll.encode(&b, llc[i]);
    extras(i);
  }
  if (!rle[2]) ml.flush(&b);
  if (!rle[1]) of.flush(&b);
  if (!rle[0]) ll.flush(&b);
  const size_t body = b.close();
  return body ? op + body : 0;
}

// -- the matcher --

struct MatchLevel {
  int depth;       // chain candidates tried a position
  int lazy;        // 0 greedy, 1 lazy, 2 lazy2
  int hash_log;    // at most; fewer for short inputs
  int sufficient;  // > 0: the optimal parser, a match this long taken as is
};

// blosc clevel 1-9 (zstd levels 1, 3, 5, ... 15, 22 in c-blosc): the search
// grows with the level
// (zstd's btopt, btultra, btultra2 at c-blosc's clevels 6-9 on small inputs)
constexpr MatchLevel kMatchLevels[10] = {
    {1, 0, 12, 0},   {4, 0, 14, 0},   {6, 0, 15, 0},    {8, 1, 16, 0},   {16, 1, 16, 0},
    {24, 2, 17, 0},  {16, 2, 17, 32}, {24, 2, 17, 64}, {48, 2, 17, 128}, {128, 2, 17, 256}};

inline size_t match_length(const uint8_t* a, const uint8_t* b, const uint8_t* a_end) {
  const uint8_t* start = a;
  while (a_end - a >= 8) {
    uint64_t x, y;
    std::memcpy(&x, a, 8);
    std::memcpy(&y, b, 8);
    if (x != y) return size_t(a - start) + (__builtin_ctzll(x ^ y) >> 3);
    a += 8;
    b += 8;
  }
  while (a < a_end && *a == *b) {
    ++a;
    ++b;
  }
  return size_t(a - start);
}

struct OptNode {  // the cheapest parse found of the bytes before a position
  float price;      // in bits, the pending literals' length code not in it
  uint32_t lit;     // literals since the last match
  uint32_t offset;  // of the match that ends here; 0: reached by a literal
  uint32_t len;
  uint32_t rep[3];  // the repeat offsets after it
};

struct ZstdScratch {
  std::vector<int32_t> head, chain;
  std::vector<Sequence> seqs;
  std::vector<uint8_t> literals, codes, block;
  std::vector<OptNode> opt;
  std::vector<std::pair<uint32_t, uint32_t>> cands;
};

struct Matcher {
  const uint8_t* src;
  size_t n;
  MatchLevel lv;
  int hash_log;
  int32_t* head;
  int32_t* chain;
  size_t next = 0;  // positions below are in the chains
  std::vector<std::pair<uint32_t, uint32_t>> found;  // find's scratch

  uint32_t hash(size_t p) const {
    uint32_t v;
    std::memcpy(&v, src + p, 4);
    return (v * 2654435761u) >> (32 - hash_log);
  }
  void insert_until(size_t p) {
    const size_t end = std::min(p, n - 3);
    for (; next < end; ++next) {
      const uint32_t h = hash(next);
      chain[next] = head[h];
      head[h] = int32_t(next);
    }
  }
  // the chains as they were before position p was inserted
  void rewind(size_t p) {
    for (; next > p; --next) head[hash(next - 1)] = chain[next - 1];
  }
  // every match at ip longer than `best` (ending by `limit`), in the order
  // found: each longer than the one before
  void find_all(size_t ip, size_t limit, size_t best,
                std::vector<std::pair<uint32_t, uint32_t>>* out) {
    insert_until(ip);
    const uint8_t* end = src + limit;
    int32_t cand = head[hash(ip)];
    for (int tries = lv.depth; cand >= 0 && tries > 0; --tries, cand = chain[cand]) {
      const size_t c = size_t(cand);
      if (src[c + best] != src[ip + best]) continue;  // ip + best < limit
      const size_t len = match_length(src + ip, src + c, end);
      if (len > best) {
        best = len;
        out->push_back({uint32_t(len), uint32_t(ip - c)});
        if (ip + len == limit) break;
      }
    }
  }
  // the longest match of at least 4 bytes at ip ending by `limit` (0 when
  // none), its offset in *off
  size_t find(size_t ip, size_t limit, uint32_t* off) {
    found.clear();
    find_all(ip, limit, 3, &found);
    if (found.empty()) return 0;
    *off = found.back().second;
    return found.back().first;
  }
  size_t rep_length(size_t ip, uint32_t offset, size_t limit) const {
    if (offset == 0 || offset > ip) return 0;
    uint32_t a, b;
    std::memcpy(&a, src + ip, 4);
    std::memcpy(&b, src + ip - offset, 4);
    return a == b ? match_length(src + ip, src + ip - offset, src + limit) : 0;
  }
};

// The sequences of the block src[start, end): zstd's lazy matcher (gain =
// 4 bits a matched byte against the offset's bits; a repeat offset checked
// first); the literals in s->literals.  `rep` is the encoder's copy of the
// decoder's repeat offsets.
void find_sequences(Matcher* m, size_t start, size_t end, uint32_t* rep, ZstdScratch* s) {
  s->seqs.clear();
  s->literals.clear();
  const uint8_t* src = m->src;
  size_t ip = start, anchor = start;
  const size_t ilimit = end - start >= 8 ? end - 8 : start;
  auto store = [&](size_t at, uint32_t offset, size_t len) {
    const uint32_t lit = uint32_t(at - anchor);
    s->literals.insert(s->literals.end(), src + anchor, src + at);
    s->seqs.push_back({lit, off_base_for(offset, lit, rep), uint32_t(len)});
    anchor = at + len;
  };
  auto code_of = [&](uint32_t offset) -> uint32_t {  // the code's cost proxy
    return offset == rep[0] ? 1 : offset + 3;
  };
  while (ip < ilimit) {
    size_t len = 0, at = ip;
    uint32_t offset = 0;
    // a repeat of the last offset one byte on (literals before it)
    const size_t rl = m->rep_length(ip + 1, rep[0], end);
    if (rl >= 4) {
      len = rl;
      at = ip + 1;
      offset = rep[0];
    }
    if (!(len && m->lv.lazy == 0)) {
      uint32_t off;
      const size_t fl = m->find(ip, end, &off);
      if (fl > len) {
        len = fl;
        at = ip;
        offset = off;
      }
    }
    if (len == 0) {
      ip += 1 + ((ip - anchor) >> 8);
      continue;
    }
    if (m->lv.lazy > 0) {
      for (int d = 1; ip < ilimit;) {
        ++ip;
        const int bonus = d == 1 ? 0 : 3;
        const size_t r = m->rep_length(ip, rep[0], end);
        if (r >= 4 && int(r * 3) > int(len * 3) - highbit(code_of(offset)) + 1 + bonus) {
          len = r;
          at = ip;
          offset = rep[0];
        }
        uint32_t off;
        const size_t fl = m->find(ip, end, &off);
        if (fl && int(fl * 4) - highbit(code_of(off)) >
                           int(len * 4) - highbit(code_of(offset)) + 4 + bonus) {
          len = fl;
          at = ip;
          offset = off;
          d = 1;
          continue;
        }
        if (d < m->lv.lazy) {
          ++d;
          continue;
        }
        break;
      }
    }
    // extend backwards over equal bytes
    while (at > anchor && at > offset && src[at - 1] == src[at - 1 - offset]) {
      --at;
      ++len;
    }
    store(at, offset, len);
    ip = anchor;
    // the second repeat offset right after a match (no literals)
    while (ip < ilimit) {
      const size_t r = m->rep_length(ip, rep[1], end);
      if (r < 4) break;
      store(ip, rep[1], r);
      ip = anchor;
    }
  }
  s->literals.insert(s->literals.end(), src + anchor, src + end);
}

// Bits a symbol costs, estimated from a parse's counts (one added to each):
// the optimal parser's prices.
struct Prices {
  float lit[256], ll[36], ml[53], of[32];
  explicit Prices(const ZstdScratch& s) {
    uint32_t cl[256] = {0}, cll[36] = {0}, cml[53] = {0}, cof[32] = {0};
    for (const uint8_t b : s.literals) cl[b]++;
    for (const Sequence& q : s.seqs) {
      cll[ll_code(q.lit)]++;
      cml[ml_code(q.match)]++;
      cof[highbit(q.off_base)]++;
    }
    auto fill = [](const uint32_t* count, int n, float* out) {
      double total = n;
      for (int i = 0; i < n; ++i) total += count[i];
      for (int i = 0; i < n; ++i) out[i] = float(std::log2(total / (count[i] + 1.0)));
    };
    fill(cl, 256, lit);
    fill(cll, 36, ll);
    fill(cml, 53, ml);
    fill(cof, 32, of);
  }
  float lit_length(uint32_t n) const {  // n up to a whole block: code 36
    const int c = std::min(ll_code(n), 35);
    return ll[c] + kLLBits[c];
  }
  float match(uint32_t off_base, uint32_t len) const {
    const int oc = highbit(off_base), mc = ml_code(len);
    return of[oc] + float(oc) + ml[mc] + kMLBits[mc];
  }
};

// The sequences of src[start, end) by price (zstd's btopt): each position
// reached at least cost by a literal or by a match of any length up to
// each candidate's (the repeat offsets of the path first, then the hash
// chain's), a match of `sufficient` bytes taken as is; then the cheapest
// path back from the end.
void optimal_sequences(Matcher* m, size_t start, size_t end, uint32_t* rep, const Prices& pr,
                       ZstdScratch* s) {
  const size_t n = end - start;
  const uint8_t* src = m->src;
  s->opt.resize(n + 1);
  OptNode* opt = s->opt.data();
  for (size_t k = 1; k <= n; ++k) opt[k].price = 1e30f;
  opt[0] = {0, 0, 0, 0, {rep[0], rep[1], rep[2]}};
  const size_t ilimit = n >= 8 ? n - 8 : 0;
  const uint32_t min_len = 3;
  for (size_t k = 0; k < n;) {
    const OptNode at = opt[k];
    const float lp = at.price + pr.lit[src[start + k]] + pr.lit_length(at.lit + 1) -
                     pr.lit_length(at.lit);
    if (lp < opt[k + 1].price) opt[k + 1] = {lp, at.lit + 1, 0, 0, {at.rep[0], at.rep[1], at.rep[2]}};
    if (k >= ilimit) {
      ++k;
      continue;
    }
    const size_t ip = start + k;
    s->cands.clear();
    size_t best = min_len - 1;
    const uint32_t reps[3] = {at.lit ? at.rep[0] : at.rep[1], at.lit ? at.rep[1] : at.rep[2],
                              at.lit ? at.rep[2] : at.rep[0] - 1};
    for (const uint32_t r : reps) {
      if (r == 0 || r > ip) continue;
      const size_t len = match_length(src + ip, src + ip - r, src + end);
      if (len > best) {
        best = len;
        s->cands.push_back({uint32_t(len), r});
      }
    }
    m->find_all(ip, end, best, &s->cands);
    if (s->cands.empty()) {
      ++k;
      continue;
    }
    const float base = at.price + pr.lit_length(at.lit);
    auto reach = [&](uint32_t len, uint32_t offset, float price) {
      OptNode& to = opt[k + len];
      to = {price, 0, offset, len, {at.rep[0], at.rep[1], at.rep[2]}};
      off_base_for(offset, at.lit, to.rep);
    };
    const auto longest = s->cands.back();
    if (longest.first >= uint32_t(m->lv.sufficient)) {
      uint32_t r[3] = {at.rep[0], at.rep[1], at.rep[2]};
      reach(longest.first, longest.second,
            base + pr.match(off_base_for(longest.second, at.lit, r), longest.first));
      k += longest.first;
      continue;
    }
    uint32_t prev = min_len - 1;
    for (const auto& c : s->cands) {
      uint32_t r[3] = {at.rep[0], at.rep[1], at.rep[2]};
      const uint32_t code = off_base_for(c.second, at.lit, r);
      for (uint32_t len = prev + 1; len <= c.first; ++len) {
        const float p = base + pr.match(code, len);
        if (p < opt[k + len].price) reach(len, c.second, p);
      }
      prev = c.first;
    }
    ++k;
  }
  // the path back from the end, then its sequences in order
  size_t count = 0;
  for (size_t k = n; k > 0; k -= opt[k].len ? opt[k].len : 1) count += opt[k].len ? 1 : 0;
  s->seqs.resize(count);
  for (size_t k = n, i = count; k > 0; k -= opt[k].len ? opt[k].len : 1)
    if (opt[k].len) s->seqs[--i] = {uint32_t(k - opt[k].len), opt[k].offset, opt[k].len};
  s->literals.clear();
  size_t anchor = 0;
  for (Sequence& q : s->seqs) {  // {start, offset, length} into {lit, code, length}
    const uint32_t lit = uint32_t(q.lit - anchor);
    s->literals.insert(s->literals.end(), src + start + anchor, src + start + q.lit);
    anchor = q.lit + q.match;
    q = {lit, off_base_for(q.off_base, lit, rep), q.match};
  }
  s->literals.insert(s->literals.end(), src + start + anchor, src + end);
}

// The literals and sequences sections of one block into dst[0, cap); 0
// when they do not fit.
size_t write_block_body(ZstdScratch* s, uint8_t* dst, size_t cap) {
  const size_t lsize = zstd_write_literals(s->literals.data(), s->literals.size(), dst, cap);
  if (!lsize) return 0;
  const size_t ssize =
      zstd_write_sequences(s->seqs.data(), s->seqs.size(), dst + lsize, cap - lsize, &s->codes);
  return ssize ? lsize + ssize : 0;
}

// One zstd frame of src[0, n) into dst[0, cap) at blosc clevel 1-9; the
// frame's size, or 0 when it does not fit.
size_t zstd_encode(const uint8_t* src, size_t n, int clevel, uint8_t* dst, size_t cap,
                   ZstdScratch* s) {
  if (cap < 18 || n > UINT32_MAX) return 0;
  size_t op = 0;
  store32(dst, 0xFD2FB528u);
  const int fcs_flag = n < 256 ? 0 : n < 65536 + 256 ? 1 : 2;
  dst[4] = uint8_t((fcs_flag << 6) | 0x20);  // single segment
  op = 5;
  if (fcs_flag == 0) {
    dst[op++] = uint8_t(n);
  } else if (fcs_flag == 1) {
    dst[op++] = uint8_t(n - 256);
    dst[op++] = uint8_t((n - 256) >> 8);
  } else {
    store32(dst + op, uint32_t(n));
    op += 4;
  }
  if (n == 0) {  // one empty raw block
    dst[op++] = 1;
    dst[op++] = 0;
    dst[op++] = 0;
    return op;
  }
  Matcher m{src, n, kMatchLevels[std::max(1, std::min(clevel, 9))], 0, nullptr, nullptr, 0, {}};
  m.hash_log = std::max(10, std::min(m.lv.hash_log, highbit(uint32_t(n)) + 1));
  if (n >= 8) {
    s->head.assign(size_t(1) << m.hash_log, -1);
    s->chain.resize(n);
    m.head = s->head.data();
    m.chain = s->chain.data();
  }
  uint32_t rep[3] = {1, 4, 8};
  for (size_t start = 0; start < n;) {
    const size_t end = std::min(n, start + kZstdBlockMax);
    const size_t size = end - start;
    const uint32_t last = end == n ? 1 : 0;
    if (cap - op < 4) return 0;
    uint8_t* bh = dst + op;
    op += 3;
    const uint8_t* b = src + start;
    if (std::all_of(b, b + size, [&](uint8_t c) { return c == b[0]; })) {
      dst[op++] = b[0];
      const uint32_t h = last | (1u << 1) | uint32_t(size << 3);
      bh[0] = uint8_t(h);
      bh[1] = uint8_t(h >> 8);
      bh[2] = uint8_t(h >> 16);
      start = end;
      continue;
    }
    size_t csize = 0;
    if (size >= 8) {
      const uint32_t saved[3] = {rep[0], rep[1], rep[2]};
      find_sequences(&m, start, end, rep, s);
      // a compressed block only when it saves min_gain on the raw one
      const size_t room = std::min(cap - op, size - min_gain(size));
      csize = write_block_body(s, dst + op, room);
      if (m.lv.sufficient > 0) {
        // the optimal parse, priced by the lazy one's counts; the shorter
        // block is kept
        const Prices prices(*s);
        uint32_t opt_rep[3] = {saved[0], saved[1], saved[2]};
        m.rewind(start);
        optimal_sequences(&m, start, end, opt_rep, prices, s);
        s->block.resize(room);
        const size_t osize = write_block_body(s, s->block.data(), csize ? csize - 1 : room);
        if (osize) {
          std::memcpy(dst + op, s->block.data(), osize);
          std::memcpy(rep, opt_rep, sizeof(rep));
          csize = osize;
        }
      }
      if (!csize) std::memcpy(rep, saved, sizeof(rep));  // the decoder never sees them
    }
    uint32_t h;
    if (csize) {
      h = last | (2u << 1) | uint32_t(csize << 3);
      op += csize;
    } else {
      if (cap - op < size) return 0;
      std::memcpy(dst + op, b, size);
      op += size;
      h = last | uint32_t(size << 3);
    }
    bh[0] = uint8_t(h);
    bh[1] = uint8_t(h >> 8);
    bh[2] = uint8_t(h >> 16);
    start = end;
  }
  return op;
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
// past the last whole element stay where they are.  In two passes through
// `tmp` (the block's size): a byte shuffle, then eight elements' bytes of a
// byte plane at a time through one 8x8 bit transpose, read or written as
// one word on the plane's side.
template <bool kForward>
void bit_shuffle(const uint8_t* src, uint8_t* dst, size_t ts, size_t size,
                 std::vector<uint8_t>* tmp) {
  const size_t n = size / ts;
  if (n % 8 != 0) {
    std::memcpy(dst, src, size);
    return;
  }
  const size_t row = n / 8;
  tmp->resize(size);
  uint8_t* planes = tmp->data();  // byte j of element i at j * n + i
  if (kForward) byte_shuffle<true>(src, planes, ts, size);
  for (size_t j = 0; j < ts; ++j) {
    uint8_t* plane = planes + j * n;
    const uint8_t* rows_in = src + 8 * j * row;
    uint8_t* rows_out = dst + 8 * j * row;
    for (size_t b = 0; b < row; ++b) {
      uint64_t x = 0;
      if (kForward) {
        std::memcpy(&x, plane + 8 * b, 8);
      } else {
        for (size_t k = 0; k < 8; ++k) x |= uint64_t(rows_in[k * row + b]) << (8 * k);
      }
      x = transpose8x8(x);
      if (kForward) {
        for (size_t k = 0; k < 8; ++k) rows_out[k * row + b] = uint8_t(x >> (8 * k));
      } else {
        std::memcpy(plane + 8 * b, &x, 8);
      }
    }
  }
  if (!kForward) byte_shuffle<false>(planes, dst, ts, size);
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

// The writer's codecs: blosc's codec number, its clevel (1-9) and the
// stream's bytes; each returns the compressed size, or 0 when that would
// not be below `cap` + 1.
struct EncodeScratch {
  std::vector<uint8_t> shuffled, planes;
  ZstdScratch zstd;
};

size_t encode_stream(int codec, int clevel, const uint8_t* src, size_t n, uint8_t* dst,
                     size_t cap, EncodeScratch* s) {
  if (codec == kZstd) return zstd_encode(src, n, clevel, dst, cap, &s->zstd);
  return lz4_encode(src, n, dst, cap);
}

// One block of the writer into out[0, bsize + 4 * typesize): shuffled, then
// each of its streams after its int32 size, compressed when that makes it
// shorter and raw otherwise.  Returns the bytes written.
size_t encode_block(const uint8_t* src, size_t bsize, size_t ts, int shuffle, uint8_t flags,
                    bool leftover, int codec, int clevel, uint8_t* out, EncodeScratch* tmp) {
  const uint8_t* block = src;
  if (shuffle == 1 && ts > 1) {
    tmp->shuffled.resize(bsize);
    byte_shuffle<true>(src, tmp->shuffled.data(), ts, bsize);
    block = tmp->shuffled.data();
  } else if (shuffle == 2 && bsize >= ts) {
    tmp->shuffled.resize(bsize);
    bit_shuffle<true>(src, tmp->shuffled.data(), ts, bsize, &tmp->planes);
    block = tmp->shuffled.data();
  }
  const size_t nsplits = splits(flags, ts, bsize, leftover) ? ts : 1;
  const size_t neblock = bsize / nsplits;
  size_t p = 0;
  for (size_t s = 0; s < nsplits; ++s) {
    // a stream of exactly its raw size reads as raw: compressed only when
    // shorter
    size_t cs = neblock > 1 ? encode_stream(codec, clevel, block + s * neblock, neblock,
                                            out + p + 4, neblock - 1, tmp)
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

// The fields of a blosc1 header that the decoders need.
struct BloscHeader {
  uint8_t flags;
  size_t ts;
  int64_t nbytes, blocksize, nblocks, table_end;
  int codec;
};

// Checks the header and the block table's extent of src[0, len), which must
// decode to dst_len bytes.
int read_header(const uint8_t* src, int64_t len, int64_t dst_len, BloscHeader* h) {
  if (len < 0 || dst_len < 0) return kBadArgument;
  if (len < kHeader) return kTruncated;
  const uint8_t version = src[0];
  h->flags = src[2];
  h->ts = src[3];
  h->nbytes = int32_t(load32(src + 4));
  h->blocksize = int32_t(load32(src + 8));
  const int64_t cbytes = int32_t(load32(src + 12));
  if (version == 0 || version > 2) return kBadVersion;
  if (h->nbytes < 0 || cbytes < kHeader) return kBadHeader;
  if (cbytes > len) return kTruncated;
  if (cbytes < len) return kBadHeader;
  if (h->nbytes != dst_len) return kSizeMismatch;
  h->codec = h->flags >> 5;
  h->nblocks = h->table_end = 0;
  if (h->flags & kMemcpyed) {
    if (cbytes - kHeader < h->nbytes) return kTruncated;
    if (cbytes - kHeader > h->nbytes) return kBadHeader;
    return kOk;
  }
  if (h->nbytes == 0) return kOk;
  if (h->ts == 0 || h->blocksize <= 0) return kBadHeader;
  if (h->codec > kZstd) return kUnknownCodec;
  h->nblocks = (h->nbytes + h->blocksize - 1) / h->blocksize;
  h->table_end = kHeader + 4 * h->nblocks;
  if (h->table_end > len) return kTruncated;
  return kOk;
}

// Block j of a checked chunk into out[0, the block's size); tmp[0, 2) are
// the caller's scratch.
int decode_block(const uint8_t* src, int64_t len, const BloscHeader& h, int64_t j, uint8_t* out,
                 std::vector<uint8_t>* tmp) {
  const bool leftover = j == h.nblocks - 1 && h.nbytes % h.blocksize != 0;
  const size_t bsize = size_t(leftover ? h.nbytes % h.blocksize : h.blocksize);
  const bool unshuffle = (h.flags & kByteShuffle) && h.ts > 1;
  const bool unbitshuffle = !unshuffle && (h.flags & kBitShuffle) && bsize >= h.ts;
  uint8_t* block = out;
  if (unshuffle || unbitshuffle) {
    tmp->resize(bsize);
    block = tmp->data();
  }
  const int64_t start = int32_t(load32(src + kHeader + 4 * j));
  if (start < h.table_end || start > len) return kBadHeader;
  const size_t nsplits = splits(h.flags, h.ts, bsize, leftover) ? h.ts : 1;
  const size_t neblock = bsize / nsplits;
  if (neblock * nsplits != bsize) return kBadHeader;
  int64_t p = start;
  for (size_t s = 0; s < nsplits; ++s) {
    if (len - p < 4) return kTruncated;
    const int64_t cs = int32_t(load32(src + p));
    p += 4;
    if (cs < 0) return kBadHeader;
    if (cs > len - p) return kTruncated;
    uint8_t* stream = block + s * neblock;
    if (size_t(cs) == neblock) {
      std::memcpy(stream, src + p, neblock);
    } else {
      const int err = decode_stream(h.codec, src + p, size_t(cs), stream, neblock);
      if (err) return err;
    }
    p += cs;
  }
  if (unshuffle)
    byte_shuffle<false>(tmp->data(), out, h.ts, bsize);
  else if (unbitshuffle)
    bit_shuffle<false>(tmp->data(), out, h.ts, bsize, tmp + 1);
  return kOk;
}

// c-blosc1's compute_blocksize and split rule (blosc.c), held to
// tensorstore's chunks by tests/test_torch_zstd_writer.py: the default
// blocksize grows with the clevel, twice over for the codecs meant for
// large blocks (zlib, zstd), and the splitting codecs (BloscLZ, LZ4,
// Snappy) take `typesize` times that, within 64 KiB to 1 MiB.
constexpr int64_t kL1 = 32 * 1024;
constexpr int64_t kMaxBlocksize = (INT32_MAX - 255 * 4) / 3;  // BLOSC_MAX_BLOCKSIZE

int64_t blosc_blocksize(int codec, int clevel, int64_t ts, int64_t nbytes, int64_t forced,
                        bool* split) {
  const bool hcr = codec == kZlib || codec == kZstd;
  *split = false;
  if (nbytes < ts) return 1;
  int64_t bs = nbytes;
  if (forced) {
    bs = std::max(kMinBufferSize, std::min(forced, kMaxBlocksize));
  } else if (nbytes >= kL1) {
    bs = hcr ? 2 * kL1 : kL1;
    static constexpr int kScale[10] = {-4, -2, 1, 2, 4, 4, 8, 8, 8, 8};  // -k: divide by k
    bs = kScale[clevel] < 0 ? bs / -kScale[clevel] : bs * kScale[clevel];
    if (clevel == 9 && hcr) bs *= 2;
  }
  *split = codec <= kSnappy && ts <= kMaxSplits && bs / ts >= kMinBufferSize;
  if (clevel > 0 && *split) {
    bs = std::min<int64_t>(bs, 1 << 18) * ts;
    bs = std::max<int64_t>(bs, 1 << 16);
    bs = std::min<int64_t>(bs, 1 << 20);
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > ts) bs -= bs % ts;
  return bs;
}

}  // namespace

extern "C" {

const char* wb2_codec_error_string(int err) {
  return err >= 0 && err < kNumErrors ? kErrorStrings[err] : "unknown error";
}

// Decodes the blosc1 chunk src[0, len) into dst[0, dst_len); the chunk must
// decode to exactly dst_len bytes.
int wb2_blosc_decode(const uint8_t* src, int64_t len, uint8_t* dst, int64_t dst_len) {
  BloscHeader h;
  int err = read_header(src, len, dst_len, &h);
  if (err) return err;
  if (h.flags & kMemcpyed) {
    std::memcpy(dst, src + kHeader, size_t(h.nbytes));
    return kOk;
  }
  try {
    std::vector<uint8_t> tmp[2];
    for (int64_t j = 0; j < h.nblocks && !err; ++j)
      err = decode_block(src, len, h, j, dst + j * h.blocksize, tmp);
  } catch (...) {  // memory
    return kResources;
  }
  return err;
}

// Decodes blocks first..last of the blosc1 chunk src[0, len) into dst[0,
// dst_len): block j at (j - first) * blocksize, dst_len the bytes of those
// blocks (the last block of the chunk may be short).  The rules are
// wb2_blosc_decode's; a memcpyed chunk gives the same bytes of its copy.
int wb2_blosc_decode_blocks(const uint8_t* src, int64_t len, uint8_t* dst, int64_t dst_len,
                            int64_t first, int64_t last) {
  if (len < kHeader) return len < 0 ? kBadArgument : kTruncated;
  BloscHeader h;
  int err = read_header(src, len, int32_t(load32(src + 4)), &h);
  if (err) return err;
  const int64_t bs = int32_t(load32(src + 8));
  const int64_t nblocks = bs > 0 ? (h.nbytes + bs - 1) / bs : 0;
  if (first < 0 || last < first || last >= nblocks ||
      std::min(h.nbytes, (last + 1) * bs) - first * bs != dst_len)
    return kBadArgument;
  if (h.flags & kMemcpyed) {
    std::memcpy(dst, src + kHeader + first * bs, size_t(dst_len));
    return kOk;
  }
  try {
    std::vector<uint8_t> tmp[2];
    for (int64_t j = first; j <= last && !err; ++j)
      err = decode_block(src, len, h, j, dst + (j - first) * bs, tmp);
  } catch (...) {  // memory
    return kResources;
  }
  return err;
}

// Encodes src[0, n) as a blosc1 chunk with `codec` (LZ4 or zstd) at
// `clevel` (0: stored, "memcpyed"; LZ4 has one level) into dst[0, cap); cap
// must be at least n + 16 (a chunk that does not compress is stored raw).
// shuffle: 0 none, 1 byte, 2 bit.  blocksize 0 takes c-blosc's default for
// the codec, clevel and typesize (blosc_blocksize), as c-blosc's header
// does; the do-not-split flag follows c-blosc too.  Up to `threads` threads
// (the caller's among them) encode the blocks.  Writes the chunk's length
// to *out_len.
int wb2_blosc_encode(int codec, int clevel, int typesize, int shuffle, int64_t blocksize,
                     int threads, const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                     int64_t* out_len) {
  if (n < 0 || n > INT32_MAX - kHeader || cap < n + kHeader || typesize < 1 || shuffle < 0 ||
      shuffle > 2 || blocksize < 0 || threads < 1 || clevel < 0 || clevel > 9 ||
      (codec != kLZ4 && codec != kZstd))
    return kBadArgument;
  const size_t ts = typesize > 255 ? 1 : size_t(typesize);
  bool split;
  const int64_t bs = blosc_blocksize(codec, clevel, int64_t(ts), n, blocksize, &split);
  uint8_t flags = uint8_t(codec << 5);
  if (shuffle == 1) flags |= kByteShuffle;
  if (shuffle == 2) flags |= kBitShuffle;
  if (!split) flags |= kDontSplit;
  auto header = [&](uint8_t f, int64_t cbytes) {
    dst[0] = 2;  // blosc format version
    dst[1] = 1;  // the codec's format version (LZ4 and zstd: 1)
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
  if (clevel == 0 || n < kMinBufferSize || table_end >= n + kHeader) return memcpyed();
  try {
    // each block into its slot of one scratch buffer, then packed into dst
    const size_t slot = size_t(bs) + 4 * ts;
    std::unique_ptr<uint8_t[]> scratch(new uint8_t[size_t(nblocks) * slot]);
    std::vector<size_t> sizes(static_cast<size_t>(nblocks));
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto work = [&]() {
      try {
        EncodeScratch tmp;
        for (int64_t j; (j = next++) < nblocks;) {
          const bool leftover = j == nblocks - 1 && n % bs != 0;
          sizes[size_t(j)] = encode_block(src + j * bs, size_t(leftover ? n % bs : bs), ts,
                                          shuffle, flags, leftover, codec, clevel,
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
