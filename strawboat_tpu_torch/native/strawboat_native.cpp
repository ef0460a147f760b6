// Native host runtime of the torch port: the byte-sequential work of the
// writer and the scan planner that numpy does not vectorize.
//
// Cut from strawboat_tpu/native/strawboat_native.cpp, keeping what the port
// calls: batched page decompression and compression (LZ4 block / Zstd at
// level 0 / Snappy) over a std::thread pool, the bit-packed block-header
// walk, the BitPacker4x page encoder and decoder, the fused DICT-column
// decode of the host read, the first-occurrence factorize, the one-pass
// integer page stats and the PATAS float codec.
// Snappy is compiled in only with -DSB_SNAPPY (where libsnappy exists);
// sb_has_snappy() says which.
//
// Built as a plain C ABI shared library, loaded with ctypes.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
// liblz4 / libzstd / libsnappy (C ABI)
int LZ4_decompress_safe(const char* src, char* dst, int compressedSize, int dstCapacity);
int LZ4_compressBound(int inputSize);
int LZ4_compress_default(const char* src, char* dst, int srcSize, int dstCapacity);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t srcSize);
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize, int level);
unsigned ZSTD_isError(size_t code);
#ifdef SB_SNAPPY
int snappy_uncompress(const char* compressed, size_t compressed_length,
                      char* uncompressed, size_t* uncompressed_length);
int snappy_compress(const char* input, size_t input_length, char* compressed,
                    size_t* compressed_length);
size_t snappy_max_compressed_length(size_t source_length);
#endif
}

namespace {

enum Codec : int { kNone = 0, kLz4 = 1, kZstd = 2, kSnappy = 3 };

int decompress_one(int codec, const uint8_t* in, int64_t in_len, uint8_t* out,
                   int64_t out_len) {
  switch (codec) {
    case kNone:
      if (in_len != out_len) return -1;
      std::memcpy(out, in, (size_t)out_len);
      return 0;
    case kLz4: {
      int n = LZ4_decompress_safe((const char*)in, (char*)out, (int)in_len,
                                  (int)out_len);
      return n == (int)out_len ? 0 : -2;
    }
    case kZstd: {
      size_t n = ZSTD_decompress(out, (size_t)out_len, in, (size_t)in_len);
      return (!ZSTD_isError(n) && n == (size_t)out_len) ? 0 : -3;
    }
#ifdef SB_SNAPPY
    case kSnappy: {
      size_t n = (size_t)out_len;
      int rc = snappy_uncompress((const char*)in, (size_t)in_len, (char*)out, &n);
      return (rc == 0 && n == (size_t)out_len) ? 0 : -4;
    }
#endif
  }
  return -5;  // a codec this build does not have
}

// Compress into a buffer of out_cap bytes; returns the compressed size, or
// < 0 (-5: a codec this build does not have).  Zstd runs at level 0, the
// library's default, as the reference writer asks for it.
int64_t compress_one(int codec, const uint8_t* in, int64_t in_len, uint8_t* out,
                     int64_t out_cap) {
  switch (codec) {
    case kNone:
      if (out_cap < in_len) return -1;
      std::memcpy(out, in, (size_t)in_len);
      return in_len;
    case kLz4: {
      int n = LZ4_compress_default((const char*)in, (char*)out, (int)in_len, (int)out_cap);
      return n > 0 ? n : -2;
    }
    case kZstd: {
      size_t n = ZSTD_compress(out, (size_t)out_cap, in, (size_t)in_len, 0);
      return ZSTD_isError(n) ? -3 : (int64_t)n;
    }
#ifdef SB_SNAPPY
    case kSnappy: {
      size_t n = (size_t)out_cap;
      int rc = snappy_compress((const char*)in, (size_t)in_len, (char*)out, &n);
      return rc == 0 ? (int64_t)n : -4;
    }
#endif
  }
  return -5;
}

// Run fn(i) for i in [0, n) on n_threads threads (0: one per core).
template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn fn) {
  if (n <= 0) return;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = (int)n;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  if (n_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

int sb_has_snappy() {
#ifdef SB_SNAPPY
  return 1;
#else
  return 0;
#endif
}

// Decompress n pages in parallel.  Arrays of pointers/sizes; returns 0 or a
// nonzero per-page error code.
int sb_decompress_batch(int codec, int64_t n, const uint8_t** inputs,
                        const int64_t* in_lens, uint8_t** outputs,
                        const int64_t* out_lens, int n_threads) {
  std::atomic<int> err(0);
  parallel_for(n, n_threads, [&](int64_t i) {
    int rc = decompress_one(codec, inputs[i], in_lens[i], outputs[i], out_lens[i]);
    if (rc != 0) err.store(rc);
  });
  return err.load();
}

// The bound of a compressed buffer for in_len bytes, or -1 for a codec this
// build does not have.
int64_t sb_compress_bound(int codec, int64_t in_len) {
  switch (codec) {
    case kNone: return in_len;
    case kLz4: return LZ4_compressBound((int)in_len);
    case kZstd: return (int64_t)ZSTD_compressBound((size_t)in_len);
#ifdef SB_SNAPPY
    case kSnappy: return (int64_t)snappy_max_compressed_length((size_t)in_len);
#endif
  }
  return -1;
}

// Compress n buffers in parallel, each into its own buffer of out_caps[i]
// bytes; out_lens[i] receives the compressed size.  Returns 0 or the
// (negative) code of a buffer that failed.
int sb_compress_batch(int codec, int64_t n, const uint8_t** inputs,
                      const int64_t* in_lens, uint8_t** outputs,
                      const int64_t* out_caps, int64_t* out_lens, int n_threads) {
  std::atomic<int> err(0);
  parallel_for(n, n_threads, [&](int64_t i) {
    int64_t m = compress_one(codec, inputs[i], in_lens[i], outputs[i], out_caps[i]);
    out_lens[i] = m;
    if (m < 0) err.store((int)m);
  });
  return err.load();
}

// Walk bitpacked block headers: per 128-value block [u8 num_bits][nb*16 bytes].
// Writes each block's num_bits and returns the end offset, or -1 if the walk
// runs past buf_len (corrupt input).
int64_t sb_bp_walk(const uint8_t* buf, int64_t buf_len, int64_t body,
                   int64_t n_blocks, uint8_t* nbs_out) {
  int64_t p = body;
  for (int64_t i = 0; i < n_blocks; i++) {
    if (p >= buf_len) return -1;
    uint8_t nb = buf[p];
    nbs_out[i] = nb;
    p += 1 + (int64_t)nb * 16;
  }
  return p <= buf_len ? p : -1;
}

// Encode 128-value blocks as [u8 num_bits][BitPacker4x packed] in one pass
// (reference integer/bp.rs:36-86 layout: 4 interleaved 32-value lanes,
// LSB-first).  A block's width comes from OR-reducing width_vals.  Returns
// bytes written.
int64_t sb_bp_encode(const uint32_t* vals, int64_t n_blocks,
                     const uint32_t* width_vals, uint8_t* out) {
  int64_t p = 0;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const uint32_t* v = vals + blk * 128;
    const uint32_t* wv = width_vals + blk * 128;
    uint32_t acc = 0;
    for (int i = 0; i < 128; ++i) acc |= wv[i];
    uint32_t nb = acc ? 32 - __builtin_clz(acc) : 0;
    out[p++] = (uint8_t)nb;
    if (!nb) continue;
    uint32_t words[32 * 4];
    std::memset(words, 0, sizeof(uint32_t) * nb * 4);
    for (uint32_t t = 0; t < 32; ++t) {
      const uint32_t s = t * nb;
      const uint32_t w0 = s >> 5, sh = s & 31;
      for (uint32_t l = 0; l < 4; ++l) {
        uint32_t x = v[t * 4 + l];
        words[w0 * 4 + l] |= x << sh;
        if (sh + nb > 32) words[(w0 + 1) * 4 + l] |= x >> (32 - sh);
      }
    }
    std::memcpy(out + p, words, (size_t)nb * 16);
    p += (int64_t)nb * 16;
  }
  return p;
}

}  // extern "C"

// First-occurrence factorization (the reference DictEncoder's interning,
// integer/dict.rs): codes[i] = index of vals[i] in uniq, in first-occurrence
// order.  Returns the unique count, or -1 when it would exceed max_uniq.
// The open-addressing table is thread-local and epoch-tagged, so a call
// neither allocates nor clears it again.
template <typename T>
static int64_t factorize_impl(const T* vals, int64_t n, uint32_t* codes,
                              T* uniq, int64_t max_uniq) {
  int64_t cap = 64;
  while (cap < 2 * n) cap <<= 1;
  static thread_local std::vector<T> keys;
  static thread_local std::vector<int32_t> slot_code;
  static thread_local std::vector<uint32_t> tags;
  static thread_local uint32_t epoch = 0;
  if ((int64_t)keys.size() < cap) {
    keys.resize((size_t)cap);
    slot_code.resize((size_t)cap);
    tags.assign((size_t)cap, 0);
    epoch = 0;
  }
  const int64_t hmask = (int64_t)keys.size() - 1;  // a power of two
  if (++epoch == 0) {
    std::fill(tags.begin(), tags.end(), 0u);
    epoch = 1;
  }
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < n; ++i) {
    T v = vals[i];
    uint64_t h = (uint64_t)v;
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
    h ^= h >> 31;
    int64_t s = (int64_t)(h & (uint64_t)hmask);
    for (;;) {
      if (tags[s] != epoch) {
        if (n_uniq >= max_uniq) return -1;
        tags[s] = epoch;
        keys[s] = v;
        slot_code[s] = (int32_t)n_uniq;
        uniq[n_uniq] = v;
        codes[i] = (uint32_t)n_uniq;
        ++n_uniq;
        break;
      }
      if (keys[s] == v) {
        codes[i] = (uint32_t)slot_code[s];
        break;
      }
      s = (s + 1) & hmask;
    }
  }
  return n_uniq;
}

extern "C" int64_t sb_factorize_u64(const uint64_t* vals, int64_t n,
                                    uint32_t* codes, uint64_t* uniq,
                                    int64_t max_uniq) {
  return factorize_impl<uint64_t>(vals, n, codes, uniq, max_uniq);
}

extern "C" int64_t sb_factorize_u32(const uint32_t* vals, int64_t n,
                                    uint32_t* codes, uint32_t* uniq,
                                    int64_t max_uniq) {
  return factorize_impl<uint32_t>(vals, n, codes, uniq, max_uniq);
}

// ---------------------------------------------------------------------------
// Integer page stats (reference integer/mod.rs:179-229 gen_stats): one pass
// of min / max / run count / sortedness over the values and a distinct
// count with the most frequent value.  out (int64 x8): [min, max,
// null_count, run_count, is_sorted, unique_count, top_value, max_count].
// Runs and sortedness walk the valid values from T(0); min, max and the
// distinct table take every slot, null ones too.  The top value is the
// first value to reach the highest count in row order (a FREQ page stores
// it, so a file's bytes depend on this rule).  The open-addressing table is
// thread-local and epoch-tagged, as in factorize_impl.

template <typename T>
static void int_stats_impl(const T* vals, const uint8_t* validity, int64_t n,
                           int64_t* out) {
  T vmin = n ? vals[0] : T(0), vmax = n ? vals[0] : T(0);
  int64_t nulls = 0, runs = 0;
  bool sorted = true;
  T last = T(0);
  int64_t cap = 64;
  while (cap < 2 * n) cap <<= 1;
  static thread_local std::vector<T> keys;
  static thread_local std::vector<int64_t> cnts;
  static thread_local std::vector<uint32_t> tags;
  static thread_local uint32_t epoch = 0;
  if ((int64_t)keys.size() < cap) {
    keys.resize((size_t)cap);
    cnts.resize((size_t)cap);
    tags.assign((size_t)cap, 0);
    epoch = 0;
  }
  const int64_t hmask = (int64_t)keys.size() - 1;  // a power of two
  if (++epoch == 0) {
    std::fill(tags.begin(), tags.end(), 0u);
    epoch = 1;
  }
  int64_t n_distinct = 0;
  T top = n ? vals[0] : T(0);
  int64_t max_count = 0;
  auto bump = [&](T v) {
    uint64_t h = (uint64_t)v;
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
    h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
    h ^= h >> 31;
    int64_t i = (int64_t)(h & (uint64_t)hmask);
    for (;;) {
      if (tags[i] != epoch) {
        tags[i] = epoch;
        keys[i] = v;
        cnts[i] = 1;
        ++n_distinct;
        if (max_count < 1) { max_count = 1; top = v; }
        return;
      }
      if (keys[i] == v) {
        int64_t c = ++cnts[i];
        if (c > max_count) { max_count = c; top = v; }
        return;
      }
      i = (i + 1) & hmask;
    }
  };
  for (int64_t i = 0; i < n; ++i) {
    T v = vals[i];
    bool ok = validity == nullptr || validity[i];
    if (ok) {
      if (v < last) sorted = false;
      if (last != v) {
        ++runs;
        last = v;
      }
    } else {
      ++nulls;
    }
    if (v < vmin) vmin = v;
    if (v > vmax) vmax = v;
    bump(v);
  }
  out[0] = (int64_t)vmin;
  out[1] = (int64_t)vmax;
  out[2] = nulls;
  out[3] = runs;
  out[4] = sorted ? 1 : 0;
  out[5] = n_distinct;
  out[6] = (int64_t)top;
  out[7] = max_count;
}

#define SB_INT_STATS(NAME, T)                                                  \
  extern "C" int NAME(const T* vals, const uint8_t* validity, int64_t n,       \
                      int64_t* out) {                                          \
    int_stats_impl<T>(vals, validity, n, out);                                 \
    return 0;                                                                  \
  }
SB_INT_STATS(sb_int_stats_i64, int64_t)
SB_INT_STATS(sb_int_stats_u64, uint64_t)
SB_INT_STATS(sb_int_stats_i32, int32_t)
SB_INT_STATS(sb_int_stats_u32, uint32_t)
SB_INT_STATS(sb_int_stats_i16, int16_t)
SB_INT_STATS(sb_int_stats_u16, uint16_t)
SB_INT_STATS(sb_int_stats_i8, int8_t)
SB_INT_STATS(sb_int_stats_u8, uint8_t)
#undef SB_INT_STATS

// ---------------------------------------------------------------------------
// PATAS (f64/f32 via width parameter; semantics mirror patas.rs + the f32
// equal-marker rule described in codecs/double.py)

extern "C" int sb_patas_decode(const uint8_t* in, int64_t in_len, int64_t length,
                    int width, uint64_t* out) {
  if (length <= 0) return 0;
  if (in_len < width) return -1;
  const int wbits = width * 8;
  const int equal_tz = wbits - 1;
  const uint64_t mask = width == 8 ? ~0ull : ((1ull << wbits) - 1);
  int64_t p = 0;
  uint64_t first = 0;
  std::memcpy(&first, in, (size_t)width);
  out[0] = first;
  p += width;
  for (int64_t i = 1; i < length; ++i) {
    if (p + 2 > in_len) return -2;
    uint16_t packed;
    std::memcpy(&packed, in + p, 2);
    p += 2;
    int diff = (packed >> 9) & 0x7F;
    int sig = (packed >> 6) & 0x7;
    int tz = packed & 0x3F;
    if (tz < equal_tz && sig == 0) sig = 8;
    if (sig > width && tz < 8) sig = width;
    uint64_t val = 0;
    if (sig > width) {
      p += sig;  // reference read_value_custom returns default
    } else {
      if (p + sig > in_len) return -3;
      std::memcpy(&val, in + p, (size_t)sig);
      p += sig;
    }
    uint64_t prev = out[i - diff];
    out[i] = ((val << tz) & mask) ^ prev;
  }
  return 0;
}

// Encode: out must have capacity length*(width+2)+width; returns bytes written.
//
// Reference-index lookup uses a windowed 8-way bucket table instead of the
// reference's full hashmap: only references within the last 128 positions are
// usable (patas.rs:63-66 falls back to i-1 otherwise), so entries older than
// the window are semantically dead and their slots reusable.  In the
// (astronomically unlikely) case a bucket overflows with live entries, we
// fall back to i-1 — still a valid stream, identical on decode.
namespace {
struct PatasSlot { uint64_t val; int64_t idx; };
constexpr int kPatasBuckets = 128;  // x8 slots = 1024 for a 128-entry window
constexpr int kPatasWays = 8;

static inline uint64_t patas_hash(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}
}  // namespace

extern "C" int64_t sb_patas_encode(const uint64_t* bits, int64_t length, int width,
                        uint8_t* out) {
  if (length <= 0) return 0;
  const int wbits = width * 8;
  const uint64_t mask = width == 8 ? ~0ull : ((1ull << wbits) - 1);
  PatasSlot table[kPatasBuckets][kPatasWays];
  for (auto& b : table)
    for (auto& s : b) s.idx = INT64_MIN;
  auto lookup = [&](uint64_t v) -> int64_t {
    auto& b = table[patas_hash(v) & (kPatasBuckets - 1)];
    for (auto& s : b)
      if (s.idx != INT64_MIN && s.val == v) return s.idx;
    return 0;  // reference: indices.get(&val).unwrap_or(0)
  };
  auto insert = [&](uint64_t v, int64_t i) {
    auto& b = table[patas_hash(v) & (kPatasBuckets - 1)];
    PatasSlot* dead = nullptr;
    PatasSlot* oldest = &b[0];
    for (auto& s : b) {
      if (s.idx != INT64_MIN && s.val == v) { s.idx = i; return; }
      if (s.idx == INT64_MIN || s.idx < i - 128) dead = &s;
      if (s.idx < oldest->idx) oldest = &s;
    }
    PatasSlot* slot = dead ? dead : oldest;
    slot->val = v;
    slot->idx = i;
  };
  int64_t p = 0;
  std::memcpy(out + p, &bits[0], (size_t)width);
  p += width;
  insert(bits[0], 0);
  for (int64_t i = 1; i < length; ++i) {
    uint64_t val = bits[i];
    int64_t ref_idx = lookup(val);
    if (ref_idx > i || (i - ref_idx) >= 128) ref_idx = i - 1;
    int diff = (int)(i - ref_idx);
    uint64_t refer = bits[i - diff];
    uint64_t x = val ^ refer;
    int tz, lz;
    if (x == 0) {
      tz = wbits;
      lz = wbits;
    } else {
      tz = __builtin_ctzll(x);
      lz = __builtin_clzll(x) - (64 - wbits);
    }
    int is_equal = (tz == wbits) ? 1 : 0;
    int sig_bits = is_equal ? 0 : wbits - tz - lz;
    int sig_bytes = (sig_bits >> 3) + ((sig_bits & 7) ? 1 : 0);
    uint16_t packed = (uint16_t)(((diff & 0x7F) << 9) | ((sig_bytes & 7) << 6) |
                                 (tz - is_equal));
    std::memcpy(out + p, &packed, 2);
    p += 2;
    if (sig_bytes) {
      uint64_t payload = (x >> (tz - is_equal)) & mask;
      std::memcpy(out + p, &payload, (size_t)sig_bytes);
      p += sig_bytes;
    }
    insert(val, i);
  }
  return p;
}

// Decode a whole bit-packed page (BitPacker4x: per block [u8 num_bits]
// [num_bits * 16 bytes], 4 interleaved 32-value lanes, LSB-first) into
// out[n_blocks * 128] u32, mixed widths in one pass.  Returns the end
// offset, or -1 on truncated input.
extern "C" int64_t sb_bp_decode(const uint8_t* buf, int64_t buf_len,
                                int64_t pos, int64_t n_blocks, uint32_t* out) {
  int64_t p = pos;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    if (p >= buf_len) return -1;
    const uint32_t b = buf[p];
    p += 1;
    uint32_t* o = out + blk * 128;
    if (b == 0) {
      std::memset(o, 0, 128 * sizeof(uint32_t));
      continue;
    }
    if (b > 32 || p + (int64_t)b * 16 > buf_len) return -1;
    uint32_t words[32 * 4];
    std::memcpy(words, buf + p, (size_t)b * 16);
    p += (int64_t)b * 16;
    const uint32_t mask = b < 32 ? ((1u << b) - 1u) : 0xFFFFFFFFu;
    for (uint32_t t = 0; t < 32; ++t) {
      const uint32_t s = t * b;
      const uint32_t w0 = s >> 5, sh = s & 31;
      // word w of lane l sits at u32 index w*4 + l
      for (uint32_t l = 0; l < 4; ++l) {
        uint32_t v = words[w0 * 4 + l] >> sh;
        if (sh + b > 32) v |= words[(w0 + 1) * 4 + l] << (32 - sh);
        o[t * 4 + l] = v & mask;
      }
    }
  }
  return p;
}

// out[k] = dict[codes[k] + base] for one page; false on a code out of range.
template <typename T>
static bool gather_page(const uint32_t* codes, int64_t nv, int64_t base,
                        const void* dict, int64_t dict_len, void* out) {
  const T* d = (const T*)dict;
  T* o = (T*)out;
  for (int64_t k = 0; k < nv; ++k) {
    const int64_t idx = (int64_t)codes[k] + base;
    if ((uint64_t)idx >= (uint64_t)dict_len) return false;
    o[k] = d[idx];
  }
  return true;
}

// Fused DICT-column decode: per page, the u32 index codes (kinds: 0 =
// bit-packed at bodies[i]; 1 = raw u32 codes, page_bufs[i] points at them;
// 2 = bit-packed deltas, prefix-summed over the page), then
// out[row_offsets[i] + k] = dict[code + bases[i]] at the element width,
// pages spread over a thread pool.  Returns 0, or -1 (raw codes short),
// -2 (truncated page), -3 (code out of range), -4 (width not 1/2/4/8).
extern "C" int sb_dict_column_decode(
    const uint8_t** page_bufs, const int64_t* buf_lens, const int64_t* bodies,
    const int64_t* n_values, const int64_t* row_offsets, const int64_t* bases,
    const uint8_t* kinds, int64_t n_pages, const void* dict, int64_t dict_len,
    int width, void* out, int n_threads) {
  if (n_pages <= 0) return 0;
  if (width != 1 && width != 2 && width != 4 && width != 8) return -4;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n_pages) n_threads = (int)n_pages;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    std::vector<uint32_t> codes;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_pages) break;
      const int64_t nv = n_values[i];
      const uint32_t* cp;
      if (kinds[i] == 1) {
        if (buf_lens[i] < nv * 4) { err.store(-1); continue; }
        cp = (const uint32_t*)page_bufs[i];
      } else {
        const int64_t n_blocks = (nv + 127) / 128;
        codes.resize((size_t)n_blocks * 128);
        if (sb_bp_decode(page_bufs[i], buf_lens[i], bodies[i], n_blocks,
                         codes.data()) < 0) {
          err.store(-2);
          continue;
        }
        if (kinds[i] == 2) {
          uint32_t acc = 0;
          for (int64_t k = 0; k < nv; ++k) { acc += codes[k]; codes[k] = acc; }
        }
        cp = codes.data();
      }
      void* o = (uint8_t*)out + row_offsets[i] * width;
      bool ok = width == 8   ? gather_page<uint64_t>(cp, nv, bases[i], dict, dict_len, o)
                : width == 4 ? gather_page<uint32_t>(cp, nv, bases[i], dict, dict_len, o)
                : width == 2 ? gather_page<uint16_t>(cp, nv, bases[i], dict, dict_len, o)
                             : gather_page<uint8_t>(cp, nv, bases[i], dict, dict_len, o);
      if (!ok) err.store(-3);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}
