// K1: tiled bit-plane unpack for NVIDIA Hopper (sm_90a), many planes a
// launch.
//
// Replaces the Pallas TPU kernel
// strawboat_tpu/kernels/bitunpack_pallas.py:222 bitunpack_pallas_tiled_seeded
// (bodies _plane_kernel_seeded and _rowloop_kernel_seeded); at seed 0 it is
// also K2 (bitunpack_pallas_tiled :174) and K0 (bitunpack_pallas_tmajor :41).
//
// Input  words (n_tiles, b, tile) u32 a plane: lane column `lane` of tile
//        `ti` holds 32 values of b bits each, packed LSB-first into its b
//        words.
// Output out   (n_tiles, 32, tile) u32 a plane: out[ti, t, lane] is value t
//        of that lane column, unpacked from words ^ seed.  Rows come out in
//        value order t for every b (the TPU kernel wrote plane order for
//        widths dividing 32, and its callers restored t order).
//
// Bound: device-memory bytes.  Per 32 values a plane reads b words and
// writes 32, so (b + 32) * 4 bytes move for 32 shifts and masks; the
// arithmetic is negligible.  What the design does about it:
//
// - One launch decodes a list of up to kMaxPlanes planes (every plane a
//   resident query reads).  Their descriptors ride in the kernel's
//   parameter space as one __grid_constant__ struct, so no host-to-device
//   copy precedes the launch; a CTA finds its plane by a binary search
//   over the planes' first CTAs, then switches on b into a body templated
//   on b, where every shift, mask and word index is a constant.
// - A thread takes 4 adjacent lane columns and kRows of the 32 values:
//   one 16-byte load of words [ti, j, lane .. lane + 3] a word row j,
//   issued just before the first of its values needs it (ptxas hoists
//   what the 64-register cap allows), and one 16-byte streaming store
//   (st.global.cs) of out[ti, t, lane .. lane + 3] a value t.  A warp
//   moves 512 bytes an instruction; the output, far larger than the 50 MB
//   L2, streams past it.
// - The 32 rows of a lane group split between kSplit threads (two warps
//   a row range), so a CTA covers 256 lane columns: (115, b, 16384) runs
//   7360 CTAs, a lone (29, b, 16384) plane 1856 and a 1-tile plane 64,
//   every SM busy.  The threads of a lane group read their word rows from
//   L1 where their ranges share one.  A thread taking all 32 rows (1024
//   lane columns a CTA) was as fast or slower at every shape, 8 ranges of
//   4 rows within 1%.
// - A plane whose tile is not a multiple of 4, or whose words or out are
//   not 16-byte aligned, takes the kernel's own scalar path (4-byte
//   accesses, the same lanes and rows a thread).
//
// The single-plane entry sb_bitunpack_tiled launches the same kernel over
// one descriptor (K1, K2 and K0's one-plane wrappers).  The C entries lay
// out the CTAs (each plane's cta_begin); the host only packs the planes,
// at most kMaxPlanes a call.
//
// Measured on an H100 (PERF.md §6, scripts/torch_k1_variants.py, device
// time): 86-97% of the bound at (115, b, 16384) for the path's widths, the
// parent kernel (a thread a lane column, 4-byte accesses) 80-84%; 84-99%
// at (29, b, 16384).  A lone 1-tile plane (64 CTAs, at most one an SM)
// takes 1.9-2.1 us against the parent's 1.5-1.7 us; it shortens with
// fewer rows a thread (2.5, 1.9, 1.8 us at 16, 8, 4 rows), and 4 rows
// was within 1.3% of 8 at the large planes.  64 registers at every width
// (the cap), no spills.

#include <cstdint>
#include <cuda_runtime.h>

// Build with -DSB_K1_BITS=b to compile the body of width b alone (ptxas's
// registers of one width); 0 compiles every width.
#ifndef SB_K1_BITS
#define SB_K1_BITS 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;         // lane columns a thread
constexpr int kSplit = 4;         // threads sharing a lane group's 32 rows
constexpr int kRows = 32 / kSplit;
constexpr int kGroup = kThreads / kSplit;        // threads of one row range
constexpr int kLanesPerCta = kGroup * kLanes;    // 256
constexpr int kMaxPlanes = 64;    // descriptors one launch carries
constexpr int kMinBlocksPerSm = 4;  // caps registers at 64 a thread

// One plane of a launch (40 bytes; kernels/bitunpack.py _PLANE).
struct Plane {
  const uint32_t* words;
  uint32_t* out;
  long long tile;      // lane columns a tile
  int n_tiles;
  int cta_begin;       // the plane's first CTA in its launch (set by launch)
  unsigned int seed;
  int bits;
};
static_assert(sizeof(Plane) == 40, "Plane must match _PLANE");

struct Batch {
  int n;
  Plane planes[kMaxPlanes];
};
static_assert(sizeof(Batch) <= 4096, "the batch must fit the 4 KB parameter space");

__device__ __forceinline__ uint4 load_row(const uint32_t* p, uint32_t seed) {
  uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  w.x ^= seed;
  w.y ^= seed;
  w.z ^= seed;
  w.w ^= seed;
  return w;
}

// b == 32: (1u << 32) is undefined, so the full mask is spelled out
template <int B>
constexpr uint32_t kMask = B == 32 ? 0xFFFFFFFFu : ((1u << B) - 1u);

// Values T0 .. T0 + kRows - 1 of 4 lane columns: src and dst point at lane
// `lane` of word row 0 and output row 0 of the tile, 16-byte aligned.
template <int B, int T0>
__device__ __forceinline__ void unpack_vec(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst,
                                           long long tile, uint32_t seed) {
  constexpr int J0 = T0 * B / 32;                   // first word row read
  constexpr int J1 = ((T0 + kRows) * B - 1) / 32;   // last word row read
  uint4 w[J1 - J0 + 1];
#pragma unroll
  for (int t = T0; t < T0 + kRows; ++t) {
    // word row j is first needed by value floor(32 j / b)
#pragma unroll
    for (int j = J0; j <= J1; ++j) {
      const int first = 32 * j / B < T0 ? T0 : 32 * j / B;
      if (first == t) w[j - J0] = load_row(src + j * tile, seed);
    }
    const int s = t * B;
    const int w0 = s / 32 - J0;
    const int sh = s % 32;
    uint4 v;
    if (sh + B > 32) {
      // the value straddles two words: its high bits start word w0 + 1
      v.x = __funnelshift_r(w[w0].x, w[w0 + 1].x, sh);
      v.y = __funnelshift_r(w[w0].y, w[w0 + 1].y, sh);
      v.z = __funnelshift_r(w[w0].z, w[w0 + 1].z, sh);
      v.w = __funnelshift_r(w[w0].w, w[w0 + 1].w, sh);
    } else {
      v.x = w[w0].x >> sh;
      v.y = w[w0].y >> sh;
      v.z = w[w0].z >> sh;
      v.w = w[w0].w >> sh;
    }
    v.x &= kMask<B>;
    v.y &= kMask<B>;
    v.z &= kMask<B>;
    v.w &= kMask<B>;
    __stcs(reinterpret_cast<uint4*>(dst + t * tile), v);
  }
}

// Row range s (warp-uniform) of width B: values kRows * s ...
template <int B, int S = 0>
__device__ __forceinline__ void unpack_range(int s, const uint32_t* src, uint32_t* dst,
                                             long long tile, uint32_t seed) {
  if constexpr (S < kSplit && (SB_K1_BITS == 0 || SB_K1_BITS == B)) {
    if (s == S) unpack_vec<B, S * kRows>(src, dst, tile, seed);
    else unpack_range<B, S + 1>(s, src, dst, tile, seed);
  }
}

// Values t0 .. t0 + kRows - 1 of the up to 4 lane columns from `lane`,
// with 4-byte accesses: a tile that is not a multiple of 4 lanes, or a
// base that is not 16-byte aligned.
__device__ void unpack_scalar(const uint32_t* __restrict__ src,
                              uint32_t* __restrict__ dst, long long tile,
                              long long lane, int bits, uint32_t seed, int t0) {
  const uint32_t mask = bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  for (int l = 0; l < kLanes && lane + l < tile; ++l) {
    for (int t = t0; t < t0 + kRows; ++t) {
      const int s = t * bits;
      const int w0 = s >> 5;
      const int sh = s & 31;
      const uint32_t lo = __ldg(src + w0 * tile + l) ^ seed;
      const uint32_t hi = sh + bits > 32 ? __ldg(src + (w0 + 1) * tile + l) ^ seed : 0u;
      dst[t * tile + l] = __funnelshift_r(lo, hi, sh) & mask;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
bitunpack_tiled_many_kernel(const __grid_constant__ Batch batch) {
  // this CTA's plane: the last whose first CTA is at or below it
  const int cta = int(blockIdx.x);
  int lo = 0, hi = batch.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.planes[mid].cta_begin <= cta) lo = mid;
    else hi = mid - 1;
  }
  const Plane& p = batch.planes[lo];
  const int ctas_per_tile = int((p.tile + kLanesPerCta - 1) / kLanesPerCta);
  const int local = cta - p.cta_begin;
  const int ti = local / ctas_per_tile;
  const int chunk = local - ti * ctas_per_tile;
  const int s = int(threadIdx.x) / kGroup;  // warp-uniform
  const long long lane =
      (long long)chunk * kLanesPerCta + (int(threadIdx.x) % kGroup) * kLanes;
  if (lane >= p.tile) return;
  const int b = p.bits;
  const uint32_t* src = p.words + (long long)ti * b * p.tile + lane;
  uint32_t* dst = p.out + (long long)ti * 32 * p.tile + lane;
  const bool vec = (p.tile & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.words) |
                     reinterpret_cast<uintptr_t>(p.out)) & 15) == 0;
  if (!vec) {
    unpack_scalar(src, dst, p.tile, lane, b, p.seed, s * kRows);
    return;
  }
  switch (b) {
#define SB_K1_CASE(B) \
  case B: unpack_range<B>(s, src, dst, p.tile, p.seed); break;
    SB_K1_CASE(1) SB_K1_CASE(2) SB_K1_CASE(3) SB_K1_CASE(4)
    SB_K1_CASE(5) SB_K1_CASE(6) SB_K1_CASE(7) SB_K1_CASE(8)
    SB_K1_CASE(9) SB_K1_CASE(10) SB_K1_CASE(11) SB_K1_CASE(12)
    SB_K1_CASE(13) SB_K1_CASE(14) SB_K1_CASE(15) SB_K1_CASE(16)
    SB_K1_CASE(17) SB_K1_CASE(18) SB_K1_CASE(19) SB_K1_CASE(20)
    SB_K1_CASE(21) SB_K1_CASE(22) SB_K1_CASE(23) SB_K1_CASE(24)
    SB_K1_CASE(25) SB_K1_CASE(26) SB_K1_CASE(27) SB_K1_CASE(28)
    SB_K1_CASE(29) SB_K1_CASE(30) SB_K1_CASE(31) SB_K1_CASE(32)
#undef SB_K1_CASE
    default: break;
  }
}

// Checks a batch's widths and shapes, lays out its CTAs (each plane's
// cta_begin) and launches it.
int launch(Batch& batch, cudaStream_t stream) {
  if (batch.n < 1 || batch.n > kMaxPlanes) return int(cudaErrorInvalidValue);
  long long ctas = 0;
  for (int i = 0; i < batch.n; ++i) {
    Plane& p = batch.planes[i];
    if (p.bits < 1 || p.bits > 32 || p.n_tiles < 1 || p.tile < 1 || p.tile >= (1LL << 31))
      return int(cudaErrorInvalidValue);
    p.cta_begin = int(ctas);
    ctas += (long long)p.n_tiles * ((p.tile + kLanesPerCta - 1) / kLanesPerCta);
    if (ctas >= (1LL << 31)) return int(cudaErrorInvalidValue);
  }
  bitunpack_tiled_many_kernel<<<unsigned(ctas), kThreads, 0, stream>>>(batch);
  return int(cudaGetLastError());
}

}  // namespace

// K1 over n planes in one launch: descs points at n host-side Plane
// descriptors (1 <= n <= 64; their cta_begin is ignored and laid out
// here).  Returns a cudaError_t: cudaSuccess (0) when the launch was
// accepted, cudaErrorInvalidValue (1) for a bad descriptor.
extern "C" int sb_bitunpack_tiled_many(const void* descs, int n, void* stream) {
  if (n < 1 || n > kMaxPlanes) return int(cudaErrorInvalidValue);
  Batch batch{};
  batch.n = n;
  const Plane* src = static_cast<const Plane*>(descs);
  for (int i = 0; i < n; ++i) batch.planes[i] = src[i];
  return launch(batch, static_cast<cudaStream_t>(stream));
}

// K1 over one plane: the same kernel over one descriptor.
extern "C" int sb_bitunpack_tiled(const void* words, void* out,
                                  unsigned int seed, int bits,
                                  long long n_tiles, long long tile,
                                  void* stream) {
  if (n_tiles < 1 || n_tiles >= (1LL << 31)) return int(cudaErrorInvalidValue);
  Batch batch{};
  batch.n = 1;
  Plane& p = batch.planes[0];
  p.words = static_cast<const uint32_t*>(words);
  p.out = static_cast<uint32_t*>(out);
  p.tile = tile;
  p.n_tiles = int(n_tiles);
  p.seed = seed;
  p.bits = bits;
  return launch(batch, static_cast<cudaStream_t>(stream));
}
