// K3: natural-order unpack of BitPacker4x blocks for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// strawboat_tpu/kernels/bitunpack_pallas.py:298 bitunpack_pallas_tiled_natural
// (bodies _plane_kernel_natural :249 and _rowloop_kernel_natural :277),
// together with the relayout pass transpose_words_device_tiled that fed it.
//
// Input  words (n_blocks, 4 * b) u32: the header-stripped bodies of
//        BitPacker4x blocks as a page stores them.  Lane l of block blk
//        packs 32 values LSB-first into words[blk, 4k + l], k = 0 .. b-1.
// Output out   (n_blocks * 128,) u32 in natural row order:
//        out[128 * blk + 4 * t + l] = bits [t*b, (t+1)*b) of lane l's stream
//        of words ^ seed.
//
// The TPU kernel needed its words transposed into (n_tiles, b, tile)
// planes first, because VMEM is tiled by lanes; here a thread reads the
// page's own layout directly, so that pass is gone.
//
// Bound: device-memory bytes.  Per 128 values the kernel must read 16 * b
// bytes and write 512 (3.35 TB/s on an H100 SXM: 0.081 ms for 60 M values
// at b = 4, 0.099 ms at b = 12).  The shifts are negligible.
//
// Design: one thread per (block, t) unpacks value t of all four lanes.
// The lanes share the word index w0 = t*b >> 5 and the shift sh = t*b & 31,
// and words[blk, 4*w0 .. 4*w0 + 3] are 16 contiguous bytes (a block's row
// is 16 * b bytes, so they are 16-byte aligned): one 16-byte load (a second
// when the value straddles into word w0 + 1), four shifts and masks, and
// one 16-byte store of out[128 * blk + 4t .. +3].  A warp covers one block:
// its loads touch the block's 16 * b bytes, its 32 stores are 512
// contiguous bytes.  Each warp takes kBlocksPerWarp consecutive blocks and
// issues all their loads before the first store, so several loads are in
// flight a thread.  Stores stream (st.global.cs): the decoded column is
// far larger than the 50 MB L2, and the next kernel reads it, not this one.
// b is a template parameter, so the mask and, for b dividing 32, the
// absence of a second load are constants.  Offsets are 64-bit.
//
// Measured on an H100 (PERF.md): 67-77% of the bound at the scan's
// widths, against torch's fill_ of the same output at 90%.  A variant that
// stages each CTA's chunk in shared memory (cp.async.bulk into a double
// buffer, completing on an mbarrier, persistent grid) ran 2-5% slower, and
// neither 8 blocks a warp, plain stores nor a persistent grid that loads
// the next blocks before storing gained, so this, the simplest, stays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerWarp = 4;
// blocks one CTA unpacks (the tails checked by the tests sit around it)
constexpr int kBlocksPerCta = kThreads / 32 * kBlocksPerWarp;

template <int B>
__device__ __forceinline__ uint32_t field(uint32_t lo, uint32_t hi, int sh,
                                          bool straddle, uint32_t seed) {
  // b == 32: (1u << 32) is undefined, so the full mask is spelled out
  constexpr uint32_t mask = B == 32 ? 0xFFFFFFFFu : ((1u << B) - 1u);
  uint32_t v = (lo ^ seed) >> sh;
  // the value's high bits start word w0 + 1 (sh > 0 here, so 32 - sh < 32)
  if (straddle) v |= (hi ^ seed) << (32 - sh);
  return v & mask;
}

template <int B>
__global__ void __launch_bounds__(kThreads)
bitunpack_natural_kernel(const uint4* __restrict__ words,
                         uint4* __restrict__ out, uint32_t seed,
                         int64_t n_blocks) {
  const int t = threadIdx.x & 31;
  const int s = t * B;
  const int w0 = s >> 5;
  const int sh = s & 31;
  // for b dividing 32 no value straddles two words
  const bool straddle = (32 % B != 0) && (sh + B > 32);
  const int64_t first =
      (int64_t(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) * kBlocksPerWarp;

  uint4 lo[kBlocksPerWarp], hi[kBlocksPerWarp];
#pragma unroll
  for (int k = 0; k < kBlocksPerWarp; ++k) {
    lo[k] = hi[k] = make_uint4(0u, 0u, 0u, 0u);
    const int64_t blk = first + k;
    if (blk < n_blocks) {
      const uint4* row = words + blk * B;  // a block's row: b 16-byte words
      lo[k] = __ldg(row + w0);
      if (straddle) hi[k] = __ldg(row + w0 + 1);
    }
  }
#pragma unroll
  for (int k = 0; k < kBlocksPerWarp; ++k) {
    const int64_t blk = first + k;
    if (blk < n_blocks) {
      uint4 v;
      v.x = field<B>(lo[k].x, hi[k].x, sh, straddle, seed);
      v.y = field<B>(lo[k].y, hi[k].y, sh, straddle, seed);
      v.z = field<B>(lo[k].z, hi[k].z, sh, straddle, seed);
      v.w = field<B>(lo[k].w, hi[k].w, sh, straddle, seed);
      __stcs(out + blk * 32 + t, v);  // values 128 * blk + 4t .. +3
    }
  }
}

template <int B>
cudaError_t launch(const void* words, void* out, uint32_t seed,
                   int64_t n_blocks, cudaStream_t stream) {
  const int64_t grid = (n_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  bitunpack_natural_kernel<B><<<unsigned(grid), kThreads, 0, stream>>>(
      static_cast<const uint4*>(words), static_cast<uint4*>(out), seed,
      n_blocks);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const void*, void*, uint32_t, int64_t,
                                 cudaStream_t);

constexpr LaunchFn kLaunch[32] = {
    &launch<1>,  &launch<2>,  &launch<3>,  &launch<4>,  &launch<5>,
    &launch<6>,  &launch<7>,  &launch<8>,  &launch<9>,  &launch<10>,
    &launch<11>, &launch<12>, &launch<13>, &launch<14>, &launch<15>,
    &launch<16>, &launch<17>, &launch<18>, &launch<19>, &launch<20>,
    &launch<21>, &launch<22>, &launch<23>, &launch<24>, &launch<25>,
    &launch<26>, &launch<27>, &launch<28>, &launch<29>, &launch<30>,
    &launch<31>, &launch<32>};

}  // namespace

// Returns a cudaError_t: cudaSuccess (0) when the launch was accepted.
// words and out must be 16-byte aligned; the grid (n_blocks / 32 CTAs)
// must stay below 2^31.
extern "C" int sb_bitunpack_natural(const void* words, void* out,
                                    unsigned int seed, int bits,
                                    long long n_blocks, void* stream) {
  if (bits < 1 || bits > 32 || n_blocks < 1 ||
      n_blocks / kBlocksPerCta >= (1LL << 31) - 1)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(words) | reinterpret_cast<uintptr_t>(out)) & 15)
    return int(cudaErrorMisalignedAddress);
  return int(kLaunch[bits - 1](words, out, seed, n_blocks,
                               static_cast<cudaStream_t>(stream)));
}
