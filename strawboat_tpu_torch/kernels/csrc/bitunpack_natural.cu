// K3: natural-order unpack of BitPacker4x blocks for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// strawboat_tpu/kernels/bitunpack_pallas.py:bitunpack_pallas_tiled_natural
// (bodies _plane_kernel_natural and _rowloop_kernel_natural), together with
// the relayout pass transpose_words_device_tiled that fed it.
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
// Bound: device-memory bytes.  Per 128 values the kernel reads 16 * b bytes
// and writes 512.  One thread per output value keeps every store of a warp
// on 32 consecutive words; the 128 threads of one BitPacker4x block read
// the block's 16 * b bytes, which the first warp brings into L1 for the
// other three.  The shift arithmetic is negligible.  b is a template
// parameter, so the mask is a constant; t varies by thread, so the word
// index and shift are computed (two shifts and an and).
//
// Not yet: several values per thread, 16-byte stores, staging a block's
// words in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int B>
__global__ void __launch_bounds__(kThreads)
bitunpack_natural_kernel(const uint32_t* __restrict__ words,
                         uint32_t* __restrict__ out, uint32_t seed,
                         int64_t n_values) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_values) return;
  const int64_t blk = i >> 7;
  const int r = int(i & 127);
  const int t = r >> 2;
  const int l = r & 3;
  const int s = t * B;
  const int w0 = s >> 5;
  const int sh = s & 31;
  const uint32_t* lane = words + blk * (4 * B) + l;
  uint32_t v = (lane[4 * w0] ^ seed) >> sh;
  // the value straddles two words: its high bits start word w0 + 1
  // (sh > 0 here, so the shift 32 - sh stays below 32)
  if (sh + B > 32) v |= (lane[4 * (w0 + 1)] ^ seed) << (32 - sh);
  // b == 32: (1u << 32) is undefined, so the full mask is spelled out
  constexpr uint32_t mask = B == 32 ? 0xFFFFFFFFu : ((1u << B) - 1u);
  out[i] = v & mask;
}

template <int B>
cudaError_t launch(const uint32_t* words, uint32_t* out, uint32_t seed,
                   int64_t n_blocks, cudaStream_t stream) {
  const int64_t n_values = n_blocks * 128;
  const int64_t grid = (n_values + kThreads - 1) / kThreads;
  bitunpack_natural_kernel<B><<<unsigned(grid), kThreads, 0, stream>>>(
      words, out, seed, n_values);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const uint32_t*, uint32_t*, uint32_t, int64_t,
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
// The grid is one-dimensional: n_blocks * 128 / 256 blocks must stay below
// 2^31, i.e. n_blocks < 2^32.
extern "C" int sb_bitunpack_natural(const void* words, void* out,
                                    unsigned int seed, int bits,
                                    long long n_blocks, void* stream) {
  if (bits < 1 || bits > 32 || n_blocks < 1 || n_blocks >= (1LL << 32))
    return int(cudaErrorInvalidValue);
  return int(kLaunch[bits - 1](static_cast<const uint32_t*>(words),
                               static_cast<uint32_t*>(out), seed, n_blocks,
                               static_cast<cudaStream_t>(stream)));
}
