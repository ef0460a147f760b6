// K7: a filtered sum of integer columns for NVIDIA Hopper (sm_90a), in one
// pass: the range predicates, the validity tests, the product and the sum
// of resident TPC-H Q6 (ResidentTable.filter_sum).
//
// Replaces no Pallas kernel.  It is the counterpart of the fusion XLA does
// inside the JAX package's filter_sum jit (strawboat_tpu/exec/resident.py
// :547): there the compares, the product and the sum over K1's output are
// one fused loop.  The port ran them as eager torch passes: int64 widening
// of three columns, about six compares and ands over every slot, the
// padding mask read back, the product, a where and a reduction, each pass
// writing and rereading a full column (88% of the query's device time).
//
// Input  up to kMaxIn int32 columns of the same length (K1's outputs, in
//        tiled-slot order).  Input 0 is the value; with prod set, input 1
//        is the product.  Each input i keeps a row only where
//        lo[i] <= int64(x) < hi[i] (INT64_MIN and INT64_MAX where it has
//        no bound) and, where bit i of nonzero is set, x != 0.  Rows at or
//        past n_rows are padding and are never read.
// Output out, one uint64: the sum over kept rows of int64(x0) [* int64(x1)],
//        mod 2^64 (torch.sum(dtype=torch.int64)'s wrapping).  Zeroed by
//        the C entry before the launch.
//
// Bound: device-memory bytes, 4 a row an input, each read once.  Q6 at
// SF10 reads 4 inputs over 60,293,120 slots: 964,689,920 bytes, 0.288 ms
// at 3.35 TB/s.  What the design does about it:
//
// - Each thread reads 16 bytes (4 adjacent rows) of an input a load,
//   neighbouring threads on neighbouring 16-byte words, and issues every
//   load of a step (kLoads 16-byte loads in all, spread over the inputs)
//   before it uses any, so a step waits on memory once.  Loads stream
//   (ld.global.cs): nothing is read twice.  A block walks the rows with a
//   stride of the grid (a few blocks an SM), so loads stay in flight on
//   every SM to the end.  A base that is not 16-byte aligned takes scalar
//   loads of the same rows; so do the last n_rows % 4 rows.
// - Predicates are compares and ands, with no branch; the product is an
//   int64 multiply in registers; nothing but the one sum is written.
// - The kernel is templated on the number of inputs, so the loads and
//   compares of every input unroll and the words stay in registers.
// - A warp sums its threads' sums with shuffles, a block its warps' in
//   shared memory, and each block adds its sum to out with one 64-bit
//   atomicAdd.  Integer addition mod 2^64 is associative, so the order of
//   the atomics never changes the bits.
//
// The inputs travel in the launch's parameter space (a __grid_constant__
// struct), so no copy to the device precedes the launch.  The C entry
// returns cudaGetLastError() after the launch.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxIn = 8;
constexpr int kThreads = 256;
constexpr int kLoads = 8;  // 16-byte loads in flight a thread a step

// One launch's inputs (224 bytes; kernels/filter_sum.py _ARGS).
struct Args {
  const int* in[kMaxIn];
  long long lo[kMaxIn];
  long long hi[kMaxIn];
  unsigned long long* out;
  long long n_rows;
  int n_in;
  unsigned nonzero;  // bit i: input i keeps a row only where it is not 0
  int prod;          // 1: input 1 multiplies input 0
  int vec;           // every base 16-byte aligned
};
static_assert(sizeof(Args) == 224, "Args must match kernels/filter_sum.py _ARGS");

// What one row adds: its value (times its product) where every input keeps
// it, else 0.
template <int N>
__device__ __forceinline__ unsigned long long row_term(const Args& a, const int (&x)[N]) {
  bool keep = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long v = x[i];
    keep = keep & (v >= a.lo[i]) & (v < a.hi[i]) & (!((a.nonzero >> i) & 1u) | (x[i] != 0));
  }
  const long long p = (N > 1 && a.prod) ? (long long)x[N > 1 ? 1 : 0] : 1LL;
  const unsigned long long t = (unsigned long long)((long long)x[0] * p);
  return keep ? t : 0ull;
}

__device__ __forceinline__ int word(const uint4& w, int j) {
  return int(j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w);
}

template <int N>
__global__ void __launch_bounds__(kThreads) filter_sum_kernel(const __grid_constant__ Args a) {
  // 16-byte words an input a step: about kLoads loads in flight in all
  constexpr int V = N >= kLoads ? 1 : kLoads / N;
  const long long n_words = a.vec ? a.n_rows / 4 : 0;
  const long long per_block = (long long)kThreads * V;
  unsigned long long acc = 0;

  for (long long base = blockIdx.x * per_block; base < n_words;
       base += (long long)gridDim.x * per_block) {
    const long long first = base + threadIdx.x;
    if (base + per_block <= n_words) {
      uint4 w[N][V];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          w[i][k] = __ldcs(reinterpret_cast<const uint4*>(a.in[i]) + first + k * kThreads);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int x[N];
#pragma unroll
          for (int i = 0; i < N; ++i) x[i] = word(w[i][k], j);
          acc += row_term<N>(a, x);
        }
      }
    } else {  // the grid's last, partial step
      for (int k = 0; k < V; ++k) {
        const long long u = first + k * kThreads;
        if (u >= n_words) break;
        uint4 w[N];
#pragma unroll
        for (int i = 0; i < N; ++i) w[i] = __ldcs(reinterpret_cast<const uint4*>(a.in[i]) + u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int x[N];
#pragma unroll
          for (int i = 0; i < N; ++i) x[i] = word(w[i], j);
          acc += row_term<N>(a, x);
        }
      }
    }
  }
  // rows the 16-byte words leave: all of them off 16 bytes, else the last
  // n_rows % 4
  for (long long r = n_words * 4 + (long long)blockIdx.x * kThreads + threadIdx.x; r < a.n_rows;
       r += (long long)gridDim.x * kThreads) {
    int x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __ldcs(a.in[i] + r);
    acc += row_term<N>(a, x);
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, d);
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, d);
    if (lane == 0 && acc != 0) atomicAdd(a.out, acc);
  }
}

constexpr int kMaxCards = 64;

// The blocks of filter_sum_kernel<N> the current card holds at once, asked
// once a card (concurrent first calls store the same value).
template <int N>
int resident_blocks() {
  static std::atomic<int> per_card[kMaxCards];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < kMaxCards;
  int r = kept ? per_card[dev].load(std::memory_order_relaxed) : 0;
  if (r == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, filter_sum_kernel<N>, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    r = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (kept) per_card[dev].store(r, std::memory_order_relaxed);
  }
  return r;
}

template <int N>
void launch(const Args& a, cudaStream_t stream) {
  const int resident = resident_blocks<N>();
  constexpr int V = N >= kLoads ? 1 : kLoads / N;
  const long long rows_a_block = (long long)kThreads * V * 4;
  const long long needed = (a.n_rows + rows_a_block - 1) / rows_a_block;
  const int grid = int(needed < resident ? (needed > 0 ? needed : 1) : resident);
  filter_sum_kernel<N><<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace

// Zeroes *out, then sums into it.  Returns 0 or a cudaError_t.
extern "C" int sb_filter_sum(const void* args, int args_size, void* stream) {
  if (args_size != int(sizeof(Args))) return int(cudaErrorInvalidValue);
  Args a;
  std::memcpy(&a, args, sizeof(Args));
  if (a.n_in < 1 || a.n_in > kMaxIn || a.n_rows < 0 || a.out == nullptr ||
      (a.prod && a.n_in < 2)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = int(cudaMemsetAsync(a.out, 0, sizeof(unsigned long long), s));
  if (err != 0 || a.n_rows == 0) return err;
  switch (a.n_in) {
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 5: launch<5>(a, s); break;
    case 6: launch<6>(a, s); break;
    case 7: launch<7>(a, s); break;
    default: launch<8>(a, s); break;
  }
  return int(cudaGetLastError());
}
