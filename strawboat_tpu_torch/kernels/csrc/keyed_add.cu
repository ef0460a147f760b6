// K9: a filtered keyed add of integer columns for NVIDIA Hopper (sm_90a), in
// one pass: the range predicates, the validity tests, each kept row's slot,
// the products of its terms and the adds into every slot's sums and count
// (the dense partials of parallel/dist_resident.py sharded_keyed_aggregate,
// TPC-H Q15's revenue by supplier).
//
// Replaces no Pallas kernel.  The JAX package's keyed aggregate
// (strawboat_tpu/parallel/dist_agg.py, stage 1 of shard_fn) is one jit that
// XLA fuses; the port's dense partials, which it has not, ran as eager torch
// passes: the quarter's compares, the int64 widening of the money columns,
// the literal less the discount, the product, the mask's where and one
// index_add_ a sum and the count over every row, a masked row adding 0 (88%
// of a four-card Q15 query's device time).
//
// Input  up to kMaxIn int32 columns of the same length (K1's outputs, in
//        tiled-slot order).  Input 0 is the key.  Each input i with bit i of
//        filt set is read for every row and keeps a row only where
//        lo[i] <= int64(x) < hi[i] (INT64_MIN and INT64_MAX where it has no
//        bound) and, where bit i of nonzero is set, x != 0.  The other
//        inputs are read only where a row of their 16-byte word is kept.
//        Rows at or past n_rows are padding and are never read.
// Output out, (n_terms + 1, slots) uint64 row-major: for every kept row,
//        slot = key - lowest (or, with clamp, key clamped to [0, slots)),
//        out[t][slot] += term t and out[n_terms][slot] += 1, mod 2^64.  A
//        slot outside [0, slots) adds nothing.  Zeroed by the C entry
//        before the launch.
// Terms  each a product of one or two factors; a factor is literal + x or
//        literal - x of one input, in int64 where it is wide and in int32
//        (wrapping) where not.  Two int32 factors multiply in int32 and
//        wrap; otherwise the int32 one is sign-extended and the product is
//        int64.  The term is widened to int64 (torch's promotion, then
//        dist_agg.py dense_partials' widening).
//
// Bound: device-memory bytes, each input's rows read once: TPC-H Q15 on one
// of four cards reads 4 inputs over about 150 M rows, 2.4 GB, 0.72 ms at
// 3.35 TB/s.  What the design does about it:
//
// - Each thread reads 16 bytes (4 adjacent rows) of an input a load,
//   neighbouring threads on neighbouring 16-byte words, and issues the
//   loads of every read-always input of a step before it uses any.  Loads
//   stream (ld.global.cs).  A block walks the rows with a stride of the
//   grid (a few blocks an SM).  A base that is not 16-byte aligned takes
//   scalar loads of the same rows; so do the last n_rows % 4 rows.
// - The other inputs (the key and the summed columns) are loaded only for
//   the 16-byte words that hold a kept row: Q15 keeps a quarter's rows,
//   about 3.6%, so most of their sectors are never fetched.
// - Only kept rows add, and a lane takes its kept rows in turn, each picked
//   by selects: a warp runs the add code once a kept row of its busiest
//   lane (one or two a step at Q15's 3.6%), not once each of its 8 row
//   positions (the first version's 0.88 ms at Q15's shape became 0.77).
// - Where the block's (n_terms + 1, slots) table fits kSharedBytes (small
//   dictionary keys, which would all contend on a few addresses), a block
//   adds under shared-memory atomics and flushes its nonzero slots once
//   (Q15's rows by an 11-slot key on an H100: 0.74 ms, against 5.98 ms
//   with every add in device memory);
//   otherwise each kept row adds straight into device memory with 64-bit
//   atomics (Q15: 2^20 slots, about 5.4 M kept rows a card, 16 MB of sums
//   that stay in the 50 MB L2).  Integer addition mod 2^64 is associative,
//   so the order of the atomics never changes the bits.
// - The kernel is templated on the number of inputs and on the way it adds,
//   so the loads and compares unroll and the words stay in registers; a
//   factor picks its input by selects, never by an indexed register array.
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
constexpr int kMaxTerms = 4;
constexpr int kThreads = 256;
constexpr int kLoads = 8;  // 16-byte words an input a step: kLoads / inputs
constexpr int kSharedBytes = 48 * 1024;

// One factor: literal + x or literal - x of input `in` (-1: no factor).
struct Factor {
  long long literal;
  int in;
  int op;  // bits 0-1: 0 the column, 1 literal - x, 2 literal + x; bit 2: wide (int64)
};

// One launch's inputs (384 bytes; kernels/keyed_add.py _ARGS).
struct Args {
  const int* in[kMaxIn];
  long long lo[kMaxIn];
  long long hi[kMaxIn];
  Factor f[kMaxTerms][2];
  unsigned long long* out;
  long long n_rows;
  long long lowest;
  long long slots;
  int n_in;
  int n_terms;
  unsigned filt;     // bit i: input i is read for every row and tested
  unsigned nonzero;  // bit i: input i keeps a row only where it is not 0
  int clamp;         // 1: the slot is the key clamped to [0, slots)
  int vec;           // every base 16-byte aligned
  int shared;        // 1: a block adds in shared memory
  int pad;
};
static_assert(sizeof(Args) == 384, "Args must match kernels/keyed_add.py _ARGS");

__device__ __forceinline__ int word(const uint4& w, int j) {
  return int(j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w);
}

// x[i] by selects over the unrolled inputs.
template <int N>
__device__ __forceinline__ int pick(const int (&x)[N], int i) {
  int r = 0;
#pragma unroll
  for (int q = 0; q < N; ++q) r = q == i ? x[q] : r;
  return r;
}

// Whether the read-always inputs keep a row.
template <int N>
__device__ __forceinline__ bool keeps(const Args& a, const int (&x)[N]) {
  bool keep = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if ((a.filt >> i) & 1u) {
      const long long v = x[i];
      keep = keep & (v >= a.lo[i]) & (v < a.hi[i]) & (!((a.nonzero >> i) & 1u) | (x[i] != 0));
    }
  }
  return keep;
}

// A factor's value, sign-extended to 64 bits where it is int32.
template <int N>
__device__ __forceinline__ long long factor(const Factor& f, const int (&x)[N]) {
  const int c = pick<N>(x, f.in);
  const int op = f.op & 3;
  if (f.op & 4) {
    const unsigned long long u = (unsigned long long)(long long)c;
    const unsigned long long l = (unsigned long long)f.literal;
    return (long long)(op == 0 ? u : op == 1 ? l - u : l + u);
  }
  const unsigned u = (unsigned)c, l = (unsigned)f.literal;
  return (long long)(int)(op == 0 ? u : op == 1 ? l - u : l + u);
}

// One kept row's adds into `sink`, a (n_terms + 1, slots) table.
template <int N>
__device__ __forceinline__ void add_row(const Args& a, const int (&x)[N],
                                        unsigned long long* sink) {
  const long long key = x[0];
  const long long slot = a.clamp ? (key < 0 ? 0 : key >= a.slots ? a.slots - 1 : key)
                                 : (long long)((unsigned long long)key -
                                               (unsigned long long)a.lowest);
  if ((unsigned long long)slot >= (unsigned long long)a.slots) return;
#pragma unroll 1
  for (int t = 0; t < a.n_terms; ++t) {
    const Factor f0 = a.f[t][0], f1 = a.f[t][1];
    const long long v0 = factor<N>(f0, x);
    unsigned long long p = (unsigned long long)v0;
    if (f1.in >= 0) {
      const long long v1 = factor<N>(f1, x);
      p = ((f0.op | f1.op) & 4)
              ? (unsigned long long)v0 * (unsigned long long)v1
              : (unsigned long long)(long long)(int)((unsigned)v0 * (unsigned)v1);
    }
    atomicAdd(sink + t * a.slots + slot, p);
  }
  atomicAdd(sink + a.n_terms * a.slots + slot, 1ull);
}

template <int N, bool kShared>
__global__ void __launch_bounds__(kThreads) keyed_add_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned long long table[];
  const long long cells = (a.n_terms + 1) * a.slots;
  if (kShared) {
    for (long long c = threadIdx.x; c < cells; c += kThreads) table[c] = 0ull;
    __syncthreads();
  }
  unsigned long long* sink = kShared ? table : a.out;

  constexpr int V = N >= kLoads ? 1 : kLoads / N;
  const long long n_words = a.vec ? a.n_rows / 4 : 0;
  const long long per_block = (long long)kThreads * V;

  for (long long base = blockIdx.x * per_block; base < n_words;
       base += (long long)gridDim.x * per_block) {
    const long long first = base + threadIdx.x;
    uint4 w[N][V];
    bool in_range[V];
#pragma unroll
    for (int k = 0; k < V; ++k) in_range[k] = first + k * kThreads < n_words;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        w[i][k] = make_uint4(0u, 0u, 0u, 0u);
        if (((a.filt >> i) & 1u) && in_range[k]) {
          w[i][k] = __ldcs(reinterpret_cast<const uint4*>(a.in[i]) + first + k * kThreads);
        }
      }
    }
    unsigned kept = 0;  // bit 4k + j: row j of word k
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int x[N];
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = word(w[i][k], j);
        kept |= unsigned(in_range[k] && keeps<N>(a, x)) << (4 * k + j);
      }
    }
    if (kept == 0u) continue;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (!((a.filt >> i) & 1u) && ((kept >> (4 * k)) & 0xFu)) {
          w[i][k] = __ldcs(reinterpret_cast<const uint4*>(a.in[i]) + first + k * kThreads);
        }
      }
    }
    // each lane's kept rows in turn: a warp runs the adds once a kept row
    // of its busiest lane, not once a row position
    while (kept) {
      const int b = __ffs(kept) - 1;
      kept &= kept - 1;
      int x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        int v = 0;
#pragma unroll
        for (int k = 0; k < V; ++k) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v = b == 4 * k + j ? word(w[i][k], j) : v;
        }
        x[i] = v;
      }
      add_row<N>(a, x, sink);
    }
  }
  // rows the 16-byte words leave: all of them off 16 bytes, else the last
  // n_rows % 4
  for (long long r = n_words * 4 + (long long)blockIdx.x * kThreads + threadIdx.x; r < a.n_rows;
       r += (long long)gridDim.x * kThreads) {
    int x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __ldcs(a.in[i] + r);
    if (keeps<N>(a, x)) add_row<N>(a, x, sink);
  }

  if (kShared) {  // the block's nonzero slots, once
    __syncthreads();
    for (long long s = threadIdx.x; s < a.slots; s += kThreads) {
      const unsigned long long count = table[a.n_terms * a.slots + s];
      if (count == 0ull) continue;
      atomicAdd(a.out + a.n_terms * a.slots + s, count);
      for (int t = 0; t < a.n_terms; ++t) {
        const unsigned long long v = table[t * a.slots + s];
        if (v != 0ull) atomicAdd(a.out + t * a.slots + s, v);
      }
    }
  }
}

constexpr int kMaxCards = 64;

// The blocks of keyed_add_kernel<N, S> the current card holds at once (at
// the most shared memory a block asks), asked once a card (concurrent first
// calls store the same value).
template <int N, bool S>
int resident_blocks() {
  static std::atomic<int> per_card[kMaxCards];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < kMaxCards;
  int r = kept ? per_card[dev].load(std::memory_order_relaxed) : 0;
  if (r == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keyed_add_kernel<N, S>, kThreads,
                                                  S ? kSharedBytes : 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    r = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (kept) per_card[dev].store(r, std::memory_order_relaxed);
  }
  return r;
}

template <int N, bool S>
void launch(const Args& a, cudaStream_t stream) {
  const int resident = resident_blocks<N, S>();
  constexpr int V = N >= kLoads ? 1 : kLoads / N;
  const long long rows_a_block = (long long)kThreads * V * 4;
  const long long needed = (a.n_rows + rows_a_block - 1) / rows_a_block;
  const int grid = int(needed < resident ? (needed > 0 ? needed : 1) : resident);
  const size_t smem = S ? size_t(a.n_terms + 1) * size_t(a.slots) * 8 : 0;
  keyed_add_kernel<N, S><<<grid, kThreads, smem, stream>>>(a);
}

template <bool S>
void launch_n(const Args& a, cudaStream_t s) {
  switch (a.n_in) {
    case 1: launch<1, S>(a, s); break;
    case 2: launch<2, S>(a, s); break;
    case 3: launch<3, S>(a, s); break;
    case 4: launch<4, S>(a, s); break;
    case 5: launch<5, S>(a, s); break;
    case 6: launch<6, S>(a, s); break;
    case 7: launch<7, S>(a, s); break;
    default: launch<8, S>(a, s); break;
  }
}

}  // namespace

// Zeroes out, then adds into it.  Returns 0 or a cudaError_t.
extern "C" int sb_keyed_add(const void* args, int args_size, void* stream) {
  if (args_size != int(sizeof(Args))) return int(cudaErrorInvalidValue);
  Args a;
  std::memcpy(&a, args, sizeof(Args));
  if (a.n_in < 1 || a.n_in > kMaxIn || a.n_terms < 1 || a.n_terms > kMaxTerms ||
      a.n_rows < 0 || a.n_rows > INT_MAX || a.slots < 1 || a.slots > INT_MAX ||
      a.out == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  for (int t = 0; t < a.n_terms; ++t) {
    if (a.f[t][0].in < 0 || a.f[t][0].in >= a.n_in || a.f[t][1].in >= a.n_in) {
      return int(cudaErrorInvalidValue);
    }
  }
  const long long cells = (a.n_terms + 1) * a.slots;
  if (a.shared && cells * 8 > kSharedBytes) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = int(cudaMemsetAsync(a.out, 0, size_t(cells) * 8, s));
  if (err != 0 || a.n_rows == 0) return err;
  if (a.shared) {
    launch_n<true>(a, s);
  } else {
    launch_n<false>(a, s);
  }
  return int(cudaGetLastError());
}
