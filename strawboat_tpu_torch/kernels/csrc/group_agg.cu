// K6: dense grouped integer sums and counts for NVIDIA Hopper (sm_90a), in
// one pass over the rows.
//
// Replaces the JAX package's dense_group_sum
// (strawboat_tpu/exec/aggregate.py:233): there a grouped sum is a one-hot
// matmul that XLA fuses on the MXU, not a Pallas kernel.  The port had
// eager torch in its place: per aggregate a routed copy of the group codes,
// a count nobody read and a chunked scatter-add, some 15 scatter-adds and
// 100 full-length elementwise passes for one TPC-H Q1.
//
// Input  up to kMaxKeys key columns (int32 or int64) with their strides, a
//        row mask (bool, or none), and up to kMaxOut outputs, each a value
//        column (int32 or int64; none: a count) with a validity (bool, or
//        none).  A row's group is sum(key_k * stride_k) in int64; a row
//        outside [0, cap), or whose mask is false, adds to nothing.
// Output out (n_out, cap) int64, zeroed by the caller: out[o, g] adds the
//        values of output o over the rows of group g that the mask and o's
//        validity keep, mod 2^64 (a count adds 1 a row).
//
// Bound: device-memory bytes.  Every distinct input column is read once
// (the host passes an input that several aggregates share once); the
// output is a few KB.  Q1 at SF10 reads 2 int32 keys, the mask and 5 int64
// values: 49 bytes a row, 2.9 GB, 0.88 ms at 3.35 TB/s.  What the design
// does about it:
//
// - A thread walks many rows, 4 adjacent rows a step (grid-stride): one
//   16-byte load an int32 column, two an int64 column, 4 bytes of each
//   mask, through the read-only path.  These are predicated loads with no
//   branch around them, all issued before the first is used, so a step
//   waits on memory once (with a branch a column, each column was a trip
//   of its own: 34% of the bound against 55%).  A row count that is not a
//   multiple of 4, a base that is not 16-byte aligned, or more than two
//   keys take scalar loads of the same rows.
// - No per-row atomic where the groups are few: TPC-H Q1 has 6 groups, 4
//   live, and atomics into so few addresses serialize every warp.  With a
//   cap of at most 8 (32 with at most 2 outputs) each thread keeps its own
//   (outputs x cap) int64 sums, in shared memory: a slot a thread, so a
//   row adds to its group's slot with no atomic and no bank conflict
//   beyond the 64-bit access's two.  The kernel is templated on the bound
//   of cap and on the number of outputs, so the loads of every output are
//   unrolled.  At the end a block's threads sum the slots and the block
//   issues one 64-bit atomicAdd a (group, output).  Sums held in registers
//   instead, added to every group under a predicate, took 181-254
//   registers (8 warps an SM) and reached 55% of the bound at Q1's shape;
//   the slots take 105 registers and 24 KB a block of 64 threads and reach
//   75-85% (scripts/torch_k6_variants.py, PERF.md).
// - Larger caps, up to the callers' 4096, keep per-block sums in dynamic
//   shared memory and add each row with a shared 64-bit atomic; a row that
//   adds 0 is skipped.  Where (cap x outputs) does not fit the host splits
//   the outputs over launches (kernels/group_agg.py plan_launches).
//
// The host chooses between the two from cap and the number of outputs
// alone.  The C entry returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxKeys = 8;
constexpr int kMaxOut = 16;
constexpr int kRows = 4;            // adjacent rows a thread a step
constexpr int kLaneThreads = 64;
constexpr int kSmemThreads = 512;
constexpr int kMaxLaneSums = 64;    // outputs x cap bound of a lane kernel (32 KB of sums)

// One launch's inputs (432 bytes; kernels/group_agg.py _ARGS).
struct Args {
  const void* keys[kMaxKeys];
  long long strides[kMaxKeys];
  const void* vals[kMaxOut];        // null: a count
  const uint8_t* valid[kMaxOut];    // null: every row valid
  const uint8_t* mask;              // null: every row kept
  unsigned long long* out;          // (n_out, cap)
  long long n_rows;
  int n_keys;
  int n_out;
  int cap;
  unsigned key64;                   // bit k: key k is int64 (else int32)
  unsigned val64;                   // bit o: value o is int64 (else int32)
  int vec;                          // every base 16-byte aligned
};
static_assert(sizeof(Args) == 432, "Args must match kernels/group_agg.py _ARGS");

// 4 rows from r of an int32 or int64 column, sign-extended; rows at or past
// n read 0.
__device__ __forceinline__ void load_ints(const void* p, bool is64, long long r, long long n,
                                          bool vec, long long v[kRows]) {
  if (vec && r + kRows <= n) {
    if (is64) {
      const longlong2* q = reinterpret_cast<const longlong2*>(static_cast<const long long*>(p) + r);
      const longlong2 a = __ldg(q), b = __ldg(q + 1);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
      const int4 a = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(p) + r));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r + i < n) {
      v[i] = is64 ? __ldg(static_cast<const long long*>(p) + r + i)
                  : (long long)__ldg(static_cast<const int*>(p) + r + i);
    } else {
      v[i] = 0;
    }
  }
}

// 4 bools from r (rows at or past n read false).
__device__ __forceinline__ void load_bools(const uint8_t* p, long long r, long long n, bool vec,
                                           bool b[kRows]) {
  if (vec && r + kRows <= n) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p + r));
#pragma unroll
    for (int i = 0; i < kRows; ++i) b[i] = (w >> (8 * i)) & 0xFF;
    return;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) b[i] = r + i < n && __ldg(p + r + i);
}

// The groups of rows r .. r+3: -1 for a row that adds to nothing.  The
// mask and the keys two at a time are loaded before any is used, so that
// Q1's step waits on memory once.
__device__ __forceinline__ void row_groups(const Args& a, long long r, bool vec, int g[kRows]) {
  bool keep[kRows] = {true, true, true, true};
  if (a.mask != nullptr) load_bools(a.mask, r, a.n_rows, vec, keep);
  long long code[kRows] = {0, 0, 0, 0};
  for (int k = 0; k < a.n_keys; k += 2) {
    long long c[kRows], d[kRows] = {0, 0, 0, 0};
    load_ints(a.keys[k], (a.key64 >> k) & 1u, r, a.n_rows, vec, c);
    const bool two = k + 1 < a.n_keys;
    if (two) load_ints(a.keys[k + 1], (a.key64 >> (k + 1)) & 1u, r, a.n_rows, vec, d);
    const long long s1 = two ? a.strides[k + 1] : 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) code[i] += c[i] * a.strides[k] + d[i] * s1;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool in = keep[i] && r + i < a.n_rows && code[i] >= 0 && code[i] < a.cap;
    g[i] = in ? int(code[i]) : -1;
  }
}

// What output o adds for rows r .. r+3 (0 where its validity is false).
__device__ __forceinline__ void row_values(const Args& a, int o, long long r, bool vec,
                                           unsigned long long x[kRows]) {
  long long v[kRows] = {1, 1, 1, 1};
  if (a.vals[o] != nullptr) load_ints(a.vals[o], (a.val64 >> o) & 1u, r, a.n_rows, vec, v);
  bool ok[kRows] = {true, true, true, true};
  if (a.valid[o] != nullptr) load_bools(a.valid[o], r, a.n_rows, vec, ok);
#pragma unroll
  for (int i = 0; i < kRows; ++i) x[i] = ok[i] ? (unsigned long long)v[i] : 0ull;
}

// 16 bytes at p, or zeros where !pred.  A predicated load and no branch:
// a branch around a load makes the compiler wait for it where the paths
// join, so each column of a step would cost a trip to memory of its own.
__device__ __forceinline__ uint4 ld16(const void* p, bool pred) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "l"(p), "r"(int(pred)));
  return v;
}

__device__ __forceinline__ uint32_t ld4(const void* p, bool pred, uint32_t otherwise) {
  uint32_t v = otherwise;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.u32 %0, [%1];\n\t}"
      : "+r"(v)
      : "l"(p), "r"(int(pred)));
  return v;
}

// Rows r .. r+3 of an int32 or int64 column (16-byte aligned; null: 1s).
struct Rows4 {
  uint4 lo, hi;
};

__device__ __forceinline__ Rows4 ld_rows(const void* p, bool is64, long long r) {
  const char* base = static_cast<const char*>(p) + r * (is64 ? 8 : 4);
  return {ld16(base, p != nullptr), ld16(base + 16, p != nullptr && is64)};
}

__device__ __forceinline__ long long row_of(const Rows4& w, const void* p, bool is64, int i) {
  if (p == nullptr) return 1;
  const uint32_t l32[4] = {w.lo.x, w.lo.y, w.lo.z, w.lo.w};
  const uint32_t h32[4] = {w.hi.x, w.hi.y, w.hi.z, w.hi.w};
  const uint32_t* q = i < 2 ? l32 : h32;
  const int j = (i & 1) * 2;
  const long long wide = (long long)(((unsigned long long)q[j + 1] << 32) | q[j]);
  return is64 ? wide : (long long)(int)l32[i];
}

// A step of 4 whole rows from 16-byte aligned bases, at most 2 keys: every
// load issued before any is used.
template <int NOUT>
__device__ __forceinline__ void step_fast(const Args& a, long long r,
                                          unsigned long long x[NOUT][kRows], int grp[kRows]) {
  Rows4 vw[NOUT];
  uint32_t ok[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    vw[o] = ld_rows(a.vals[o], (a.val64 >> o) & 1u, r);
    ok[o] = ld4(a.valid[o] + r, a.valid[o] != nullptr, 0x01010101u);
  }
  const void* k0 = a.n_keys > 0 ? a.keys[0] : nullptr;
  const void* k1 = a.n_keys > 1 ? a.keys[1] : nullptr;
  const Rows4 w0 = ld_rows(k0, a.key64 & 1u, r), w1 = ld_rows(k1, (a.key64 >> 1) & 1u, r);
  const uint32_t m = ld4(a.mask + r, a.mask != nullptr, 0x01010101u);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long code = (k0 ? row_of(w0, k0, a.key64 & 1u, i) * a.strides[0] : 0) +
                           (k1 ? row_of(w1, k1, (a.key64 >> 1) & 1u, i) * a.strides[1] : 0);
    const bool in = ((m >> (8 * i)) & 0xFF) && code >= 0 && code < a.cap;
    grp[i] = in ? int(code) : -1;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      const long long v = row_of(vw[o], a.vals[o], (a.val64 >> o) & 1u, i);
      x[o][i] = ((ok[o] >> (8 * i)) & 0xFF) ? (unsigned long long)v : 0ull;
    }
  }
}

template <int CAP, int NOUT>
__global__ void __launch_bounds__(kLaneThreads)
group_agg_lanes_kernel(const __grid_constant__ Args a) {
  static_assert(CAP * NOUT <= kMaxLaneSums, "lane sums");
  // sums[o * CAP + g][t]: thread t's own sum of output o in group g
  __shared__ unsigned long long sums[NOUT * CAP][kLaneThreads];
  for (int j = 0; j < NOUT * CAP; ++j) sums[j][threadIdx.x] = 0;

  const bool vec = a.vec != 0, fast = vec && a.n_keys <= 2;
  const long long step = (long long)gridDim.x * blockDim.x * kRows;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kRows; r < a.n_rows;
       r += step) {
    unsigned long long x[NOUT][kRows];
    int grp[kRows];
    if (fast && r + kRows <= a.n_rows) {
      step_fast<NOUT>(a, r, x, grp);
    } else {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) row_values(a, o, r, vec, x[o]);
      row_groups(a, r, vec, grp);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (grp[i] >= 0) {
#pragma unroll
        for (int o = 0; o < NOUT; ++o) sums[o * CAP + grp[i]][threadIdx.x] += x[o][i];
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NOUT * CAP; j += blockDim.x) {
    const int o = j / CAP, g = j - o * CAP;
    if (g >= a.cap) continue;
    unsigned long long s = 0;
    for (int t = 0; t < kLaneThreads; ++t) s += sums[j][t];
    if (s != 0) atomicAdd(a.out + (long long)o * a.cap + g, s);
  }
}

__global__ void __launch_bounds__(kSmemThreads) group_agg_smem_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned long long sums[];  // (n_out, cap)
  const int n_sums = a.n_out * a.cap;
  for (int i = threadIdx.x; i < n_sums; i += blockDim.x) sums[i] = 0;
  __syncthreads();

  const bool vec = a.vec != 0;
  const long long step = (long long)gridDim.x * blockDim.x * kRows;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kRows; r < a.n_rows;
       r += step) {
    int grp[kRows];
    row_groups(a, r, vec, grp);
    for (int o = 0; o < a.n_out; ++o) {
      unsigned long long x[kRows];
      row_values(a, o, r, vec, x);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (grp[i] >= 0 && x[i] != 0) atomicAdd(sums + o * a.cap + grp[i], x[i]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_sums; i += blockDim.x) {
    if (sums[i] != 0) atomicAdd(a.out + i, sums[i]);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Blocks a launch over n rows: as many as stay resident on the card, fewer
// where the rows run out.
template <typename K>
int grid_for(K kernel, int threads, size_t smem, long long n_rows) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const long long needed = (n_rows + (long long)threads * kRows - 1) / ((long long)threads * kRows);
  const long long grid = needed < resident ? needed : resident;
  return int(grid > 0 ? grid : 1);
}

template <int CAP, int NOUT>
void launch_lanes(const Args& a, cudaStream_t stream) {
  static int resident = 0;  // per instantiation: the blocks the card holds
  auto kernel = group_agg_lanes_kernel<CAP, NOUT>;
  if (resident == 0) resident = grid_for(kernel, kLaneThreads, 0, 1LL << 62);
  const long long needed = (a.n_rows + kLaneThreads * kRows - 1) / (kLaneThreads * kRows);
  const int grid = int(needed < resident ? needed : resident);
  kernel<<<grid, kLaneThreads, 0, stream>>>(a);
}

template <int CAP>
int launch_lanes_n(const Args& a, cudaStream_t stream) {
  switch (a.n_out) {
#define SB_K6_CASE(N)                                                                  \
  case N:                                                                              \
    if constexpr (CAP * N <= kMaxLaneSums) { launch_lanes<CAP, N>(a, stream); return 0; } \
    break;
    SB_K6_CASE(1) SB_K6_CASE(2) SB_K6_CASE(3) SB_K6_CASE(4)
    SB_K6_CASE(5) SB_K6_CASE(6) SB_K6_CASE(7) SB_K6_CASE(8)
#undef SB_K6_CASE
    default: break;
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// mode 0: a thread's own sums, cap <= cap_bound in {8, 32}; mode 1: a
// block's sums under shared atomics.  Returns 0 or a cudaError_t.
extern "C" int sb_group_agg(const void* args, int args_size, int mode, int cap_bound,
                            void* stream) {
  if (args_size != int(sizeof(Args))) return int(cudaErrorInvalidValue);
  Args a;
  std::memcpy(&a, args, sizeof(Args));
  if (a.n_keys < 0 || a.n_keys > kMaxKeys || a.n_out < 1 || a.n_out > kMaxOut || a.cap < 1 ||
      a.n_rows < 1) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (mode == 0) {
    if (a.cap > cap_bound) return int(cudaErrorInvalidValue);
    if (cap_bound == 8) err = launch_lanes_n<8>(a, s);
    else if (cap_bound == 32) err = launch_lanes_n<32>(a, s);
    else err = int(cudaErrorInvalidValue);
  } else {
    const size_t smem = size_t(a.n_out) * a.cap * sizeof(unsigned long long);
    err = int(cudaFuncSetAttribute(group_agg_smem_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
    if (err == 0) {
      const int grid = grid_for(group_agg_smem_kernel, kSmemThreads, smem, a.n_rows);
      group_agg_smem_kernel<<<grid, kSmemThreads, smem, s>>>(a);
    }
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
