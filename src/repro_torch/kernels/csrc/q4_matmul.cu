// Q4_0 dequant-matmul for Hopper (sm_90a): y (M, N) = x (M, K) . dequant(W)^T
//
// Replaces the two Pallas TPU kernels of repro/kernels/q4_matmul.py:
//   * q4_matmul_pallas    (_kernel)    -> entry q4_matmul
//   * q4_matmul_pallas_db (_db_kernel) -> entry q4_matmul_db
// Both entries instantiate one kernel body, q4_gemv_kernel.  They differ
// only in how a lane's weight vectors arrive: straight into registers
// (q4_matmul), or through a two-slot cp.async ring in shared memory
// (q4_matmul_db, the counterpart of the TPU kernel's two-slot DMA).
//
// What bounds them.  W stays packed in HBM as Q4_0 (llama.cpp layout: one
// 32-element group = 16 bytes, byte j holds element j in its low nibble and
// element j + 16 in its high nibble, plus one f16 scale d; the element is
// (code - 8) * d).  A launch streams 0.5625 bytes per weight element and
// does 2*M f32 flops on it.  At 3.35 TB/s and 67 TFLOP/s (f32 outside the
// tensor cores), HBM bounds every shape at M <= 4 (q/k/v/o at M = 4: 2.86
// us of bytes against 2.00 us of FMAs).  The FP32 issue rate bounds every
// shape at M = 8 (q/k/v/o: 4.01 us of FMAs against 2.88 us of bytes).  So
// the kernel must keep many weight bytes in flight, read x from shared
// memory, and spend few instructions per weight element besides M FMAs.
//
// What the design does about it.
//   * x is staged in shared memory once per block: a phase of kPhase = 128
//     groups (4,096 elements) of all the block's x rows, as f32, each group
//     padded to kXGroup = 36 floats so that 8 lanes on 8 neighbouring
//     groups load 16 bytes each from 32 different banks.  K = 4096 is one
//     phase; K = 11008 is three, with one barrier each.
//   * A block is 8 warps over 32 W rows.  8 lanes share a row: lane gg
//     reads groups gg, gg + 8, ..., so a row's 8 lanes read 128 contiguous
//     bytes.  Each lane owns 4 rows, so one shared-memory load of x feeds 4
//     rows' FMAs.  A warp thus covers 16 rows; the 4 warps on the same 16
//     rows split K: chunks of 16 groups (2 per lane and row) are dealt to
//     them in turn, and their partial sums meet in shared memory.
//   * Each warp fetches its next chunk (8 loads of 16 bytes per lane) while
//     it computes the current one: into registers (q4_matmul) or into its
//     ring slot (q4_matmul_db).  That is up to 64 KB of weights in flight
//     per block, one block per SM.
//   * Dequantization costs two instructions per element and no multiply
//     by d.  The nibble stays where it is in its 16-bit half, is OR-ed into
//     the mantissa of 2^23 (one LOP3), and 2^23 + 8 * 2^s is subtracted
//     (one FADD): (code - 8) * 2^s, exactly.  The staged x carries the
//     2^-s (prescale(), exact for |x| >= 2^-114).  The scale is factored
//     out of the group: acc += d * sum_j x_j (c_j - 8).
//   * The kernel is compiled for kM = 1, 2, 4 and 8 rows of x (M rounded
//     up; a padded row is zeros and is not stored), so a launch at M = 1
//     issues a quarter of the FMAs of M = 4.
//   * Sums run in an order set by K alone: each lane adds its groups in K
//     order, a shuffle tree sums a row's 8 lanes, the 4 slices are added
//     in order.  Neither the entry, bk, M nor the rows beside a row change
//     it, so q4_matmul and q4_matmul_db are bitwise equal at every shape,
//     and an eager shard equals the same rows of one launch.
//   * No dense weight exists in any memory.  Rows past N load nothing and
//     store nothing, groups past K are skipped, x rows past M are zeros
//     (grid.y covers M in tiles of 8), and y's row stride ldy is honoured.
//
// bk, the Pallas kernels' K tile, is validated (32 * 2^i <= 1024, dividing
// K) and otherwise unused.  Times against the bounds: PERF.md.
//
// Launch: grid (ceil(N / 32), ceil(M / 8)), 256 threads, dynamic shared
// memory for the x phase (and the db ring).  The kernels allocate nothing
// and run on the stream they are given.  The C entries return
// cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerRow = 8;    // lanes sharing a W row (one group each)
constexpr int kRowsPerLane = 4;    // W rows per lane, sharing each x load
constexpr int kRowsPerWarp = 32 / kLanesPerRow * kRowsPerLane;  // 16
constexpr int kRows = 2 * kRowsPerWarp;  // W rows per block: two warp rows
constexpr int kSlices = 4;               // warps sharing a warp row's K
constexpr int kWarps = 2 * kSlices;
constexpr int kThreads = 32 * kWarps;
constexpr int kPhase = 128;        // groups of x staged at once
constexpr int kSteps = 2;          // groups per lane and row in a chunk
constexpr int kChunk = kSteps * kLanesPerRow;  // groups per chunk
constexpr int kPhaseChunks = kPhase / kChunk;
constexpr int kMTile = 8;          // x rows per block, at most
constexpr int kXGroup = 36;        // staged floats per group (32 + padding)
constexpr int kXRow = kPhase * kXGroup;  // staged floats per x row
constexpr size_t kRingBytes =
    2 * sizeof(uint4) * kSteps * kRowsPerLane * kThreads;
static_assert(kPhaseChunks % kSlices == 0, "whole chunks per warp and phase");

__device__ __forceinline__ void store_y(float* y, float v) { *y = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// Element j of a staged group is x_j * 2^-s_j, where s_j is the bit at
// which code() finds its nibble: 0 or 8 in the low plane (j < 16, even or
// odd j), 4 or 12 in the high plane.  A power of two, so exact (for
// |x| >= 2^-114).
__device__ __forceinline__ float4 prescale(float4 v, bool high) {
  const float e = high ? 0.0625f : 1.f;                  // 2^-4 or 1
  const float o = high ? 0.000244140625f : 0.00390625f;  // 2^-12 or 2^-8
  return make_float4(v.x * e, v.y * o, v.z * e, v.w * o);
}

// The four bf16 in words a, b (low half first) as floats.
__device__ __forceinline__ float4 bf16x4(unsigned a, unsigned b) {
  return make_float4(__uint_as_float(a << 16),
                     __uint_as_float(a & 0xFFFF0000u),
                     __uint_as_float(b << 16),
                     __uint_as_float(b & 0xFFFF0000u));
}

// Stage groups [g0, g0 + kPhase) of x rows [m0, m0 + mc), prescaled f32,
// into xs [kM][kPhase][kXGroup]; groups past G and rows [mc, kM) are zeros.
template <int kM, typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int K,
                                        int m0, int mc, int g0, float* xs) {
  constexpr int kPerGroup = sizeof(T) * 32 / 16;  // 16-byte vectors per group
  constexpr int kTotal = kM * kPhase * kPerGroup;
  static_assert(kTotal % kThreads == 0, "whole vectors per thread");
  // thread t takes vector t % kPerGroup of staged groups t / kPerGroup +
  // k * kStride, k = 0, 1, ...: row k / kPerRow, group k % kPerRow * kStride
  constexpr int kStride = kThreads / kPerGroup;
  constexpr int kPerRow = kPhase / kStride;
  static_assert(kPhase % kStride == 0, "whole rows per thread");
  constexpr int kBatch = kTotal / kThreads < 8 ? kTotal / kThreads : 8;
  const int G = K / 32;
  const int e = threadIdx.x % kPerGroup * (32 / kPerGroup);  // first element
  const int lg0 = threadIdx.x / kPerGroup;
  const uint4* src = reinterpret_cast<const uint4*>(
                         x + static_cast<size_t>(m0) * K) +
                     (g0 + lg0) * kPerGroup + threadIdx.x % kPerGroup;
  float* dst0 = xs + lg0 * kXGroup + e;
#pragma unroll
  for (int k0 = 0; k0 < kTotal / kThreads; k0 += kBatch) {
    uint4 v[kBatch];  // loads in flight together
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int m = (k0 + k) / kPerRow;
      const int lg = (k0 + k) % kPerRow * kStride;
      v[k] = m < mc && g0 + lg0 + lg < G
                 ? __ldg(src + m * (K / 32 * kPerGroup) + lg * kPerGroup)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int m = (k0 + k) / kPerRow;
      const int lg = (k0 + k) % kPerRow * kStride;
      float* dst = dst0 + m * kXRow + lg * kXGroup;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = prescale(
            make_float4(__uint_as_float(v[k].x), __uint_as_float(v[k].y),
                        __uint_as_float(v[k].z), __uint_as_float(v[k].w)),
            e >= 16);
      } else {
        *reinterpret_cast<float4*>(dst) =
            prescale(bf16x4(v[k].x, v[k].y), e >= 16);
        *reinterpret_cast<float4*>(dst + 4) =
            prescale(bf16x4(v[k].z, v[k].w), e >= 16);
      }
    }
  }
}

// (code - 8) * 2^S of the nibble at bits S..S+3 of w, exactly: the nibble,
// left in place, is OR-ed into the mantissa of 2^23 and 2^23 + 8 * 2^S is
// subtracted (two instructions; the 2^-S is in the staged x).
template <int S>
__device__ __forceinline__ float code(unsigned w) {
  unsigned v;  // (w & mask) | magic in one LOP3
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(v)
      : "r"(w), "n"(0xFu << S), "r"(0x4B000000u));
  return __uint_as_float(v) - (8388608.0f + 8.0f * (1 << S));
}

// The shared routine: the Q4_0 groups q[r] (16 packed bytes, scale d[r]) of
// kRowsPerLane W rows at one K position, against the staged x group xg of
// kM x rows: acc[r][m] += d[r] * sum_{j = 0..31} x[m][j] * (c[r]_j - 8),
// j in order.  Each x load serves every row.
template <int kM>
__device__ __forceinline__ void group_dot(const uint4 (&q)[kRowsPerLane],
                                          const float (&d)[kRowsPerLane],
                                          const float* xg,
                                          float (&acc)[kRowsPerLane][kM]) {
  constexpr int R = kRowsPerLane;
  float s[R][kM];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < kM; ++m) s[r][m] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // elements 4i..4i+3: low plane, then high
    float c[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned words[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
      const unsigned a = words[i & 3];  // bytes 0, 1 at bits 0..15
      const unsigned b = a >> 16;       // bytes 2, 3
      if (i < 4) {
        c[r][0] = code<0>(a); c[r][1] = code<8>(a);
        c[r][2] = code<0>(b); c[r][3] = code<8>(b);
      } else {
        c[r][0] = code<4>(a); c[r][1] = code<12>(a);
        c[r][2] = code<4>(b); c[r][3] = code<12>(b);
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float4 v =
          *reinterpret_cast<const float4*>(xg + m * kXRow + 4 * i);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][m] = fmaf(v.x, c[r][0], s[r][m]);
        s[r][m] = fmaf(v.y, c[r][1], s[r][m]);
        s[r][m] = fmaf(v.z, c[r][2], s[r][m]);
        s[r][m] = fmaf(v.w, c[r][3], s[r][m]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[r][m] = fmaf(d[r], s[r][m], acc[r][m]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One body for both entries (kDb: weights through the cp.async ring).
template <typename T, bool kDb, int kM>
__global__ void __launch_bounds__(kThreads, 1)
q4_gemv_kernel(const T* __restrict__ x, const uint4* __restrict__ packed,
               const unsigned short* __restrict__ scales, T* __restrict__ y,
               int M, int N, int K, int ldy) {
  constexpr int R = kRowsPerLane;
  // db: the ring [slot][row][thread] of each thread's own 16-byte vectors,
  // then the x phase; direct: the x phase alone
  extern __shared__ __align__(16) float smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* xs = smem + (kDb ? kRingBytes / sizeof(float) : 0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gg = lane % kLanesPerRow;
  const int ks = warp >> 1;  // the warp's K slice: chunks ks, ks + kSlices, ...
  // row r of the lane within the block: row0 + 4 * r
  const int row0 = (warp & 1) * kRowsPerWarp + lane / kLanesPerRow;
  const int m0 = blockIdx.y * kMTile;
  const int mc = min(kMTile, M - m0);
  const int G = K / 32;                                // groups per row
  const int chunks = (G + kChunk - 1) / kChunk;
  const int n0 = blockIdx.x * kRows + row0;
  // the lane's rows n0 + 4r, at its first group gg
  const uint4* wp[R];
  const unsigned short* sp[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live[r] = n0 + 4 * r < N;
    const size_t o = static_cast<size_t>(live[r] ? n0 + 4 * r : 0) * G + gg;
    wp[r] = packed + o;
    sp[r] = scales + o;
  }

  // Fetch chunk j (groups kChunk * j + 8u + gg of each of the lane's
  // rows), the t-th of the warp: the scales into d, the codes into q
  // (direct) or into ring slot t & 1 (db).
  auto fetch = [&](int j, int t, uint4 (&q)[kSteps][R],
                   float (&d)[kSteps][R]) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int g = j * kChunk + u * kLanesPerRow;  // minus gg
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool ok = live[r] && g + gg < G;
        d[u][r] = ok ? __half2float(__ushort_as_half(__ldg(sp[r] + g))) : 0.f;
        if constexpr (kDb)
          cp_async16(ring + (((t & 1) * kSteps + u) * R + r) * kThreads +
                         threadIdx.x,
                     wp[r] + (ok ? g : 0), ok);
        else
          q[u][r] = ok ? __ldg(wp[r] + g) : make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (kDb) cp_async_commit();
  };

  float acc[R][kM];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[r][m] = 0.f;

  uint4 q[kSteps][R], qn[kSteps][R];
  float d[kSteps][R], dn[kSteps][R];
  if (ks < chunks) fetch(ks, 0, qn, dn);
  int t = 0;  // chunks of this warp so far
  for (int g0 = 0; g0 < G; g0 += kPhase) {
    if (g0 > 0) __syncthreads();  // every warp is done with the last phase
    stage_x<kM>(x, K, m0, mc, g0, xs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPhaseChunks / kSlices; ++i, ++t) {
      const int j = g0 / kChunk + i * kSlices + ks;
      if (j >= chunks) break;
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if constexpr (!kDb) q[u][r] = qn[u][r];
          d[u][r] = dn[u][r];
        }
      const bool more = j + kSlices < chunks;
      if (more) fetch(j + kSlices, t + 1, qn, dn);  // the next chunk in flight
      if constexpr (kDb) {
        if (more)
          cp_async_wait<1>();  // chunk j has landed
        else
          cp_async_wait<0>();
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int g = j * kChunk + u * kLanesPerRow + gg;
        if (g < G) {
          if constexpr (kDb) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              q[u][r] = ring[(((t & 1) * kSteps + u) * R + r) * kThreads +
                             threadIdx.x];
          }
          group_dot<kM>(q[u], d[u], xs + (g - g0) * kXGroup, acc);
        }
      }
    }
  }

  // Sum the 8 lanes of each row, then the slices in order, and store.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
  __syncthreads();   // every warp is done with xs
  float* part = xs;  // [slice][m][row of the block]
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < kM; ++m)
      if (gg == m % kLanesPerRow)
        part[(ks * kM + m) * kRows + row0 + 4 * r] = acc[r][m];
  __syncthreads();
  for (int i = threadIdx.x; i < mc * kRows; i += kThreads) {
    const int m = i / kRows;
    const int r = i % kRows;
    float v = part[m * kRows + r];
#pragma unroll
    for (int s = 1; s < kSlices; ++s) v += part[(s * kM + m) * kRows + r];
    const int n = blockIdx.x * kRows + r;
    if (n < N) store_y(y + static_cast<size_t>(m0 + m) * ldy + n, v);
  }
}

template <typename T, bool kDb, int kM>
cudaError_t launch(const void* x, const void* packed, const void* scales,
                   void* y, int M, int N, int K, int ldy,
                   cudaStream_t stream) {
  constexpr size_t kBytes =
      (kDb ? kRingBytes : 0) + sizeof(float) * kM * kXRow;
  static_assert(kSlices * kM * kRows <= kM * kXRow, "partials fit in xs");
  // once per kernel: allow the dynamic shared memory it takes
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        q4_gemv_kernel<T, kDb, kM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    cudaGetLastError();  // reported through attr, not to a later launch
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kRows - 1) / kRows, (M + kMTile - 1) / kMTile);
  q4_gemv_kernel<T, kDb, kM><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const uint4*>(packed),
      static_cast<const unsigned short*>(scales), static_cast<T*>(y), M, N, K,
      ldy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_rows(int db, int mt, const void* x, const void* packed,
                    const void* scales, void* y, int M, int N, int K, int ldy,
                    cudaStream_t s) {
#define Q4_LAUNCH(DB, MT) \
  launch<T, DB, MT>(x, packed, scales, y, M, N, K, ldy, s)
  switch (mt) {
    case 1: return db ? Q4_LAUNCH(true, 1) : Q4_LAUNCH(false, 1);
    case 2: return db ? Q4_LAUNCH(true, 2) : Q4_LAUNCH(false, 2);
    case 4: return db ? Q4_LAUNCH(true, 4) : Q4_LAUNCH(false, 4);
    default: return db ? Q4_LAUNCH(true, 8) : Q4_LAUNCH(false, 8);
  }
#undef Q4_LAUNCH
}

int dispatch(int db, int x_bf16, const void* x, const void* packed,
             const void* scales, void* y, int M, int N, int K, int bk,
             int ldy, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || bk < 32 || bk % 32 ||
      K % bk || ldy < N || (M + kMTile - 1) / kMTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = bk / 32;
  if (G > 32 || (G & (G - 1))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the x rows of a block, rounded up to 1, 2, 4 or 8 (a padded row is
  // zeros and is not stored; each row's sums are the same whatever kM)
  const int mt = M > 4 ? 8 : M > 2 ? 4 : M;
  return static_cast<int>(
      x_bf16 ? by_rows<__nv_bfloat16>(db, mt, x, packed, scales, y, M, N, K,
                                      ldy, s)
             : by_rows<float>(db, mt, x, packed, scales, y, M, N, K, ldy, s));
}

}  // namespace

extern "C" {

// x: (M, K) f32 or bf16 (x_bf16 = 1); packed: u8 (N, K/2); scales: f16
// (N, K/32); y: (M, N) in x's type with rows ldy >= N elements apart (a
// column slice of a wider output when ldy > N).  All row-major, the inputs
// contiguous, x and packed 16-byte aligned.  Returns the cudaError_t of the
// launch.
int q4_matmul(int x_bf16, const void* x, const void* packed,
              const void* scales, void* y, int M, int N, int K, int bk,
              int ldy, void* stream) {
  return dispatch(0, x_bf16, x, packed, scales, y, M, N, K, bk, ldy, stream);
}

int q4_matmul_db(int x_bf16, const void* x, const void* packed,
                 const void* scales, void* y, int M, int N, int K, int bk,
                 int ldy, void* stream) {
  return dispatch(1, x_bf16, x, packed, scales, y, M, N, K, bk, ldy, stream);
}

}  // extern "C"
