// Q4_0 dequant-matmul for Hopper (sm_90a): y (M, N) = x (M, K) . dequant(W)^T
//
// Replaces the two Pallas TPU kernels of repro/kernels/q4_matmul.py:
//   * q4_matmul_pallas    (_kernel)    -> entry q4_matmul
//   * q4_matmul_pallas_db (_db_kernel) -> entry q4_matmul_db
// W stays packed in HBM as Q4_0 (llama.cpp layout: one 32-element group =
// 16 bytes, byte j holds element j in its low nibble and element j + 16 in
// its high nibble, plus one f16 scale d; the element is (code - 8) * d).  A
// launch streams 0.5625 bytes per weight element.  x's type picks the body,
// the same for both entries:
//   * f32 x: q4_gemv_kernel, f32 FMAs outside the tensor cores;
//   * bf16 x: q4_mma_kernel, bf16 products on the tensor cores.
// Each body sums an output element in an order set by K alone, so the two
// entries are bitwise equal, an eager shard (out= with ldy > N) equals the
// same columns of one launch, and row i of a launch equals a launch of row
// i alone.
//
// q4_gemv_kernel (f32 x).  It does 2*M f32 flops per weight element.  At
// 3.35 TB/s and 67 TFLOP/s (f32 outside the tensor cores), HBM bounds every
// shape at M <= 4 (q/k/v/o at M = 4: 2.86 us of bytes against 2.00 us of
// FMAs).  The FP32 issue rate bounds every shape at M = 8 (q/k/v/o: 4.01 us
// of FMAs against 2.88 us of bytes).  So the kernel must keep many weight
// bytes in flight, read x from shared memory, and spend few instructions
// per weight element besides M FMAs.  The two entries differ only in how a
// lane's weight vectors arrive: straight into registers (q4_matmul), or
// through a two-slot cp.async ring in shared memory (q4_matmul_db, the
// counterpart of the TPU kernel's two-slot DMA).
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
//     in order.
//   * No dense weight exists in any memory.  Rows past N load nothing and
//     store nothing, groups past K are skipped, x rows past M are zeros
//     (grid.y covers M in tiles of 8), and y's row stride ldy is honoured.
//   Launch: grid (ceil(N / 32), ceil(M / 8)), 256 threads, dynamic shared
//   memory for the x phase (and the db ring).
//
// q4_mma_kernel (bf16 x).  The SIMT body streams W once per 8 x rows and
// issues 2*M FMAs per weight element, so at long decode's M = 32 it reads
// W four times and FP32 issue, not HBM, bounds it.  On the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums) the products leave the FMA pipes
// and W is streamed once for every 64 x rows.
//   * W is the A operand (16 W rows an MMA tile), x^T the B operand (8 x
//     rows an n-tile).  A warp owns 16 W rows (an A tile), every x row of
//     the block (kNT n-tiles of 8, kNT = 1, 2, 4 or 8 by M, so a row's
//     products do not depend on kNT) and half of every stage's groups (its
//     K slice); a block is 2, 4 or 8 warp rows of 2 slices.
//   * The arithmetic of the SIMT body, in another order: a code c - 8 is
//     exact in bf16 (the nibble is OR-ed into the mantissa of 128.0, one
//     LOP3, and 136 subtracted, one bf16x2 FMA; two codes a register),
//     each product x * (c - 8) is exact in f32, the tensor cores sum a
//     group's 32 products in f32 from zero (two MMAs), and the f32 sum
//     takes acc = fmaf(d, group sum, acc), a slice's groups in K order.
//     Nothing is held in fewer bits than x and W are stored in.
//   * The order of an element's sum is set by K alone: K is cut into P
//     parts (P = 4 from 128 groups, 2 from 64, else 1), each part's two
//     slices are summed from zero, and the element is T0 + T1 with
//     Tq = ((s0q + s1q) + s2q) + s3q over the parts.  A launch runs every
//     part in one block (the slice totals kept in shared memory), or each
//     part in its own block of a thread block cluster of P, whose blocks
//     add the parts' sums through distributed shared memory after a
//     cluster barrier: the same operations either way.  So K is split
//     across SMs inside the one launch where N is small, with no scratch
//     in device memory, no counter and no second kernel.
//   * A ring of stages in shared memory, filled by cp.async (16 bytes a
//     thread, zero-filled past N, M and the block's groups): a stage holds
//     8 groups of the block's W rows, their scales and all its x rows.
//     Of the shapes (128 W rows a block, alone on K), (64, alone),
//     (128, cluster), (64, cluster), (32, alone), (32, cluster) the launch
//     takes the first that gives every SM a block.  Two blocks of 128 rows
//     fit an SM at every kNT but 8.  A whole stage's groups run with no
//     branch between them.
//   * Shared-memory layouts keep every load free of bank conflicts and
//     its address a constant offset: a W row's 8 pieces (16 bytes: a
//     row's group) lie in 9 slots; x rows' 16-byte chunks are XOR-ed by
//     the row; x fragments come by ldmatrix, W codes by two 32-bit loads a
//     row and group, each scale by one 16-bit load.
//   * y is written from the f32 sum: rounded once to bf16, or as f32 (the
//     LM head's logits).
//   Launch: grid (1 or P, ceil(M / (8 kNT)), ceil(N / rows)), clusters of
//   (1 or P, 1, 1), 4 * rows threads, dynamic shared memory for the ring
//   and the slice totals.
//
// bk, the Pallas kernels' K tile, is validated (32 * 2^i <= 1024, dividing
// K) and otherwise unused.  Times against the bounds: PERF.md.  The kernels
// allocate nothing and run on the stream they are given.  The C entries
// return the launch's cudaError_t.

#include <cooperative_groups.h>
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

cudaError_t by_rows(int db, int mt, const void* x, const void* packed,
                    const void* scales, void* y, int M, int N, int K, int ldy,
                    cudaStream_t s) {
#define Q4_LAUNCH(DB, MT) \
  launch<float, DB, MT>(x, packed, scales, y, M, N, K, ldy, s)
  switch (mt) {
    case 1: return db ? Q4_LAUNCH(true, 1) : Q4_LAUNCH(false, 1);
    case 2: return db ? Q4_LAUNCH(true, 2) : Q4_LAUNCH(false, 2);
    case 4: return db ? Q4_LAUNCH(true, 4) : Q4_LAUNCH(false, 4);
    default: return db ? Q4_LAUNCH(true, 8) : Q4_LAUNCH(false, 8);
  }
#undef Q4_LAUNCH
}

// ------------------------------------------- the tensor-core body (bf16) --
namespace cg = cooperative_groups;

constexpr int kTcGroups = 8;     // groups of K a ring stage holds
constexpr int kTcSlices = 2;     // warps sharing a stage's groups (K)
constexpr int kTcWarpRows = 16;  // W rows a warp owns: an MMA A tile
constexpr int kTcMaxRows = 128;  // W rows a block owns, at most
constexpr int kTcThreads = kTcMaxRows / kTcWarpRows * kTcSlices * 32;
constexpr int kTcWindows = kTcGroups / 8 + 1;  // 16-byte scale windows
constexpr int kTcWBytes = (kTcGroups + 1 + kTcWindows) * 16;  // a W row's
constexpr int kTcXBytes = kTcGroups * 64;                      // an x row's
constexpr int kTcBudget = 112 * 1024;  // ring and totals: two blocks an SM
// launch shapes in order of preference: (W rows a block, K parts across a
// cluster)
constexpr int kTcShapes[][2] = {{128, 0}, {64, 0}, {128, 1},
                                {64, 1},  {32, 0}, {32, 1}};

__host__ __device__ constexpr int tc_stage_bytes(int rows, int xrows) {
  return rows * kTcWBytes + xrows * kTcXBytes;
}

// Ring stages by n-tiles: as many as kTcBudget holds beside the sums of a
// block of kTcMaxRows rows, 2 to 6.
__host__ __device__ constexpr int tc_stages(int nt) {
  const int n = (kTcBudget - kTcSlices * 8 * nt * kTcMaxRows * 4) /
                tc_stage_bytes(kTcMaxRows, 8 * nt);
  return n < 2 ? 2 : n > 6 ? 6 : n;
}

// A block's shared memory: the ring, then its slices' sums.
__host__ __device__ constexpr int tc_smem_bytes(int nt, int rows) {
  return tc_stages(nt) * tc_stage_bytes(rows, 8 * nt) +
         kTcSlices * 8 * nt * rows * 4;
}

// Parts of K, each summed from zero and added in order: set by K alone.
__host__ __device__ constexpr int tc_parts(int groups) {
  return groups >= 128 ? 4 : groups >= 64 ? 2 : 1;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two codes as bf16x2 c - 8, exactly: p holds a code byte's nibble at bits
// 0..3 and another at bits 16..19; each is OR-ed into 128.0 (0x4300; the
// mantissa's unit there is 1) and 136 is subtracted.
__device__ __forceinline__ unsigned codes_bf16x2(unsigned p) {
  unsigned v, d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(v)
      : "r"(p), "n"(0x000F000Fu), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));  // v * 1 - 136
  return d;
}

// d = a . b + c on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// C and D 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// y = x . dequant(W)^T for bf16 x, y bf16 or f32 (TY), kNT n-tiles of 8 x
// rows a block.  Block (rank, m tile, n tile) of a cluster of 1 or P;
// 16 W rows a warp row; warp (row w, slice q) takes groups [4q, 4q + 4) of
// every stage.  Stage layout: W pieces [row][9 slots], scales [row][16-byte
// windows], x [group][x row][16-byte chunk ^ x row].
template <int kNT, typename TY>
__global__ void __launch_bounds__(kTcThreads)
q4_mma_kernel(const __nv_bfloat16* __restrict__ x,
              const uint4* __restrict__ packed,
              const unsigned short* __restrict__ scales, TY* __restrict__ y,
              int M, int N, int K, int ldy) {
  constexpr int kMT = 8 * kNT;
  constexpr int kS = tc_stages(kNT);
  constexpr int kC = kTcGroups;
  constexpr int kQ = kTcSlices;
  constexpr int kCq = kC / kQ;  // groups of a stage per slice
  constexpr int kWin = kTcWindows;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());  // 1 or P
  const int rank = static_cast<int>(cluster.block_rank());
  const int threads = blockDim.x;
  const int rows = threads / (32 * kQ) * kTcWarpRows;  // W rows of the block
  const int tid = threadIdx.x;
  const int stage = tc_stage_bytes(rows, kMT);
  const int G = K / 32;
  // K's parts: plen groups each (whole stages); this block's groups
  // [gbeg, gend) are its rank's part, or every part when it is alone
  const int parts = tc_parts(G);
  const int plen = ((G + parts - 1) / parts + kC - 1) / kC * kC;
  const int gbeg = ranks == 1 ? 0 : min(G, rank * plen);
  const int gend = ranks == 1 ? G : min(G, gbeg + plen);
  const int chunks = (gend - gbeg + kC - 1) / kC;
  const int m0 = blockIdx.y * kMT;
  const int n0 = blockIdx.z * rows;
  // scales in halves from a 16-byte aligned base (a row shard's scales may
  // start anywhere)
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(scales) & 15) >> 1);
  const unsigned short* sal = scales - mis;
  auto scale_at = [&](int n, int g0) {  // half index of (row n, group g0)
    return static_cast<size_t>(mis) +
           static_cast<size_t>(n < N ? n : 0) * G + g0;
  };

  auto load = [&](int j) {
    unsigned char* st = tc_smem + (j % kS) * stage;
    uint4* ws = reinterpret_cast<uint4*>(st);
    uint4* ss = reinterpret_cast<uint4*>(st + rows * (kC + 1) * 16);
    unsigned char* xs = st + rows * kTcWBytes;
    const int g0 = gbeg + j * kC;
    const int ng = min(kC, gend - g0);
    for (int i = tid; i < rows * kC; i += threads) {
      const int r = i / kC, gi = i % kC;  // a row's groups: contiguous
      const int n = n0 + r;
      const bool ok = n < N && gi < ng;
      cp_async16(ws + r * (kC + 1) + gi,
                 packed + (ok ? static_cast<size_t>(n) * G + g0 + gi : 0),
                 ok);
    }
    for (int i = tid; i < rows * kWin; i += threads) {
      const int r = i / kWin, w = i % kWin;
      const size_t h = scale_at(n0 + r, g0);
      // a window only where the stage's scales reach into it
      const bool ok = n0 + r < N && (w == 0 || int(h & 7) + ng > 8 * w);
      cp_async16(ss + i, sal + (h & ~size_t{7}) + 8 * w, ok);
    }
    for (int i = tid; i < kMT * kC * 4; i += threads) {
      const int c = i & 3, m = (i >> 2) % kMT, gi = (i >> 2) / kMT;
      const bool ok = m0 + m < M && gi < ng;
      cp_async16(xs + (gi * kMT + m) * 64 + ((c ^ ((m >> 1) & 3)) << 4),
                 x + (ok ? static_cast<size_t>(m0 + m) * K +
                               static_cast<size_t>(g0 + gi) * 32 + 8 * c
                         : 0),
                 ok);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp % (rows / kTcWarpRows) * kTcWarpRows;  // first row
  const int q = warp / (rows / kTcWarpRows);                 // slice
  const int g = lane >> 2, t = lane & 3;
  // thread t's codes: bytes 2t, 2t+1 and 2t+8, 2t+9 of a row's group,
  // half t & 1 of words t / 2 and t / 2 + 2
  const unsigned sel = (t & 1) ? 0x4342u : 0x4140u;
  // ldmatrix row address: matrix lane / 8 (8 elements), row lane % 8
  const int xoff = (lane & 7) * 64 + (((lane >> 3) ^ ((lane >> 1) & 3)) << 4);

  // acc: the current part's sums, from zero; sums: the parts so far, in
  // order (((p0 + p1) + p2) + p3), [slice][x row][W row] behind the ring
  float acc[kNT][4];
  float* sums = reinterpret_cast<float*>(tc_smem + kS * stage);
  auto close_part = [&](bool first) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& u = sums[(q * kMT + nt * 8 + 2 * t + (e & 1)) * rows + wr + g +
                        8 * (e >> 1)];
        u = first ? acc[nt][e] : u + acc[nt][e];
        acc[nt][e] = 0.f;
      }
  };
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  // acc += the products of stage group gi: ws is the thread's first W
  // piece word, sp[h] its rows' scales (rows g and g + 8 of the warp's)
  auto group = [&](const unsigned* ws, const unsigned short* const (&sp)[2],
                   unsigned xs, int gi) {
    unsigned b[kNT][4];  // x: elements 0-15 (b[0], b[1]), 16-31 (b[2], b[3])
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      ldsm_x4(b[nt], xs + (gi * kMT + nt * 8) * 64);
    unsigned lo[4], hi[4];  // A fragments of elements 0-15 and 16-31
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned* w = ws + (h * 8 * (kC + 1) + gi) * 4;
      const unsigned p0 = __byte_perm(w[0], 0, sel);
      const unsigned p2 = __byte_perm(w[2], 0, sel);
      lo[h] = codes_bf16x2(p0);
      lo[h + 2] = codes_bf16x2(p2);
      hi[h] = codes_bf16x2(p0 >> 4);
      hi[h + 2] = codes_bf16x2(p2 >> 4);
    }
    const float d0 = __half2float(__ushort_as_half(sp[0][gi]));
    const float d1 = __half2float(__ushort_as_half(sp[1][gi]));
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float s[4];
      mma_bf16(s, lo, b[nt][0], b[nt][1], zero);
      mma_bf16(s, hi, b[nt][2], b[nt][3], s);
      acc[nt][0] = fmaf(d0, s[0], acc[nt][0]);
      acc[nt][1] = fmaf(d0, s[1], acc[nt][1]);
      acc[nt][2] = fmaf(d1, s[2], acc[nt][2]);
      acc[nt][3] = fmaf(d1, s[3], acc[nt][3]);
    }
  };

#pragma unroll
  for (int j = 0; j < kS - 1; ++j) {
    if (j < chunks) load(j);
    cp_async_commit();
  }
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kS - 2>();  // chunk j has landed
    __syncthreads();          // and every warp is done with chunk j - 1
    if (j + kS - 1 < chunks) load(j + kS - 1);
    cp_async_commit();
    const unsigned char* st = tc_smem + (j % kS) * stage;
    // the thread's words: half t & 1 of words t / 2 and t / 2 + 2 of its
    // rows' pieces, rows wr + g and wr + g + 8
    const unsigned* ws = reinterpret_cast<const unsigned*>(st) +
                         (wr + g) * (kC + 1) * 4 + (t >> 1);
    const unsigned short* ss =
        reinterpret_cast<const unsigned short*>(st + rows * (kC + 1) * 16);
    const unsigned xs = smem_u32(st + rows * kTcWBytes) + xoff;
    const int g0 = gbeg + j * kC;
    const int ng = min(kC, gend - g0);
    if (j > 0 && g0 % plen == 0) close_part(g0 == plen);
    const unsigned short* sp[2];  // the thread's rows' scales
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + h * 8 + g;
      sp[h] = ss + r * kWin * 8 + static_cast<int>(scale_at(n0 + r, g0) & 7);
    }
    if (ng == kC) {  // a whole stage: no branch between the groups
#pragma unroll
      for (int u = 0; u < kCq; ++u) group(ws, sp, xs, q * kCq + u);
    } else {
#pragma unroll
      for (int u = 0; u < kCq; ++u)
        if (q * kCq + u < ng) group(ws, sp, xs, q * kCq + u);
    }
  }
  close_part(ranks > 1 || gbeg + chunks * kC <= plen);
  cp_async_wait<0>();

  // Each block of the cluster adds a share of the tile's outputs: per slice
  // the parts in order, then the slices in order.
  cluster.sync();
  for (int i = rank * threads + tid; i < kMT * rows; i += ranks * threads) {
    const int m = i / rows, r = i % rows;
    if (m0 + m >= M || n0 + r >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      float vu = cluster.map_shared_rank(sums, 0)[u * kMT * rows + i];
      for (int c = 1; c < ranks; ++c)
        vu += cluster.map_shared_rank(sums, c)[u * kMT * rows + i];
      v = u == 0 ? vu : v + vu;
    }
    store_y(y + static_cast<size_t>(m0 + m) * ldy + n0 + r, v);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    cudaGetLastError();
    return v;
  }();
  return n;
}

template <int kNT, typename TY>
cudaError_t tc_launch(const void* x, const void* packed, const void* scales,
                      void* y, int M, int N, int K, int ldy,
                      cudaStream_t stream) {
  constexpr int kMT = 8 * kNT;
  constexpr int kMaxRows = kTcMaxRows;
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        q4_mma_kernel<kNT, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc_smem_bytes(kNT, kMaxRows));
    cudaGetLastError();  // reported through attr, not to a later launch
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int parts = tc_parts(K / 32);
  const int mtiles = (M + kMT - 1) / kMT;
  // The launch's shape, the first of kTcShapes that gives every SM a block:
  // W rows a block, and each block alone on all of K (split 0) or the P
  // blocks of a cluster on one part each (split 1).
  int rows = kTcWarpRows, ranks = parts;
  for (const auto& sh : kTcShapes) {
    const int r = sh[0], c = sh[1] ? parts : 1;
    if (r > kMaxRows) continue;
    if (static_cast<long>((N + r - 1) / r) * mtiles * c >= sm_count()) {
      rows = r;
      ranks = c;
      break;
    }
  }
  const int ntiles = (N + rows - 1) / rows;
  if (mtiles > 65535 || ntiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, mtiles, ntiles);
  cfg.blockDim = dim3(rows / kTcWarpRows * kTcSlices * 32);
  cfg.dynamicSmemBytes = tc_smem_bytes(kNT, rows);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ranks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, q4_mma_kernel<kNT, TY>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint4*>(packed),
      static_cast<const unsigned short*>(scales), static_cast<TY*>(y), M, N,
      K, ldy);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename TY>
cudaError_t by_tiles(const void* x, const void* packed, const void* scales,
                     void* y, int M, int N, int K, int ldy, cudaStream_t s) {
  // kNT n-tiles of 8 x rows (a padded row is zeros and is not stored; each
  // row's sums are the same whatever kNT)
  const int nt = M > 32 ? 8 : M > 16 ? 4 : M > 8 ? 2 : 1;
  switch (nt) {
    case 1: return tc_launch<1, TY>(x, packed, scales, y, M, N, K, ldy, s);
    case 2: return tc_launch<2, TY>(x, packed, scales, y, M, N, K, ldy, s);
    case 4: return tc_launch<4, TY>(x, packed, scales, y, M, N, K, ldy, s);
    default: return tc_launch<8, TY>(x, packed, scales, y, M, N, K, ldy, s);
  }
}

// types: 0 f32 x and y (the SIMT body), 1 bf16 x and y, 2 bf16 x and f32 y
// (the tensor-core body, at every M and for both entries)
int dispatch(int db, int types, const void* x, const void* packed,
             const void* scales, void* y, int M, int N, int K, int bk,
             int ldy, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || bk < 32 || bk % 32 ||
      K % bk || ldy < N || (M + kMTile - 1) / kMTile > 65535 || types < 0 ||
      types > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = bk / 32;
  if (G > 32 || (G & (G - 1))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 1)
    return static_cast<int>(
        by_tiles<__nv_bfloat16>(x, packed, scales, y, M, N, K, ldy, s));
  if (types == 2)
    return static_cast<int>(
        by_tiles<float>(x, packed, scales, y, M, N, K, ldy, s));
  // the x rows of a block, rounded up to 1, 2, 4 or 8 (a padded row is
  // zeros and is not stored; each row's sums are the same whatever kM)
  const int mt = M > 4 ? 8 : M > 2 ? 4 : M;
  return static_cast<int>(
      by_rows(db, mt, x, packed, scales, y, M, N, K, ldy, s));
}

}  // namespace

extern "C" {

// x: (M, K) f32 (types 0) or bf16 (types 1, 2); packed: u8 (N, K/2);
// scales: f16 (N, K/32); y: (M, N), f32 (types 0, 2) or bf16 (types 1),
// with rows ldy >= N elements apart (a column slice of a wider output when
// ldy > N).  All row-major, the inputs contiguous, x and packed 16-byte
// aligned.  Returns the cudaError_t of the launch.
int q4_matmul(int types, const void* x, const void* packed,
              const void* scales, void* y, int M, int N, int K, int bk,
              int ldy, void* stream) {
  return dispatch(0, types, x, packed, scales, y, M, N, K, bk, ldy, stream);
}

int q4_matmul_db(int types, const void* x, const void* packed,
                 const void* scales, void* y, int M, int N, int K, int bk,
                 int ldy, void* stream) {
  return dispatch(1, types, x, packed, scales, y, M, N, K, bk, ldy, stream);
}

}  // extern "C"
