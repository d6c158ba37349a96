// u8 x s8 -> s32 GEMM for Hopper (sm_90a): acc (M, N) = a (M, K) . w (N, K)^T
//
// Replaces the Pallas TPU kernel int8_gemm_pallas of
// repro/kernels/int8_gemm.py (:60; its body _kernel, :41): the paper's INT8
// GEMM (AVX-VNNI vpdpbusd: u8 activations times s8 weights summed in s32),
// an exact integer sum over K.  The TPU kernel carried that sum across a
// sequential K grid axis (:42) in a VMEM scratch tile; here the K axis is
// split among the warps of a block and their sums meet in shared memory.
//
// What bounds it.  A launch must stream the N*K bytes of s8 weights; x
// (M*K bytes) and the s32 output are small beside them.  It does 2*M
// integer operations per weight byte, against the card's balance of about
// 590 (1,979 TOP/s int8 over 3.35 TB/s), so HBM bandwidth bounds it at
// every M the int8 trunk uses:
//   * M <= 8 (decode at 4 slots; prefill chunks of 8): bytes alone.  At
//     M = 4 the bounds are 5.03 us (4096 x 4096), 13.5 us (11008 x 4096
//     and 4096 x 11008) and 39.3 us (the 32000 x 4096 head).  The kernel
//     has to keep enough weight bytes in flight on every SM, also where
//     N = 4096 gives each SM only 31 rows.
//   * M > 8 (multi-lane prefill; M = 32 is the yardstick): bytes, and W's
//     re-reads.  A kernel that streams W once per few rows of x moves
//     ceil(M / rows) times the bytes; and every block reads the x rows it
//     serves from L2, M * K bytes for each kRows rows of W, so x's L2
//     traffic is M / kRows times W's.
//
// What the design does about it.
//   * One kernel body, int8_mma_kernel, compiled per x tile: kNT tiles of 8
//     x rows and kMT tiles of 16 W rows per block.  The C entry picks them
//     from M (and N):
//       M <= 8       kNT 1, kMT 1: 256 blocks at N = 4096, two per SM
//       M 9..32      kNT 2 or 4, kMT 2
//       M > 32       kNT 8, kMT 2, or kMT 4 where N >= 16384 (the head):
//                    64 x rows per block, so W streams once for M <= 64
//                    and x's L2 reads are M / 64 of W's on the head
//   * The inner product is the tensor cores' mma.sync m16n8k32 with s8 A
//     (16 W rows) and u8 B (8 x rows): u8 times s8 in s32 directly, so x
//     needs no shift and w no correction, and the issue cost is one
//     instruction per 512 weight bytes and 8 x rows (the first port's
//     dp4a.u32.s32 took 4 instructions per 16 weight bytes and x row).
//     Without .satfinite: the largest sum on the main path, 255 * 127 *
//     11008 ~ 3.6e8, is far below 2^31.
//   * No shuffles of fragments and no ldmatrix: the sum over K does not
//     care which K position a fragment slot holds, as long as A and B
//     agree.  Lane (g, t) (g = lane / 4, t = lane % 4) loads 16 bytes at K
//     offset 16t of a 64-byte step from W rows g and g + 8 and from x row
//     g; words .x,.y of them feed one mma and .z,.w the next.  A warp's
//     load instruction covers 64 contiguous bytes of 8 rows.
//   * The 8 warps of a block own the same W rows and take the K steps in
//     turn (warp w: steps w, w + 8, ...), each through its own cp.async
//     ring of kStages slots in shared memory (6 at M <= 8, 3 above): every
//     thread copies its own 16-byte vectors (W and x) and reads back only
//     what it copied, so the stream needs no barrier and never stops;
//     kStages - 1 steps are in flight per thread (80 KB of W per SM at
//     N = 4096, M <= 8).  x is read once per block, by the warp whose K
//     step it is; staging it whole first would read the same bytes and
//     put a barrier before the stream.
//   * At M <= 8 an mma costs the same for 1 or 8 x rows and rows past M
//     load nothing, so one build serves M = 1..8 and the time hardly
//     grows with M (no per-row accumulators or reductions).
//   * One barrier at the end: the warps' s32 partials meet in shared
//     memory (the ring's space) and are summed and stored.  Every sum is
//     an exact integer, so the result equals the plain version bit for bit
//     in any order, at any split of K, M or N (an eager shard equals the
//     same columns of one launch).
//   * Ragged edges are masked, nothing is padded: rows past N or M and K
//     past the end are zero-filled by the copies (nothing is read) and
//     nothing past N or M is stored.  Vectors need K % 16 == 0 and
//     16-byte aligned operands; any other K or alignment takes
//     int8_gemm_bytes_kernel, the same function one byte at a time (the
//     reference's ragged test shapes; never the main path).
//
// Launch: grid (ceil(N / (16 kMT)), ceil(M / (8 kNT))), 256 threads,
// dynamic shared memory for the ring.  The kernels allocate nothing and
// run on the stream they are given.  The C entries return
// cudaGetLastError().  Times against the bounds: PERF.md.
//
// Launch variants.  int8_gemm picks the instantiation from M (above);
// int8_gemm_variant launches the one named by (kNT, kMT, kStages),
// whatever M is: the five instantiations this file compiles are the
// candidates the port's kernel tuner chooses among for an eager shard.
// Every one sums the same exact s32 products, so all give the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The tile of each regime: W tiles of 16 rows per block (kMt*) and ring
// slots per thread (kStages*).  Measured choices (PERF.md); the variant
// script scripts/int8_gemm_variants.py builds copies of this file with
// other values of these constants.
constexpr int kMtSmall = 1;      // M <= 8
constexpr int kStagesSmall = 6;
constexpr int kMtLarge = 2;      // M > 8
constexpr int kMtWide = 4;       // M > 32 where N >= kWideN
constexpr int kStagesLarge = 3;  // M > 8, both
constexpr int kWideN = 16384;    // 64 W rows per block still give 256 blocks
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // 256 threads per block
constexpr int kStep = 64;              // K bytes of one warp step
constexpr int kMaxM = 8 * 65535;       // what the wrapper accepts
// W's copies ask L2 to fetch the whole 128-byte line around each 16 bytes
// (measured: 3.09 -> 3.01 ms per decode step at M = 4; PERF.md).  A line
// holds the steps of two neighbouring warps in one row, so the likely gain
// is one DRAM access where there were two.
constexpr bool kWPrefetch = true;

// 16 bytes from global to shared memory, asynchronously; kPrefetch: with
// an L2 prefetch of the 128-byte line
template <bool kPrefetch>
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: zero-fill, nothing is read
  if constexpr (kPrefetch)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A (16 x 32, s8, row) . B (32 x 8, u8, col), exact in s32.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int kNT, int kMT, int kStages>
constexpr size_t smem_bytes() {
  const size_t ring = sizeof(uint4) * kStages * (2 * kMT + kNT) * kThreads;
  // the partials [warp][x row][W row], rows 16 kMT + 4 apart
  const size_t part = sizeof(int) * kWarps * 8 * kNT * (16 * kMT + 4);
  return ring > part ? ring : part;
}

template <int kNT, int kMT, int kStages>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const uint8_t* __restrict__ a, const int8_t* __restrict__ w,
                int32_t* __restrict__ out, int M, int N, int K, int ldc) {
  constexpr int kRows = 16 * kMT;  // W rows per block
  constexpr int kXRows = 8 * kNT;  // x rows per block
  constexpr int kW = 2 * kMT;      // W vectors per thread and step
  constexpr int kVecs = kW + kNT;  // and x vectors after them
  constexpr int kLd = kRows + 4;  // partial row stride: no bank conflicts
  // ring [slot][vector][thread]: each thread's 16-byte vectors, so that a
  // warp's copies and reads touch 512 contiguous bytes
  extern __shared__ __align__(16) uint4 ring[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kRows;
  const int m0 = blockIdx.y * kXRows;
  const int steps = (K + kStep - 1) / kStep;
  const int mine = warp < steps ? (steps - warp + kWarps - 1) / kWarps : 0;

  // The lane's rows: W rows n0 + 16 mt + g (+ 8), x rows m0 + 8 nt + g,
  // each at K offset 16t of a step; rows past N or M read nothing.
  const int8_t* wsrc[kW];
  bool wok[kW];
#pragma unroll
  for (int v = 0; v < kW; ++v) {
    const int n = n0 + 16 * (v >> 1) + 8 * (v & 1) + g;
    wok[v] = n < N;
    wsrc[v] = w + static_cast<size_t>(wok[v] ? n : 0) * K + 16 * t;
  }
  const uint8_t* xsrc[kNT];
  bool xok[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int m = m0 + 8 * nt + g;
    xok[nt] = m < M;
    xsrc[nt] = a + static_cast<size_t>(xok[nt] ? m : 0) * K + 16 * t;
  }

  // Copy the warp's i-th step into ring slot s; always one commit group.
  auto issue = [&](int i, int s) {
    if (i < mine) {
      const int k = (warp + i * kWarps) * kStep;
      const bool kok = k + 16 * t < K;
      uint4* slot = ring + s * kVecs * kThreads + threadIdx.x;
#pragma unroll
      for (int v = 0; v < kW; ++v)
        cp_async16<kWPrefetch>(slot + v * kThreads,
                               wsrc[v] + (kok ? k : 0), wok[v] && kok);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        cp_async16<false>(slot + (kW + nt) * kThreads,
                          xsrc[nt] + (kok ? k : 0), xok[nt] && kok);
    }
    cp_async_commit();
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, i);
  int rd = 0;               // slot of step i
  int wr = kStages - 1;     // slot of step i + kStages - 1
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();  // step i has landed
    const uint4* slot = ring + rd * kVecs * kThreads + threadIdx.x;
    uint4 wv[kW], xv[kNT];
#pragma unroll
    for (int v = 0; v < kW; ++v) wv[v] = slot[v * kThreads];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) xv[nt] = slot[(kW + nt) * kThreads];
    // refill the slot read one step ago (this thread's own, read already)
    issue(i + kStages - 1, wr);
    rd = rd + 1 == kStages ? 0 : rd + 1;
    wr = wr + 1 == kStages ? 0 : wr + 1;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const uint4 lo = wv[2 * mt];      // row g
      const uint4 hi = wv[2 * mt + 1];  // row g + 8
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mma_s8u8(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, xv[nt].x, xv[nt].y);
        mma_s8u8(acc[mt][nt], lo.z, hi.z, lo.w, hi.w, xv[nt].z, xv[nt].w);
      }
    }
  }

  // The warps' partials [warp][x row][W row] in the ring's space, then
  // one thread per output sums the 8 warps and stores.
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring
  int* part = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // c_j of m16n8: W row g (+ 8 for j >= 2), x row 2t + (j & 1)
        const int r = 16 * mt + g + 8 * (j >> 1);
        const int m = 8 * nt + 2 * t + (j & 1);
        part[(warp * kXRows + m) * kLd + r] = acc[mt][nt][j];
      }
  __syncthreads();
  const int mc = min(kXRows, M - m0);
  for (int e = threadIdx.x; e < mc * kRows; e += kThreads) {
    const int m = e / kRows;
    const int r = e - m * kRows;
    if (n0 + r < N) {
      int s = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += part[(v * kXRows + m) * kLd + r];
      out[static_cast<size_t>(m0 + m) * ldc + n0 + r] = s;
    }
  }
}

template <int kNT, int kMT, int kStages>
cudaError_t launch_mma(const uint8_t* a, const int8_t* w, int32_t* out,
                       int M, int N, int K, int ldc, cudaStream_t stream) {
  static_assert(kStages >= 2, "a ring needs two slots");
  constexpr size_t kBytes = smem_bytes<kNT, kMT, kStages>();
  static_assert(kBytes <= 232448, "fits an H100 block's shared memory");
  // once per kernel: allow the dynamic shared memory it takes
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_mma_kernel<kNT, kMT, kStages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    cudaGetLastError();  // reported through attr, not to a later launch
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + 16 * kMT - 1) / (16 * kMT),
                  (M + 8 * kNT - 1) / (8 * kNT));
  int8_mma_kernel<kNT, kMT, kStages><<<grid, kThreads, kBytes, stream>>>(
      a, w, out, M, N, K, ldc);
  return cudaGetLastError();
}

// The ragged-K variant: any K and any alignment, one byte of each operand
// per lane per step, x read straight from global memory.  Each warp owns
// kBytesRowsPerWarp W rows and a block kBytesMTile x rows; the lanes' sums
// meet in a shuffle tree.
constexpr int kBytesRowsPerWarp = 4;
constexpr int kBytesRows = kWarps * kBytesRowsPerWarp;  // W rows per block
constexpr int kBytesMTile = 8;                          // x rows per block

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_bytes_kernel(const uint8_t* __restrict__ a,
                       const int8_t* __restrict__ w,
                       int32_t* __restrict__ out, int M, int N, int K,
                       int ldc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBytesRows + warp * kBytesRowsPerWarp;
  const int m0 = blockIdx.y * kBytesMTile;
  const int mc = min(kBytesMTile, M - m0);

  int acc[kBytesMTile][kBytesRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kBytesMTile; ++m)
#pragma unroll
    for (int r = 0; r < kBytesRowsPerWarp; ++r) acc[m][r] = 0;

  for (int k = lane; k < K; k += 32) {
    int wv[kBytesRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kBytesRowsPerWarp; ++r)
      wv[r] = n0 + r < N
                  ? static_cast<int>(w[static_cast<size_t>(n0 + r) * K + k])
                  : 0;
#pragma unroll
    for (int m = 0; m < kBytesMTile; ++m) {
      if (m < mc) {
        const int xv =
            static_cast<int>(a[static_cast<size_t>(m0 + m) * K + k]);
#pragma unroll
        for (int r = 0; r < kBytesRowsPerWarp; ++r) acc[m][r] += xv * wv[r];
      }
    }
  }
  // lane m * kBytesRowsPerWarp + r stores pair (m, r)
#pragma unroll
  for (int m = 0; m < kBytesMTile; ++m) {
#pragma unroll
    for (int r = 0; r < kBytesRowsPerWarp; ++r) {
      const int s = warp_sum(acc[m][r]);
      if (lane == m * kBytesRowsPerWarp + r && m < mc && n0 + r < N)
        out[static_cast<size_t>(m0 + m) * ldc + n0 + r] = s;
    }
  }
}

// The operands the vector kernel takes: K a multiple of 16, a and w
// 16-byte aligned; anything else takes the bytes kernel.
bool vector_ok(const void* a, const void* w, int K) {
  return K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

cudaError_t launch_bytes(const uint8_t* a, const int8_t* w, int32_t* out,
                         int M, int N, int K, int ldc, cudaStream_t stream) {
  const dim3 grid((N + kBytesRows - 1) / kBytesRows,
                  (M + kBytesMTile - 1) / kBytesMTile);
  int8_gemm_bytes_kernel<<<grid, kThreads, 0, stream>>>(a, w, out, M, N, K,
                                                        ldc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: u8 (M, K); w: s8 (N, K); out: s32 (M, N) with rows ldc >= N elements
// apart (a column slice of a wider output when ldc > N).  All row-major,
// a and w contiguous.  Picks the x tile from M (one launch either way).
// Returns the cudaError_t of the launch.
int int8_gemm(const void* a, const void* w, void* out, int M, int N, int K,
              int ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldc < N || M > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* at = static_cast<const uint8_t*>(a);
  const int8_t* wt = static_cast<const int8_t*>(w);
  int32_t* ot = static_cast<int32_t*>(out);
  if (!vector_ok(a, w, K))
    return static_cast<int>(launch_bytes(at, wt, ot, M, N, K, ldc, s));
  cudaError_t e;
  if (M <= 8)
    e = launch_mma<1, kMtSmall, kStagesSmall>(at, wt, ot, M, N, K, ldc, s);
  else if (M <= 16)
    e = launch_mma<2, kMtLarge, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  else if (M <= 32)
    e = launch_mma<4, kMtLarge, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  else if (N < kWideN)
    e = launch_mma<8, kMtLarge, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  else
    e = launch_mma<8, kMtWide, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  return static_cast<int>(e);
}

// The same product through the instantiation (kNT, kMT, kStages) = (nt,
// mt, stages), one of the five int8_gemm chooses among, at any M (the
// operands the vector kernel does not take still go to the bytes
// kernel).  Returns cudaErrorInvalidValue for a tuple that is not
// compiled.
int int8_gemm_variant(const void* a, const void* w, void* out, int M, int N,
                      int K, int ldc, int nt, int mt, int stages,
                      void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldc < N || M > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* at = static_cast<const uint8_t*>(a);
  const int8_t* wt = static_cast<const int8_t*>(w);
  int32_t* ot = static_cast<int32_t*>(out);
  const bool small = nt == 1 && mt == kMtSmall && stages == kStagesSmall;
  const bool large = mt == kMtLarge && stages == kStagesLarge &&
                     (nt == 2 || nt == 4 || nt == 8);
  const bool wide = nt == 8 && mt == kMtWide && stages == kStagesLarge;
  if (!small && !large && !wide)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!vector_ok(a, w, K))
    return static_cast<int>(launch_bytes(at, wt, ot, M, N, K, ldc, s));
  cudaError_t e;
  if (small)
    e = launch_mma<1, kMtSmall, kStagesSmall>(at, wt, ot, M, N, K, ldc, s);
  else if (wide)
    e = launch_mma<8, kMtWide, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  else if (nt == 2)
    e = launch_mma<2, kMtLarge, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  else if (nt == 4)
    e = launch_mma<4, kMtLarge, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  else
    e = launch_mma<8, kMtLarge, kStagesLarge>(at, wt, ot, M, N, K, ldc, s);
  return static_cast<int>(e);
}

}  // extern "C"
