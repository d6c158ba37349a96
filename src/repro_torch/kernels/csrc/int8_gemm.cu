// u8 x s8 -> s32 GEMM for Hopper (sm_90a): acc (M, N) = a (M, K) . w (N, K)^T
//
// Replaces the Pallas TPU kernel int8_gemm_pallas of
// repro/kernels/int8_gemm.py (:60; its body _kernel, :42): the paper's INT8
// GEMM (AVX-VNNI vpdpbusd: u8 activations times s8 weights summed in s32),
// an exact integer sum over K.  The TPU kernel carried that sum across a
// sequential K grid axis in a VMEM scratch tile; here a loop inside the
// block takes the K axis, and the sum lives in registers.
//
// What bounds it.  The int8 trunk runs it at M <= 8 (decode: 4 slots;
// prefill: chunks of 8), where it does 2*M integer operations per weight
// byte: far below the card's operation/byte balance, so HBM bandwidth
// bounds it.  Each launch must stream N*K bytes of s8 weights once; x
// (M*K bytes) and the s32 output are small beside them.  At M = 4 the
// bounds at 3.35 TB/s are 5.03 us (4096 x 4096), 13.5 us (11008 x 4096 and
// 4096 x 11008) and 39.3 us (the 32000 x 4096 head).
//
// What the design does about it.
//   * Each warp owns kRowsPerWarp output rows (neighbouring rows of W) and
//     streams them in 16-byte vector loads, lane l on bytes 16l..16l+15 of
//     each 512-byte stretch: neighbouring lanes on neighbouring addresses,
//     kRowsPerWarp independent loads in flight per lane.
//   * The rows of x (u8) are staged once per block in shared memory, one
//     K tile of kKTile bytes at a time, and every warp of the block reads
//     them from there: x is read from global memory once per block, not
//     once per row and lane (the fault that bounds the Q4 kernels).
//   * Four-byte dot products use dp4a.u32.s32 (u8 times s8, s32 sum), so x
//     needs no shift and w no correction.
//   * Each lane keeps a partial s32 sum per (x row, W row); a warp-shuffle
//     reduction sums the 32 lanes at the end.  Every sum is an exact
//     integer (at most 255 * 127 * 11008 ~ 3.6e8 < 2^31 on the main path),
//     so the result equals the plain version bit for bit in any order.
//   * Ragged edges are masked, nothing is padded: rows past N load zeros
//     and store nothing; x rows past M are skipped; a loop over M tiles of
//     kMTile rows (grid.y) serves any M.  K must be a multiple of 16 with
//     16-byte aligned operands for the vector kernel; any other K (or
//     alignment) takes int8_gemm_bytes_kernel, which reads bytes one at a
//     time (the reference's ragged test shapes; never the main path).
//
// Launch: grid (ceil(N / kRows), ceil(M / kMTile)), kThreads threads.  The
// kernels allocate nothing and run on the stream they are given.  The C
// entry returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;              // 256 threads per block
constexpr int kRowsPerWarp = 4;                    // W rows per warp
constexpr int kRows = kWarps * kRowsPerWarp;       // W rows per block (32)
constexpr int kMTile = 8;                          // x rows per block
constexpr int kKTile = 2048;                       // x bytes per row per pass

__device__ __forceinline__ int dp4a_u8s8(int a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum the lanes of every (x row, W row) pair and store it: lane
// m * kRowsPerWarp + r stores pair (m, r), so every lane stores at most one.
__device__ __forceinline__ void reduce_store(int (&acc)[kMTile][kRowsPerWarp],
                                             int lane, int m0, int mc, int n0,
                                             int N, int ldc,
                                             int32_t* __restrict__ out) {
#pragma unroll
  for (int m = 0; m < kMTile; ++m) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int s = warp_sum(acc[m][r]);
      if (lane == m * kRowsPerWarp + r && m < mc && n0 + r < N)
        out[static_cast<size_t>(m0 + m) * ldc + n0 + r] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_vec_kernel(const uint8_t* __restrict__ a,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     int M, int N, int K, int ldc) {
  __shared__ __align__(16) uint8_t xs[kMTile][kKTile];  // 16 KB

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kRows + warp * kRowsPerWarp;
  const int m0 = blockIdx.y * kMTile;
  const int mc = min(kMTile, M - m0);

  const int4* wrow[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    live[r] = n0 + r < N;
    wrow[r] = reinterpret_cast<const int4*>(
        w + static_cast<size_t>(live[r] ? n0 + r : 0) * K);
  }

  int acc[kMTile][kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[m][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kKTile) {
    const int vecs = min(kKTile, K - k0) / 16;  // 16-byte vectors per row
    __syncthreads();  // every warp is done with the previous x tile
    for (int i = threadIdx.x; i < mc * vecs; i += kThreads) {
      const int m = i / vecs;
      const int v = i - m * vecs;
      reinterpret_cast<int4*>(xs[m])[v] = __ldg(
          reinterpret_cast<const int4*>(a + static_cast<size_t>(m0 + m) * K +
                                        k0) + v);
    }
    __syncthreads();
    const int base = k0 / 16;
#pragma unroll 2
    for (int v = lane; v < vecs; v += 32) {
      int4 wv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        wv[r] = live[r] ? __ldg(wrow[r] + base + v) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int m = 0; m < kMTile; ++m) {
        if (m < mc) {
          const int4 xv = reinterpret_cast<const int4*>(xs[m])[v];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            int s = acc[m][r];
            s = dp4a_u8s8(xv.x, wv[r].x, s);
            s = dp4a_u8s8(xv.y, wv[r].y, s);
            s = dp4a_u8s8(xv.z, wv[r].z, s);
            s = dp4a_u8s8(xv.w, wv[r].w, s);
            acc[m][r] = s;
          }
        }
      }
    }
  }
  reduce_store(acc, lane, m0, mc, n0, N, ldc, out);
}

// Any K and any alignment: the same warp-to-row mapping, one byte of each
// operand per lane per step, x read straight from global memory.
__global__ void __launch_bounds__(kThreads)
int8_gemm_bytes_kernel(const uint8_t* __restrict__ a,
                       const int8_t* __restrict__ w,
                       int32_t* __restrict__ out, int M, int N, int K,
                       int ldc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kRows + warp * kRowsPerWarp;
  const int m0 = blockIdx.y * kMTile;
  const int mc = min(kMTile, M - m0);

  int acc[kMTile][kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[m][r] = 0;

  for (int k = lane; k < K; k += 32) {
    int wv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      wv[r] = n0 + r < N
                  ? static_cast<int>(w[static_cast<size_t>(n0 + r) * K + k])
                  : 0;
#pragma unroll
    for (int m = 0; m < kMTile; ++m) {
      if (m < mc) {
        const int xv =
            static_cast<int>(a[static_cast<size_t>(m0 + m) * K + k]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[m][r] += xv * wv[r];
      }
    }
  }
  reduce_store(acc, lane, m0, mc, n0, N, ldc, out);
}

}  // namespace

extern "C" {

// a: u8 (M, K); w: s8 (N, K); out: s32 (M, N) with rows ldc >= N elements
// apart (a column slice of a wider output when ldc > N).  All row-major,
// a and w contiguous.  Returns the cudaError_t of the launch.
int int8_gemm(const void* a, const void* w, void* out, int M, int N, int K,
              int ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldc < N ||
      (M + kMTile - 1) / kMTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kRows - 1) / kRows, (M + kMTile - 1) / kMTile);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* at = static_cast<const uint8_t*>(a);
  const int8_t* wt = static_cast<const int8_t*>(w);
  int32_t* ot = static_cast<int32_t*>(out);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    int8_gemm_vec_kernel<<<grid, block, 0, s>>>(at, wt, ot, M, N, K, ldc);
  else
    int8_gemm_bytes_kernel<<<grid, block, 0, s>>>(at, wt, ot, M, N, K, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
