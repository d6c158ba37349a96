// Q4_0 dequant-matmul for Hopper (sm_90a): y (M, N) = x (M, K) . dequant(W)^T
//
// Replaces the two Pallas TPU kernels of repro/kernels/q4_matmul.py:
//   * q4_matmul_pallas    (_kernel)    -> q4_direct_kernel, entry q4_matmul
//   * q4_matmul_pallas_db (_db_kernel) -> q4_db_kernel,     entry q4_matmul_db
//
// What bounds them.  W stays packed in HBM as Q4_0 (llama.cpp layout: one
// 32-element group = 16 bytes, byte j holds element j in its low nibble and
// element j + 16 in its high nibble, plus one f16 scale per group): every
// launch streams 0.5625 bytes per weight element and does 2*M flops on it.
// At decode (M <= 8) that is far below the card's flop/byte balance, so HBM
// bandwidth bounds both kernels; at M = 8 the f32 FMA rate comes close.
//
// What the design does about it.
//   * Each thread reads one whole group per K tile with one 16-byte load;
//     the G = bk/32 groups of a row's K tile sit on G neighbouring lanes, so
//     neighbouring lanes read neighbouring addresses.
//   * The group is dequantized in registers, (code - 8) * d, and never
//     written anywhere: no dense weight exists in any memory.
//   * The G lanes that share a row sum their partial dot products with warp
//     shuffles at the end; rows past N (the head's 32000) are masked.
//   * q4_matmul loads every tile straight from global memory.  q4_matmul_db
//     is the counterpart of the TPU kernel's two-slot DMA ring: it stages
//     each (rows x bk/2) packed tile and its (rows x bk/32) scales in two
//     shared-memory slots filled by cp.async, and waits on tile k while
//     tile k + 1 is in flight.  A row's scale tile is 2*G bytes; cp.async
//     copies 4, 8 or 16, so when G is odd (bk = 32) or a row's scales are
//     not 4-byte aligned, each thread reads its scale from global instead.
//   * Both kernels run the same __device__ tile routine (group_fma) with
//     the same thread-to-element mapping and the same order of sums (per K
//     tile: low plane, then high plane), so they are bit-identical at equal
//     bk; they differ only in how a tile arrives.
//
// Launch: grid (ceil(N / (128 / G)), ceil(M / 8)), 128 threads; thread t
// owns row t / G of the block's rows and group t % G of every K tile, and
// up to 8 rows of x.  The kernels allocate nothing and run on the stream
// they are given.  The C entries return cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kMTile = 8;      // rows of x per block

__device__ __forceinline__ void load_x32(const float* __restrict__ p,
                                         float (&xs)[32]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 f = __ldg(v + i);
    xs[4 * i + 0] = f.x;
    xs[4 * i + 1] = f.y;
    xs[4 * i + 2] = f.z;
    xs[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_x32(const __nv_bfloat16* __restrict__ p,
                                         float (&xs)[32]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 u = __ldg(v + i);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[8 * i + 2 * j + 0] = __uint_as_float(w[j] << 16);
      xs[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ void store_y(float* y, float v) { *y = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// The shared tile routine: one Q4_0 group (16 packed bytes q, scale d)
// against columns [k0, k0 + 32) of mc rows of x, accumulated into acc[m]:
// the low plane (elements 0..15) first, then the high plane (16..31).
template <typename T>
__device__ __forceinline__ void group_fma(const uint4 q, const float d,
                                          const T* __restrict__ x, int ldx,
                                          int k0, int mc,
                                          float (&acc)[kMTile]) {
  float wlo[16], whi[16];
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int byte = (words[i] >> (8 * b)) & 0xFF;
      wlo[4 * i + b] = static_cast<float>((byte & 0xF) - 8) * d;
      whi[4 * i + b] = static_cast<float>((byte >> 4) - 8) * d;
    }
  }
#pragma unroll
  for (int m = 0; m < kMTile; ++m) {
    if (m < mc) {
      float xs[32];
      load_x32(x + static_cast<size_t>(m) * ldx + k0, xs);
      float a = acc[m];
#pragma unroll
      for (int j = 0; j < 16; ++j) a = fmaf(xs[j], wlo[j], a);
#pragma unroll
      for (int j = 0; j < 16; ++j) a = fmaf(xs[16 + j], whi[j], a);
      acc[m] = a;
    }
  }
}

// Sum the G lanes of each row (aligned lane segments) and store the row.
template <typename T>
__device__ __forceinline__ void reduce_store(float (&acc)[kMTile], int G,
                                             int g, bool live, int n,
                                             int ldy, int m0, int mc,
                                             T* __restrict__ y) {
#pragma unroll
  for (int m = 0; m < kMTile; ++m) {
    float v = acc[m];
    for (int off = G >> 1; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[m] = v;
  }
  if (live && g == 0) {
#pragma unroll
    for (int m = 0; m < kMTile; ++m)
      if (m < mc) store_y(y + static_cast<size_t>(m0 + m) * ldy + n, acc[m]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
q4_direct_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                 const __half* __restrict__ scales, T* __restrict__ y, int M,
                 int N, int K, int G, int ldy) {
  const int t = threadIdx.x;
  const int g = t % G;
  const int n = blockIdx.x * (kThreads / G) + t / G;
  const int m0 = blockIdx.y * kMTile;
  const int mc = min(kMTile, M - m0);
  const int groups = K / 32;
  const int nk = groups / G;
  const bool live = n < N;
  const size_t row = live ? static_cast<size_t>(n) : 0;
  const uint4* prow = reinterpret_cast<const uint4*>(packed + row * (K / 2));
  const __half* srow = scales + row * groups;
  const T* xb = x + static_cast<size_t>(m0) * K;

  float acc[kMTile];
#pragma unroll
  for (int m = 0; m < kMTile; ++m) acc[m] = 0.f;

  if (live) {
#pragma unroll 4
    for (int kt = 0; kt < nk; ++kt) {
      const int gi = kt * G + g;
      const uint4 q = __ldg(prow + gi);
      const float d = __half2float(srow[gi]);
      group_fma<T>(q, d, xb, K, gi * 32, mc, acc);
    }
  }
  reduce_store<T>(acc, G, g, live, n, ldy, m0, mc, y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
q4_db_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
             const __half* __restrict__ scales, T* __restrict__ y, int M,
             int N, int K, int G, int ldy, int scale_async) {
  // Two slots, each one K tile of the block: (128 / G rows) x G groups.
  __shared__ __align__(16) uint4 p_buf[2][kThreads];
  __shared__ __align__(16) __half s_buf[2][kThreads];

  const int t = threadIdx.x;
  const int g = t % G;
  const int rows = kThreads / G;
  const int n = blockIdx.x * rows + t / G;
  const int m0 = blockIdx.y * kMTile;
  const int mc = min(kMTile, M - m0);
  const int groups = K / 32;
  const int nk = groups / G;
  const bool live = n < N;
  const size_t row = live ? static_cast<size_t>(n) : 0;
  const uint4* prow = reinterpret_cast<const uint4*>(packed + row * (K / 2));
  const __half* srow = scales + row * groups;
  const T* xb = x + static_cast<size_t>(m0) * K;

  // Scale copy: row r of the tile owns G halves at s_buf[slot][r * G ...],
  // copied as G / 2 four-byte chunks by the first 64 threads.
  const int half_g = G >> 1;
  const int sc_r = scale_async ? t / half_g : 0;
  const int sc_c = scale_async ? t % half_g : 0;
  const int sc_n = blockIdx.x * rows + sc_r;
  const bool sc_live = scale_async && t < kThreads / 2 && sc_n < N;
  const __half* sc_row =
      scales + (sc_live ? static_cast<size_t>(sc_n) : 0) * groups + 2 * sc_c;

  auto issue = [&](int kt, int slot) {
    cp_async16(&p_buf[slot][t], live ? prow + kt * G + g : prow, live);
    if (scale_async && t < kThreads / 2)
      cp_async4(&s_buf[slot][sc_r * G + 2 * sc_c],
                sc_live ? sc_row + kt * G : scales, sc_live);
    cp_async_commit();
  };

  float acc[kMTile];
#pragma unroll
  for (int m = 0; m < kMTile; ++m) acc[m] = 0.f;

  issue(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt & 1;
    if (kt + 1 < nk) {
      issue(kt + 1, slot ^ 1);  // prefetch the next tile into the other slot
      cp_async_wait<1>();       // ...and wait only for this one
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int gi = kt * G + g;
      const uint4 q = p_buf[slot][t];
      const float d = __half2float(scale_async ? s_buf[slot][t] : srow[gi]);
      group_fma<T>(q, d, xb, K, gi * 32, mc, acc);
    }
    __syncthreads();  // the slot is refilled by the next iteration's issue
  }
  reduce_store<T>(acc, G, g, live, n, ldy, m0, mc, y);
}

template <typename T>
cudaError_t launch(int db, const void* x, const void* packed,
                   const void* scales, void* y, int M, int N, int K, int bk,
                   int ldy, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk < 32 || bk % 32 || K % bk || ldy < N)
    return cudaErrorInvalidValue;
  const int G = bk / 32;
  if (G > 32 || (G & (G - 1))) return cudaErrorInvalidValue;
  const dim3 grid((N + kThreads / G - 1) / (kThreads / G),
                  (M + kMTile - 1) / kMTile);
  const dim3 block(kThreads);
  const T* xt = static_cast<const T*>(x);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const __half* s = static_cast<const __half*>(scales);
  T* yt = static_cast<T*>(y);
  if (db) {
    const int scale_async = G % 2 == 0 && (K / 32) % 2 == 0 &&
                            reinterpret_cast<uintptr_t>(scales) % 4 == 0;
    q4_db_kernel<T><<<grid, block, 0, stream>>>(xt, p, s, yt, M, N, K, G,
                                                ldy, scale_async);
  } else {
    q4_direct_kernel<T><<<grid, block, 0, stream>>>(xt, p, s, yt, M, N, K, G,
                                                    ldy);
  }
  return cudaGetLastError();
}

int dispatch(int db, int x_bf16, const void* x, const void* packed,
             const void* scales, void* y, int M, int N, int K, int bk,
             int ldy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16
          ? launch<__nv_bfloat16>(db, x, packed, scales, y, M, N, K, bk, ldy, s)
          : launch<float>(db, x, packed, scales, y, M, N, K, bk, ldy, s);
  return static_cast<int>(err);
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
