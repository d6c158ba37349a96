// Decode attention for Hopper (sm_90a): one new query per batch row against
// the KV cache, over each row's live positions only.
//
//   out[b, h, g, :] = softmax_s(q[b, h, g] . k[b, h, s] * scale) . v[b, h, s]
//
// over s < L_b = min(q_pos[b] + 1, kv_len[b], S_max): the mask of
// models/attention.py _sdpa_grouped at one query (Sq = 1), free slots whose
// index has run past S_max included.  q is (B, Hkv, G, 1, hd) (the G query
// heads of each KV head, GQA), k and v (B, Hkv, S_max, hd), out as q.
//
// Replaces no TPU kernel: the JAX package's attention is plain jnp, and the
// port's plain path upcasts the whole cache to float32 and runs two einsums
// over every position, masking afterwards.  This kernel reads the cache in
// place, in its own dtype (bf16 or f32), once, and only the live rows.
//
// What bounds it.  Bytes.  Each K and V element read does G FMAs (2 G flops
// per element, G / 1 flops per byte in bf16 at G <= 16), far below the
// card's ~295 flops per byte in bf16 or the ~20 of its f32 FMA units.  The
// least time is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it.
//   * Split over the sequence (flash-decoding).  A block is (split, KV head
//     and a group of up to GB of its query heads, row) and covers `span`
//     positions; a block whose span starts at or past its row's length exits
//     at once, so no dead position is read.  The span is set by S_max alone
//     (the wrapper's choice), never by the batch: a row's sums, and so its
//     bits, do not depend on the rows beside it.
//   * Every lane owns 8 consecutive head-dim elements (one 16-byte vector in
//     bf16); `lanes` (a power of two, hd / 8 rounded up) lanes share a
//     position, so a warp reads whole, contiguous K/V rows.  The block's 128
//     threads hold 128 / lanes positions at a time; each lane keeps its 8
//     elements of the G queries in registers, so one K/V vector feeds G
//     heads' FMAs and GQA's saving in bytes is kept.
//   * Loads stay in flight through a 3-slot cp.async ring in shared memory,
//     2 slots (4 positions a thread in bf16) ahead of the compute.  Each thread copies and later reads only
//     its own 16-byte units ([slot][unit][thread]: conflict-free), so the
//     loop has no barrier.
//   * float32 throughout, as the plain path: scores, a running max and sum
//     per position slot (online softmax), the P.V sums.  The scores are
//     taken in base 2 (scale * log2(e) applied once), so an exponential is
//     one ex2.approx; the sums so far are rescaled only when a slot's max
//     grows.  At the end the slots of a warp merge by shuffles, the 4 warps
//     through shared memory, and the block writes its unnormalised sums
//     with their max and sum.
//     A second kernel merges a row's splits by log-sum-exp and writes the
//     output in the cache's dtype.
//   * A row with no live position (L <= 0) attends uniformly over all S_max
//     positions, as the plain path's softmax over a fully masked row does.
//
// Launch: grid (ceil(S_max / span), Hkv * ceil(G / GB), B), 128 threads,
// static shared memory only; then the merge, grid (Hkv, B), 128 threads.
// The kernels allocate nothing (the wrapper passes the partial sums' scratch)
// and run on the stream they are given.  The C entry returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;        // head-dim elements per lane
constexpr int kStages = 3;   // ring slots
constexpr int kMaxHd = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* q_pos;
  const void* kv_len;
  float* part_acc;   // (B, Hkv, G, n_split, hd)
  float* part_ml;    // (B, Hkv, G, n_split, 2): max, sum
  void* out;         // (B, Hkv, G, hd)
  long long qsb, qsh, qsg;   // q strides (elements) of row, KV head, group
  long long ksb, ksh, kss;   // k strides of row, head, position
  long long vsb, vsh, vss;
  long long pos_sb, len_sb;  // q_pos and kv_len row strides (0: one value)
  int q_bf16, pos64, len64;
  int H, G, S, hd, lanes, span, n_split;
  float scale;
};

// 8 elements of T as floats: one 16-byte unit in bf16, two in f32 (the
// second kThreads units further on, in the ring's layout).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kUnits = 1;  // 16-byte units per lane's 8 elements
  static constexpr int kU = 2;      // positions per lane in a ring slot
  __device__ static void load(const uint4* src, int, float (&f)[kE]) {
    const uint4 u = *src;
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elem<float> {
  static constexpr int kUnits = 2;
  static constexpr int kU = 1;
  __device__ static void load(const uint4* src, int stride, float (&f)[kE]) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(src + w * stride);
      f[4 * w] = u.x;
      f[4 * w + 1] = u.y;
      f[4 * w + 2] = u.z;
      f[4 * w + 3] = u.w;
    }
  }
  __device__ static float store(float x) { return x; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x (scores are kept in base-2 units: scaled by log2(e) once); 2^-inf
// is 0, a result below 2^-126 is flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^(x - m) for a max m of a set holding x; 0 where x is -inf
__device__ __forceinline__ float rel_exp(float x, float m) {
  return x == -CUDART_INF_F ? 0.f : ex2(x - m);
}

// Row b's live length, min(q_pos + 1, kv_len, S_max); <= 0 when the mask
// leaves nothing.
__device__ __forceinline__ int row_length(const Args& a, int b) {
  const long long qp =
      a.pos64 ? static_cast<const long long*>(a.q_pos)[b * a.pos_sb]
              : static_cast<const int*>(a.q_pos)[b * a.pos_sb];
  const long long kl =
      a.len64 ? static_cast<const long long*>(a.kv_len)[b * a.len_sb]
              : static_cast<const int*>(a.kv_len)[b * a.len_sb];
  const long long n = min(min(qp + 1, kl), static_cast<long long>(a.S));
  return static_cast<int>(max(n, -1LL));
}

template <typename T, int GB>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ring = kStages * Elem<T>::kU * 2 * Elem<T>::kUnits *
                       kThreads * 16;
  constexpr int merge = kWarps * GB * (kMaxHd + 2) * 4;
  return ring > merge ? ring : merge;
}

template <typename T, int GB>
__global__ void __launch_bounds__(kThreads)
decode_attn_split_kernel(const Args a) {
  using E = Elem<T>;
  constexpr int U = E::kU, NU = E::kUnits;
  constexpr int kSlotUnits = U * 2 * NU;  // per thread: K then V of U rows
  __shared__ __align__(16) unsigned char smem[smem_bytes<T, GB>()];
  uint4* ring = reinterpret_cast<uint4*>(smem);

  const int b = blockIdx.z;
  const int n_gb = (a.G + GB - 1) / GB;
  const int h = blockIdx.y / n_gb;
  const int g0 = (blockIdx.y % n_gb) * GB;
  const int gn = min(GB, a.G - g0);
  int len = row_length(a, b);
  float scale = a.scale;
  if (len <= 0) {  // nothing live: uniform over every position, as the plain
    len = a.S;     // path's softmax of a fully masked row
    scale = 0.f;
  }
  const int s0 = blockIdx.x * a.span;
  if (s0 >= len) return;
  const int s1 = min(s0 + a.span, len);

  const int tid = threadIdx.x;
  const int lanes = a.lanes;
  const int c = tid & (lanes - 1);  // the lane's 8 elements: c * 8 ...
  const int j = tid / lanes;        // the lane's position slot
  const int slots = kThreads / lanes;
  const bool active = c * kE < a.hd;

  float qf[GB][kE];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const long long o = b * a.qsb + h * a.qsh + (g0 + g) * a.qsg + c * kE;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float x = 0.f;
      if (active && g < gn)
        x = a.q_bf16
                ? __bfloat162float(
                      static_cast<const __nv_bfloat16*>(a.q)[o + e])
                : static_cast<const float*>(a.q)[o + e];
      qf[g][e] = x;
    }
  }

  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh + c * kE;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh + c * kE;
  const int per_slot = slots * U;  // positions of the block in a ring slot
  const int n_st = (s1 - s0 + per_slot - 1) / per_slot;

  // Copy ring slot st's K and V units of this thread (U positions).
  auto issue = [&](int st) {
    if (st < n_st && active) {
      uint4* dst = ring + (st % kStages) * kSlotUnits * kThreads + tid;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = s0 + (st * U + u) * slots + j;
        if (pos < s1) {
          const uint4* ks = reinterpret_cast<const uint4*>(kp + pos * a.kss);
          const uint4* vs = reinterpret_cast<const uint4*>(vp + pos * a.vss);
#pragma unroll
          for (int w = 0; w < NU; ++w) {
            cp_async16(dst + ((2 * u) * NU + w) * kThreads, ks + w);
            cp_async16(dst + ((2 * u + 1) * NU + w) * kThreads, vs + w);
          }
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count
  };

  float m[GB], l[GB], acc[GB][kE];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();  // slot st has landed
    issue(st + kStages - 1);       // into the slot read one step ago
    const uint4* slot = ring + (st % kStages) * kSlotUnits * kThreads + tid;

    float s[U][GB];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = s0 + (st * U + u) * slots + j < s1;
      float kf[kE];
      if (active) E::load(slot + 2 * u * NU * kThreads, kThreads, kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
        if (active && g < gn) {
#pragma unroll
          for (int e = 0; e < kE; ++e) d = fmaf(qf[g][e], kf[e], d);
        }
        s[u][g] = d;
      }
    }
    // each position's dot products: the sum over its lanes (the shuffles
    // of every head and position interleave)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < lanes) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GB; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        s[u][g] = ok[u] ? s[u][g] * scale : -CUDART_INF_F;

    float p[U][GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      if (mx > m[g]) {  // a new max: rescale the sums so far (0 on the first)
        const float corr = ex2(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] *= corr;
        m[g] = mx;
      }
      // with no live position yet every score is -inf, and so is m
      const float ms = m[g] == -CUDART_INF_F ? 0.f : m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][g] = ex2(s[u][g] - ms);
        l[g] += p[u][g];
      }
    }

#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u] && active) {
        float vf[kE];
        E::load(slot + (2 * u + 1) * NU * kThreads, kThreads, vf);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < kE; ++e)
            acc[g][e] = fmaf(p[u][g], vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // Merge the position slots of the warp (lanes c of every slot)...
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off < lanes) continue;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float ca = rel_exp(m[g], mx), cb = rel_exp(mo, mx);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mx;
    }
  }

  // ... then the 4 warps through shared memory, and store the block's sums.
  __syncthreads();  // every thread is done with the ring
  const int hd = a.hd;
  float* red = reinterpret_cast<float*>(smem);  // [warp][g][hd]
  float* red_m = red + kWarps * GB * hd;        // [warp][g]
  float* red_l = red_m + kWarps * GB;
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < lanes) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (active) {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          red[(warp * GB + g) * hd + c * kE + e] = acc[g][e];
      }
      if (c == 0) {
        red_m[warp * GB + g] = m[g];
        red_l[warp * GB + g] = l[g];
      }
    }
  }
  __syncthreads();
  const long long base = (static_cast<long long>(b) * a.H + h) * a.G + g0;
  for (int i = tid; i < gn * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GB + g]);
    float sum = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = rel_exp(red_m[w * GB + g], mx);
      sum += cw * red[(w * GB + g) * hd + d];
      lsum += cw * red_l[w * GB + g];
    }
    const long long o = (base + g) * a.n_split + blockIdx.x;
    a.part_acc[o * hd + d] = sum;
    if (d == 0) {
      a.part_ml[2 * o] = mx;
      a.part_ml[2 * o + 1] = lsum;
    }
  }
}

// A row's splits merged by log-sum-exp, normalised, stored in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_merge_kernel(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  int len = row_length(a, b);
  if (len <= 0) len = a.S;
  const int live = (len + a.span - 1) / a.span;  // splits that wrote
  const int hd = a.hd;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.G;
  for (int i = threadIdx.x; i < a.G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const long long o = (row + g) * a.n_split;
    float mx = -CUDART_INF_F;
    for (int sp = 0; sp < live; ++sp) mx = fmaxf(mx, a.part_ml[2 * (o + sp)]);
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < live; ++sp) {
      const float w = rel_exp(a.part_ml[2 * (o + sp)], mx);
      num += w * a.part_acc[(o + sp) * hd + d];
      den += w * a.part_ml[2 * (o + sp) + 1];
    }
    static_cast<T*>(a.out)[(row + g) * hd + d] = Elem<T>::store(num / den);
  }
}

template <typename T, int GB>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(a.n_split, a.H * ((a.G + GB - 1) / GB), B);
  decode_attn_split_kernel<T, GB><<<grid, kThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attn_merge_kernel<T><<<dim3(a.H, B), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_group(const Args& a, int B, cudaStream_t s) {
  return a.G <= 4 ? launch<T, 4>(a, B, s) : launch<T, 8>(a, B, s);
}

}  // namespace

extern "C" {

// q: (B, Hkv, G, hd) at strides (qsb, qsh, qsg, 1), bf16 (q_bf16 = 1) or
// f32; k, v: (B, Hkv, S, hd) at strides (*sb, *sh, *ss, 1) in bf16
// (kv_bf16 = 1) or f32, 16-byte aligned rows; q_pos, kv_len: int32 or int64
// (pos64, len64) with row strides pos_sb, len_sb (0: one value for every
// row); part_acc: f32 (B, Hkv, G, n_split, hd), part_ml: f32 (B, Hkv, G,
// n_split, 2) scratch with n_split = ceil(S / span); out: (B, Hkv, G, hd)
// contiguous in k's dtype.  hd a multiple of 8 in [16, 256], 1 <= G <= 16.
// Returns the cudaError_t of the launches.
int decode_attention(int kv_bf16, int q_bf16, const void* q, long long qsb,
                     long long qsh, long long qsg, const void* k,
                     const void* v, long long ksb, long long ksh,
                     long long kss, long long vsb, long long vsh,
                     long long vss, const void* q_pos, int pos64,
                     long long pos_sb, const void* kv_len, int len64,
                     long long len_sb, int B, int H, int G, int S, int hd,
                     int span, float scale, void* part_acc, void* part_ml,
                     void* out, void* stream) {
  if (B <= 0 || H <= 0 || G < 1 || G > 16 || S <= 0 || hd < 16 ||
      hd > kMaxHd || hd % kE || span <= 0 || B > 65535 ||
      H * ((G + 7) / 8) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_pos = q_pos;
  a.kv_len = kv_len;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.out = out;
  a.qsb = qsb;
  a.qsh = qsh;
  a.qsg = qsg;
  a.ksb = ksb;
  a.ksh = ksh;
  a.kss = kss;
  a.vsb = vsb;
  a.vsh = vsh;
  a.vss = vss;
  a.pos_sb = pos_sb;
  a.len_sb = len_sb;
  a.q_bf16 = q_bf16;
  a.pos64 = pos64;
  a.len64 = len64;
  a.H = H;
  a.G = G;
  a.S = S;
  a.hd = hd;
  a.lanes = 1;
  while (a.lanes * kE < hd) a.lanes *= 2;
  a.span = span;
  a.n_split = (S + span - 1) / span;
  a.scale = scale * kLog2e;  // scores in base-2 units
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kv_bf16 ? by_group<__nv_bfloat16>(a, B, s)
                                  : by_group<float>(a, B, s));
}

}  // extern "C"
