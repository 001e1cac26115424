// Decode attention for Hopper (sm_90a): one token a sequence against its
// layer's KV cache, RoPE and the cache write included, in one launch.
// Plain C entry point, loaded with ctypes (kernels/build.py); the wrapper,
// its rule and the plain version live in kernels/decode_attention.py.
//
// Replaces no Pallas kernel: the reference computes a decode token's
// attention in jnp (src/repro/models/transformer.py attn_decode_core:
// RoPE, a masked where of the new K / V row into the cache, then
// layers.attention_decode's float32 softmax), which XLA fuses under the
// serve step's jit.  Eager PyTorch ran it as 44 launches a layer, among
// them two float32 copies of the layer's whole cache.
//
// What it computes, for each sequence b at position p = lens[b] (the new
// token's row) and each q head h of KV head g = h / REP:
//   - q and k rotated as rope_angles / _rotate do: inv = 1 / powf(theta,
//     i * (1 / (hd / 2))), angle = p * inv, cosf / sinf in float32; the
//     rotated halves x1 c - x2 s and x2 c + x1 s as separate float32
//     products and a sum (never fused: __fmul_rn / __fsub_rn), rounded to
//     the cache's type.  With rope == 0 (learned positions) q and k are
//     taken as they are.  The written K / V rows are the plain version's
//     bits;
//   - the rotated k and the given v written at row p of k_cache / v_cache
//     (the only write to the cache; nothing is written when p >= S);
//   - out[b, h] = sum_{s <= p} softmax_s(q . k_s / sqrt(hd)) v_s, the
//     scores, the online softmax and the P.V sum in float32 (base-2
//     exponentials of scores pre-scaled by log2(e)), cast to the cache's
//     type.  Rows past p are never read (the plain version weighs them
//     exp(-inf) = 0).  A NaN in q, the new row or a live row reaches the
//     output of its KV head's q heads, as in the plain version (the
//     running maxima compare so that a NaN sticks, and the partials meet
//     by a max that keeps it): the engine's finite check on the logits,
//     which sends a poisoned slot to its fallback, depends on it.
//
// Bound: bytes.  A live row costs 2 KV hd elements (its K and V) for 4 H
// hd operations, ~4 operations a byte in bf16 at GQA 32 / 8, far under the
// card's ridge; so CUDA-core float32 and no tensor cores.  At the served
// cells' shapes (B 32, KV 8, hd 64, bf16) a full 1536-row view is 100.7
// MB of K / V, 30.0 us at 3.35 TB/s; a chat mix of ~400 live rows a
// sequence ~26 MB, ~8 us.
//
// Design (flash-decoding in one launch).  A cluster of `splits` blocks of
// 128 threads for each (KV head, sequence), GQA read un-repeated (each K /
// V element loaded once for the REP q heads that share it).  The live
// rows 0..p of a sequence are cut into `splits` equal spans, one a block;
// the wrapper picks `splits` (1-8) so that the grid's KV B splits blocks
// are about what the card holds at once (kernels/decode_attention.splits:
// 2 at the served cells' B 32 x KV 8, 8 at B 1).  In a block, groups of
// hd / 8 threads walk the rows, a thread copying its own 16-byte piece of
// K and V kStages - 1 rows ahead (cp.async into a ring in shared memory:
// no registers held by the copies in flight), each group keeping a
// float32 running max, sum and P.V for its REP heads (rescaled only when
// the max grows); the groups meet by shuffles, the warps in shared
// memory, then the blocks' partials in block 0 through distributed shared
// memory, which writes the output: one launch, no scratch in device
// memory.  Row p is never loaded: the block that holds it takes the
// rotated k and v it wrote from shared memory, so the only write and
// every read are disjoint.
//
// The A/B (NVIDIA H100 80GB HBM3, 700 W; PERF.md) at B 32 x KV 8 x hd 64,
// S 1536: 2 blocks a cluster took 41.2 us with every row live (1.37x the
// bound) and 25.0 us over a chat mix of lengths, against 55-60 / 28-40 us
// at 4 or 8 (a block's prologue and epilogue hold its SM ~4 us, so more,
// shorter blocks lose); rings of 6 or 8 stages were no faster than 4;
// tiles of fixed rows with a second kernel to combine them took 49.6-80
// / 24-34 us; a first body loading two rows a group into registers, no
// ring, at 8 blocks a cluster, 72 / 42 us.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplits = 8;   // blocks a (KV head, sequence): a cluster
constexpr int kThreads = 128;   // 4 warps a block
constexpr int kStages = 4;      // rows in flight a thread, + the one in use
constexpr int kVec = 8;         // elements a 16-byte load

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// the two elements of a 32-bit word, low half first, widened
__device__ __forceinline__ void widen2(uint32_t u, float* f,
                                       const __nv_bfloat16*) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void widen2(uint32_t u, float* f, const __half*) {
  f[0] = __half2float(__ushort_as_half((unsigned short)(u & 0xffffu)));
  f[1] = __half2float(__ushort_as_half((unsigned short)(u >> 16)));
}

template <typename T>
__device__ __forceinline__ void widen8(const uint4& w, float* f) {
  widen2(w.x, f, (const T*)nullptr);
  widen2(w.y, f + 2, (const T*)nullptr);
  widen2(w.z, f + 4, (const T*)nullptr);
  widen2(w.w, f + 6, (const T*)nullptr);
}

// element d of a head rotated, from x1 = x[d % (hd/2)] and x2 = x[d %
// (hd/2) + hd/2], rounded to T; the products and the sum each round once,
// as in the plain version
template <typename T, int HD>
__device__ __forceinline__ T rotated(float x1, float x2, int d, int rope,
                                     const float* c, const float* s) {
  constexpr int kHalf = HD / 2;
  if (!rope) return narrow<T>(d < kHalf ? x1 : x2);
  const int i = d % kHalf;
  return narrow<T>(d < kHalf
      ? __fsub_rn(__fmul_rn(x1, c[i]), __fmul_rn(x2, s[i]))
      : __fadd_rn(__fmul_rn(x2, c[i]), __fmul_rn(x1, s[i])));
}

// the larger of a and b, NaN if either is: a non-finite score or partial
// must reach the output, as it does in the plain version's softmax (the
// engine's finite check on the logits depends on it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// 2^x in one instruction (max relative error 2^-22; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* k_cache, T* v_cache,
                        const int* __restrict__ lens, T* __restrict__ out,
                        int S, int KV, float theta, int rope, float scale) {
  constexpr int kLanes = HD / kVec;            // threads a row: 8 or 16
  constexpr int kGroups = kThreads / kLanes;   // rows a step: 16 or 8
  constexpr int kWarps = kThreads / 32;
  constexpr int kHalf = HD / 2;
  constexpr int kQ = (REP * HD + kThreads - 1) / kThreads;  // q a thread
  constexpr int kRing = kStages * 2 * kThreads * 16;
  constexpr int kWacc = kWarps * REP * HD * 4;
  // each thread's ring of its own 16-byte K and V pieces of the rows it
  // walks; after the walk, the warps' partial P.V sums
  __shared__ __align__(16) unsigned char s_buf[kRing > kWacc ? kRing : kWacc];
  __shared__ float s_cos[kHalf], s_sin[kHalf];
  __shared__ float s_q[REP][HD];       // rotated q, rounded, times scale
  __shared__ float s_k[HD], s_v[HD];   // the new row, as written
  __shared__ float s_wm[kWarps][REP], s_wl[kWarps][REP];
  __shared__ float s_m[REP], s_l[REP];         // the block's partial,
  __shared__ float s_acc[REP * HD];            // read by block 0
  uint4 (*ring)[2][kThreads] = reinterpret_cast<uint4 (*)[2][kThreads]>(s_buf);
  float (*wacc)[REP][HD] = reinterpret_cast<float (*)[REP][HD]>(s_buf);

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;                // the cluster's blocks
  const int split = blockIdx.x;                // == the cluster rank
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = tid / kLanes, d0 = (tid % kLanes) * kVec;
  const int H = KV * REP;
  const int pos = lens[b];
  const int n = max(0, min(pos + 1, S));       // rows attended: 0 .. n-1
  const bool fresh = pos >= 0 && pos < S;      // row pos is the new token
  const int per = (n + splits - 1) / splits;
  const int lo = min(n, split * per), hi = min(n, lo + per);
  const bool mine = fresh && pos >= lo && pos < hi;
  // steps are the same for every thread of the block; in step i group
  // grp takes row lo + i kGroups + grp
  const int steps = (hi - lo + kGroups - 1) / kGroups;
  const size_t row_stride = (size_t)KV * HD;
  const T* kb = k_cache + ((size_t)b * S * KV + g) * HD + d0;
  const T* vb = v_cache + ((size_t)b * S * KV + g) * HD + d0;
  auto issue = [&](int i) {
    const int row = lo + i * kGroups + grp;
    if (i < steps && row < hi && !(fresh && row == pos)) {
      cp_async16(&ring[i % kStages][0][tid], kb + (size_t)row * row_stride);
      cp_async16(&ring[i % kStages][1][tid], vb + (size_t)row * row_stride);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // this thread's q elements (both halves of each pair) and, in the block
  // that holds row pos, the new k pair and v
  const T* qb = q + ((size_t)b * H + (size_t)g * REP) * HD;
  float qx1[kQ], qx2[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int e = tid + j * kThreads;
    if (e < REP * HD) {
      const int i = (e / HD) * HD + (e % HD) % kHalf;
      qx1[j] = widen(qb[i]);
      qx2[j] = widen(qb[i + kHalf]);
    }
  }
  const size_t src = ((size_t)b * KV + g) * HD;
  float kx1 = 0.0f, kx2 = 0.0f, vx = 0.0f;
  if (mine && tid < HD) {
    kx1 = widen(k_new[src + tid % kHalf]);
    kx2 = widen(k_new[src + tid % kHalf + kHalf]);
    vx = widen(v_new[src + tid]);
  }
  // the angles at this position, as rope_angles computes them
  if (rope && tid < kHalf) {
    const float inv = 1.0f / powf(theta, (float)tid * (1.0f / kHalf));
    const float ang = (float)pos * inv;
    s_cos[tid] = cosf(ang);
    s_sin[tid] = sinf(ang);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int e = tid + j * kThreads;
    if (e < REP * HD)
      s_q[e / HD][e % HD] = widen(rotated<T, HD>(qx1[j], qx2[j], e % HD,
                                                 rope, s_cos, s_sin))
                            * scale;
  }
  if (mine && tid < HD) {
    const size_t dst = (((size_t)b * S + pos) * KV + g) * HD;
    const T kr = rotated<T, HD>(kx1, kx2, tid, rope, s_cos, s_sin);
    k_cache[dst + tid] = kr;
    v_cache[dst + tid] = narrow<T>(vx);
    s_k[tid] = widen(kr);
    s_v[tid] = vx;
  }
  __syncthreads();

  float qr[REP][kVec], acc[REP][kVec], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      qr[r][j] = s_q[r][d0 + j];
      acc[r][j] = 0.0f;
    }
  }

  // the walk: a row's copy lands kStages - 1 steps after it is issued;
  // every lane of the warp takes part in the shuffles, `live` guards the
  // update
  for (int i = 0; i < steps; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int row = lo + i * kGroups + grp;
    const bool live = row < hi;
    float kf[kVec], vf[kVec];
    if (fresh && row == pos) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        kf[j] = s_k[d0 + j];
        vf[j] = s_v[d0 + j];
      }
    } else {
      widen8<T>(ring[i % kStages][0][tid], kf);
      widen8<T>(ring[i % kStages][1][tid], vf);
    }
    float sc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) a = fmaf(qr[r][j], kf[j], a);
      sc[r] = a;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
    if (live) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (!(sc[r] <= m[r])) {        // a new running max (or a NaN,
                                       // which then sticks): rescale
          const float corr = ex2(m[r] - sc[r]);
          l[r] *= corr;
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[r][j] *= corr;
          m[r] = sc[r];
        }
        const float p = ex2(sc[r] - m[r]);
        l[r] += p;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(p, vf[j], acc[r][j]);
      }
    }
  }

  // the groups of a warp meet by shuffles, then the warps in shared
  // memory; a partial with no rows (max -inf) weighs 0
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = max_nan(m[r], mo);
      const float ws = m[r] == -INFINITY ? 0.0f : ex2(m[r] - mx);
      const float wo = mo == -INFINITY ? 0.0f : ex2(mo - mx);
      l[r] = l[r] * ws + lo_ * wo;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][j], o);
        acc[r][j] = acc[r][j] * ws + ao * wo;
      }
      m[r] = mx;
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring becomes wacc
  if (lane < kLanes) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) wacc[warp][r][d0 + j] = acc[r][j];
      if (lane == 0) {
        s_wm[warp][r] = m[r];
        s_wl[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < REP * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = max_nan(mx, s_wm[w][r]);
    float sum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = s_wm[w][r] == -INFINITY ? 0.0f
                                               : ex2(s_wm[w][r] - mx);
      sum = fmaf(s_wl[w][r], wt, sum);
      a = fmaf(wacc[w][r][d], wt, a);
    }
    s_acc[e] = a;
    if (d == 0) {
      s_m[r] = mx;
      s_l[r] = sum;
    }
  }

  // the cluster's partials -> the output, in block 0
  cluster.sync();
  if (split == 0) {
    T* ob = out + ((size_t)b * H + (size_t)g * REP) * HD;
    for (int e = tid; e < REP * HD; e += kThreads) {
      const int r = e / HD;
      float ms[kMaxSplits], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kMaxSplits; ++i) {
        ms[i] = i < splits ? cluster.map_shared_rank(s_m, i)[r] : -INFINITY;
        mx = max_nan(mx, ms[i]);
      }
      float sum = 0.0f, a = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxSplits; ++i) {
        if (ms[i] == -INFINITY) continue;
        const float w = ex2(ms[i] - mx);
        sum = fmaf(cluster.map_shared_rank(s_l, i)[r], w, sum);
        a = fmaf(cluster.map_shared_rank(s_acc, i)[e], w, a);
      }
      ob[e] = narrow<T>(a / sum);
    }
  }
  cluster.sync();   // no block leaves while block 0 may read its partial
}

template <typename T, int HD, int REP>
int launch(const void* q, const void* k, const void* v, void* kc, void* vc,
           const void* lens, void* out, int B, int S, int KV, int splits,
           float theta, int rope, float scale, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, HD, REP>, (const T*)q, (const T*)k,
      (const T*)v, (T*)kc, (T*)vc, (const int*)lens, (T*)out, S, KV, theta,
      rope, scale);
}

template <typename T, int HD>
int launch_rep(int rep, const void* q, const void* k, const void* v,
               void* kc, void* vc, const void* lens, void* out, int B, int S,
               int KV, int splits, float theta, int rope, float scale,
               cudaStream_t st) {
#define DECODE_REP(R)                                                       \
  case R:                                                                   \
    return launch<T, HD, R>(q, k, v, kc, vc, lens, out, B, S, KV, splits,   \
                            theta, rope, scale, st);
  switch (rep) {
    DECODE_REP(1)
    DECODE_REP(2)
    DECODE_REP(3)
    DECODE_REP(4)
    DECODE_REP(5)
    DECODE_REP(6)
    DECODE_REP(7)
    DECODE_REP(8)
  }
#undef DECODE_REP
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_hd(int hd, int rep, const void* q, const void* k, const void* v,
              void* kc, void* vc, const void* lens, void* out, int B, int S,
              int KV, int splits, float theta, int rope, float scale,
              cudaStream_t st) {
  if (hd == 64)
    return launch_rep<T, 64>(rep, q, k, v, kc, vc, lens, out, B, S, KV,
                             splits, theta, rope, scale, st);
  if (hd == 128)
    return launch_rep<T, 128>(rep, q, k, v, kc, vc, lens, out, B, S, KV,
                              splits, theta, rope, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, 1, KV * rep, hd); k, v (B, 1, KV, hd); k_cache, v_cache (B, S, KV,
// hd), all contiguous, of one type: bfloat16 (half16 == 0) or float16;
// lens (B,) int32, the new token's row; out (B, 1, KV * rep, hd).  hd 64
// or 128, rep 1-8; each sequence's live rows split over `splits` (1-8)
// blocks of one cluster.  Writes row lens[b] of both caches where
// lens[b] < S.  Returns a cudaError_t.
int decode_attention(const void* q, const void* k, const void* v, void* kc,
                     void* vc, const void* lens, void* out, int half16,
                     int B, int S, int KV, int rep, int hd, int splits,
                     float theta, int rope, float scale, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || KV < 1 || KV > 65535 || rep < 1
      || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (half16)
    return launch_hd<__half>(hd, rep, q, k, v, kc, vc, lens, out, B, S, KV,
                             splits, theta, rope, scale, st);
  return launch_hd<__nv_bfloat16>(hd, rep, q, k, v, kc, vc, lens, out, B, S,
                                  KV, splits, theta, rope, scale, st);
}

}  // extern "C"
