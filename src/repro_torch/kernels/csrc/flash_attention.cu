// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (_flash_kernel,
// src/repro/kernels/flash_attention.py): q, k, v (BH, S, hd) in fp32 or
// bf16, out (BH, S, hd) in q's dtype; scores of q * (1 / sqrt(hd))
// against k; keys at k_pos >= S masked, and keys after the query
// (q_pos < k_pos) masked when causal; masked scores are -1e30, as in the
// reference. The running max m, sum l and output acc stay in fp32
// registers across the key tiles, so device memory sees only the q, k, v
// and out streams.
//
// Bound: operations at long S (4 * S^2 * hd flops per head against
// 4 * S * hd elements of traffic; half the flops when causal). This first
// version uses scalar fp32 FMAs, not the tensor cores (wgmma is later
// work), so it runs far from the bf16 tensor-core peak. Design, kept
// simple: one block of 8 warps per (head, tile of kBQ = 64 queries); the
// block stages its scaled q tile once, then walks the key tiles of kBK =
// 32 keys (only those at or before the tile's last query when causal),
// staging k and v in shared memory widened to fp32 (k rows padded to
// hd + 4 floats so the lanes' 16-byte reads hit distinct banks). Each
// warp owns 8 query rows: in the score step lane j computes the 8 scores
// against key j from 16-byte shared-memory reads (q reads are broadcast),
// the warp's butterfly reductions give each row's tile max and sum, and
// the probabilities go to a per-warp tile in shared memory; in the
// p @ v step each lane owns the hd / 32 output columns lane + 32 i
// (conflict-free v reads, coalesced stores) and reads 4 probabilities
// per row as one broadcast vector. No atomics; the sum order is fixed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kBQ = 64;                // query rows per block
constexpr int kRows = kBQ / kWarps;    // query rows per warp
constexpr int kBK = 32;                // keys per tile, one per lane
constexpr float kNegInf = -1e30f;      // the reference's mask value

__device__ __forceinline__ float load(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const unsigned short* p, long long i) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p + i)) << 16);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(unsigned short* p, long long i,
                                      float v) {
  p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + kBK * (HD + 4) + kBK * HD + kBQ * kBK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarp * kWarps)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int seq,
                       int causal, float scale) {
  constexpr int KS = HD + 4;           // padded k row stride, floats
  constexpr int DPL = HD / kWarp;      // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kBQ][HD], pre-scaled
  float* ks = qs + kBQ * HD;           // [kBK][KS]
  float* vs = ks + kBK * KS;           // [kBK][HD]
  float* ps = vs + kBK * HD;           // [kBQ][kBK] probabilities
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int r0 = (tid / kWarp) * kRows;     // this warp's first tile row
  const int q0 = blockIdx.x * kBQ;
  const long long base = static_cast<long long>(blockIdx.y) * seq * HD;

  for (int e = tid; e < kBQ * HD; e += blockDim.x) {
    const int r = e / HD;
    qs[e] = q0 + r < seq
        ? load(q, base + static_cast<long long>(q0) * HD + e) * scale
        : 0.0f;
  }
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  const int k_end = causal ? min(seq, q0 + kBQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                   // previous tile consumed, q staged
    for (int e = tid; e < kBK * HD; e += blockDim.x) {
      const int j = e / HD;
      const int d = e - j * HD;
      const bool in = k0 + j < seq;
      const long long g = base + static_cast<long long>(k0) * HD + e;
      ks[j * KS + d] = in ? load(k, g) : 0.0f;
      vs[e] = in ? load(v, g) : 0.0f;
    }
    __syncthreads();

    // scores of the warp's rows against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* kr = ks + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * HD + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
      const bool keep = kpos < seq && (!causal || qpos >= kpos);
      const float sv = keep ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      ps[(r0 + r) * kBK + lane] = p;
    }
    __syncwarp();

    // acc[r][i] += sum_j p[r][j] * v[j][lane + 32 i]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(ps + (r0 + r) * kBK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = vs + (j + jj) * HD + lane;
        float vv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) vv[i] = vr[i * kWarp];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = jj == 0 ? pv[r].x
                        : jj == 1 ? pv[r].y
                        : jj == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= seq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const long long o = base + static_cast<long long>(qpos) * HD + lane;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      store(out, o + i * kWarp, acc[r][i] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int seq, int causal, float scale, void* stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((seq + kBQ - 1) / kBQ, bh);
  flash_attention_kernel<T, HD>
      <<<grid, kWarp * kWarps, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), seq, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int bh,
              int seq, int hd, int causal, float scale, void* stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, bh, seq, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, seq, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, seq, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, out (BH, S, hd) contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1);
// hd in {32, 64, 128}; scale = 1 / sqrt(hd).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int bf16, int bh, int seq, int hd, int causal,
                    float scale, void* stream) {
  if (bf16)
    return launch_hd<unsigned short>(q, k, v, out, bh, seq, hd, causal, scale,
                                     stream);
  return launch_hd<float>(q, k, v, out, bh, seq, hd, causal, scale, stream);
}

}  // extern "C"
