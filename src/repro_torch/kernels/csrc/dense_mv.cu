// Dense matrix-vector product y = W x for Hopper (sm_90a).
//
// Replaces dense_mv_pallas (_dense_mv_kernel, src/repro/kernels/dense_mv.py),
// the Newton-analogue baseline: W (R, C) and x (C,) in fp32 or bf16,
// y (R,) fp32, accumulated in fp32 across the whole row.
//
// Bound: bytes. Every element of W is read once for 2 flops, far below
// the card's operations-per-byte ridge, so the kernel must keep enough of
// W's bytes in flight to stream it at the memory rate. No tensor cores:
// at one x column a matrix unit would idle on the bytes.
//
// The streaming body (dense_mv_kernel<WT, XT, U>), the SpMV streaming
// body's recipe (csrc/espim_spmv.cu) on a dense row:
//   - a team of kWarpsPerRow warps owns a row; its lanes walk the row in
//     16-byte vectors (4 fp32 or 8 bf16 elements), neighbouring lanes on
//     neighbouring addresses, and each lane issues U independent vector
//     loads (ld.global.nc.L1::no_allocate) before the first of their
//     FMAs, so U * 16 bytes a lane are in flight and L1 is left to x.
//   - x is read beside W through L1 (__ldg), with no barrier in the row
//     walk. The body it replaces staged x in shared memory in chunks of
//     2048 between two barriers, so every warp's W stream drained at each
//     chunk edge.
//   - the team's partial sums meet in shared memory and are added in warp
//     order.
//   - a row whose start is not 16-byte aligned (C not a multiple of the
//     vector width, or an unaligned pointer) takes the same walk with
//     scalar loads.
// No atomics: each lane's sum, the warp's butterfly and the team's warp
// order are fixed, so two launches give identical bits.
//
// The A/B (scripts/dense_mv_ab.py; NVIDIA H100 80GB HBM3, 700 W; PERF.md)
// over U (2, 4, 8) x warps a row (1, 2, 4) x x through L1 or staged whole
// in shared memory, at W 4096 x 4096, 4096 x 11008 and 11008 x 4096 in
// fp32 and bf16: U = 2 with 4 warps a row and x through L1 took the least
// time over the six (225.9 us against torch.mv's 251.3; fp32 4096 x 11008
// 62.1 us, 2.90 TB/s); every x-in-shared-memory variant took 2-8% more
// than its x-through-L1 twin, and that route was removed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                 // 8 warps a block
constexpr int kWarps = kThreads / kWarp;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// a 16-byte vector of W that does not allocate in L1
__device__ __forceinline__ uint4 ld_w16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// N consecutive elements of x from c, widened, read through L1 as one or
// two vector loads
template <int N, typename XT>
__device__ __forceinline__ void load_x(const XT* __restrict__ x, int c,
                                       float (&out)[N]) {
  if constexpr (sizeof(XT) == 4) {
    const float* src = reinterpret_cast<const float*>(x) + c;
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src) + h);
      out[4 * h] = t.x;
      out[4 * h + 1] = t.y;
      out[4 * h + 2] = t.z;
      out[4 * h + 3] = t.w;
    }
  } else {                                    // bf16 x: N * 2 bytes
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(x) + c;
    unsigned words[N / 2];
    if constexpr (N == 8) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(src));
      words[0] = t.x;
      words[1] = t.y;
      words[2] = t.z;
      words[3] = t.w;
    } else {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
      words[0] = t.x;
      words[1] = t.y;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

// acc += the 16-byte vector w of W's elements times xv
__device__ __forceinline__ float dot16(const float*, uint4 w,
                                       const float (&xv)[4], float acc) {
  acc = fmaf(__uint_as_float(w.x), xv[0], acc);
  acc = fmaf(__uint_as_float(w.y), xv[1], acc);
  acc = fmaf(__uint_as_float(w.z), xv[2], acc);
  return fmaf(__uint_as_float(w.w), xv[3], acc);
}
__device__ __forceinline__ float dot16(const unsigned short*, uint4 w,
                                       const float (&xv)[8], float acc) {
  // element 2i is the low half of word i (little-endian)
  acc = fmaf(__uint_as_float(w.x << 16), xv[0], acc);
  acc = fmaf(__uint_as_float(w.x & 0xffff0000u), xv[1], acc);
  acc = fmaf(__uint_as_float(w.y << 16), xv[2], acc);
  acc = fmaf(__uint_as_float(w.y & 0xffff0000u), xv[3], acc);
  acc = fmaf(__uint_as_float(w.z << 16), xv[4], acc);
  acc = fmaf(__uint_as_float(w.z & 0xffff0000u), xv[5], acc);
  acc = fmaf(__uint_as_float(w.w << 16), xv[6], acc);
  return fmaf(__uint_as_float(w.w & 0xffff0000u), xv[7], acc);
}

// A row per team of `wpr` warps (1, 2 or 4), kWarps / wpr rows a block.
// Every thread reaches every barrier: a team past the last row walks
// nothing.
template <typename WT, typename XT, int U>
__global__ void __launch_bounds__(kThreads)
dense_mv_kernel(const WT* __restrict__ w, const XT* __restrict__ x,
                float* __restrict__ y, int rows, int cols, int vec, int wpr) {
  __shared__ float part[kWarps];
  constexpr int kV = 16 / sizeof(WT);         // elements a 16-byte vector
  const int warp = threadIdx.x / kWarp;
  const int lanes = kWarp * wpr;
  const int lane = threadIdx.x % lanes;       // within the row's team
  const int row = blockIdx.x * (kWarps / wpr) + warp / wpr;
  const bool live = row < rows;
  const WT* wr = w + static_cast<long long>(live ? row : 0) * cols;
  float acc = 0.0f;
  if (live && vec) {
    const int nv = cols / kV;
    const uint4* wv = reinterpret_cast<const uint4*>(wr);
    for (int v0 = lane; v0 < nv; v0 += U * lanes) {
      uint4 t[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * lanes;
        t[u] = v < nv ? ld_w16(wv + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * lanes;
        if (v < nv) {
          float xv[kV];
          load_x<kV>(x, v * kV, xv);
          acc = dot16(wr, t[u], xv, acc);
        }
      }
    }
  } else if (live) {
    for (int i = lane; i < cols; i += lanes)
      acc = fmaf(widen(__ldg(wr + i)), widen(__ldg(x + i)), acc);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (wpr > 1) {
    if (threadIdx.x % kWarp == 0) part[warp] = acc;
    __syncthreads();
    if (lane == 0) {
      acc = part[warp];
      for (int i = 1; i < wpr; ++i) acc += part[warp + i];
    }
  }
  if (live && lane == 0) y[row] = acc;
}

// the entry point's U and warps a row (the A/B above)
constexpr int kU = 2;
constexpr int kWarpsPerRow = 4;

// one launch of the body at (U, warps a row)
template <typename WT, typename XT, int U>
int launch_body(const void* w, const void* x, void* y, int rows, int cols,
                int vec, int wpr, void* stream) {
  const int per_block = kWarps / wpr;
  const dim3 grid((rows + per_block - 1) / per_block);
  dense_mv_kernel<WT, XT, U>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const WT*>(w), static_cast<const XT*>(x),
          static_cast<float*>(y), rows, cols, vec, wpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, typename XT>
int launch(const void* w, const void* x, void* y, int rows, int cols, int vec,
           void* stream) {
  return launch_body<WT, XT, kU>(w, x, y, rows, cols, vec, kWarpsPerRow,
                                 stream);
}

}  // namespace

extern "C" {

// w f32 or bf16 (R, C) row-major; x f32 or bf16 (C,); y f32 (R,).
// vec = 1 when every row of w and x start 16-byte aligned (C a multiple
// of the vector width, w and x aligned).
int dense_mv(const void* w, int w_bf16, const void* x, int x_bf16, void* y,
             int rows, int cols, int vec, void* stream) {
  if (w_bf16)
    return x_bf16
        ? launch<unsigned short, unsigned short>(w, x, y, rows, cols, vec,
                                                 stream)
        : launch<unsigned short, float>(w, x, y, rows, cols, vec, stream);
  return x_bf16 ? launch<float, unsigned short>(w, x, y, rows, cols, vec,
                                                stream)
                : launch<float, float>(w, x, y, rows, cols, vec, stream);
}

}  // extern "C"
