// Dense matrix-vector product y = W x for Hopper (sm_90a).
//
// Replaces dense_mv_pallas (_dense_mv_kernel, src/repro/kernels/dense_mv.py),
// the Newton-analogue baseline: W (R, C) and x (C,) in fp32 or bf16,
// y (R,) fp32, accumulated in fp32 across the whole row.
//
// Bound: bytes. Every element of W is read once for 2 flops, far below
// the card's operations-per-byte ridge, so the kernel must stream W at
// the memory rate. Design for that bound, kept simple: one warp per
// output row, its lanes reading the row in 16-byte vectors (4 fp32 or
// 8 bf16 elements), neighbouring lanes on neighbouring addresses; x is
// staged in shared memory (widened to fp32), one chunk of kChunk
// elements at a time, so the block's eight rows read each x element from
// device memory once per chunk instead of once per row; each lane keeps
// one fp32 partial sum and a warp-shuffle reduce ends the row. A row
// whose start is not 16-byte aligned (C not a multiple of the vector
// width) takes the same loop with scalar loads. No tensor cores: at one
// x column a matrix unit would idle on the bytes. No atomics, so the sum
// order is fixed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;      // rows per block, one warp each
constexpr int kChunk = 2048;   // x elements staged per pass (8 KB fp32)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// dot product of one 16-byte vector of W with the matching x elements
__device__ __forceinline__ float dot16(const float*, uint4 w, const float* xs,
                                       float acc) {
  const float4 xv = *reinterpret_cast<const float4*>(xs);
  acc = fmaf(__uint_as_float(w.x), xv.x, acc);
  acc = fmaf(__uint_as_float(w.y), xv.y, acc);
  acc = fmaf(__uint_as_float(w.z), xv.z, acc);
  return fmaf(__uint_as_float(w.w), xv.w, acc);
}

__device__ __forceinline__ float dot16(const unsigned short*, uint4 w,
                                       const float* xs, float acc) {
  const float4 lo = *reinterpret_cast<const float4*>(xs);
  const float4 hi = *reinterpret_cast<const float4*>(xs + 4);
  // element 2i is the low half of word i (little-endian)
  acc = fmaf(__uint_as_float(w.x << 16), lo.x, acc);
  acc = fmaf(__uint_as_float(w.x & 0xffff0000u), lo.y, acc);
  acc = fmaf(__uint_as_float(w.y << 16), lo.z, acc);
  acc = fmaf(__uint_as_float(w.y & 0xffff0000u), lo.w, acc);
  acc = fmaf(__uint_as_float(w.z << 16), hi.x, acc);
  acc = fmaf(__uint_as_float(w.z & 0xffff0000u), hi.y, acc);
  acc = fmaf(__uint_as_float(w.w << 16), hi.z, acc);
  return fmaf(__uint_as_float(w.w & 0xffff0000u), hi.w, acc);
}

template <typename WT, typename XT>
__global__ void __launch_bounds__(kWarp * kWarps)
dense_mv_kernel(const WT* __restrict__ w, const XT* __restrict__ x,
                float* __restrict__ y, int rows, int cols, int vec) {
  __shared__ __align__(16) float xs[kChunk];
  constexpr int kV = 16 / sizeof(WT);   // elements per 16-byte vector
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const bool active = row < rows;       // all threads reach the barriers
  const WT* wr = w + static_cast<long long>(active ? row : 0) * cols;
  float acc = 0.0f;
  for (int c0 = 0; c0 < cols; c0 += kChunk) {
    const int n = min(kChunk, cols - c0);
    __syncthreads();                    // the previous chunk is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      xs[i] = widen(__ldg(x + c0 + i));
    __syncthreads();
    if (!active) continue;
    if (vec) {                          // n is a multiple of kV here
      const uint4* wv = reinterpret_cast<const uint4*>(wr + c0);
#pragma unroll 4
      for (int v = lane; v < n / kV; v += kWarp)
        acc = dot16(wr, __ldg(wv + v), xs + v * kV, acc);
    } else {
      for (int i = lane; i < n; i += kWarp)
        acc = fmaf(widen(__ldg(wr + c0 + i)), xs[i], acc);
    }
  }
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (active && lane == 0) y[row] = acc;
}

template <typename WT, typename XT>
int launch(const void* w, const void* x, void* y, int rows, int cols, int vec,
           void* stream) {
  const dim3 block(kWarp * kWarps);
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dense_mv_kernel<WT, XT><<<grid, block, 0, s>>>(
      static_cast<const WT*>(w), static_cast<const XT*>(x),
      static_cast<float*>(y), rows, cols, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w f32 or bf16 (R, C) row-major; x f32 or bf16 (C,); y f32 (R,).
// vec = 1 when every row starts 16-byte aligned (C a multiple of the
// vector width and w aligned).
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
