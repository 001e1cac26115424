// Column-chunked ELL SpMV kernels for Hopper (sm_90a).
//
// Replace six Pallas kernels of the JAX package
// (src/repro/kernels/espim_spmv.py):
//   espim_spmv                   <- espim_spmv_pallas (_spmv_kernel)
//   espim_spmv_batched_f32       <- espim_spmv_batched_pallas (_spmv_batched_kernel)
//   espim_spmv_batched_res_f32   <- espim_spmv_batched_res_pallas
//                                   (_spmv_batched_res_kernel)
//   espim_spmv_batched_quant     <- espim_spmv_batched_quant_pallas
//                                   (_spmv_batched_quant_kernel, _spmv_batched_q4_kernel)
//   espim_spmv_batched_glu_f32   <- espim_spmv_batched_glu_pallas (_glu_kernel)
//   espim_spmv_batched_quant_glu <- espim_spmv_batched_quant_glu_pallas (_glu_quant_kernel)
//
// What they compute, with planes (R, K, Lc) and chunk-local column ids:
//   y[r, b] = sum_k sum_l v[r, k, l] * x[k * chunk_cols + cols[r, k, l], b]
// where v is fp32, bf16 (the unbatched kernel only), int8 codes, or int4
// codes packed two to a byte (slot 2j in the low nibble of byte j,
// Lv = ceil(Lc / 2) bytes per chunk row). The unbatched kernel takes x (M,)
// in fp32 or bf16 and is the B = 1 case of the same warp-per-row body.
// The residual kernel adds residual[r, b] (packed row order) to the
// reduced sum before the one store. The quant kernel multiplies by
// scale[r / group_rows] after the reduce unless scale is null (the
// serving path owns its scales). The GLU kernels read a half-major
// (2 * Rg, K, Lc) gate+up pack and write act(gate) * up (Rg, B); the quant
// GLU multiplies BOTH halves by their per-row scale srow before the
// activation, the op order of _glu_quant_kernel.
//
// Bound: bytes. Each slot is read once (4 B col + 4 / 2 / 1 / 0.5 B
// value) for 2 * B flops, so at decode batch B <= 16 the kernel is far
// below the card's operations-per-byte ridge; the value and index planes
// are ~all of the traffic (x is K * chunk_cols * B elements and stays in
// L2). Design for that bound, kept simple: one warp per packed row (per
// gate/up row pair for GLU); the warp's lanes stride over the row's
// K * Lc contiguous slots so plane reads are coalesced and each plane
// byte is read exactly once; x rows are gathered through the read-only
// cache (__ldg), contiguous over B in the (M, B) layout; B partial sums
// live in registers, tiled by the batch tile BT so any B works; a
// warp-shuffle reduce ends each row and lane 0 writes it, with the
// residual added there (no second pass). Column ids are bound-checked
// against M in place of padding x. No shared memory, no atomics: the sum
// order is fixed, so repeated runs give identical bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kBTile = 8;   // batch columns accumulated per pass over a row

enum Plane { kF32 = 0, kI8 = 1, kNib = 2, kBF16 = 3 };

// bf16 travels as its 16-bit pattern; widening to fp32 is exact
__device__ __forceinline__ float bf16_bits_to_float(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// element i of x, fp32 or bf16, widened to fp32
__device__ __forceinline__ float load_x(const float* x, long long i) {
  return __ldg(x + i);
}
__device__ __forceinline__ float load_x(const unsigned short* x, long long i) {
  return bf16_bits_to_float(__ldg(x + i));
}

enum Act { kSilu = 0, kGelu = 1, kRelu = 2, kRelu2 = 3 };

// value of slot (k, l) of a row whose plane starts at `base`
template <int P>
__device__ __forceinline__ float slot_value(const void* v, long long base,
                                            int s, int k, int l, int lv) {
  if (P == kF32) return __ldg(static_cast<const float*>(v) + base + s);
  if (P == kBF16)
    return bf16_bits_to_float(
        __ldg(static_cast<const unsigned short*>(v) + base + s));
  if (P == kI8)
    return static_cast<float>(__ldg(static_cast<const signed char*>(v) + base + s));
  const unsigned char byte =
      __ldg(static_cast<const unsigned char*>(v) + base +
            static_cast<long long>(k) * lv + (l >> 1));
  // sign-extend the nibble from the int8 bit pattern by arithmetic shifts
  const int code = (l & 1)
      ? (static_cast<int>(static_cast<signed char>(byte)) >> 4)
      : (static_cast<int>(static_cast<unsigned>(byte) << 28) >> 28);
  return static_cast<float>(code);
}

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kSilu:
      return v / (1.0f + expf(-v));
    case kGelu: {  // tanh form, as jax.nn.gelu(approximate=True)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case kRelu:
      return fmaxf(v, 0.0f);
    default: {
      const float r = fmaxf(v, 0.0f);
      return r * r;
    }
  }
}

// accumulate one row's slots into acc[0 : nb) for batch columns b0..b0+nb
template <int P, typename XT, int BT>
__device__ __forceinline__ void row_accumulate(
    const void* __restrict__ values, const int* __restrict__ cols,
    const XT* __restrict__ x, long long vbase, long long cbase, int lane,
    int slots, int lc, int lv, int chunk_cols, int m, int b, int b0, int nb,
    float (&acc)[BT]) {
  for (int s = lane; s < slots; s += kWarp) {
    const int k = s / lc;
    const int l = s - k * lc;
    const int g = k * chunk_cols + __ldg(cols + cbase + s);
    const float v = slot_value<P>(values, vbase, s, k, l, lv);
    if (static_cast<unsigned>(g) < static_cast<unsigned>(m)) {
      const long long xr = static_cast<long long>(g) * b + b0;
#pragma unroll
      for (int j = 0; j < BT; ++j)
        if (j < nb) acc[j] = fmaf(v, load_x(x, xr + j), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BT; ++j)
    for (int off = kWarp / 2; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
}

// One warp per output row. Non-GLU: row r of an (R, K, Lc) plane. GLU:
// gate row r and up row r + rows_out of a (2 * rows_out, K, Lc) plane.
template <int P, bool GLU, typename XT, int BT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
espim_spmv_kernel(const void* __restrict__ values, const int* __restrict__ cols,
                  const XT* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int rows_out, int n_chunks, int lc, int lv, int chunk_cols,
                  int m, int b, int group_rows, int act) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (row >= rows_out) return;  // uniform across the warp
  const int slots = n_chunks * lc;
  const int vrow = (P == kNib) ? n_chunks * lv : slots;
  const long long cg = static_cast<long long>(row) * slots;
  const long long vg = static_cast<long long>(row) * vrow;
  const long long cu = static_cast<long long>(row + rows_out) * slots;
  const long long vu = static_cast<long long>(row + rows_out) * vrow;
  for (int b0 = 0; b0 < b; b0 += BT) {
    const int nb = min(BT, b - b0);
    float ag[BT];
    float au[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) ag[j] = au[j] = 0.0f;
    row_accumulate<P, XT, BT>(values, cols, x, vg, cg, lane, slots, lc, lv,
                              chunk_cols, m, b, b0, nb, ag);
    if (GLU)
      row_accumulate<P, XT, BT>(values, cols, x, vu, cu, lane, slots, lc, lv,
                                chunk_cols, m, b, b0, nb, au);
    if (lane == 0) {
      float* o = out + static_cast<long long>(row) * b + b0;
      if (GLU) {
        const float sg = scale ? scale[row] : 1.0f;
        const float su = scale ? scale[row + rows_out] : 1.0f;
        for (int j = 0; j < nb; ++j) {
          float gate = ag[j], up = au[j];
          if (scale) {
            gate *= sg;
            up *= su;
          }
          o[j] = apply_act(gate, act) * up;
        }
      } else {
        const float sr = scale ? scale[row / group_rows] : 1.0f;
        const float* res =
            residual ? residual + static_cast<long long>(row) * b + b0
                     : nullptr;
        for (int j = 0; j < nb; ++j) {
          const float y = scale ? ag[j] * sr : ag[j];
          o[j] = res ? y + res[j] : y;
        }
      }
    }
  }
}

template <int P, bool GLU, typename XT = float, int BT = kBTile>
int launch(const void* values, const int* cols, const XT* x,
           const float* scale, const float* residual, float* out,
           int rows_out, int n_chunks, int lc, int lv, int chunk_cols, int m,
           int b, int group_rows, int act, void* stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((rows_out + kWarpsPerBlock - 1) / kWarpsPerBlock);
  espim_spmv_kernel<P, GLU, XT, BT>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          values, cols, x, scale, residual, out, rows_out, n_chunks, lc, lv,
          chunk_cols, m, b, group_rows, act);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_unbatched(const void* values, const int* cols, const void* x,
                     int x_bf16, float* out, int rows, int n_chunks, int lc,
                     int chunk_cols, int m, void* stream) {
  if (x_bf16)
    return launch<P, false, unsigned short, 1>(
        values, cols, static_cast<const unsigned short*>(x), nullptr, nullptr,
        out, rows, n_chunks, lc, lc, chunk_cols, m, 1, 1, 0, stream);
  return launch<P, false, float, 1>(values, cols, static_cast<const float*>(x),
                                    nullptr, nullptr, out, rows, n_chunks, lc,
                                    lc, chunk_cols, m, 1, 1, 0, stream);
}

}  // namespace

extern "C" {

// values f32 or bf16 (R, K, Lc); x f32 or bf16 (M,); out f32 (R,)
int espim_spmv(const void* values, int values_bf16, const void* cols,
               const void* x, int x_bf16, void* out, int rows, int n_chunks,
               int lc, int chunk_cols, int m, void* stream) {
  const int* c = static_cast<const int*>(cols);
  float* o = static_cast<float*>(out);
  if (values_bf16)
    return launch_unbatched<kBF16>(values, c, x, x_bf16, o, rows, n_chunks,
                                   lc, chunk_cols, m, stream);
  return launch_unbatched<kF32>(values, c, x, x_bf16, o, rows, n_chunks, lc,
                                chunk_cols, m, stream);
}

// values f32 (R, K, Lc); out (R, B)
int espim_spmv_batched_f32(const void* values, const void* cols,
                           const void* x, void* out, int rows, int n_chunks,
                           int lc, int chunk_cols, int m, int b,
                           void* stream) {
  return launch<kF32, false>(values, static_cast<const int*>(cols),
                             static_cast<const float*>(x), nullptr, nullptr,
                             static_cast<float*>(out), rows, n_chunks, lc, lc,
                             chunk_cols, m, b, 1, 0, stream);
}

// values f32 (R, K, Lc); residual f32 (R, B) in packed row order; out (R, B)
int espim_spmv_batched_res_f32(const void* values, const void* cols,
                               const void* x, const void* residual, void* out,
                               int rows, int n_chunks, int lc, int chunk_cols,
                               int m, int b, void* stream) {
  return launch<kF32, false>(values, static_cast<const int*>(cols),
                             static_cast<const float*>(x), nullptr,
                             static_cast<const float*>(residual),
                             static_cast<float*>(out), rows, n_chunks, lc, lc,
                             chunk_cols, m, b, 1, 0, stream);
}

// codes int8 (R, K, Lc) or nibble-packed uint8 (R, K, lv); scales
// (R / group_rows,) f32 or null; out (R, B)
int espim_spmv_batched_quant(const void* codes, int nibble, int lv,
                             const void* cols, const void* scales,
                             int group_rows, const void* x, void* out,
                             int rows, int n_chunks, int lc, int chunk_cols,
                             int m, int b, void* stream) {
  const int* c = static_cast<const int*>(cols);
  const float* xs = static_cast<const float*>(x);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (nibble)
    return launch<kNib, false>(codes, c, xs, sc, nullptr, o, rows, n_chunks,
                               lc, lv, chunk_cols, m, b, group_rows, 0,
                               stream);
  return launch<kI8, false>(codes, c, xs, sc, nullptr, o, rows, n_chunks, lc,
                            lc, chunk_cols, m, b, group_rows, 0, stream);
}

// values f32 (2 * Rg, K, Lc) half-major; out (Rg, B)
int espim_spmv_batched_glu_f32(const void* values, const void* cols,
                               const void* x, void* out, int rows_g,
                               int n_chunks, int lc, int chunk_cols, int m,
                               int b, int act, void* stream) {
  return launch<kF32, true>(values, static_cast<const int*>(cols),
                            static_cast<const float*>(x), nullptr, nullptr,
                            static_cast<float*>(out), rows_g, n_chunks, lc, lc,
                            chunk_cols, m, b, 1, act, stream);
}

// codes int8 / nibble uint8 (2 * Rg, K, Lc | lv); srow (2 * Rg,) f32;
// out (Rg, B)
int espim_spmv_batched_quant_glu(const void* codes, int nibble, int lv,
                                 const void* cols, const void* srow,
                                 const void* x, void* out, int rows_g,
                                 int n_chunks, int lc, int chunk_cols, int m,
                                 int b, int act, void* stream) {
  const int* c = static_cast<const int*>(cols);
  const float* xs = static_cast<const float*>(x);
  const float* sr = static_cast<const float*>(srow);
  float* o = static_cast<float*>(out);
  if (nibble)
    return launch<kNib, true>(codes, c, xs, sr, nullptr, o, rows_g, n_chunks,
                              lc, lv, chunk_cols, m, b, 1, act, stream);
  return launch<kI8, true>(codes, c, xs, sr, nullptr, o, rows_g, n_chunks, lc,
                           lc, chunk_cols, m, b, 1, act, stream);
}

}  // extern "C"
