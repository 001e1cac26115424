// Column-chunked ELL SpMV kernels for Hopper (sm_90a).
//
// Replace six Pallas kernels of the JAX package
// (src/repro/kernels/espim_spmv.py):
//   espim_spmv                   <- espim_spmv_pallas (_spmv_kernel)
//   espim_spmv_batched_fp        <- espim_spmv_batched_pallas (_spmv_batched_kernel)
//   espim_spmv_batched_res_fp    <- espim_spmv_batched_res_pallas
//                                   (_spmv_batched_res_kernel)
//   espim_spmv_batched_quant     <- espim_spmv_batched_quant_pallas
//                                   (_spmv_batched_quant_kernel, _spmv_batched_q4_kernel)
//   espim_spmv_batched_glu_fp    <- espim_spmv_batched_glu_pallas (_glu_kernel)
//   espim_spmv_batched_quant_glu <- espim_spmv_batched_quant_glu_pallas (_glu_quant_kernel)
//
// What they compute, with planes (R, K, Lc) and chunk-local column ids:
//   y[r, b] = sum_k sum_l v[r, k, l] * x[k * chunk_cols + cols[r, k, l], b]
// where v is fp32, bf16 (the unbatched kernel and the three _fp kernels,
// which take a values_bf16 flag; a bf16 value widens to fp32 exactly, as
// the reference's in-kernel cast does), int8 codes, or int4 codes packed
// two to a byte (slot 2j in the low nibble of byte j, Lv = ceil(Lc / 2)
// bytes per chunk row). The unbatched kernel takes x (M,) in fp32 or bf16;
// the batched kernels take x (M, B) in fp32 (the wrapper widens a bf16 x). The residual kernel adds residual[r, b] (packed row
// order) to the reduced sum before the one store, the reference's order
// (_spmv_batched_res_kernel: sum, then residual). The quant kernel
// multiplies by scale[r / group_rows] after the reduce unless scale is null
// (the serving path owns its scales). The GLU kernels read a half-major
// (2 * Rg, K, Lc) gate+up pack and write act(gate) * up (Rg, B); the quant
// GLU multiplies BOTH halves by their per-row scale srow before the
// activation, the op order of _glu_quant_kernel.
//
// Bound: bytes. Each slot is read once (4 B col + 4 / 2 / 1 / 0.5 B
// value) for 2 * B flops, so at decode batch B <= 16 the kernels are far
// below the card's operations-per-byte ridge (no tensor cores); the value
// and index planes are ~all of the traffic (x is K * chunk_cols * B
// elements and stays in L1 / L2). The GLU launches read both halves of
// their pair, 8 B per fp32 slot, 5 B per int8 slot, 4.5 B per int4 slot,
// plus 4 B of srow per packed row (quant), and write Rg * B floats. No
// atomics: every sum has a fixed order, so repeated runs give identical
// bits.
//
// Two bodies.
//
// The streaming body serves kernels 1-4 and 6: espim_spmv_stream_kernel
// runs espim_spmv_batched_fp and espim_spmv_batched_quant (the decode
// path's QKV / O / down buckets) and, with its RES flag,
// espim_spmv_batched_res_fp; espim_spmv_stream_glu_kernel runs
// espim_spmv_batched_glu_fp and espim_spmv_batched_quant_glu (its
// gate+up buckets). Those launches are short (32 to ~12k rows of 8-22
// chunks x Lc 80-88 slots) and the warp-per-row body below was
// latency-bound on them, not byte-bound (3.3-3.5x slower on kernels 1-2's
// buckets, 4.6x the addmm on kernel 6's; PERF.md): a lane had one 4-byte
// index load and one value load in flight before the gather that needed
// them, and its 8-wide batch tile carried 8 accumulators at any B. The
// streaming body keeps plane bytes in flight and its chains short:
//   - a lane owns groups of 4 consecutive slots; it loads a group's 4
//     column ids as one 16-byte load and its 4 values as one load (16 B
//     fp32, 8 B bf16, 4 B int8, 2 B int4), and issues U groups' loads
//     before the first gather that needs them. The planes are loaded with
//     L1::no_allocate, so L1 keeps the x rows the gathers hit.
//   - the batch tile BT equals B (instantiated for 1, 2, 4, 8; larger B
//     loops over tiles of 8): BT accumulators a lane, BT * log2(32)
//     shuffles a warp, and one x row of BT floats is one 4/8/16-byte load
//     (two at BT = 8) when the x row pitch allows it.
//   - a row's K * Lc slots are walked in order, lanes interleaved over
//     groups (coalesced plane reads, each plane byte read once). Lc / 4 =
//     20-22 groups a chunk do not fill a warp, so the walk is flat and
//     each lane carries its (chunk base, offset) forward by a compare and
//     subtract: no per-slot division.
//   - a warp a row, or 2 or 4 warps of one block when the launch has few
//     rows (stream_wpr): a small bucket of long rows (down: 22 chunks) was
//     a few long dependent chains on an idle card, while a large bucket
//     already fills the card and only pays the extra reduce. The warps'
//     partial sums meet in shared memory and are added in warp order (no
//     atomics; a row never spans blocks).
//   - x stays in global memory, gathered through L1: staging it in shared
//     memory gained little on the QKV / O buckets and lost on down, where
//     a block copies 176 KB of x before its first gather (the A/B in
//     PERF.md), so the gathers do not set the pace.
//   - widths or pointers that do not meet the vector alignment (Lc not a
//     multiple of 4, a plane not aligned) take a scalar slot walk inside
//     the same kernel; the host picks the walk from the shapes and
//     pointers (stream_mode), the tile from B and the warps a row from
//     the rows.
// The GLU variant's output row r needs gate row r and up row r + Rg of the
// same half-major plane. A team of 1, 2 or 4 warps owns a pair, and the
// warps a pair come from stream_wpr over the pairs, the pairs counting as
// rows (the engines' gate+up buckets hold 384-6944 pairs; on 132 SMs
// those over 2112 take one warp a pair). It walks the gate row, reduces
// it and parks the sum in shared memory, then walks the up row with the
// same BT accumulator registers (design "a"; only BT accumulators are
// live, where 2 * BT spilled at BT = 8). Design "b" (SPLIT) splits the
// team's warps between the two rows at once and meets their sums in
// shared memory in warp order; only scripts/spmv_tile_ab.py instantiates
// it. Design a at U = 2 was the best
// or within 2% of the best of 15 (design, U, warps a pair) variants on
// one full-width layer, fp32 and int8, B = 1 and 4 (the A/B in PERF.md).
// The team's first lane writes the epilogue in the reference's op order:
// act(gate) * up (fp32), or act(gate * srow[r]) * (up * srow[r + Rg])
// (int8 / int4), with apply_act below.
//
// The residual kernel (6) is kernel 1's launch with RES set: the row's
// lead lane writes acc[j] + residual[r * B + b0 + j], so kernels 1-2's
// instantiations (RES false) keep their code. On the fp32 attn_out + down
// buckets at B = 4 it went from 248.4 us on the warp-per-row body to
// 62.3 us (bound 24.0, addmm 54.5; NVIDIA H100 80GB HBM3, 700 W, PERF.md).
//
// The warp-per-row body (espim_spmv_kernel) serves only kernel 5, the
// unbatched espim_spmv: the warp's lanes stride over the row's slots one
// at a time, x is gathered through the read-only cache (fp32 or bf16), a
// warp-shuffle reduce ends each row and lane 0 writes it. It goes once
// kernel 5 moves to the streaming body. Column ids are bound-checked
// against M in place of padding x, in both bodies.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

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

// One warp per output row r of an (R, K, Lc) plane.
template <int P, typename XT, int BT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
espim_spmv_kernel(const void* __restrict__ values, const int* __restrict__ cols,
                  const XT* __restrict__ x, float* __restrict__ out,
                  int rows, int n_chunks, int lc, int lv, int chunk_cols,
                  int m, int b) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (row >= rows) return;  // uniform across the warp
  const int slots = n_chunks * lc;
  const int vrow = (P == kNib) ? n_chunks * lv : slots;
  const long long cg = static_cast<long long>(row) * slots;
  const long long vg = static_cast<long long>(row) * vrow;
  for (int b0 = 0; b0 < b; b0 += BT) {
    const int nb = min(BT, b - b0);
    float acc[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) acc[j] = 0.0f;
    row_accumulate<P, XT, BT>(values, cols, x, vg, cg, lane, slots, lc, lv,
                              chunk_cols, m, b, b0, nb, acc);
    if (lane == 0) {
      float* o = out + static_cast<long long>(row) * b + b0;
      for (int j = 0; j < nb; ++j) o[j] = acc[j];
    }
  }
}

template <int P, typename XT, int BT>
int launch(const void* values, const int* cols, const XT* x, float* out,
           int rows, int n_chunks, int lc, int lv, int chunk_cols, int m,
           int b, void* stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  espim_spmv_kernel<P, XT, BT>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          values, cols, x, out, rows, n_chunks, lc, lv, chunk_cols, m, b);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_unbatched(const void* values, const int* cols, const void* x,
                     int x_bf16, float* out, int rows, int n_chunks, int lc,
                     int chunk_cols, int m, void* stream) {
  if (x_bf16)
    return launch<P, unsigned short, 1>(
        values, cols, static_cast<const unsigned short*>(x), out, rows,
        n_chunks, lc, lc, chunk_cols, m, 1, stream);
  return launch<P, float, 1>(values, cols, static_cast<const float*>(x), out,
                             rows, n_chunks, lc, lc, chunk_cols, m, 1,
                             stream);
}


// --------------------------------------------------------------------------
// The streaming body of kernels 1-4 and 6 (see the note at the head).
// --------------------------------------------------------------------------
constexpr int kStreamThreads = 128;                  // 4 warps a block
constexpr int kStreamWarps = kStreamThreads / kWarp;

// stream_mode bits: the vector slot walk, and whole-row x loads
constexpr int kVecPlanes = 1;
constexpr int kVecX = 2;

// plane loads that do not allocate in L1, which is left to the x rows
__device__ __forceinline__ int4 ld_plane16(const void* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
__device__ __forceinline__ uint2 ld_plane8(const void* p) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p));
  return r;
}
__device__ __forceinline__ unsigned ld_plane4(const void* p) {
  unsigned r;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ unsigned ld_plane2(const void* p) {
  unsigned short r;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(r) : "l"(p));
  return r;
}

// the values of one group of 4 consecutive slots starting at slot s0 of a
// plane (Lc a multiple of 4, so the group lies in one chunk and, for int4,
// starts at byte s0 / 2), as the bits one load brings, and slot i of them
template <int P>
struct Group;
template <>
struct Group<kF32> {
  using T = int4;
  __device__ static T load(const void* v, long long s0) {
    return ld_plane16(static_cast<const float*>(v) + s0);
  }
  __device__ static float get(const T& w, int i) {
    return __int_as_float(i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w);
  }
};
template <>
struct Group<kBF16> {
  using T = uint2;
  __device__ static T load(const void* v, long long s0) {
    return ld_plane8(static_cast<const unsigned short*>(v) + s0);
  }
  __device__ static float get(const T& w, int i) {  // slot 2j: low half
    const unsigned word = i < 2 ? w.x : w.y;
    return __uint_as_float((i & 1) ? word & 0xffff0000u : word << 16);
  }
};
template <>
struct Group<kI8> {
  using T = unsigned;
  __device__ static T load(const void* v, long long s0) {
    return ld_plane4(static_cast<const signed char*>(v) + s0);
  }
  __device__ static float get(T w, int i) {  // byte i, sign-extended
    return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
};
template <>
struct Group<kNib> {
  using T = unsigned;
  __device__ static T load(const void* v, long long s0) {
    return ld_plane2(static_cast<const unsigned char*>(v) + (s0 >> 1));
  }
  __device__ static float get(T w, int i) {  // nibble i, sign-extended
    return static_cast<float>(static_cast<int>(w << (28 - 4 * i)) >> 28);
  }
};

// acc[j] += v * x[off + j] for the tile's nb columns; XV: the BT floats
// at x + off are one aligned row (BT == nb), loaded in 4-16 byte pieces
template <int BT, bool XV>
__device__ __forceinline__ void gather_fma(const float* __restrict__ x,
                                           long long off, float v, int nb,
                                           float (&acc)[BT]) {
  if (XV && BT == 1) {
    acc[0] = fmaf(v, __ldg(x + off), acc[0]);
  } else if (XV && BT == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(x + off));
    acc[0] = fmaf(v, t.x, acc[0]);
    acc[BT - 1] = fmaf(v, t.y, acc[BT - 1]);
  } else if (XV) {
#pragma unroll
    for (int h = 0; h < BT / 4; ++h) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(x + off) + h);
      acc[4 * h] = fmaf(v, t.x, acc[4 * h]);
      acc[4 * h + 1] = fmaf(v, t.y, acc[4 * h + 1]);
      acc[4 * h + 2] = fmaf(v, t.z, acc[4 * h + 2]);
      acc[4 * h + 3] = fmaf(v, t.w, acc[4 * h + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BT; ++j)
      if (j < nb) acc[j] = fmaf(v, __ldg(x + off + j), acc[j]);
  }
}

// advance a lane's (chunk base, offset in chunk) by `step` slots
__device__ __forceinline__ void advance(int& l, int& base, int& k, int step,
                                        int lc, int chunk_cols) {
  l += step;
  while (l >= lc) {
    l -= lc;
    base += chunk_cols;
    ++k;
  }
}

// one row's slots in groups of 4: lane `lane` of `lanes` takes groups
// lane, lane + lanes, ...; U groups' index and value loads are issued
// before the first of their gathers
template <int P, int BT, int U, bool XV>
__device__ __forceinline__ void walk_groups(
    const void* __restrict__ values, const int* __restrict__ cols,
    const float* __restrict__ x, long long rslot, int slots, int lc,
    int chunk_cols, int m, int b, int b0, int nb, int lane, int lanes,
    float (&acc)[BT]) {
  using G = Group<P>;
  const int groups = slots >> 2;
  const int4* c4 = reinterpret_cast<const int4*>(cols + rslot);
  int l = 0, base = 0, k = 0;
  advance(l, base, k, 4 * lane, lc, chunk_cols);
  for (int g = lane; g < groups; g += U * lanes) {
    int4 cv[U];
    typename G::T vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gu = g + u * lanes;
      if (gu < groups) {
        cv[u] = ld_plane16(c4 + gu);
        vv[u] = G::load(values, rslot + 4LL * gu);
      } else {
        cv[u] = make_int4(0, 0, 0, 0);
        vv[u] = typename G::T();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g + u * lanes < groups) {
        const int c[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gc = base + c[i];
          if (static_cast<unsigned>(gc) < static_cast<unsigned>(m))
            gather_fma<BT, XV>(x, static_cast<long long>(gc) * b + b0,
                               G::get(vv[u], i), nb, acc);
        }
      }
      advance(l, base, k, 4 * lanes, lc, chunk_cols);
    }
  }
}

// one row's slots one at a time (any Lc, any alignment)
template <int P, int BT, bool XV>
__device__ __forceinline__ void walk_slots(
    const void* __restrict__ values, const int* __restrict__ cols,
    const float* __restrict__ x, long long rslot, long long vrow, int slots,
    int lc, int lv, int chunk_cols, int m, int b, int b0, int nb, int lane,
    int lanes, float (&acc)[BT]) {
  int l = 0, base = 0, k = 0;
  advance(l, base, k, lane, lc, chunk_cols);
  for (int s = lane; s < slots; s += lanes) {
    const int gc = base + __ldg(cols + rslot + s);
    const float v = slot_value<P>(values, vrow, s, k, l, lv);
    if (static_cast<unsigned>(gc) < static_cast<unsigned>(m))
      gather_fma<BT, XV>(x, static_cast<long long>(gc) * b + b0, v, nb, acc);
    advance(l, base, k, lanes, lc, chunk_cols);
  }
}

// row r's slots into acc[0 : nb) for batch columns b0..b0+nb, by the
// slot walk `mode` names; lane `lane` of `lanes` walks its share
template <int P, int BT, int U>
__device__ __forceinline__ void walk_row(
    const void* __restrict__ values, const int* __restrict__ cols,
    const float* __restrict__ x, long long r, int n_chunks, int lc, int lv,
    int chunk_cols, int m, int b, int b0, int nb, int mode, int lane,
    int lanes, float (&acc)[BT]) {
  const int slots = n_chunks * lc;
  const long long rslot = r * slots;
  const long long vrow = P == kNib ? r * n_chunks * lv : rslot;
  if ((mode & kVecPlanes) && (mode & kVecX))
    walk_groups<P, BT, U, true>(values, cols, x, rslot, slots, lc, chunk_cols,
                                m, b, b0, nb, lane, lanes, acc);
  else if (mode & kVecPlanes)
    walk_groups<P, BT, U, false>(values, cols, x, rslot, slots, lc,
                                 chunk_cols, m, b, b0, nb, lane, lanes, acc);
  else if (mode & kVecX)
    walk_slots<P, BT, true>(values, cols, x, rslot, vrow, slots, lc, lv,
                            chunk_cols, m, b, b0, nb, lane, lanes, acc);
  else
    walk_slots<P, BT, false>(values, cols, x, rslot, vrow, slots, lc, lv,
                             chunk_cols, m, b, b0, nb, lane, lanes, acc);
}

// the warp's sum of acc, in every lane (a butterfly: a fixed order)
template <int BT>
__device__ __forceinline__ void warp_sum(float (&acc)[BT]) {
#pragma unroll
  for (int j = 0; j < BT; ++j)
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
}

// each warp's lane 0 posts its warp sum to part[warp]; every thread of the
// block must call it, and read part only after the barrier
template <int BT>
__device__ __forceinline__ void post_warp_sum(float (&part)[kStreamWarps][BT],
                                              const float (&acc)[BT]) {
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int j = 0; j < BT; ++j) part[threadIdx.x / kWarp][j] = acc[j];
  }
  __syncthreads();
}

// part[w0] + ... + part[w0 + n - 1], added in warp order
template <int BT>
__device__ __forceinline__ void sum_warps(const float (&part)[kStreamWarps][BT],
                                          int w0, int n, float (&acc)[BT]) {
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    float t = part[w0][j];
    for (int w = 1; w < n; ++w) t += part[w0 + w][j];
    acc[j] = t;
  }
}

// A row per `wpr` warps (1, 2 or 4), kStreamWarps / wpr rows a block. The
// row's lanes walk its slots; each warp reduces its partial sums by
// shuffles, and with wpr > 1 the first warp of the row adds the other
// warps' partials from shared memory in warp order. The row's first lane
// stores the sum, times scale[r / group_rows] when scale is not null, plus
// residual[r, b] when RES. Every thread reaches every barrier: a team past
// the last row walks nothing.
template <int P, int BT, int U, bool RES>
__global__ void __launch_bounds__(kStreamThreads)
espim_spmv_stream_kernel(const void* __restrict__ values,
                         const int* __restrict__ cols,
                         const float* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ residual,
                         float* __restrict__ out, int rows, int n_chunks,
                         int lc, int lv, int chunk_cols, int m, int b,
                         int group_rows, int mode, int wpr) {
  __shared__ float part[kStreamWarps][BT];
  const int warp = threadIdx.x / kWarp;
  const int lanes = kWarp * wpr;
  const int lane = threadIdx.x % lanes;  // within the row's team
  const long long r =
      static_cast<long long>(blockIdx.x) * (kStreamWarps / wpr) + warp / wpr;
  const bool live = r < rows;
  for (int b0 = 0; b0 < b; b0 += BT) {
    const int nb = min(BT, b - b0);
    float acc[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) acc[j] = 0.0f;
    if (live)
      walk_row<P, BT, U>(values, cols, x, r, n_chunks, lc, lv, chunk_cols, m,
                         b, b0, nb, mode, lane, lanes, acc);
    warp_sum(acc);
    if (wpr > 1) {
      post_warp_sum(part, acc);
      if (lane == 0) sum_warps(part, warp, wpr, acc);
      __syncthreads();  // the next tile reuses part
    }
    if (live && lane == 0) {
      const float sr = scale ? scale[r / group_rows] : 1.0f;
      float* o = out + r * b + b0;
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        if (j < nb) {
          const float y = scale ? acc[j] * sr : acc[j];
          o[j] = RES ? y + residual[r * b + b0 + j] : y;
        }
      }
    }
  }
}

// GLU: output row r of rows_g from gate row r and up row r + rows_g of a
// half-major (2 * rows_g, K, Lc) plane; a pair per team of `wpr` warps,
// kStreamWarps / wpr pairs a block. SPLIT false (design a): the whole team
// walks the gate row, then the up row, with one set of BT accumulators;
// the gate sum waits in shared memory. SPLIT (design b, wpr 2 or 4): the
// team's first wpr / 2 warps walk the gate row while the others walk the
// up row. Either way the warps' sums are added in warp order, and the
// team's first lane writes act(g) * u, g and u times srow first when srow
// is not null. Every thread reaches every barrier.
template <int P, int BT, int U, bool SPLIT>
__global__ void __launch_bounds__(kStreamThreads)
espim_spmv_stream_glu_kernel(const void* __restrict__ values,
                             const int* __restrict__ cols,
                             const float* __restrict__ x,
                             const float* __restrict__ srow,
                             float* __restrict__ out, int rows_g,
                             int n_chunks, int lc, int lv, int chunk_cols,
                             int m, int b, int mode, int wpr, int act) {
  __shared__ float part[kStreamWarps][BT];
  __shared__ float gate[kStreamWarps][BT];
  const int warp = threadIdx.x / kWarp;
  const int team = warp / wpr;
  const int w0 = team * wpr;                 // the team's first warp
  const int hw = SPLIT ? wpr / 2 : wpr;      // warps walking one row
  const int lanes = kWarp * hw;
  const int lane = threadIdx.x % lanes;      // within the row's walkers
  const bool lead = threadIdx.x % (kWarp * wpr) == 0;
  const long long r =
      static_cast<long long>(blockIdx.x) * (kStreamWarps / wpr) + team;
  const bool live = r < rows_g;
  for (int b0 = 0; b0 < b; b0 += BT) {
    const int nb = min(BT, b - b0);
    float acc[BT];
#pragma unroll
    for (int pass = 0; pass < (SPLIT ? 1 : 2); ++pass) {
      const int half = SPLIT ? (warp - w0) / hw : pass;
#pragma unroll
      for (int j = 0; j < BT; ++j) acc[j] = 0.0f;
      if (live)
        walk_row<P, BT, U>(values, cols, x, r + half * rows_g, n_chunks, lc,
                           lv, chunk_cols, m, b, b0, nb, mode, lane, lanes,
                           acc);
      warp_sum(acc);
      if (SPLIT) {
        post_warp_sum(part, acc);
        if (lead) {
          sum_warps(part, w0, hw, acc);
#pragma unroll
          for (int j = 0; j < BT; ++j) gate[team][j] = acc[j];
          sum_warps(part, w0 + hw, hw, acc);
        }
        __syncthreads();  // the next tile reuses part
      } else {
        if (wpr > 1) {
          post_warp_sum(part, acc);
          if (lead) sum_warps(part, w0, wpr, acc);
          __syncthreads();  // the up pass reuses part
        }
        if (pass == 0 && lead) {
#pragma unroll
          for (int j = 0; j < BT; ++j) gate[team][j] = acc[j];
        }
      }
    }
    if (live && lead) {
      const float sg = srow ? srow[r] : 1.0f;
      const float su = srow ? srow[r + rows_g] : 1.0f;
      float* o = out + r * b + b0;
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        if (j < nb) {
          float g = gate[team][j], u = acc[j];
          if (srow) {
            g *= sg;
            u *= su;
          }
          o[j] = apply_act(g, act) * u;
        }
      }
    }
  }
}

// the batch tile for B: 1, 2, 4, or 8 (B > 8 loops over tiles of 8)
inline int stream_tile(int b) { return b <= 1 ? 1 : b <= 2 ? 2 : b <= 4 ? 4 : 8; }

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// kVecPlanes when every group of 4 slots is one aligned 16-byte index
// load and one aligned value load; kVecX when every x row of a tile is
// one aligned load of BT floats
template <int P>
int stream_mode(const void* values, const int* cols, const float* x, int lc,
                int lv, int b) {
  const int bt = stream_tile(b);
  const unsigned vbytes = P == kF32 ? 16 : P == kBF16 ? 8 : P == kI8 ? 4 : 2;
  const bool vec = lc % 4 == 0 && (P != kNib || 2 * lv == lc) &&
                   aligned(cols, 16) && aligned(values, vbytes);
  const bool vx = b % bt == 0 && aligned(x, 4 * (bt < 4 ? bt : 4));
  return (vec ? kVecPlanes : 0) | (vx ? kVecX : 0);
}

template <int P, int BT, int U, bool RES = false>
int launch_stream_tile(const void* values, const int* cols, const float* x,
                       const float* scale, const float* residual, float* out,
                       int rows, int n_chunks, int lc, int lv, int chunk_cols,
                       int m, int b, int group_rows, int mode, int wpr,
                       void* stream) {
  const int per_block = kStreamWarps / wpr;
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(rows) + per_block - 1) / per_block));
  espim_spmv_stream_kernel<P, BT, U, RES>
      <<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          values, cols, x, scale, residual, out, rows, n_chunks, lc, lv,
          chunk_cols, m, b, group_rows, mode, wpr);
  return static_cast<int>(cudaGetLastError());
}

// groups of 4 slots in flight a lane (the A/B in PERF.md)
constexpr int kStreamU = 2;

// warps a row: as many (1, 2 or 4) as keep rows * warps within kFillWarps
// an SM, so a launch of few rows still fills the card while a large one
// keeps whole rows per warp (the A/B in PERF.md)
constexpr int kFillWarps = 32;
inline int stream_wpr(int rows) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long fill = 1LL * sms * kFillWarps;
  return 4LL * rows <= fill ? 4 : 2LL * rows <= fill ? 2 : 1;
}

// f(std::integral_constant<int, BT>()) for the batch tile BT of B
template <typename F>
int by_tile(int b, F&& f) {
  switch (stream_tile(b)) {
    case 1:
      return f(std::integral_constant<int, 1>());
    case 2:
      return f(std::integral_constant<int, 2>());
    case 4:
      return f(std::integral_constant<int, 4>());
    default:
      return f(std::integral_constant<int, 8>());
  }
}

// kernels 1, 2 and (RES) 6: the tile from B, the slot walk from the shapes
// and pointers, the warps a row from the rows
template <int P, bool RES = false>
int launch_stream(const void* values, const int* cols, const float* x,
                  const float* scale, const float* residual, float* out,
                  int rows, int n_chunks, int lc, int lv, int chunk_cols,
                  int m, int b, int group_rows, void* stream) {
  const int mode = stream_mode<P>(values, cols, x, lc, lv, b);
  const int wpr = stream_wpr(rows);
  return by_tile(b, [&](auto bt) {
    return launch_stream_tile<P, decltype(bt)::value, kStreamU, RES>(
        values, cols, x, scale, residual, out, rows, n_chunks, lc, lv,
        chunk_cols, m, b, group_rows, mode, wpr, stream);
  });
}

template <int P, int BT, int U, bool SPLIT>
int launch_glu_tile(const void* values, const int* cols, const float* x,
                    const float* srow, float* out, int rows_g, int n_chunks,
                    int lc, int lv, int chunk_cols, int m, int b, int mode,
                    int wpr, int act, void* stream) {
  const int per_block = kStreamWarps / wpr;
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(rows_g) + per_block - 1) / per_block));
  espim_spmv_stream_glu_kernel<P, BT, U, SPLIT>
      <<<grid, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          values, cols, x, srow, out, rows_g, n_chunks, lc, lv, chunk_cols, m,
          b, mode, wpr, act);
  return static_cast<int>(cudaGetLastError());
}

// kernels 3 and 4: as kernels 1 and 2, a pair counting as a row, in
// design a (the A/B in PERF.md)
template <int P>
int launch_glu(const void* values, const int* cols, const float* x,
               const float* srow, float* out, int rows_g, int n_chunks,
               int lc, int lv, int chunk_cols, int m, int b, int act,
               void* stream) {
  const int mode = stream_mode<P>(values, cols, x, lc, lv, b);
  const int wpr = stream_wpr(rows_g);
  return by_tile(b, [&](auto bt) {
    return launch_glu_tile<P, decltype(bt)::value, kStreamU, false>(
        values, cols, x, srow, out, rows_g, n_chunks, lc, lv, chunk_cols, m,
        b, mode, wpr, act, stream);
  });
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

// values f32 or bf16 (values_bf16 = 1) (R, K, Lc); x f32 (M, B);
// out (R, B)
int espim_spmv_batched_fp(const void* values, int values_bf16,
                          const void* cols, const void* x, void* out,
                          int rows, int n_chunks, int lc, int chunk_cols,
                          int m, int b, void* stream) {
  const int* c = static_cast<const int*>(cols);
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (values_bf16)
    return launch_stream<kBF16>(values, c, xs, nullptr, nullptr, o, rows,
                                n_chunks, lc, lc, chunk_cols, m, b, 1, stream);
  return launch_stream<kF32>(values, c, xs, nullptr, nullptr, o, rows,
                             n_chunks, lc, lc, chunk_cols, m, b, 1, stream);
}

// values f32 or bf16 (values_bf16 = 1) (R, K, Lc); residual f32 (R, B) in
// packed row order; out (R, B)
int espim_spmv_batched_res_fp(const void* values, int values_bf16,
                              const void* cols, const void* x,
                              const void* residual, void* out, int rows,
                              int n_chunks, int lc, int chunk_cols, int m,
                              int b, void* stream) {
  const int* c = static_cast<const int*>(cols);
  const float* xs = static_cast<const float*>(x);
  const float* res = static_cast<const float*>(residual);
  float* o = static_cast<float*>(out);
  if (values_bf16)
    return launch_stream<kBF16, true>(values, c, xs, nullptr, res, o, rows,
                                      n_chunks, lc, lc, chunk_cols, m, b, 1,
                                      stream);
  return launch_stream<kF32, true>(values, c, xs, nullptr, res, o, rows,
                                   n_chunks, lc, lc, chunk_cols, m, b, 1,
                                   stream);
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
    return launch_stream<kNib>(codes, c, xs, sc, nullptr, o, rows, n_chunks,
                               lc, lv, chunk_cols, m, b, group_rows, stream);
  return launch_stream<kI8>(codes, c, xs, sc, nullptr, o, rows, n_chunks, lc,
                            lc, chunk_cols, m, b, group_rows, stream);
}

// values f32 or bf16 (values_bf16 = 1) (2 * Rg, K, Lc) half-major;
// out (Rg, B)
int espim_spmv_batched_glu_fp(const void* values, int values_bf16,
                              const void* cols, const void* x, void* out,
                              int rows_g, int n_chunks, int lc,
                              int chunk_cols, int m, int b, int act,
                              void* stream) {
  const int* c = static_cast<const int*>(cols);
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (values_bf16)
    return launch_glu<kBF16>(values, c, xs, nullptr, o, rows_g, n_chunks, lc,
                             lc, chunk_cols, m, b, act, stream);
  return launch_glu<kF32>(values, c, xs, nullptr, o, rows_g, n_chunks, lc, lc,
                          chunk_cols, m, b, act, stream);
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
    return launch_glu<kNib>(codes, c, xs, sr, o, rows_g, n_chunks, lc, lv,
                            chunk_cols, m, b, act, stream);
  return launch_glu<kI8>(codes, c, xs, sr, o, rows_g, n_chunks, lc, lc,
                         chunk_cols, m, b, act, stream);
}

}  // extern "C"
