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
//   espim_spmv_group             <- one packed group's buckets of the four
//                                   batched kernels above in one launch
//                                   (the decode step's _group_apply and
//                                   _group_take: scale, concatenate, take)
//
// What they compute, with planes (R, K, Lc) and chunk-local column ids:
//   y[r, b] = sum_k sum_l v[r, k, l] * x[k * chunk_cols + cols[r, k, l], b]
// where v is fp32, bf16 (widened to fp32 exactly, as the reference's
// in-kernel cast does), int8 codes, or int4 codes packed two to a byte
// (slot 2j in the low nibble of byte j, Lv = ceil(Lc / 2) bytes per chunk
// row). The unbatched kernel takes x (M,) in fp32 or bf16; the batched
// kernels take x (M, B) in fp32 (the wrapper widens a bf16 x). After a
// row's sum, in the reference's op order: times scale[r / group_rows]
// when there is a scale (the serving path's per-row srow is group_rows 1:
// the single multiply of sparse_model's unfused `yp * srow`), plus
// residual[r, b] (kernel 6), stored at row out_row0 + r of the packed
// output or, for a take group, at perm[out_row0 + r] (pad rows, perm -1,
// are not stored). The GLU kernels read a half-major (2 * Rg, K, Lc)
// gate+up plane and write act(gate) * up (Rg, B); with scales, both halves
// are multiplied by their srow before the activation (_glu_quant_kernel's
// order).
//
// Bound: bytes. Each slot is read once (4 B col + 4 / 2 / 1 / 0.5 B
// value) for 2 * B flops, so at decode batch B <= 16 the kernels are far
// below the card's operations-per-byte ridge (no tensor cores); the value
// and index planes are ~all of the traffic (x is K * chunk_cols * B floats
// and stays in L1 / L2). No atomics: every sum has a fixed order.
//
// Two bodies.
//
// The ring body serves kernels 1-4 and 6 and the grouped entry point:
// espim_spmv_stream_kernel (plain, scale, residual and take epilogues)
// and espim_spmv_stream_glu_kernel (the GLU epilogue). What held their
// first (streaming, register-level) design back on the decode step's
// buckets was launch count and bytes in flight: one launch a bucket (7 of
// kernel 2 a layer, 384-1800 rows each taking 7-12 us whatever its bytes,
// a small bucket paying its own ramp and tail on 132 SMs), plus a scale
// multiply, a concatenation and a take on the host around them; and a
// lane kept U <= 4 groups of 4 slots (~40 B at U = 2) in flight, each
// gather waiting on an index that came from HBM through a register. The
// ring body:
//   - one persistent launch a group: its buckets (<= kMaxBuckets) travel
//     by value in the launch's parameters (no device-side pointer table
//     that a swapped plane could leave stale); the grid is as many blocks
//     as fit the SMs (fewer for few rows), and a static split, from the
//     bucket shapes alone (the sparsity is known before inference, SDDS's
//     premise), gives each block a contiguous range of the group's output
//     rows holding about the same number of padded slots;
//   - a block's rows of one bucket are one contiguous byte range of the
//     index plane and one of the value plane (two each for GLU); its
//     producer warp streams them, a tile of whole rows at a time (a piece
//     of a row when one row outgrows a stage), into a ring of stages by
//     bulk copies (cp.async.bulk ... mbarrier::complete_tx), the index
//     spans completing on the stage's index barrier ahead of the value
//     spans on its value barrier. Bulk copies need 16-byte aligned
//     addresses and sizes and rows are not 16-byte multiples (int8 rows
//     are K * Lc bytes), so each span's 16-byte interior is copied in bulk
//     and its head and tail bytes by the producer's lanes: no byte outside
//     a plane is read. The ring (up to u + 2 stages, the schedule's u, of
//     up to 48 KB each, as shared memory beside x allows, sized for the
//     most rows in flight), not a lane's registers, sets the bytes in
//     flight on an SM;
//   - x is the other limit: a gather of x rows at random columns. Through
//     L1 it ran ~1 slot a clock an SM; so the producer first copies the
//     whole of x into shared memory when it fits beside 2 stages (every
//     case of the decode step at B <= 4: 64 KB for QKV, O and gate+up,
//     176 KB for down at B = 4, which leaves 2 stages), and the ring takes
//     the room left. Else x is gathered through L1, and on a tile's index
//     barrier each lane prefetches into L1 the x rows of its first group
//     (the paper's index-ahead-of-value prefetch);
//   - 16 consumer warps a block (one block an SM: the shared memory) take
//     the tiles in order, walk their rows from shared memory and free each
//     stage on its empty barrier. A waiting warp polls with one lane and
//     backs off (32 lanes polling an mbarrier crowd the walkers). The walk
//     is bound by instructions a slot, not by bytes: its common case
//     (walk_fast: Lc a multiple of 4, aligned spans, x staged, one x row
//     a vector load) issues an index load a group, a value load, and a
//     32-bit-addressed ld.shared and B FMAs a slot;
//   - a row is walked by a team of 1, 2 or 4 warps (the schedule's wpr;
//     0: one warp, 4 for a row of more than kWideRowSlots); lane i of the
//     team's L lanes takes the row's groups of 4 consecutive slots i,
//     i + L, ... and adds each group's slots in order, then a butterfly
//     and, across the team's warps, a sum in warp order. That order
//     depends on the row's own slots and its team alone, not on B, the
//     stage, the block, the launch or the bucket's neighbours, so a column
//     gives the same bits alone and inside a batch, a grouped launch gives
//     the per-bucket launches' bits, and the GLU kernel's gate and up sums
//     are the plain kernel's sums of those rows;
//   - the batch tile BT is 1, 4 or 8 (B = 2 or 3 runs tile 4 with its
//     columns masked, larger B loops over tiles of 8 on the same stage);
//   - the epilogue (scale, residual, GLU, take, the bucket's row offset in
//     the group's one output) runs in the team's first lane; the row's
//     output row and scales are loaded before its walk.
// The shape of the ring (consumer warps, stages, stage bytes: PortRing)
// and these choices are the A/Bs' (scripts/spmv_tile_ab.py; PERF.md).
//
// The mv body serves kernel 5, the unbatched espim_spmv (espim_spmv_mv_
// kernel): B = 1, planes f32 or bf16, x (M,) f32 or bf16.  Its bound is
// bytes: 8 (f32) or 6 (bf16) plane bytes and one 2-flop FMA a slot, so a
// launch takes at least (index + value planes + x + y) / 3.35 TB/s.  Its
// first design (one warp a row, lanes striding over the slots one at a
// time, x through the read-only cache) ran at half that bound, level with
// a dense bf16 torch.matmul: each slot cost a division, a 4-byte index
// load, a value load and a gather waiting on the index, and a warp kept
// ~256 B in flight.  This body:
//   - a persistent grid with a static split planned on the host
//     (kernels/espim_spmv._mv_plan): as many blocks as fit the SMs, fewer
//     for few rows; block j takes rows [j * rows_a_block, ...), whole
//     (every row of a chunked pack has K * Lc padded slots: equal rows are
//     equal work), so no atomics;
//   - x copied once a block into shared memory, in its own dtype, by a
//     bulk copy, where it fits beside 2 stages (a bf16 x is widened at the
//     gather); else x is gathered through L1, the same sums in the same
//     order;
//   - one producer warp streams the block's index and value spans, a tile
//     of whole rows at a time (pieces of a row too long for a stage), into
//     a ring of stages by bulk copies, the index span posted on its own
//     barrier ahead of the values: the ring's shape (stages, stage bytes)
//     is the plan's, sized for the most rows in flight (at llama7b's
//     projections 4-5 stages of 37-49 KB, ~185-220 KB an SM).
//     The 16-byte interiors go in bulk, head and tail bytes by the
//     producer's lanes (the ring body's copy_ends / copy_interior): no
//     byte outside a plane is read;
//   - 16 consumer warps walk rows in teams of 1 or 4 warps (the plan's
//     team, from K * Lc alone: 4 for a row of more than 1024 slots): lane i of the team's L lanes takes the
//     row's groups of 4 consecutive slots i, i + L, ...; a group is one
//     16-byte ld.shared of ids, one 16- (f32) or 8-byte (bf16) value load,
//     4 gathers of x and 4 FMAs into one accumulator in slot order (Lc a
//     multiple of 4, aligned planes; else the same order slot by slot);
//     the chunk base moves by compare-and-subtract, the check against M
//     is one unsigned compare; a butterfly, then a sum in warp order
//     through shared memory, ends the row.  That order depends on the
//     row's slots and team alone, not on R, the grid, the block, the
//     stage or where x lives, so a row gives the same bits in any pack or
//     slice of rows that holds it at the same K * Lc.
// Column ids are bound-checked against M in place of padding x, in both
// bodies.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarp = 32;

enum Plane { kF32 = 0, kI8 = 1, kNib = 2, kBF16 = 3 };

// bf16 travels as its 16-bit pattern; widening to fp32 is exact
__device__ __forceinline__ float bf16_bits_to_float(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

enum Act { kSilu = 0, kGelu = 1, kRelu = 2, kRelu2 = 3 };

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

// --------------------------------------------------------------------------
// The ring body of kernels 1-4 and 6 (see the note at the head).
// --------------------------------------------------------------------------

// A stuck mbarrier wait traps after this many clocks (~8.7 s at 1.98 GHz),
// so a pipeline fault ends the launch with an error instead of a hang
#ifndef SPMV_WAIT_LIMIT
#define SPMV_WAIT_LIMIT (1LL << 34)
#endif

// dynamic shared memory a block may take (of the 227 KB, the rest is the
// ring body's static arrays)
constexpr int kSmemLimit = 232448 - 2048;

// the ring's shape: NC consumer warps and one producer warp a block, up
// to STAGES stages of up to STAGE_BYTES bytes of plane (index and value
// spans; smaller when x takes the room); x is staged in shared memory
// where it fits if STAGE_X
template <int NC, int STAGES, int STAGE_BYTES, bool STAGE_X = true>
struct Ring {
  static constexpr int kConsumers = NC;
  static constexpr bool kStageX = STAGE_X;
  static constexpr int kThreads = kWarp * (NC + 1);
  static constexpr int kStages = STAGES;
  static constexpr int kStage = STAGE_BYTES;
  // 3 barriers a stage and x's, 8 bytes each
  static constexpr int kBarBytes = 256;
  static constexpr int kSmem = kBarBytes + STAGES * STAGE_BYTES;
  // a stage's least bytes: a piece of a row too long for a stage is a
  // multiple of 4 slots x 128 lanes (a 4-warp team), at most 8 plane
  // bytes a slot
  static constexpr int kMinStage = 64 + 8 * 512;
  static_assert(NC == 2 || NC == 4 || NC == 8 || NC == 16, "consumer warps");
  static_assert(8 * (3 * STAGES + 1) <= kBarBytes, "barrier space");
  static_assert(STAGE_BYTES % 128 == 0 && STAGE_BYTES >= kMinStage,
                "stage size");
  static_assert(kBarBytes + 2 * STAGE_BYTES <= kSmemLimit, "shared memory");
};
// the port's ring (the A/B in PERF.md; scripts/spmv_tile_ab.py sweeps it)
using PortRing = Ring<16, 5, 49152>;

constexpr int kMaxBuckets = 8;

// One bucket of a packed group, passed by value in the launch's
// parameters (no device-side table: a drill that swaps a plane cannot
// leave a stale pointer behind).  H = 2 (GLU) buckets are half-major
// (2 * rows, K, Lc) planes, output row r from plane rows r and rows + r.
struct Bucket {
  const void* values;      // plane rows of lv bytes-or-slots a chunk
  const int* cols;         // plane rows of K * Lc chunk-local ids
  const float* scale;      // scale[r / group_rows] (GLU: srow[h*rows + r]); null: none
  const float* residual;   // (rows, B) in packed order, added last; null: none
  int rows;                // output rows (pairs for GLU)
  int n_chunks, lc, lv;    // lv: bytes a chunk row of int4 codes, else lc
  int group_rows;
  int out_row0;            // the bucket's first row in the packed output
  int team;                // warps a row: 1, 2 or 4
};

struct GroupArgs {
  Bucket bk[kMaxBuckets];
  const float* x;          // (m, b), fp32
  float* out;              // (output rows, b)
  const int* perm;         // take: packed row -> output row, -1 a pad row;
                           // null: the packed row itself
  int n_buckets, m, b, chunk_cols, act;
  int xvec;                // an x row of BT floats is one aligned load
  int xstage;              // x is copied into shared memory, after the ring
  int stages;              // the ring's stages (<= the Ring's STAGES)
  int stage;               // bytes a stage (<= the Ring's STAGE_BYTES)
  int piece;               // slots a piece of a row too long for a stage
  long long work;          // padded slots of the launch (the static split)
};

// -- PTX helpers -------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// whether the barrier's phase of parity `parity` has completed (an
// acquire for this thread when it has)
__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}
// until the phase has completed, for a whole warp: lane 0 polls, backing
// off between tries, so a warp that waits takes one lane's shared-memory
// traffic and not 32 (the ring's idle warps would otherwise crowd the
// walkers' loads and the bulk copies); then every lane takes its acquire,
// which completes at once
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if ((threadIdx.x & 31) == 0) {
    const long long t0 = clock64();
    while (!mbar_done(bar, parity)) {
      __nanosleep(32);
      if (clock64() - t0 > SPMV_WAIT_LIMIT) __trap();
    }
  }
  __syncwarp();
  while (!mbar_done(bar, parity)) {
  }
}
// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst`, completing on `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// the warps of one team meet (named barrier `id`, `threads` threads)
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" :: "l"(p));
}

// -- planes --------------------------------------------------------------------
template <int P>
__host__ __device__ constexpr int slot_bytes() {  // kNib: half a byte
  return P == kF32 ? 4 : P == kBF16 ? 2 : 1;
}
// bytes of one plane row of values
template <int P>
__host__ __device__ __forceinline__ long long vrow_bytes(const Bucket& bk) {
  return P == kNib ? 1LL * bk.n_chunks * bk.lv
                   : 1LL * bk.n_chunks * bk.lc * slot_bytes<P>();
}
// byte of slot s within its plane row of values
template <int P>
__device__ __forceinline__ int voff(int s, int lc, int lv) {
  return P == kNib ? (s / lc) * lv + (s % lc) / 2 : s * slot_bytes<P>();
}

// value of slot s = (k, l) of a row whose value bytes start at vs
template <int P>
__device__ __forceinline__ float smem_value(const unsigned char* vs, int s,
                                            int k, int l, int lv) {
  if (P == kF32) return reinterpret_cast<const float*>(vs)[s];
  if (P == kBF16)
    return bf16_bits_to_float(reinterpret_cast<const unsigned short*>(vs)[s]);
  if (P == kI8) return static_cast<float>(reinterpret_cast<const signed char*>(vs)[s]);
  const unsigned char byte = vs[k * lv + (l >> 1)];
  const int code = (l & 1)
      ? (static_cast<int>(static_cast<signed char>(byte)) >> 4)
      : (static_cast<int>(static_cast<unsigned>(byte) << 28) >> 28);
  return static_cast<float>(code);
}
// the 4 values of the group at slot s (Lc a multiple of 4, aligned)
template <int P>
__device__ __forceinline__ void smem_values4(const unsigned char* vs, int s,
                                             float (&v)[4]) {
  if (P == kF32) {
    const float4 t = *reinterpret_cast<const float4*>(vs + 4 * s);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if (P == kBF16) {
    const uint2 t = *reinterpret_cast<const uint2*>(vs + 2 * s);
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if (P == kI8) {
    const unsigned w = *reinterpret_cast<const unsigned*>(vs + s);
#pragma unroll
    for (int i = 0; i < 4; ++i)   // byte i, sign-extended
      v[i] = static_cast<float>(static_cast<signed char>(w >> (8 * i)));
  } else {
    const unsigned w = *reinterpret_cast<const unsigned short*>(vs + s / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = static_cast<float>(static_cast<int>(w << (28 - 4 * i)) >> 28);
  }
}

// acc[j] += v * x[off + j] for the tile's nb columns; xv: the BT floats
// at x + off are one aligned row (BT == nb), loaded in 4-16 byte pieces.
// x is in shared memory (staged) or global memory: generic loads serve both
template <int BT>
__device__ __forceinline__ void gather_fma(const float* __restrict__ x,
                                           long long off, float v, int nb,
                                           bool xv, float (&acc)[BT]) {
  if (xv && BT == 1) {
    acc[0] = fmaf(v, x[off], acc[0]);
  } else if (xv) {
#pragma unroll
    for (int h = 0; h < BT / 4; ++h) {
      const float4 t = reinterpret_cast<const float4*>(x + off)[h];
      acc[4 * h] = fmaf(v, t.x, acc[4 * h]);
      acc[4 * h + 1] = fmaf(v, t.y, acc[4 * h + 1]);
      acc[4 * h + 2] = fmaf(v, t.z, acc[4 * h + 2]);
      acc[4 * h + 3] = fmaf(v, t.w, acc[4 * h + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BT; ++j)
      if (j < nb) acc[j] = fmaf(v, x[off + j], acc[j]);
  }
}

// advance a lane's (offset in chunk, chunk base, chunk) by `step` slots
__device__ __forceinline__ void advance(int& l, int& base, int& k, int step,
                                        int lc, int chunk_cols) {
  l += step;
  while (l >= lc) {
    l -= lc;
    base += chunk_cols;
    ++k;
  }
}

// The slots [s0, s1) of one row, from shared memory: cs[s] is slot s's
// column id and vs the row's value bytes.  The row's slots go in groups of
// 4 consecutive slots (the last may be short); lane `lane` of the row's
// `lanes` takes groups lane, lane + lanes, ... (s0 is a multiple of 4 *
// lanes) and adds each group's slots in order.  The order depends on the
// row's slot count and its team alone: not on B, the stage, the block or
// the launch.  `vec`: Lc is a multiple of 4 and the row's spans are
// aligned, so a group is one 16-byte index load and one value load.
template <int P, int BT>
__device__ __forceinline__ void walk(
    const int* cs, const unsigned char* vs, int s0, int s1, int lc, int lv,
    int chunk_cols, int m, const float* __restrict__ x, int b, int b0, int nb,
    int lane, int lanes, bool vec, bool xv, float (&acc)[BT]) {
  int s = s0 + 4 * lane;
  int k = s / lc, l = s - k * lc, base = k * chunk_cols;
  for (; s < s1; s += 4 * lanes) {
    int c[4];
    float v[4];
    if (vec) {
      const int4 c4 = *reinterpret_cast<const int4*>(cs + s);
      c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
      smem_values4<P>(vs, s, v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int li = l + i, kb = base, kk = k;
      while (li >= lc) {
        li -= lc;
        kb += chunk_cols;
        ++kk;
      }
      if (!vec) {
        if (s + i >= s1) break;
        c[i] = cs[s + i];
        v[i] = smem_value<P>(vs, s + i, kk, li, lv);
      }
      const int gc = kb + c[i];
      if (static_cast<unsigned>(gc) < static_cast<unsigned>(m))
        gather_fma<BT>(x, static_cast<long long>(gc) * b + b0, v[i], nb, xv,
                       acc);
    }
    advance(l, base, k, 4 * lanes, lc, chunk_cols);
  }
}

// x row `row` (BT floats from column b0) of x staged in shared memory at
// `xs` (a shared address), into acc with weight v: one 4-, 16- or two
// 16-byte ld.shared
template <int BT>
__device__ __forceinline__ void gather_fma_shared(uint32_t xs, uint32_t off,
                                                  float v, float (&acc)[BT]) {
  if (BT == 1) {
    float t;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(t) : "r"(xs + off));
    acc[0] = fmaf(v, t, acc[0]);
  } else {
#pragma unroll
    for (int h = 0; h < BT / 4; ++h) {
      float4 t;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(t.x), "=f"(t.y), "=f"(t.z), "=f"(t.w)
                   : "r"(xs + off + 16 * h));
      acc[4 * h] = fmaf(v, t.x, acc[4 * h]);
      acc[4 * h + 1] = fmaf(v, t.y, acc[4 * h + 1]);
      acc[4 * h + 2] = fmaf(v, t.z, acc[4 * h + 2]);
      acc[4 * h + 3] = fmaf(v, t.w, acc[4 * h + 3]);
    }
  }
}

// walk's common case with fewer instructions a slot, in the same order:
// Lc a multiple of 4 (a group's 4 slots share one chunk), aligned spans,
// x staged in shared memory at `xs`, one x row a vector load (B % BT 0)
template <int P, int BT>
__device__ __forceinline__ void walk_fast(
    const int* cs, const unsigned char* vs, int s0, int s1, int lc,
    int chunk_cols, int m, uint32_t xs, int b, int b0, int lane, int lanes,
    float (&acc)[BT]) {
  int s = s0 + 4 * lane;
  int k = s / lc, l = s - k * lc, base = k * chunk_cols;
  for (; s < s1; s += 4 * lanes) {
    const int4 c4 = *reinterpret_cast<const int4*>(cs + s);
    float v[4];
    smem_values4<P>(vs, s, v);
    const int c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gc = base + c[i];
      if (static_cast<unsigned>(gc) < static_cast<unsigned>(m))
        gather_fma_shared<BT>(xs, static_cast<uint32_t>(gc * b + b0) * 4u,
                              v[i], acc);
    }
    advance(l, base, k, 4 * lanes, lc, chunk_cols);
  }
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

// one contiguous byte range of a plane, and where it sits in a stage: the
// global byte g lands at shared address smem + (g - gptr) + (gptr & 15)
struct Span {
  const unsigned char* gptr;
  int len;
  uint32_t smem;   // 16-byte aligned
};

// what one stage holds: output rows [r0, r0 + n) of bucket `bucket`, whole
// (half -1: every half, slots [0, slots), every batch tile), or one piece
// of one row (n 1): slots [s0, s1) of half `half` at batch tile b0
struct Tile {
  int bucket, r0, n, half, s0, s1, b0;
  bool last;       // a piece that ends its half
};

template <int P, int H>
__device__ __forceinline__ int whole_rows(const Bucket& bk, int stage) {
  const long long rowb = H * (4LL * bk.n_chunks * bk.lc + vrow_bytes<P>(bk));
  return static_cast<int>((stage - 64 * H) / rowb);
}

// f(tile) for every tile of the block's output rows [r_begin, r_end) of
// the group, in order; the producer and every consumer walk the same list
template <int P, class Cfg, int H, int BT, class F>
__device__ __forceinline__ void for_tiles(const GroupArgs& a,
                                          long long r_begin, long long r_end,
                                          F&& f) {
  long long r_first = 0;
  for (int i = 0; i < a.n_buckets; ++i) {
    const Bucket& bk = a.bk[i];
    const long long lo = max(r_begin, r_first) - r_first;
    const long long hi = min(r_end, r_first + bk.rows) - r_first;
    r_first += bk.rows;
    if (lo >= hi) continue;
    const int slots = bk.n_chunks * bk.lc;
    const int n = whole_rows<P, H>(bk, a.stage);
    if (n > 0) {
      for (long long r = lo; r < hi; r += n)
        f(Tile{i, static_cast<int>(r),
               static_cast<int>(hi - r < n ? hi - r : n), -1, 0, slots, 0,
               true});
    } else {
      for (long long r = lo; r < hi; ++r)
        for (int b0 = 0; b0 < a.b; b0 += BT)
          for (int h = 0; h < H; ++h)
            for (int s0 = 0; s0 < slots; s0 += a.piece) {
              const int s1 = min(s0 + a.piece, slots);
              f(Tile{i, static_cast<int>(r), 1, h, s0, s1, b0, s1 == slots});
            }
    }
  }
}

// the tile's spans: the index span of each half, then the value span of
// each half, laid out one after another from shared address `stage`;
// returns their count
template <int P, int H>
__device__ __forceinline__ int tile_spans(const Bucket& bk, const Tile& t,
                                          uint32_t stage, Span (&sp)[4]) {
  const int slots = bk.n_chunks * bk.lc;
  const long long vrow = vrow_bytes<P>(bk);
  const int h0 = t.half < 0 ? 0 : t.half, h1 = t.half < 0 ? H : t.half + 1;
  int n = 0;
  for (int h = h0; h < h1; ++h) {
    const long long p0 = 1LL * h * bk.rows + t.r0;      // first plane row
    const long long c0 = p0 * slots + t.s0;
    sp[n++] = {reinterpret_cast<const unsigned char*>(bk.cols + c0),
               static_cast<int>(4LL * ((t.n - 1) * 1LL * slots + t.s1 - t.s0)),
               0};
  }
  for (int h = h0; h < h1; ++h) {
    const long long p0 = 1LL * h * bk.rows + t.r0;
    // the value bytes of slots [s0, s1) of rows [r0, r0 + n)
    const int a = voff<P>(t.s0, bk.lc, bk.lv);
    const long long e = t.half < 0 ? vrow
                        : P == kNib ? voff<P>(t.s1 - 1, bk.lc, bk.lv) + 1
                                    : 1LL * t.s1 * slot_bytes<P>();
    sp[n++] = {static_cast<const unsigned char*>(bk.values) + p0 * vrow + a,
               static_cast<int>((t.n - 1) * vrow + e - a), 0};
  }
  uint32_t off = stage;
  for (int i = 0; i < n; ++i) {
    sp[i].smem = off;
    const uint32_t head = reinterpret_cast<uintptr_t>(sp[i].gptr) & 15;
    off += (head + sp[i].len + 15) & ~15u;
  }
  return n;
}

// a span's 16-byte interior [a16, e16) (what a bulk copy can take)
struct Interior {
  uintptr_t a16, e16;
};
__device__ __forceinline__ Interior interior(const Span& sp) {
  const uintptr_t g = reinterpret_cast<uintptr_t>(sp.gptr);
  const uintptr_t e = g + sp.len;
  const uintptr_t up = (g + 15) & ~uintptr_t(15), dn = e & ~uintptr_t(15);
  const uintptr_t a16 = up < e ? up : e;
  return {a16, dn > a16 ? dn : a16};
}

// the producer warp's lanes copy a span's head [g, a16) (lanes 0-15) and
// tail [e16, e) (lanes 16-31) bytes, which bulk copies cannot take;
// returns the interior's bytes
__device__ __forceinline__ uint32_t copy_ends(const Span& sp, int lane,
                                              unsigned char* smem,
                                              uint32_t bars) {
  const Interior in = interior(sp);
  const uintptr_t g = reinterpret_cast<uintptr_t>(sp.gptr);
  const uintptr_t byte = lane < 16 ? g + lane : in.e16 + (lane - 16);
  if (lane < 16 ? byte < in.a16 : byte < g + sp.len)
    smem[sp.smem - bars + (g & 15) + (byte - g)] =
        __ldg(reinterpret_cast<const unsigned char*>(byte));
  return static_cast<uint32_t>(in.e16 - in.a16);
}

// lane 0 of the producer: the span's interior by bulk copies (pieces of at
// most 64 KB), completing on `bar`
__device__ __forceinline__ void copy_interior(const Span& sp, uint32_t bar) {
  const Interior in = interior(sp);
  const uintptr_t g = reinterpret_cast<uintptr_t>(sp.gptr);
  for (uintptr_t a = in.a16; a < in.e16; a += 65536) {
    const uintptr_t e = in.e16 - a < 65536 ? in.e16 : a + 65536;
    bulk_g2s(sp.smem + static_cast<uint32_t>(a - (g & ~uintptr_t(15))),
             reinterpret_cast<const void*>(a), static_cast<uint32_t>(e - a),
             bar);
  }
}

// The producer warp: first x, when the launch stages it (its own
// barrier); then for each tile, wait until the stage is free, copy the
// head and tail bytes of each span that the 16-byte bulk copies cannot
// cover (the planes' rows are not 16-byte multiples), and lane 0 posts
// the index spans' copies on the stage's index barrier and the value
// spans' on its value barrier: the index part lands first.
template <int P, class Cfg, int H, int BT>
__device__ __forceinline__ void produce(const GroupArgs& a, long long r_begin,
                                        long long r_end, unsigned char* smem,
                                        uint32_t stages, uint32_t bars,
                                        const Span& xspan) {
  const int lane = threadIdx.x % kWarp;
  const uint32_t xbar = bars + 8 * 3 * Cfg::kStages;
  if (a.xstage) {
    const uint32_t tx = copy_ends(xspan, lane, smem, bars);
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(xbar, tx);
      copy_interior(xspan, xbar);
    }
  }
  int it = 0;
  for_tiles<P, Cfg, H, BT>(a, r_begin, r_end, [&](const Tile& t) {
    const int st = it % a.stages;
    const uint32_t ph = (it / a.stages) & 1;
    const uint32_t full_idx = bars + 8 * st;
    const uint32_t full_val = bars + 8 * (Cfg::kStages + st);
    const uint32_t empty = bars + 8 * (2 * Cfg::kStages + st);
    mbar_wait(empty, ph ^ 1);
    Span sp[4];
    const int n = tile_spans<P, H>(a.bk[t.bucket], t, stages + st * a.stage, sp);
    uint32_t tx[2] = {0, 0};
    for (int i = 0; i < n; ++i) tx[i >= n / 2] += copy_ends(sp[i], lane, smem, bars);
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(full_idx, tx[0]);
      for (int i = 0; i < n / 2; ++i) copy_interior(sp[i], full_idx);
      mbar_expect_tx(full_val, tx[1]);
      for (int i = n / 2; i < n; ++i) copy_interior(sp[i], full_val);
    }
    ++it;
  });
}

// the row's sum: each warp's butterfly, then, for a team of several warps,
// their sums added in warp order through part[] (two team barriers)
template <class Cfg, int BT>
__device__ __forceinline__ void team_sum(float (&acc)[BT],
                                         float (&part)[Cfg::kConsumers][BT],
                                         int warp, int team, int t_id) {
  warp_sum(acc);
  if (team == 1) return;
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int j = 0; j < BT; ++j) part[warp][j] = acc[j];
  }
  // named barriers 1 .. NC / 2 for teams of 2, the next NC / 4 for teams
  // of 4: buckets of different team sizes never share one (at most 12
  // with 16 consumer warps)
  const int id = 1 + t_id + (team == 4 ? Cfg::kConsumers / 2 : 0);
  team_sync(id, kWarp * team);
  const int w0 = t_id * team;
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    float s = part[w0][j];
    for (int w = 1; w < team; ++w) s += part[w0 + w][j];
    acc[j] = s;
  }
  team_sync(id, kWarp * team);   // part is free again
}

// where a row's result goes and its scales, loaded before its walk so
// the loads' latency hides behind it
struct RowOut {
  long long dst;   // output row, -1 for a pad row of a take
  float s0, s1;    // the scale (GLU: the gate's and the up row's)
};
template <int H>
__device__ __forceinline__ RowOut row_out(const GroupArgs& a,
                                          const Bucket& bk, int r) {
  RowOut o;
  const long long p = 1LL * bk.out_row0 + r;
  o.dst = a.perm ? a.perm[p] : p;
  if (H == 2) {
    o.s0 = bk.scale ? bk.scale[r] : 1.0f;
    o.s1 = bk.scale ? bk.scale[bk.rows + r] : 1.0f;
  } else {
    o.s0 = bk.scale ? bk.scale[r / bk.group_rows] : 1.0f;
    o.s1 = 1.0f;
  }
  return o;
}

// the row's result for batch columns b0 .. b0 + nb: GLU (H 2) half 0
// parks the gate sum, half 1 writes act(gate * sg) * (up * su); else
// acc * scale, plus the residual, stored at the row's output row
template <int BT, int H>
__device__ __forceinline__ void epilogue(const GroupArgs& a, const Bucket& bk,
                                         int r, int h, int b0, int nb,
                                         const RowOut& ro,
                                         const float (&acc)[BT],
                                         float (&gate)[BT]) {
  if (H == 2 && h == 0) {
#pragma unroll
    for (int j = 0; j < BT; ++j) gate[j] = acc[j];
    return;
  }
  if (ro.dst < 0) return;                       // a pad row of a take
  float* o = a.out + ro.dst * a.b + b0;
  if (H == 2) {
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        float g = gate[j], u = acc[j];
        if (bk.scale) {
          g *= ro.s0;
          u *= ro.s1;
        }
        o[j] = apply_act(g, a.act) * u;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        const float y = bk.scale ? acc[j] * ro.s0 : acc[j];
        o[j] = bk.residual ? y + bk.residual[1LL * r * a.b + b0 + j] : y;
      }
    }
  }
}

// The first output row of block j of g: the blocks split the launch's
// padded slots evenly, at row boundaries (static: from the shapes alone)
template <int H>
__device__ __forceinline__ long long block_row(const GroupArgs& a, int j,
                                               int g) {
  const long long target = a.work * j / g;
  long long done = 0, r_first = 0;
  for (int i = 0; i < a.n_buckets; ++i) {
    const long long w = max(1LL, 1LL * H * a.bk[i].n_chunks * a.bk[i].lc);
    const long long total = w * a.bk[i].rows;
    if (target < done + total) return r_first + (target - done + w - 1) / w;
    done += total;
    r_first += a.bk[i].rows;
  }
  return r_first;
}

// One block: the producer warp streams the planes of the block's rows
// through the ring; each consumer warp takes the tiles in order, waits on
// a tile's index barrier, prefetches into L1 the x rows of its rows' first
// groups (index ahead of value), waits on the value barrier, walks its
// rows, then frees the stage.  Output row q of the block (counted over its
// tiles) belongs to team q % (NC / team) of the row's bucket.
template <int P, int BT, class Cfg, int H>
__device__ __forceinline__ void ring_body(const GroupArgs& a) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ float part[Cfg::kConsumers][BT];
  __shared__ float gate[Cfg::kConsumers][BT];
  const uint32_t bars = smem_u32(ring_smem);
  const uint32_t stages = bars + Cfg::kBarBytes;
  const uint32_t xbar = bars + 8 * 3 * Cfg::kStages;
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (Cfg::kStages + s), 1);
      mbar_init(bars + 8 * (2 * Cfg::kStages + s), Cfg::kConsumers);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long r_begin = block_row<H>(a, blockIdx.x, gridDim.x);
  const long long r_end = block_row<H>(a, blockIdx.x + 1, gridDim.x);
  // x, when staged, sits after the ring: global byte x + i at xs + i
  const Span xspan = {reinterpret_cast<const unsigned char*>(a.x),
                      static_cast<int>(4LL * a.m * a.b), stages + a.stages * a.stage};
  if (warp == Cfg::kConsumers) {
    produce<P, Cfg, H, BT>(a, r_begin, r_end, ring_smem, stages, bars, xspan);
    return;
  }
  const float* xs = a.x;
  const uint32_t xs_u32 =
      xspan.smem + static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a.x) & 15);
  if (a.xstage) {
    xs = reinterpret_cast<const float*>(ring_smem + (xs_u32 - bars));
    if (r_begin < r_end) mbar_wait(xbar, 0);
  }
  const bool xv = a.xvec;
  const int lane32 = threadIdx.x % kWarp;
  float acc[BT];
  long long q = 0;           // the block's output rows done
  int it = 0;
  for_tiles<P, Cfg, H, BT>(a, r_begin, r_end, [&](const Tile& t) {
    const int st = it % a.stages;
    const uint32_t ph = (it / a.stages) & 1;
    const Bucket& bk = a.bk[t.bucket];
    const int team = bk.team;
    const int t_id = warp / team, n_teams = Cfg::kConsumers / team;
    const int lanes = kWarp * team, lane = (warp % team) * kWarp + lane32;
    const bool lead = lane == 0;
    const int slots = bk.n_chunks * bk.lc;
    const long long vrow = vrow_bytes<P>(bk);
    mbar_wait(bars + 8 * st, ph);
    Span sp[4];
    const int n_sp = tile_spans<P, H>(bk, t, stages + st * a.stage, sp);
    // shared pointers to slot 0 of the tile's first row, each half
    auto row_cols = [&](int h, int j) {
      const Span& s = sp[t.half < 0 ? h : 0];
      return reinterpret_cast<const int*>(
                 ring_smem + (s.smem - bars) +
                 (reinterpret_cast<uintptr_t>(s.gptr) & 15)) +
             1LL * j * slots - t.s0;
    };
    auto row_vals = [&](int h, int j) {
      const Span& s = sp[n_sp / 2 + (t.half < 0 ? h : 0)];
      return ring_smem + (s.smem - bars) +
             (reinterpret_cast<uintptr_t>(s.gptr) & 15) + j * vrow -
             voff<P>(t.s0, bk.lc, bk.lv);
    };
    const int j0 = static_cast<int>((t_id - q % n_teams + n_teams) % n_teams);
    // index ahead of value: the x rows of this lane's first group of each
    // of its rows in the tile, into L1 before the values land (x in
    // global memory)
    for (int j = a.xstage ? t.n : j0; j < t.n; j += n_teams) {
      const int* cs = row_cols(t.half < 0 ? 0 : t.half, j);
      const int s = t.s0 + 4 * lane;
      for (int i = 0; i < 4; ++i) {
        if (s + i >= t.s1) break;
        const int kk = (s + i) / bk.lc;
        const int gc = kk * a.chunk_cols + cs[s + i];
        if (static_cast<unsigned>(gc) < static_cast<unsigned>(a.m))
          prefetch_l1(a.x + static_cast<long long>(gc) * a.b + t.b0);
      }
    }
    if (j0 < t.n) mbar_wait(bars + 8 * (Cfg::kStages + st), ph);
    for (int j = j0; j < t.n; j += n_teams) {
      const int r = t.r0 + j;
      const RowOut ro = row_out<H>(a, bk, r);
      const int h0 = t.half < 0 ? 0 : t.half, h1 = t.half < 0 ? H : t.half + 1;
      for (int b0 = t.half < 0 ? 0 : t.b0; b0 < (t.half < 0 ? a.b : t.b0 + 1);
           b0 += BT) {
        const int nb = min(BT, a.b - b0);
        for (int h = h0; h < h1; ++h) {
          const int* cs = row_cols(h, j);
          const unsigned char* vs = row_vals(h, j);
          const bool vec = bk.lc % 4 == 0 &&
                           (reinterpret_cast<uintptr_t>(cs + t.s0) & 15) == 0 &&
                           (reinterpret_cast<uintptr_t>(vs + voff<P>(t.s0, bk.lc, bk.lv)) &
                            (P == kNib ? 1 : 4 * slot_bytes<P>() - 1)) == 0;
          if (t.s0 == 0) {
#pragma unroll
            for (int jj = 0; jj < BT; ++jj) acc[jj] = 0.0f;
          }
          if (vec && xv && a.xstage)
            walk_fast<P, BT>(cs, vs, t.s0, t.s1, bk.lc, a.chunk_cols, a.m,
                             xs_u32, a.b, b0, lane, lanes, acc);
          else
            walk<P, BT>(cs, vs, t.s0, t.s1, bk.lc, bk.lv, a.chunk_cols, a.m,
                        xs, a.b, b0, nb, lane, lanes, vec, xv, acc);
          if (t.last) {
            team_sum<Cfg, BT>(acc, part, warp, team, t_id);
            if (lead)
              epilogue<BT, H>(a, bk, r, h, b0, nb, ro, acc, gate[t_id]);
          }
        }
      }
    }
    // the row counter moves on after a whole tile, or after a row's last
    // piece (its last half at its last batch tile)
    if (t.half < 0) q += t.n;
    else if (t.last && t.half == H - 1 && t.b0 + BT >= a.b) q += 1;
    __syncwarp();
    if (lane32 == 0) mbar_arrive(bars + 8 * (2 * Cfg::kStages + st));
    ++it;
  });
}

template <int P, int BT, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
espim_spmv_stream_kernel(const __grid_constant__ GroupArgs a) {
  ring_body<P, BT, Cfg, 1>(a);
}

template <int P, int BT, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
espim_spmv_stream_glu_kernel(const __grid_constant__ GroupArgs a) {
  ring_body<P, BT, Cfg, 2>(a);
}

// the batch tile for B: 1, 4, or 8 (B > 8 loops over tiles of 8)
inline int stream_tile(int b) { return b <= 1 ? 1 : b <= 4 ? 4 : 8; }

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// warps a row when the schedule leaves it to the launcher (wpr 0), from
// the row's own padded slots: one warp, or kWideRowWarps (at most the
// ring's consumer warps) for a row of more than kWideRowSlots (down's 22
// chunks), whose bucket, with x taking most of shared memory at B = 4,
// gets 2-4 rows in flight a block. Teams of 8 ran slower (the A/B in
// PERF.md). The
// streaming body's fill rule (more warps a row for a launch of few rows)
// is gone: in a grouped launch a small bucket's rows sit beside the
// others' in the same blocks, where its 4-warp teams made those blocks the
// stragglers (the A/B in PERF.md). The team depends on the row's shape and
// the schedule alone, so a bucket walks its rows the same way alone, in a
// group, and in the GLU kernel or the plain one (core/sdds.
// fill_warps_per_row is its Python twin)
constexpr int kWideRowSlots = 1024;
constexpr int kWideRowWarps = 4;

// the schedule's warps a row (0: the default for rows of `slots` on a ring
// of `consumers` warps), or 0 when it is not 1, 2 or 4
inline int resolve_wpr(int wpr, int slots, int consumers) {
  if (wpr == 0)
    return slots > kWideRowSlots ? std::min(kWideRowWarps, consumers) : 1;
  return wpr == 1 || wpr == 2 || wpr == 4 ? wpr : 0;
}

// f(std::integral_constant<int, BT>()) for the batch tile BT of B
template <typename F>
int by_tile(int b, F&& f) {
  switch (stream_tile(b)) {
    case 1:
      return f(std::integral_constant<int, 1>());
    case 4:
      return f(std::integral_constant<int, 4>());
    default:
      return f(std::integral_constant<int, 8>());
  }
}

// f(std::integral_constant<int, u>()) for the schedule's u, which caps
// the ring at u + 2 stages (launch_ring): u in {1, 2, 4} when ALL_U
// (kernels 1 and 2, the ones the autotuner measures), else u = 2 only
// (kernels 3, 4 and 6); any other u is refused
template <bool ALL_U, typename F>
int by_u(int u, F&& f) {
  if (u == 2) return f(std::integral_constant<int, 2>());
  if constexpr (ALL_U) {
    if (u == 1) return f(std::integral_constant<int, 1>());
    if (u == 4) return f(std::integral_constant<int, 4>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of the ring kernel over a.n_buckets buckets: x goes into
// shared memory when it fits beside 2 stages, else it is gathered from
// global memory through L1; the ring takes the stage count (at most u + 2)
// and size that hold the most rows in flight (16 warps want many: the A/B
// in PERF.md); the grid fills the SMs (as many blocks as fit, fewer when
// the rows are fewer than the teams).
template <int P, int BT, class Cfg, int H>
int launch_ring(GroupArgs& a, int u, void* stream) {
  void (*kern)(const GroupArgs) =
      H == 2 ? espim_spmv_stream_glu_kernel<P, BT, Cfg>
             : espim_spmv_stream_kernel<P, BT, Cfg>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static int sms[64] = {0};   // SMs by device (0: attributes not set yet)
  // blocks an SM by (device, dynamic shared memory): a few sizes recur
  static int fit_smem[64][4] = {}, fit_n[64][4] = {};
  if (sms[dev] == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  // x is staged when 2 stages of at least kMinStage fit beside it. The
  // ring: of at most u + 2 stages (the schedule's u), the count whose
  // stages (as large as the room allows, up to STAGE_BYTES) hold the most
  // whole rows in flight, fewer and larger stages on a tie
  const long long xbytes = (4LL * a.m * a.b + 16 + 127) / 128 * 128;
  const long long ring_max = 1LL * Cfg::kStages * Cfg::kStage;
  const long long beside = kSmemLimit - Cfg::kBarBytes - xbytes;
  a.xstage = Cfg::kStageX && beside >= 2LL * Cfg::kMinStage;
  const long long room = std::min(
      a.xstage ? beside : kSmemLimit - Cfg::kBarBytes, ring_max);
  long long best = -1;
  for (int n = 2; n <= std::min(u + 2, Cfg::kStages); ++n) {
    const long long stage = std::min<long long>(Cfg::kStage, room / n) / 128 * 128;
    if (stage < Cfg::kMinStage) break;
    long long rows_a_stage = 1LL << 40;
    for (int i = 0; i < a.n_buckets; ++i) {
      const Bucket& bk = a.bk[i];
      const long long rowb = H * (4LL * bk.n_chunks * bk.lc + vrow_bytes<P>(bk));
      rows_a_stage = std::min(rows_a_stage, (stage - 64 * H) / std::max(rowb, 1LL));
    }
    if (n * rows_a_stage > best) {
      best = n * rows_a_stage;
      a.stages = n;
      a.stage = static_cast<int>(stage);
    }
  }
  a.piece = (a.stage - 64) / 8 / 512 * 512;
  const int smem = static_cast<int>(Cfg::kBarBytes + 1LL * a.stages * a.stage +
                                    (a.xstage ? xbytes : 0));
  int fit = 0;
  for (int i = 0; i < 4; ++i)
    if (fit_smem[dev][i] == smem) fit = fit_n[dev][i];
  if (fit == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kern, Cfg::kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fit = fit > 0 ? fit : 1;
    for (int i = 3; i > 0; --i) {
      fit_smem[dev][i] = fit_smem[dev][i - 1];
      fit_n[dev][i] = fit_n[dev][i - 1];
    }
    fit_smem[dev][0] = smem;
    fit_n[dev][0] = fit;
  }
  long long rows = 0;
  int teams = Cfg::kConsumers;
  for (int i = 0; i < a.n_buckets; ++i) {
    rows += a.bk[i].rows;
    teams = std::min(teams, Cfg::kConsumers / a.bk[i].team);
  }
  const long long want = (rows + teams - 1) / teams;
  const int grid = static_cast<int>(
      std::max(1LL, std::min(want, 1LL * sms[dev] * fit)));
  kern<<<grid, Cfg::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Fill in the launch's derived fields: each bucket's team (wpr; 0: the
// default for its rows' slots) and row offset, the padded slots,
// whether an x row is one vector load; a cudaError when a team does not
// fit the ring
template <int H, class Cfg>
int prepare(GroupArgs& a, int wpr) {
  long long row0 = 0, work = 0;
  for (int i = 0; i < a.n_buckets; ++i) {
    Bucket& bk = a.bk[i];
    bk.team = resolve_wpr(wpr, bk.n_chunks * bk.lc, Cfg::kConsumers);
    if (bk.team == 0 || bk.team > Cfg::kConsumers ||
        Cfg::kConsumers % bk.team != 0 || bk.group_rows < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    bk.out_row0 = static_cast<int>(row0);
    row0 += bk.rows;
    work += 1LL * H * bk.rows * bk.n_chunks * bk.lc;
  }
  a.work = row0 == 0 ? 0 : work;
  const int bt = stream_tile(a.b);
  a.xvec = a.b % bt == 0 && aligned(a.x, 4 * (bt < 4 ? bt : 4));
  return 0;
}

// Launch `a` (its buckets, x, out and perm set) on the ring: the batch
// tile from B, the stages in flight from the schedule's u (prepare: the
// rest)
template <int P, int H, bool ALL_U, class Cfg = PortRing>
int launch_group(GroupArgs& a, int wpr, int u, void* stream) {
  if (a.b <= 0) return 0;
  const int rc = prepare<H, Cfg>(a, wpr);
  if (rc != 0 || a.work == 0) return rc;
  return by_tile(a.b, [&](auto btc) {
    return by_u<ALL_U>(u, [&](auto) {
      return launch_ring<P, decltype(btc)::value, Cfg, H>(a, u, stream);
    });
  });
}

// the launch arguments of one bucket: out_row0 and team are set by
// launch_group
inline GroupArgs one_bucket(const void* values, const void* cols,
                            const float* scale, int group_rows,
                            const float* residual, int rows, int n_chunks,
                            int lc, int lv, const void* x, void* out,
                            int chunk_cols, int m, int b, int act) {
  GroupArgs a = {};
  a.bk[0] = Bucket{values, static_cast<const int*>(cols), scale, residual,
                   rows, n_chunks, lc, lv, group_rows, 0, 1};
  a.n_buckets = rows > 0 ? 1 : 0;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.perm = nullptr;
  a.m = m;
  a.b = b;
  a.chunk_cols = chunk_cols;
  a.act = act;
  return a;
}

// plane P of the `plane` code (enum Plane), H halves, f(P constant)
template <typename F>
int by_plane(int plane, F&& f) {
  switch (plane) {
    case kF32:
      return f(std::integral_constant<int, kF32>());
    case kBF16:
      return f(std::integral_constant<int, kBF16>());
    case kI8:
      return f(std::integral_constant<int, kI8>());
    case kNib:
      return f(std::integral_constant<int, kNib>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the launch arguments of buckets [i0, i0 + n) of a grouped call (the
// arrays of espim_spmv_group); out_row0 and team are set by prepare
inline GroupArgs group_args(int i0, int n, const void* values,
                            const void* cols, const void* scales,
                            const void* shapes, const void* x,
                            const void* perm, void* out, int chunk_cols,
                            int m, int b, int act) {
  const void* const* vp = static_cast<const void* const*>(values);
  const void* const* cp = static_cast<const void* const*>(cols);
  const void* const* sp = static_cast<const void* const*>(scales);
  const int* sh = static_cast<const int*>(shapes);
  long long row0 = 0;   // the chunk's first output row
  for (int i = 0; i < i0; ++i) row0 += sh[4 * i];
  GroupArgs a = one_bucket(nullptr, nullptr, nullptr, 1, nullptr, 0, 0, 0,
                           0, x, out, chunk_cols, m, b, act);
  a.n_buckets = n;
  a.perm = perm ? static_cast<const int*>(perm) + row0 : nullptr;
  if (!perm) a.out = static_cast<float*>(out) + row0 * b;
  for (int i = 0; i < n; ++i) {
    const int* s = sh + 4 * (i0 + i);
    a.bk[i] = Bucket{vp[i0 + i], static_cast<const int*>(cp[i0 + i]),
                     sp ? static_cast<const float*>(sp[i0 + i]) : nullptr,
                     nullptr, s[0], s[1], s[2], s[3], 1, 0, 1};
  }
  return a;
}

// --------------------------------------------------------------------------
// The mv body of kernel 5 (see the note at the head).
// --------------------------------------------------------------------------

// its shape: consumer warps a block (and one producer warp), the most
// ring stages (3 barriers each, then x's), the barriers' bytes at the
// head of shared memory (the plan's MV_CONSUMERS, MV_MAX_STAGES and
// MV_BAR_BYTES)
constexpr int kMvConsumers = 16;
constexpr int kMvMaxStages = 6;
constexpr int kMvBarBytes = 256;
constexpr int kMvThreads = kWarp * (kMvConsumers + 1);
static_assert(8 * (3 * kMvMaxStages + 1) <= kMvBarBytes, "barrier space");
static_assert(kMvConsumers % 4 == 0, "teams of 1 or 4 warps");

// the launch: operands and the host's plan (kernels/espim_spmv._mv_plan)
struct MvArgs {
  const void* values;   // (rows, K, Lc) f32 or bf16
  const int* cols;      // (rows, K, Lc) chunk-local column ids
  const void* x;        // (m,) f32 or bf16
  float* out;           // (rows,)
  int rows, n_chunks, lc, chunk_cols, m;
  int rows_a_block;     // block j walks rows [j * rows_a_block, ...)
  int team;             // warps a row: 1 or 4
  int stages, stage;    // the ring: `stages` stages of `stage` bytes
  int tile_rows;        // whole rows a stage holds; 0: rows go in pieces
  int piece;            // slots a piece, a multiple of 4 x the team's lanes
  int xstage;           // x is copied into shared memory, after the ring
  int vec;              // Lc % 4 == 0 and aligned planes: vector loads
};

// bytes of shared memory x takes when staged: its head offset (< 16) and
// its bytes, in 128-byte units (_mv_plan's _x_region)
constexpr int mv_x_region(int m, int xb) {
  return (m * xb + 15 + 127) / 128 * 128;
}

// rows [r0, r0 + n), slots [s0, s1) of each; n is 1 for a piece of a row
struct MvTile {
  int r0, n, s0, s1;
};

// f(tile) for every tile of the block's rows [r_begin, r_end), in order;
// the producer and every consumer warp walk the same list
template <class F>
__device__ __forceinline__ void for_mv_tiles(const MvArgs& a, int r_begin,
                                             int r_end, F&& f) {
  const int slots = a.n_chunks * a.lc;
  if (a.tile_rows > 0) {
    for (int r = r_begin; r < r_end; r += a.tile_rows)
      f(MvTile{r, min(a.tile_rows, r_end - r), 0, slots});
    return;
  }
  for (int r = r_begin; r < r_end; ++r)
    for (int s0 = 0; s0 < slots; s0 += a.piece)
      f(MvTile{r, 1, s0, min(s0 + a.piece, slots)});
}

// the tile's index span, then its value span, laid out from shared
// address `stage`
template <int P>
__device__ __forceinline__ void mv_spans(const MvArgs& a, const MvTile& t,
                                         uint32_t stage, Span (&sp)[2]) {
  const long long slots = 1LL * a.n_chunks * a.lc;
  const long long s = t.r0 * slots + t.s0;
  const int n = static_cast<int>((t.n - 1) * slots + t.s1 - t.s0);
  sp[0] = {reinterpret_cast<const unsigned char*>(a.cols + s), 4 * n, stage};
  sp[1] = {static_cast<const unsigned char*>(a.values) + s * slot_bytes<P>(),
           n * slot_bytes<P>(), 0};
  const uint32_t head = reinterpret_cast<uintptr_t>(sp[0].gptr) & 15;
  sp[1].smem = stage + ((head + sp[0].len + 15) & ~15u);
}

// the producer warp: x first, when staged (its own barrier); then each
// tile: wait until its stage is free, copy the spans' head and tail bytes
// with the lanes, and lane 0 posts the index span's bulk copies on the
// stage's index barrier, then the value span's on its value barrier
template <int P>
__device__ __forceinline__ void mv_produce(const MvArgs& a, int r_begin,
                                           int r_end, unsigned char* smem,
                                           uint32_t bars, uint32_t stages,
                                           const Span& xspan) {
  const int lane = threadIdx.x % kWarp;
  if (r_begin >= r_end) return;
  if (a.xstage) {
    const uint32_t xbar = bars + 8 * 3 * kMvMaxStages;
    const uint32_t tx = copy_ends(xspan, lane, smem, bars);
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(xbar, tx);
      copy_interior(xspan, xbar);
    }
  }
  int it = 0;
  for_mv_tiles(a, r_begin, r_end, [&](const MvTile& t) {
    const int st = it % a.stages;
    const uint32_t ph = (it / a.stages) & 1;
    const uint32_t full_idx = bars + 8 * st;
    const uint32_t full_val = bars + 8 * (kMvMaxStages + st);
    mbar_wait(bars + 8 * (2 * kMvMaxStages + st), ph ^ 1);
    Span sp[2];
    mv_spans<P>(a, t, stages + st * a.stage, sp);
    const uint32_t tx0 = copy_ends(sp[0], lane, smem, bars);
    const uint32_t tx1 = copy_ends(sp[1], lane, smem, bars);
    __syncwarp();
    if (lane == 0) {
      mbar_expect_tx(full_idx, tx0);
      copy_interior(sp[0], full_idx);
      mbar_expect_tx(full_val, tx1);
      copy_interior(sp[1], full_val);
    }
    ++it;
  });
}

__device__ __forceinline__ float x_at(const float* x, int i) { return x[i]; }
__device__ __forceinline__ float x_at(const unsigned short* x, int i) {
  return bf16_bits_to_float(x[i]);
}

// acc += v[i] * x[base + c[i]] for the group's 4 slots, in order; a
// column at or past m adds nothing
template <typename XT>
__device__ __forceinline__ float gather4(const XT* x, int base, const int4& c,
                                         const float (&v)[4], int m,
                                         float acc) {
  const int cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gc = base + cs[i];
    if (static_cast<unsigned>(gc) < static_cast<unsigned>(m))
      acc = fmaf(v[i], x_at(x, gc), acc);
  }
  return acc;
}

// a lane's (offset in its chunk, chunk base) one step on: `rk` slots and
// `qb` columns (the step is qk chunks and rk slots, qb = qk * chunk_cols)
__device__ __forceinline__ void mv_advance(int& l, int& base, int rk, int qb,
                                           int lc, int cc) {
  l += rk;
  base += qb;
  if (l >= lc) {
    l -= lc;
    base += cc;
  }
}

// The slots [s0, s1) of one row into acc: cs[s] is slot s's column id and
// vs the row's value bytes, both in shared memory; x in shared or global
// memory.  Lane `lane` of the team's `lanes` takes the groups of 4
// consecutive slots at s0 + 4 * lane, then every 4 * lanes slots (s0 is a
// multiple of 4 * lanes), and adds each group's slots in order.  VEC: Lc
// is a multiple of 4 (a group's slots share a chunk) and the spans are
// aligned, so a group is one 16-byte index load and one value load, two
// groups a turn; else slot by slot, in the same order.
template <int P, typename XT, bool VEC>
__device__ __forceinline__ float mv_walk(const int* cs,
                                         const unsigned char* vs, int s0,
                                         int s1, int lc, int cc, int m,
                                         const XT* x, int lane, int lanes,
                                         float acc) {
  int s = s0 + 4 * lane;
  if (s >= s1) return acc;
  const int step = 4 * lanes, qk = step / lc, rk = step - qk * lc;
  const int qb = qk * cc;
  int l = s % lc, base = s / lc * cc;
  if (VEC) {
    for (; s + step < s1; s += 2 * step) {
      const int4 ca = *reinterpret_cast<const int4*>(cs + s);
      const int4 cb = *reinterpret_cast<const int4*>(cs + s + step);
      float va[4], vb[4];
      smem_values4<P>(vs, s, va);
      smem_values4<P>(vs, s + step, vb);
      const int base_a = base;
      mv_advance(l, base, rk, qb, lc, cc);
      const int base_b = base;
      mv_advance(l, base, rk, qb, lc, cc);
      acc = gather4(x, base_a, ca, va, m, acc);
      acc = gather4(x, base_b, cb, vb, m, acc);
    }
    if (s < s1) {
      float va[4];
      smem_values4<P>(vs, s, va);
      acc = gather4(x, base, *reinterpret_cast<const int4*>(cs + s), va, m,
                    acc);
    }
    return acc;
  }
  for (; s < s1; s += step) {
    int li = l, kb = base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i > 0 && ++li == lc) {
        li = 0;
        kb += cc;
      }
      if (s + i >= s1) break;
      const int gc = kb + cs[s + i];
      const float v = smem_value<P>(vs, s + i, 0, 0, 0);
      if (static_cast<unsigned>(gc) < static_cast<unsigned>(m))
        acc = fmaf(v, x_at(x, gc), acc);
    }
    mv_advance(l, base, rk, qb, lc, cc);
  }
  return acc;
}

// The consumer warps: each takes every tile in order, waits on its index
// barrier, and, where its team has rows in the tile, on its value barrier;
// walks them, ends each row (a butterfly, then for a team of several warps
// their sums in warp order through part[], between two team barriers) and
// its first lane stores it; then frees the stage.  Row q of the block
// (counted over its tiles) belongs to team q % (kMvConsumers / team).
template <int P, typename XT, bool FAST>
__device__ __forceinline__ void mv_consume(const MvArgs& a, int r_begin,
                                           int r_end, unsigned char* smem,
                                           uint32_t bars, uint32_t stages,
                                           const XT* x, float* part) {
  const int warp = threadIdx.x / kWarp, lane32 = threadIdx.x % kWarp;
  const int team = a.team, t_id = warp / team, n_teams = kMvConsumers / team;
  const int lanes = kWarp * team, lane = (warp % team) * kWarp + lane32;
  const int slots = a.n_chunks * a.lc;
  float acc = 0.0f;
  int q = 0, it = 0;
  for_mv_tiles(a, r_begin, r_end, [&](const MvTile& t) {
    const int st = it % a.stages;
    const uint32_t ph = (it / a.stages) & 1;
    mbar_wait(bars + 8 * st, ph);
    const int j0 = (t_id - q % n_teams + n_teams) % n_teams;
    if (j0 < t.n) {
      Span sp[2];
      mv_spans<P>(a, t, stages + st * a.stage, sp);
      // slot 0 of the tile's first row (slot s0 sits at the span's head)
      const int* cs =
          reinterpret_cast<const int*>(
              smem + (sp[0].smem - bars) +
              (reinterpret_cast<uintptr_t>(sp[0].gptr) & 15)) - t.s0;
      const unsigned char* vs =
          smem + (sp[1].smem - bars) +
          (reinterpret_cast<uintptr_t>(sp[1].gptr) & 15) -
          t.s0 * slot_bytes<P>();
      mbar_wait(bars + 8 * (kMvMaxStages + st), ph);
      for (int j = j0; j < t.n; j += n_teams) {
        if (t.s0 == 0) acc = 0.0f;
        const int* rc = cs + j * slots;
        const unsigned char* rv = vs + j * slots * slot_bytes<P>();
        if (FAST || a.vec)
          acc = mv_walk<P, XT, true>(rc, rv, t.s0, t.s1, a.lc, a.chunk_cols,
                                     a.m, x, lane, lanes, acc);
        else
          acc = mv_walk<P, XT, false>(rc, rv, t.s0, t.s1, a.lc,
                                      a.chunk_cols, a.m, x, lane, lanes,
                                      acc);
        if (t.s1 < slots) continue;     // a piece that does not end its row
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (team > 1) {
          if (lane32 == 0) part[warp] = acc;
          team_sync(1 + t_id, lanes);
          acc = part[t_id * team];
          for (int w = 1; w < team; ++w) acc += part[t_id * team + w];
          team_sync(1 + t_id, lanes);   // part is free again
        }
        if (lane == 0) a.out[t.r0 + j] = acc;
      }
    }
    if (t.s1 == slots) q += t.n;
    __syncwarp();
    if (lane32 == 0) mbar_arrive(bars + 8 * (2 * kMvMaxStages + st));
    ++it;
  });
}

// FAST: vector loads and x staged, the common case in an instance of its
// own; else either walk by a.vec and x where a.xstage puts it
template <int P, typename XT, bool FAST>
__global__ void __launch_bounds__(kMvThreads, 1)
espim_spmv_mv_kernel(const __grid_constant__ MvArgs a) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ float part[kMvConsumers];
  const uint32_t bars = smem_u32(ring_smem);
  const uint32_t stages = bars + kMvBarBytes;
  const uint32_t xbar = bars + 8 * 3 * kMvMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kMvMaxStages + s), 1);
      mbar_init(bars + 8 * (2 * kMvMaxStages + s), kMvConsumers);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int r_begin = blockIdx.x * a.rows_a_block;
  const int r_end = min(a.rows, r_begin + a.rows_a_block);
  // x, when staged, sits after the ring: global byte x + i at xs + i
  const Span xspan = {static_cast<const unsigned char*>(a.x),
                      a.m * static_cast<int>(sizeof(XT)),
                      stages + a.stages * a.stage};
  if (static_cast<int>(threadIdx.x / kWarp) == kMvConsumers) {
    mv_produce<P>(a, r_begin, r_end, ring_smem, bars, stages, xspan);
    return;
  }
  const XT* x = static_cast<const XT*>(a.x);
  if (FAST || a.xstage) {
    x = reinterpret_cast<const XT*>(
        ring_smem + (xspan.smem - bars) +
        (reinterpret_cast<uintptr_t>(a.x) & 15));
    if (r_begin < r_end) mbar_wait(xbar, 0);
  }
  mv_consume<P, XT, FAST>(a, r_begin, r_end, ring_smem, bars, stages, x,
                          part);
}

// whether the plan fits the operands and the ring (a plan that would
// overrun a stage or shared memory is refused)
inline bool mv_plan_ok(const MvArgs& a, int blocks, int vb, int xb) {
  const long long slots = 1LL * a.n_chunks * a.lc;
  const long long rowb = slots * (4 + vb);
  const long long smem = kMvBarBytes + 1LL * a.stages * a.stage +
                         (a.xstage ? mv_x_region(a.m, xb) : 0);
  const bool tiles = a.tile_rows > 0
      ? a.tile_rows * rowb + 64 <= a.stage
      : a.piece > 0 && a.piece % (4 * kWarp * a.team) == 0 &&
            1LL * a.piece * (4 + vb) + 64 <= a.stage;
  return a.rows > 0 && slots > 0 && a.m > 0 && a.chunk_cols > 0 &&
         blocks >= 1 && a.rows_a_block >= 1 &&
         1LL * blocks * a.rows_a_block >= a.rows &&
         1LL * (blocks - 1) * a.rows_a_block < a.rows &&
         (a.team == 1 || a.team == 4) && a.stages >= 2 &&
         a.stages <= kMvMaxStages && a.stage % 128 == 0 && smem <= kSmemLimit &&
         tiles;
}

template <int P, typename XT, bool FAST>
int launch_mv(const MvArgs& a, int blocks, void* stream) {
  void (*kern)(const MvArgs) = espim_spmv_mv_kernel<P, XT, FAST>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static bool opted[64] = {};   // the shared-memory opt-in, by device
  if (!opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = true;
  }
  const int smem = kMvBarBytes + a.stages * a.stage +
                   (a.xstage ? mv_x_region(a.m, sizeof(XT)) : 0);
  kern<<<blocks, kMvThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int P, typename XT>
int launch_mv_x(const MvArgs& a, int blocks, void* stream) {
  return a.vec && a.xstage ? launch_mv<P, XT, true>(a, blocks, stream)
                           : launch_mv<P, XT, false>(a, blocks, stream);
}

}  // namespace

extern "C" {

// values f32 or bf16 (R, K, Lc); x f32 or bf16 (M,); out f32 (R,); the
// launch plan of kernels/espim_spmv._mv_plan (blocks .. xstage), refused
// (cudaErrorInvalidValue) where it does not fit
int espim_spmv(const void* values, int values_bf16, const void* cols,
               const void* x, int x_bf16, void* out, int rows, int n_chunks,
               int lc, int chunk_cols, int m, int blocks, int rows_a_block,
               int team, int stages, int stage_bytes,
               int tile_rows, int piece, int xstage, void* stream) {
  const int vb = values_bf16 ? 2 : 4, xb = x_bf16 ? 2 : 4;
  MvArgs a = {values, static_cast<const int*>(cols), x,
              static_cast<float*>(out), rows, n_chunks, lc, chunk_cols, m,
              rows_a_block, team, stages, stage_bytes, tile_rows,
              piece, xstage != 0, 0};
  a.vec = lc % 4 == 0 && aligned(cols, 16) && aligned(values, 4 * vb);
  if (!mv_plan_ok(a, blocks, vb, xb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (values_bf16)
    return x_bf16 ? launch_mv_x<kBF16, unsigned short>(a, blocks, stream)
                  : launch_mv_x<kBF16, float>(a, blocks, stream);
  return x_bf16 ? launch_mv_x<kF32, unsigned short>(a, blocks, stream)
                : launch_mv_x<kF32, float>(a, blocks, stream);
}

// values f32 or bf16 (values_bf16 = 1) (R, K, Lc); x f32 (M, B);
// out (R, B)
int espim_spmv_batched_fp(const void* values, int values_bf16,
                          const void* cols, const void* x, void* out,
                          int rows, int n_chunks, int lc, int chunk_cols,
                          int m, int b, int wpr, int u, void* stream) {
  GroupArgs a = one_bucket(values, cols, nullptr, 1, nullptr, rows, n_chunks,
                           lc, lc, x, out, chunk_cols, m, b, 0);
  if (values_bf16) return launch_group<kBF16, 1, true>(a, wpr, u, stream);
  return launch_group<kF32, 1, true>(a, wpr, u, stream);
}

// values f32 or bf16 (values_bf16 = 1) (R, K, Lc); residual f32 (R, B) in
// packed row order; out (R, B)
int espim_spmv_batched_res_fp(const void* values, int values_bf16,
                              const void* cols, const void* x,
                              const void* residual, void* out, int rows,
                              int n_chunks, int lc, int chunk_cols, int m,
                              int b, int wpr, int u, void* stream) {
  GroupArgs a = one_bucket(values, cols, nullptr, 1,
                           static_cast<const float*>(residual), rows,
                           n_chunks, lc, lc, x, out, chunk_cols, m, b, 0);
  if (values_bf16) return launch_group<kBF16, 1, false>(a, wpr, u, stream);
  return launch_group<kF32, 1, false>(a, wpr, u, stream);
}

// codes int8 (R, K, Lc) or nibble-packed uint8 (R, K, lv); scales
// (R / group_rows,) f32 or null; out (R, B)
int espim_spmv_batched_quant(const void* codes, int nibble, int lv,
                             const void* cols, const void* scales,
                             int group_rows, const void* x, void* out,
                             int rows, int n_chunks, int lc, int chunk_cols,
                             int m, int b, int wpr, int u, void* stream) {
  GroupArgs a = one_bucket(codes, cols, static_cast<const float*>(scales),
                           group_rows, nullptr, rows, n_chunks, lc,
                           nibble ? lv : lc, x, out, chunk_cols, m, b, 0);
  if (nibble) return launch_group<kNib, 1, true>(a, wpr, u, stream);
  return launch_group<kI8, 1, true>(a, wpr, u, stream);
}

// values f32 or bf16 (values_bf16 = 1) (2 * Rg, K, Lc) half-major;
// out (Rg, B)
int espim_spmv_batched_glu_fp(const void* values, int values_bf16,
                              const void* cols, const void* x, void* out,
                              int rows_g, int n_chunks, int lc,
                              int chunk_cols, int m, int b, int act, int wpr,
                              int u, void* stream) {
  GroupArgs a = one_bucket(values, cols, nullptr, 1, nullptr, rows_g,
                           n_chunks, lc, lc, x, out, chunk_cols, m, b, act);
  if (values_bf16) return launch_group<kBF16, 2, false>(a, wpr, u, stream);
  return launch_group<kF32, 2, false>(a, wpr, u, stream);
}

// codes int8 / nibble uint8 (2 * Rg, K, Lc | lv); srow (2 * Rg,) f32;
// out (Rg, B)
int espim_spmv_batched_quant_glu(const void* codes, int nibble, int lv,
                                 const void* cols, const void* srow,
                                 const void* x, void* out, int rows_g,
                                 int n_chunks, int lc, int chunk_cols, int m,
                                 int b, int act, int wpr, int u,
                                 void* stream) {
  GroupArgs a = one_bucket(codes, cols, static_cast<const float*>(srow), 1,
                           nullptr, rows_g, n_chunks, lc, nibble ? lv : lc, x,
                           out, chunk_cols, m, b, act);
  if (nibble) return launch_group<kNib, 2, false>(a, wpr, u, stream);
  return launch_group<kI8, 2, false>(a, wpr, u, stream);
}

// A packed group's buckets in one launch (several when it has more than
// kMaxBuckets).  plane: 0 f32, 1 int8, 2 nibble int4, 3 bf16 (enum Plane);
// glu: half-major gate+up buckets, act(gate * sg) * (up * su); values,
// cols, scales: host arrays of n_buckets device pointers (scales: each
// bucket's per-row srow, (rows,) or (2 * Rg,) for glu, or a null array);
// shapes: a host array of n_buckets x (rows, n_chunks, lc, lv), rows the
// bucket's output rows (pairs for glu); perm: (sum of rows,) packed row ->
// output row, -1 for a pad row, or null for the packed order; out: the
// group's output rows x B
int espim_spmv_group(int plane, int glu, int n_buckets, const void* values,
                     const void* cols, const void* scales,
                     const void* shapes, const void* x, const void* perm,
                     void* out, int chunk_cols, int m, int b, int act,
                     int wpr, int u, void* stream) {
  for (int i0 = 0; i0 < n_buckets; i0 += kMaxBuckets) {
    GroupArgs a = group_args(i0, std::min(kMaxBuckets, n_buckets - i0),
                             values, cols, scales, shapes, x, perm, out,
                             chunk_cols, m, b, act);
    const int rc = by_plane(plane, [&](auto pc) {
      constexpr int P = decltype(pc)::value;
      return glu ? launch_group<P, 2, false>(a, wpr, u, stream)
                 : launch_group<P, 1, true>(a, wpr, u, stream);
    });
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
