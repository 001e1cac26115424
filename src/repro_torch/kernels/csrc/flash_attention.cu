// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (_flash_kernel,
// src/repro/kernels/flash_attention.py:27-64, pallas_call at :99): q, k, v
// (BH, S, hd) in fp32 or bf16, hd in {32, 64, 128} (the wrapper zero-pads
// a narrower head up to the next of them and passes the true hd's scale),
// out (BH, S, hd) in q's dtype; scores of q * scale against k; keys at
// k_pos >= S masked, and keys after the query (k_pos > q_pos) masked when
// causal; masked scores are -1e30, as in the reference; the running max
// m, sum l and output acc are fp32, and out = acc / max(l, 1e-30). Device
// memory sees only the q, k, v and out streams.
//
// Bound: operations at long S: 4 * S^2 * hd flops per head (half when
// causal) against 4 * S * hd elements of traffic, ~S / 2 flops a byte in
// bf16, far above the card's ~295 (989 TFLOP/s over 3.35 TB/s). So both
// bodies run on the tensor cores, chosen by dtype.
//
// wgmma + TMA (flash_attention_wgmma_kernel<HD, BK, STAGES, NWG>, bf16): a
// block takes one (head, tile of 64 * NWG queries); NWG consumer
// warpgroups own 64 query rows each, and one producer warp issues every
// load. The q tile is loaded once; k and v tiles of BK keys stream through
// a ring of STAGES stages, each a TMA load (cp.async.bulk.tensor, 3-D map
// (hd, S, BH): rows past S read as zeros, never the next head) completing
// on a `full` mbarrier; each consumer warp arrives on the stage's `empty`
// mbarrier when done, and the producer waits on it before reloading the
// stage (the reference's grid pipelining, as a ring inside the block).
//   - Tiles in shared memory are TMA boxes of 64 columns (hd 64, 128:
//     128-byte swizzle) or 32 (hd 32: 64-byte swizzle), the swizzle span;
//     a tile of hd 128 is two boxes side by side. The TMA swizzle mode and
//     the wgmma descriptors' layout type are set together (Layout<HD>).
//   - S = Q K^T: wgmma m64nBKk16, both operands in shared memory, K-major
//     (k stored (keys, hd) row-major is K-major B); a k16 step is 32 bytes
//     into a box's swizzled rows, then the next box.
//   - Softmax in registers on the accumulator fragment: scores times
//     log2(e) / sqrt(hd) and exp2 (ex2.approx), row max over the quad by
//     shuffles; the quad's sum shares are added once, at the end. The
//     element mask runs only on tiles that reach past S or, causal, past
//     the warp's first query; key tiles wholly after a warpgroup's last
//     query are not computed (the block still releases their stage).
//   - O += P V: P from registers as the bf16 A operand (the fp32 score
//     fragment converted in place, as FA3 does: the one numerical change
//     from the fp32 p * v of the reference; PERF.md states its error), V
//     from shared memory as the MN-major B operand (transpose bit set;
//     LBO = the next box of hd columns, SBO = the next 8 keys).
//   - wgmma.fence before each product, commit and wait before its
//     accumulator is read or rescaled, and an empty asm on every
//     accumulator register around them so the compiler moves no access
//     across; shared memory is written only by TMA (the async proxy), so
//     no proxy fence is needed.
//   - The epilogue divides by l and stores bf16 pairs straight from the
//     fragment; rows at or past S are not stored.
//   - Causal: query tiles are walked longest first (blockIdx.y reversed,
//     heads in blockIdx.x), so the long diagonal tiles do not form the
//     tail. No atomics and a fixed sum order: two launches give the same
//     bits.
//   - The tensor maps are encoded on the host at every call
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion, so
//     the plain nvcc line needs no -lcuda) and passed as __grid_constant__
//     kernel parameters; the three encodes cost 0.2 us of host time (the
//     A/B), so they are not cached.
// 3xTF32 mma.sync (flash_attention_tf32_kernel<HD, BK, NW>, fp32): wgmma
// has no fp32 form, and one TF32 product (10 mantissa bits) misses the
// fp32 tolerance of 2e-5. Each operand is split into hi + lo, both tf32,
// and a product is lo * hi + hi * lo + hi * hi, summed in fp32: ~21 bits
// of each operand, at a third of the 495 TFLOP/s TF32 rate. mma.sync, not
// wgmma, because wgmma transposes only 16-bit operands in shared memory
// and v would need a transpose; mma.sync fragments are loaded by the
// threads, in any layout. The details are at the kernel; its softmax,
// masks, causal order and fixed sum order are the wgmma body's.
//
// The A/B (scripts/attn_tile_ab.py; NVIDIA H100 80GB HBM3, 700 W; us at
// BH 32, hd 128; PERF.md). bf16: at S = 2048 the wgmma body with key tiles
// of 128, 2 stages and 2 consumer warpgroups is the fastest of its eight
// (key tile, stages, warpgroups) variants, causal 95.1 (the scalar body it
// replaced 2086.1, SDPA 80.3) and full 157.8 (SDPA 115.6); at S = 512
// causal the 64-key, 1-warpgroup variant is 15% faster (14.6 against
// 17.2: twice the blocks where the 128-query grid fills the card once),
// and at S = 77 every variant and SDPA take 7-9. One variant serves every
// shape: 128 / 2 / 2 has the least sum over chip_smoke's shapes. fp32: the
// 3xTF32 body with key tiles of 64 and 8 warps (128 queries a block, so
// half the k and v re-reads of 4 warps) takes 610 at S = 2048 causal (the
// scalar body it replaced 2137, SDPA 905) and 1183-1199 full (SDPA 1551);
// a register-tiled SIMT candidate (each thread a 4 x 4 block of scores,
// q, k and v vectors from shared memory) took 1128-1166 causal and was
// removed, as were the scalar body and an FA2-style bf16 mma.sync body.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr float kNegInf = -1e30f;      // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// entry-point return codes beyond cudaError_t: the CUDA driver's
// tensor-map encoder could not be reached, or refused a map (kErrEncode +
// CUresult)
constexpr int kErrNoEncoder = 900;
constexpr int kErrEncode = 1000;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a key tile needs the element mask when it reaches past the sequence or,
// causal, past the first query row of the slab starting at `first_row`
template <int NK>
__device__ __forceinline__ bool tile_needs_mask(int key0, int first_row,
                                                int seq, int causal) {
  return key0 + NK > seq || (causal && key0 + NK - 1 > first_row);
}

// 16 bytes global -> shared through L2 only; `bytes` 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// k and v rows key0 .. key0 + BK - 1 of one head (base) into a stage: k
// at ks with rows SK floats apart, v at vs with rows SV floats apart; rows
// past seq are zero-filled. Every thread of the block copies 16-byte
// chunks and commits one group.
template <int HD, int BK, int THREADS, int SK, int SV>
__device__ __forceinline__ void load_kv(float* ks, float* vs,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        long long base, int key0, int seq) {
  constexpr int kChunks = BK * HD / 4;
  for (int c = threadIdx.x; c < kChunks; c += THREADS) {
    const int r = c / (HD / 4);
    const int col = 4 * (c % (HD / 4));
    const bool in = key0 + r < seq;
    const long long g =
        base + static_cast<long long>(in ? key0 + r : 0) * HD + col;
    cp_async16(smem_addr(ks + r * SK + col), k + g, in ? 16 : 0);
    cp_async16(smem_addr(vs + r * SV + col), v + g, in ? 16 : 0);
  }
  cp_async_commit();
}

// --------------------------------------------------------------------------
// The 3xTF32 body: fp32 inputs.
// --------------------------------------------------------------------------
namespace tf32 {

// x = hi + lo + a rest below 2^-21 |x|: hi is x rounded to tf32 (10
// mantissa bits; half up on the magnitude, by integer ops), lo the exact
// remainder x - hi, left in fp32: the tensor core reads a tf32 operand's
// top 19 bits and ignores the low 13, so lo is cut to tf32 there. (cvt.rna
// compiles to ~4 instructions with its special-value checks, and rounding
// lo as well changes nothing that the fp32 tolerance sees: the A/B.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row-major fragment) * b (8 x 8, col-major fragment), tf32
// products summed in fp32. Not volatile: a pure function of its operands,
// so the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[d0 + i] += a * b[i] for N independent products from split operands
// (b[i] = {hi0, hi1, lo0, lo1}): the small cross terms of every product
// first, then hi * hi (lo * lo, below 2^-22 of a product, is dropped);
// term-major, so N products are in flight between two dependent ones
template <int N, int M>
__device__ __forceinline__ void mma3(float (&d)[M][4], int d0,
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&b)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[d0 + i], alo, b[i][0], b[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[d0 + i], ahi, b[i][2], b[i][3]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[d0 + i], ahi, b[i][0], b[i][1]);
}

template <int HD, int BK, int NW>
struct Config {
  static constexpr int kBQ = 16 * NW;            // query rows a block
  static constexpr int kThreads = kWarp * NW;
  // floats a q or k row (64-bit fragment loads: 8 rows hit 32 banks) and
  // a v row (32-bit loads of rows 2 t, 2 t + 1: 32 banks)
  static constexpr int kSK = HD + 8, kSV = HD + 4;
  static constexpr int kStage = BK * (kSK + kSV);   // floats, k then v
  // q (pre-scaled), then 2 stages of k and v
  static constexpr int kSmem = (kBQ * kSK + 2 * kStage) * 4;
};

}  // namespace tf32

// 3xTF32 on the tensor cores: a block takes one (head, tile of 16 * NW
// queries), a warp 16 query rows. q (pre-scaled) sits in shared memory for
// the whole block; k and v tiles of BK keys stream through two stages by
// cp.async (tile j + 1 in flight while tile j is consumed). Rows are
// padded (Config::kSK, kSV), so every fragment load hits 32 distinct
// banks. S = Q K^T and O += P V are m16n8k8 TF32 mma.sync on operands
// split into hi + lo (tf32::split, tf32::mma3), which keeps each product
// to about fp32 precision; every warp splits the fragments it loads. A
// thread holds, of a 16-row slab, rows g = lane / 4 and g + 8 at columns
// 2 t, 2 t + 1 (t = lane % 4) of every 8-column block: the quad holds a
// row, and the row max is two shuffles. P feeds P V from those registers:
// within a block of 8 keys, A column t is key 2 t and column t + 4 key
// 2 t + 1, and the V fragment loads rows 2 t and 2 t + 1 to match (the
// sum over keys is order-free up to rounding, and the order is fixed).
// Softmax in the exp2 domain (q pre-scaled by log2(e) / sqrt(hd), as the
// wgmma body), with the reference's -1e30 masks and fp32 m, l, o.
template <int HD, int BK, int NW>
__global__ void __launch_bounds__(kWarp * NW)
flash_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int seq, int causal,
                            float scale_log2) {
  using C = tf32::Config<HD, BK, NW>;
  constexpr int NB = BK / 8;                     // 8-key blocks a tile
  constexpr int HG = 4;                          // hd blocks a P V group
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // [kBQ][kSK]
  float* ring = qs + C::kBQ * C::kSK;            // stage s at s kStage
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (seq + C::kBQ - 1) / C::kBQ;
  const int q0 = (causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                         : static_cast<int>(blockIdx.y)) * C::kBQ;
  const long long base = static_cast<long long>(blockIdx.x) * seq * HD;
  const int first = q0 + 16 * warp;              // the warp's first row
  const int k_end = causal ? min(seq, q0 + C::kBQ) : seq;
  const int n_kt = (k_end + BK - 1) / BK;
  const int wk_end = first >= seq ? 0 : causal ? min(seq, first + 16) : seq;

  if (n_kt > 0)
    load_kv<HD, BK, C::kThreads, C::kSK, C::kSV>(
        ring, ring + BK * C::kSK, k, v, base, 0, seq);
  for (int c = threadIdx.x; c < C::kBQ * HD / 4; c += C::kThreads) {
    const int r = c / (HD / 4), col = 4 * (c % (HD / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < seq) {
      x = __ldg(reinterpret_cast<const float4*>(
          q + base + static_cast<long long>(q0 + r) * HD + col));
      x.x *= scale_log2;
      x.y *= scale_log2;
      x.z *= scale_log2;
      x.w *= scale_log2;
    }
    *reinterpret_cast<float4*>(qs + r * C::kSK + col) = x;
  }
  const float* qw = qs + (16 * warp + g) * C::kSK + 2 * t;   // row g
  float o[HD / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < HD / 8; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[h][e] = 0.0f;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      float* next = ring + ((j + 1) & 1) * C::kStage;
      load_kv<HD, BK, C::kThreads, C::kSK, C::kSV>(
          next, next + BK * C::kSK, k, v, base, (j + 1) * BK, seq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                             // tile j (and q) are in
    const int key0 = j * BK;
    if (key0 < wk_end) {
      const float* ks = ring + (j & 1) * C::kStage;
      const float* vs = ks + BK * C::kSK;
      // S = Q K^T over hd blocks of 8, A column t / t + 4 being hd 2 t /
      // 2 t + 1 of the block on both sides (the sum over hd is order-free
      // up to rounding, and the order is fixed), so each fragment pair is
      // one 64-bit load: A (rows g, g + 8) from q, B (k = hd, n = key) =
      // k[key 8 n + g][8 kk + 2 t, + 1]
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ahi[4], alo[4], b[NB][4];
        const float2 q0v = *reinterpret_cast<const float2*>(qw + 8 * kk);
        const float2 q1v =
            *reinterpret_cast<const float2*>(qw + 8 * C::kSK + 8 * kk);
        tf32::split(q0v.x, ahi[0], alo[0]);
        tf32::split(q1v.x, ahi[1], alo[1]);
        tf32::split(q0v.y, ahi[2], alo[2]);
        tf32::split(q1v.y, ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(
              ks + (8 * n + g) * C::kSK + 8 * kk + 2 * t);
          tf32::split(kv.x, b[n][0], b[n][2]);
          tf32::split(kv.y, b[n][1], b[n][3]);
        }
        tf32::mma3(s, 0, ahi, alo, b);
      }
      if (tile_needs_mask<BK>(key0, first, seq, causal)) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            const int row = first + g + 8 * (e >> 1);
            if (key >= seq || (causal && key > row)) s[n][e] = kNegInf;
          }
      }
      // online softmax on rows g (e 0, 1) and g + 8 (e 2, 3)
      float mx[2] = {m[0], m[1]}, corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2_approx(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_approx(s[n][e] - mx[e >> 1]);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int h = 0; h < HD / 8; ++h) {
        o[h][0] *= corr[0];
        o[h][1] *= corr[0];
        o[h][2] *= corr[1];
        o[h][3] *= corr[1];
      }
      // O += P V: A = P (columns t, t + 4 = keys 2 t, 2 t + 1 of block n),
      // B (k = key, n = hd) = v[key 8 n + 2 t (+ 1)][8 h + g], HG hd blocks
      // at a time
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t ahi[4], alo[4];
        tf32::split(s[n][0], ahi[0], alo[0]);
        tf32::split(s[n][2], ahi[1], alo[1]);
        tf32::split(s[n][1], ahi[2], alo[2]);
        tf32::split(s[n][3], ahi[3], alo[3]);
        const float* vr = vs + (8 * n + 2 * t) * C::kSV + g;
#pragma unroll
        for (int h0 = 0; h0 < HD / 8; h0 += HG) {
          uint32_t b[HG][4];
#pragma unroll
          for (int i = 0; i < HG; ++i) {
            tf32::split(vr[8 * (h0 + i)], b[i][0], b[i][2]);
            tf32::split(vr[C::kSV + 8 * (h0 + i)], b[i][1], b[i][3]);
          }
          tf32::mma3(o, h0, ahi, alo, b);
        }
      }
    }
    __syncthreads();                             // stage j & 1 is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tl = l[h];
    tl += __shfl_xor_sync(0xffffffffu, tl, 1);
    tl += __shfl_xor_sync(0xffffffffu, tl, 2);
    const float denom = fmaxf(tl, 1e-30f);
    const int row = first + g + 8 * h;
    if (row >= seq) continue;
    float* dst = out + base + static_cast<long long>(row) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(o[c][2 * h] / denom, o[c][2 * h + 1] / denom);
  }
}

// --------------------------------------------------------------------------
// The wgmma body's fragment helpers: a warp's 16-row slab of a score or
// output tile in wgmma's m64nN accumulator fragment (mma.sync's m16n8
// fragment, repeated once per warp). For a tile of N columns a thread
// holds f[4 * j + e], j < N / 8: row (lane / 4) + 8 * (e / 2) of the slab,
// column 8 * j + 2 * (lane % 4) + (e % 2). A row lives in the 4 lanes of a
// quad.
// --------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}


// raw scores -> the exp2 domain (times log2(e) / sqrt(hd)); when `mask`,
// keys at or past seq, and keys after the row's query when causal, become
// the reference's -1e30. `row` is the query position of the thread's first
// row (its second is row + 8), key0 the tile's first key.
template <int NK>
__device__ __forceinline__ void scale_and_mask(float (&s)[NK / 2],
                                               float scale_log2, bool mask,
                                               int key0, int row, int seq,
                                               int causal) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (mask) {
        const int key = key0 + 8 * j + 2 * (lane % 4) + (e % 2);
        const int qpos = row + 8 * (e / 2);
        if (key >= seq || (causal && key > qpos)) x = kNegInf;
      }
      s[4 * j + e] = x;
    }
  }
}

// One online-softmax step over a tile of NK keys: the running row max m
// (exp2 domain), the thread's share l of the running row sums (its quad's
// four shares are added at the end), the output fragment o rescaled by
// exp2(m_old - m_new), and s overwritten by the probabilities.
template <int NK, int HD>
__device__ __forceinline__ void softmax_step(float (&s)[NK / 2], float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[HD / 2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2_approx(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(s[4 * j + e] - mx[e / 2]);
      sum[e / 2] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// the probabilities of keys 16 kb .. 16 kb + 15 as the bf16 A fragment of
// an m16k16 product (wgmma's A operand in registers)
template <int NK>
__device__ __forceinline__ void p_fragment(const float (&s)[NK / 2], int kb,
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kb], s[8 * kb + 1]);
  a[1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
  a[2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
  a[3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
}

// out rows row, row + 8 (those < seq) of one head = o / max(l, 1e-30), l
// summed over the quad in a fixed order, as bf16 pairs
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 2],
                                           const float (&l)[2],
                                           __nv_bfloat16* __restrict__ out,
                                           int row, int seq) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t = l[h];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    const float denom = fmaxf(t, 1e-30f);
    const int qpos = row + 8 * h;
    if (qpos >= seq) continue;
    __nv_bfloat16* dst = out + static_cast<long long>(qpos) * HD +
                         2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
  }
}


// --------------------------------------------------------------------------
// The wgmma + TMA body (bf16; the entry point's). NWG consumer warpgroups
// of 64 query rows and one producer warp a block. Tiles in shared memory
// are TMA boxes of kBoxW columns (the swizzle span) x rows, 1024-byte
// aligned; a tile of hd 128 is two boxes side by side.
// --------------------------------------------------------------------------
namespace wg {

template <int HD>
struct Layout {
  static constexpr int kBoxW = HD >= 64 ? 64 : 32;   // columns a box
  static constexpr int kBoxB = 2 * kBoxW;            // bytes a box row
  static constexpr int kBoxes = HD / kBoxW;
  static constexpr uint32_t kAtom = 8 * kBoxB;       // 8 rows: one swizzle atom
  // the wgmma descriptor's layout type and the TMA swizzle that match
  static constexpr uint64_t kDescLayout = HD >= 64 ? 1 : 2;   // 128B / 64B
};

template <int HD, int BK, int STAGES, int NWG>
struct Config {
  static constexpr int kBQ = 64 * NWG;
  static constexpr int kThreads = 128 * NWG + kWarp;
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kTileBytes = BK * HD * 2;   // one k or v tile
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr int kSmem = kQBytes + STAGES * kStageBytes + 1024;
};

// the 64-bit shared-memory matrix descriptor of wgmma
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// wait until the barrier's phase of parity `parity` has completed; a build
// with FLASH_WAIT_LIMIT (scripts/attn_tile_ab.py's) traps after that many
// clocks, so a pipeline fault ends the launch with an error, not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
#ifdef FLASH_WAIT_LIMIT
  const long long t0 = clock64();
#endif
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
#ifdef FLASH_WAIT_LIMIT
    if (!done && clock64() - t0 > FLASH_WAIT_LIMIT) __trap();
#endif
  } while (!done);
}

// box (c0 column, c1 row, c2 head) of a 3-D tensor map into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
               "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                  "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x N, fp32) = or += A (64 x 16, shared, K-major) * B (16 x N, shared,
// K-major); scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (64 x N, fp32) += A (64 x 16, bf16 registers) * B (16 x N, shared,
// MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

}  // namespace wg

template <int HD, int BK, int STAGES, int NWG>
__global__ void __launch_bounds__(wg::Config<HD, BK, STAGES, NWG>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int seq,
                             int causal, float scale_log2) {
  using namespace wg;
  using L = Layout<HD>;
  using C = Config<HD, BK, STAGES, NWG>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full;
  // q: box b at qs + b * kBQ * kBoxB; stage t: k box b at
  // kv(t) + b * BK * kBoxB, v box b at kv(t) + kTileBytes + b * BK * kBoxB
  const uint32_t qs = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t kv0 = qs + C::kQBytes;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_qt = (seq + C::kBQ - 1) / C::kBQ;
  const int q0 = (causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                         : static_cast<int>(blockIdx.y)) * C::kBQ;
  const int head = blockIdx.x;
  const int k_end = causal ? min(seq, q0 + C::kBQ) : seq;
  const int n_kt = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int t = 0; t < STAGES; ++t) {
      mbar_init(smem_addr(&full[t]), 1);
      mbar_init(smem_addr(&empty[t]), 4 * NWG);  // one arrival a warp
    }
    mbar_init(smem_addr(&q_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {                         // the producer warp
    if (lane == 0) {
      mbar_expect_tx(smem_addr(&q_full), C::kQBytes);
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load(qs + b * C::kBQ * L::kBoxB, &tq, smem_addr(&q_full),
                 b * L::kBoxW, q0, head);
      for (int j = 0; j < n_kt; ++j) {
        const int t = j % STAGES;
        if (j >= STAGES)                         // the consumers freed it
          mbar_wait(smem_addr(&empty[t]), ((j / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_addr(&full[t]);
        const uint32_t ks = kv0 + t * C::kStageBytes;
        mbar_expect_tx(bar, C::kStageBytes);
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load(ks + b * BK * L::kBoxB, &tk, bar, b * L::kBoxW, j * BK,
                   head);
          tma_load(ks + C::kTileBytes + b * BK * L::kBoxB, &tv, bar,
                   b * L::kBoxW, j * BK, head);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows wq0 .. wq0 + 63
  const int wq0 = q0 + 64 * (warp / 4);
  const int first = wq0 + 16 * (warp % 4);       // the warp's first row
  const int row = first + lane / 4;
  const int wk_end = wq0 >= seq ? 0 : causal ? min(seq, wq0 + 64) : seq;
  const uint32_t qa = qs + (warp / 4) * 64 * L::kBoxB;
  float o[HD / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  mbar_wait(smem_addr(&q_full), 0);

  for (int j = 0; j < n_kt; ++j) {
    const int t = j % STAGES;
    mbar_wait(smem_addr(&full[t]), (j / STAGES) & 1);
    const int key0 = j * BK;
    if (key0 < wk_end) {
      const uint32_t ks = kv0 + t * C::kStageBytes;
      const uint32_t vs = ks + C::kTileBytes;
      // S = Q K^T: k16 step kk is 32 bytes into box (16 kk) / kBoxW
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int b = 16 * kk / L::kBoxW;
        const uint32_t off = 2 * (16 * kk % L::kBoxW);
        wgmma_ss<BK>(s,
                     desc(qa + b * C::kBQ * L::kBoxB + off, 16, L::kAtom,
                          L::kDescLayout),
                     desc(ks + b * BK * L::kBoxB + off, 16, L::kAtom,
                          L::kDescLayout),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      scale_and_mask<BK>(s, scale_log2,
                         tile_needs_mask<BK>(key0, first, seq, causal), key0,
                         row, seq, causal);
      softmax_step<BK, HD>(s, m, l, o);
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb) p_fragment<BK>(s, kb, pa[kb]);
      // O += P V: V (keys x hd) is the MN-major B operand; k16 step kb is
      // 16 key rows on, the next box of hd columns BK rows on (LBO), the
      // next 8 keys one atom on (SBO)
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb)
        wgmma_rs<HD>(o, pa[kb],
                     desc(vs + 16 * kb * L::kBoxB, BK * L::kBoxB, L::kAtom,
                          L::kDescLayout));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[t]));   // stage t is free
  }
  store_rows<HD>(o, l, out + static_cast<long long>(head) * seq * HD, row,
                 seq);
}

// --------------------------------------------------------------------------
// Host side.
// --------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the CUDA runtime's driver entry
// point so the library links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (hd, seq, bh) bf16 tensor at ptr, read in boxes of HD's box width x
// `rows` rows of one head, swizzled as the wgmma descriptors expect; rows
// past seq read as zeros
template <int HD>
int tensor_map(CUtensorMap* map, const void* ptr, int bh, int seq,
               int rows) {
  using L = wg::Layout<HD>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(seq) * HD * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kBoxW),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// above 48 KB of dynamic shared memory needs the opt-in, once a kernel
template <typename K>
int allow_smem(K* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD, int BK, int NW>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                int bh, int seq, int causal, float scale, void* stream) {
  using C = tf32::Config<HD, BK, NW>;
  static const int attr =
      allow_smem(flash_attention_tf32_kernel<HD, BK, NW>, C::kSmem);
  if (attr != 0) return attr;
  const dim3 grid(bh, (seq + C::kBQ - 1) / C::kBQ);
  flash_attention_tf32_kernel<HD, BK, NW>
      <<<grid, C::kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), seq, causal,
          scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK, int STAGES, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int bh, int seq, int causal, float scale, void* stream) {
  using C = wg::Config<HD, BK, STAGES, NWG>;
  static const int attr = allow_smem(
      flash_attention_wgmma_kernel<HD, BK, STAGES, NWG>, C::kSmem);
  if (attr != 0) return attr;
  CUtensorMap tq, tk, tv;
  int rc = tensor_map<HD>(&tq, q, bh, seq, C::kBQ);
  if (rc == 0) rc = tensor_map<HD>(&tk, k, bh, seq, BK);
  if (rc == 0) rc = tensor_map<HD>(&tv, v, bh, seq, BK);
  if (rc != 0) return rc;
  const dim3 grid(bh, (seq + C::kBQ - 1) / C::kBQ);
  flash_attention_wgmma_kernel<HD, BK, STAGES, NWG>
      <<<grid, C::kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(out), seq, causal,
          scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 body and its (key tile, stages, consumer warpgroups): the A/B
// in PERF.md
constexpr int kBK = 128, kStages = 2, kNWG = 2;

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int seq, int causal, float scale, void* stream) {
  return launch_wgmma<HD, kBK, kStages, kNWG>(q, k, v, out, bh, seq, causal,
                                               scale, stream);
}

// the fp32 body and its (key tile, warps): the A/B in PERF.md
constexpr int kF32BK = 64, kF32NW = 8;

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int bh, int seq, int causal, float scale, void* stream) {
  return launch_tf32<HD, kF32BK, kF32NW>(q, k, v, out, bh, seq, causal, scale,
                                         stream);
}

}  // namespace

extern "C" {

// q, k, v, out (BH, S, hd) contiguous, fp32 (bf16 = 0) or bf16 (bf16 = 1);
// hd in {32, 64, 128} (the wrapper zero-pads a narrower head); scale: the
// softmax scale, 1 / sqrt(hd) of the true hd. bf16 runs the wgmma body,
// fp32 the 3xTF32 one.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int bf16, int bh, int seq, int hd, int causal,
                    float scale, void* stream) {
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 32 * 2 + 1:
      return launch_bf16<32>(q, k, v, out, bh, seq, causal, scale, stream);
    case 64 * 2 + 1:
      return launch_bf16<64>(q, k, v, out, bh, seq, causal, scale, stream);
    case 128 * 2 + 1:
      return launch_bf16<128>(q, k, v, out, bh, seq, causal, scale, stream);
    case 32 * 2:
      return launch_fp32<32>(q, k, v, out, bh, seq, causal, scale, stream);
    case 64 * 2:
      return launch_fp32<64>(q, k, v, out, bh, seq, causal, scale, stream);
    case 128 * 2:
      return launch_fp32<128>(q, k, v, out, bh, seq, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
