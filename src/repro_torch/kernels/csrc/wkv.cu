// The WKV recurrence of RWKV6 ("Finch"), forward and backward, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes
// (kernels/build.py); the wrappers and the launch plan live in
// kernels/wkv.py.
//
// Replaces no Pallas kernel: the reference writes the recurrence as one
// jax.lax.scan (src/repro/models/rwkv.py:103-116, time_mix_apply), which
// XLA compiles into a single loop.  Eager PyTorch ran it as a Python loop
// of five small ops a token.
//
// Per head, with the state S (K', V), for t = 0 .. S-1:
//   y_t[j]  = sum_k r_t[k] S[k,j] + v_t[j] a_t
//   a_t     = sum_k r_t[k] u[k] k_t[k]
//   S[k,j]  = w_t[k] S[k,j] + k_t[k] v_t[j]
// in float32 whatever the inputs (bf16 r / k / v are widened exactly).
// The state update is the instruction pair fmaf(w, S, k * v) (one
// rounding where the plain loop's w*S + kv rounds twice), so the state
// and the checkpoints come out in the same bits as the first port's body.
// Every sum runs in an order fixed by k and j alone, never by where a
// tile, a chunk or a launch starts: two calls over S/2 that carry the
// state give one call's bits over S.
//
// Bound.  Both kernels do 5 (forward) and 14 (backward) float32
// operations a (b, t, h, k, j) and move few bytes for them: at rwkv6's
// shapes the bound is operations (or, at one step, bytes and the launch),
// beside the serial chain of S dependent state updates (one fma, 4
// cycles, a step).  The design spreads a head's K' x V state over as many
// threads as the card holds, keeps a step to a few fmas a thread, and
// pays the sums that cross threads once a tile of steps, not once a step.
//
// Forward (wkv6_fwd_kernel<T, KG>): B * H * ceil(V / VS) CTAs of KG * VS
// compute threads and one copier warp (the plan, kernels/wkv._plan: KG
// k-groups from K' alone, VS columns from B * H to fill the card; at
// rwkv6's B 1 x H 32 x 64 x 64, 128 CTAs of 256 + 32 threads).  Thread
// (j, g) keeps WKV_ROWS = 4 state rows 4g .. 4g+3 of column j in
// registers; rows past K' are zero.  A step is three instructions a (k,
// j): kv = k v, a partial y += r S, S = fmaf(w, S, kv).  The k-groups of
// a column sit in neighbouring lanes; each keeps a tile of WKV_TILE
// partial y's in registers, and after the tile a butterfly
// reduce-scatter over the KG lanes (shuffles, a fixed tree) leaves each
// lane whole y's of WKV_TILE / KG steps.  a_t is computed once a step a
// CTA (runs of 4 rows by fma, then a fixed xor tree), and y_t[j] =
// fmaf(v_t[j], a_t, the reduced sum).  A tile's epilogue runs after the
// next tile's barrier: one barrier a tile, none a step.  r / k / w and
// the CTA's columns of v come through a ring of WKV_FSTAGES stages in
// shared memory, copied by the copier warp with cp.async two tiles ahead
// (each lane's copies planned once, 16 bytes each: RowCopy).  With
// `chunk` > 0 (a multiple of WKV_TILE) the state before every chunk-th
// step is written to ckpt (B, H, ceil(S/chunk), K', V) for the backward.
//
// Backward (wkv6_bwd_kernel<T>): B * H * ceil(V / WKV_BVS) CTAs of
// WKV_BTHREADS = 128 compute threads and two copier warps, the ceil(V / 16)
// CTAs of one (b, h) a thread-block cluster.  Thread (rg, cq) owns dS
// rows 2rg, 2rg+1 x columns 4cq .. 4cq+3 of the CTA's 16 in registers.
// Time runs back a chunk of WKV_CHUNK steps at a time: the chunk's states
// S_{t-1} are recomputed from its checkpoint with the forward's
// instruction pair (the same bits) into shared memory (WKV_CHUNK x 64 x
// 16 floats, 128 KB; a thread reads back only what it wrote), then walked
// back.  A step of the walk is the dS update and the partial dr / dk / dw
// (over the thread's 4 columns) and dv (over its 2 rows), written to
// shared memory; once a tile of WKV_BT steps (after the next barrier)
// they are summed in a fixed order: dv over the 32 row pairs (dv_t =
// sum_k dS k_t + gy_t a_t), dr / dk / dw over the 4 column quads into the
// chunk's slice sums.  Once a chunk the CTAs of a cluster sum the slices
// in rank order through distributed shared memory, add the u terms (gy .
// v summed the same way) and write dr / dk / dw and du's terms, each row
// by one rank.  The cluster barriers are split (arrive early, wait late)
// so that the next chunk's recompute hides them.  The inputs stream
// through a ring of tiles (as many slots as shared memory leaves, filled
// by the copier warps that many tiles ahead less two).  No atomics, no
// workspace in device memory; du is summed over t in the CTA and over b
// by wkv6_du_kernel, in order: every run gives the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define WKV_TILE 16          // steps a forward tile
#define WKV_CHUNK 32         // steps between checkpoints = a backward chunk
#define WKV_MAXK 64          // K' and V the kernels take
#define WKV_MAXV 64
#define WKV_ROWS 4           // state rows a forward thread owns
#define WKV_FWD_THREADS 256  // most threads a forward CTA
#define WKV_FSTAGES 4        // forward stages: 2 tiles in flight ahead
#define WKV_BAR_TILE 1       // the named barrier of a tile (copier + compute)
#define WKV_BT 4             // steps a backward tile
#define WKV_BVS 16           // columns a backward CTA
#define WKV_BTHREADS 128     // 32 row pairs x 4 column quads
#define WKV_BCOPY 64         // the backward's copier warps' threads
#define WKV_PJ 72            // row stride of the j-partials (bank spread)
#define WKV_SMEM_MAX 232448  // shared memory a block can have (227 KB)
#define WKV_FULL 0xffffffffu

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
    return __float2bfloat16(0.f);
}

// 2 / 4 consecutive elements as float (bf16 widened exactly: its 16 bits
// are a float's upper half; element 0 is the low half of a word)
__device__ __forceinline__ float bf_lo(uint32_t x) {
    return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
    return __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ void ld2(const float* p, float (&o)[2]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float (&o)[2]) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    o[0] = bf_lo(x); o[1] = bf_hi(x);
}
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    o[0] = bf_lo(x.x); o[1] = bf_hi(x.x); o[2] = bf_lo(x.y); o[3] = bf_hi(x.y);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// ---- the PTX: async copies and the cluster barrier ----
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
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
// named barrier `id` of `threads` threads (the warps that take part in
// it run different code: a copier warp and the compute warps)
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// every thread of the cluster arrives (its earlier shared-memory reads
// and writes released) / waits for all to have arrived (acquire)
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// n rows of `len` bytes, row i from src + i * sstride to dst + i *
// dstride, as 16-byte copies where every address and length allows, else
// 4-byte ones (len is a multiple of 4: the wrapper widens a bf16 operand
// whose row is odd).  Out of line: the general path of every copy site,
// which the main shapes never take, would otherwise swell the kernels'
// code past the instruction cache.
__device__ __noinline__ void copy_rows(void* dst, int dstride,
                                          const void* src, size_t sstride,
                                          int n, int len, int tid,
                                          int nthr) {
    char* d = static_cast<char*>(dst);
    const char* s = static_cast<const char*>(src);
    const bool w16 = ((len | dstride | static_cast<int>(sstride & 15)
                       | static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15)
                       | static_cast<int>(reinterpret_cast<uintptr_t>(d) & 15))
                      & 15) == 0;
    if (w16) {
        const int wpr = len >> 4;
        for (int i = tid; i < n * wpr; i += nthr) {
            const int tt = i / wpr, wd = i - tt * wpr;
            cp_async16(d + tt * dstride + 16 * wd, s + tt * sstride + 16 * wd);
        }
    } else {
        const int wpr = len >> 2;
        for (int i = tid; i < n * wpr; i += nthr) {
            const int tt = i / wpr, wd = i - tt * wpr;
            cp_async4(d + tt * dstride + 4 * wd, s + tt * sstride + 4 * wd);
        }
    }
}

// One operand's rows of `len` bytes, row i of step t at base + t * step,
// copied into a stage's rows of `dstride` bytes, planned once a CTA: where
// the row's 16-byte words divide the CTA's threads (and every address is
// 16-byte aligned), a thread copies one fixed word of every pass-th row,
// and a tile costs it an add and a copy a row; else (pass 0) copy_rows'
// loop over the whole tile.
struct RowCopy {
    const char* src;      // its word of row 0, step 0 (pass 0: row 0)
    int step;             // bytes from a step's row to the next step's
    int dst;              // this thread's word of row 0 in a stage
    int row0, pass;       // its first row; rows between its rows
};
__device__ __forceinline__ RowCopy plan_rows(const void* src, int step,
                                             int dstride, int len, int tid,
                                             int nthr) {
    const char* s = static_cast<const char*>(src);
    const int wpr = len >> 4;
    const bool fast = ((len | dstride | step
                        | static_cast<int>(reinterpret_cast<uintptr_t>(s)))
                       & 15) == 0 && wpr > 0 && nthr % wpr == 0;
    if (!fast) return {s, step, 0, 0, 0};
    const int wd = tid % wpr;
    return {s + 16 * wd, step, 16 * wd + tid / wpr * dstride, tid / wpr,
            nthr / wpr};
}
// rows 0 .. n-1 (steps t0 .. t0+n-1) into the stage at `stage`
__device__ __forceinline__ void issue_rows(const RowCopy& c,
                                           unsigned char* stage, int dstride,
                                           int len, int t0, int n, int tid,
                                           int nthr) {
    if (c.pass == 0) {
        copy_rows(stage, dstride, c.src + (long long)t0 * c.step, c.step, n,
                  len, tid, nthr);
        return;
    }
    const char* s = c.src + (long long)(t0 + c.row0) * c.step;
    unsigned char* d = stage + c.dst;
    for (int row = c.row0; row < n; row += c.pass) {
        cp_async16(d, s);
        s += (long long)c.pass * c.step;
        d += c.pass * dstride;
    }
}

// ==== forward ====

// a_t = sum_k (r_t[k] u[k]) k_t[k] for a tile's steps: rows in runs of
// WKV_ROWS by fma, the KG runs summed by an xor tree; the order depends
// on k (and K', through KG) only
template <typename T, int KG>
__device__ __forceinline__ void tile_a(float* as, const T* rs, const T* ks,
                                       const float* us, int n, int tid,
                                       int nthr) {
    constexpr int KPAD = WKV_ROWS * KG, PAIRS = WKV_TILE * KG;
    for (int p0 = 0; p0 < PAIRS; p0 += nthr) {
        const int pi = p0 + tid, tt = pi / KG, c = pi % KG;
        float x = 0.f;
        if (pi < PAIRS) {
#pragma unroll
            for (int i = 0; i < WKV_ROWS; ++i) {
                const int q = c * WKV_ROWS + i;
                x = __fmaf_rn(__fmul_rn(to_f(rs[tt * KPAD + q]), us[q]),
                              to_f(ks[tt * KPAD + q]), x);
            }
        }
#pragma unroll
        for (int m = 1; m < KG; m <<= 1)
            x = __fadd_rn(x, __shfl_xor_sync(WKV_FULL, x, m));
        if (pi < PAIRS && c == 0 && tt < n) as[tt] = x;
    }
}

// The tile's partial y's of the KG lanes of a column, reduce-scattered:
// at each level (lane bit M) the lane keeps the half of the steps its bit
// picks and adds the partner's; afterwards p[i] is the whole sum for step
// g * (WKV_TILE / KG) + i.  The tree is the same for every step.
template <int M, int HALF>
struct ReduceScatter {
    static __device__ __forceinline__ void run(float (&p)[WKV_TILE], int g) {
        const bool up = (g & M) != 0;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
            const float send = up ? p[i] : p[i + HALF];
            const float keep = up ? p[i + HALF] : p[i];
            p[i] = __fadd_rn(keep, __shfl_xor_sync(WKV_FULL, send, M));
        }
        ReduceScatter<M / 2, HALF / 2>::run(p, g);
    }
};
template <int HALF>
struct ReduceScatter<0, HALF> {
    static __device__ __forceinline__ void run(float (&)[WKV_TILE], int) {}
};

// one step of a thread's WKV_ROWS rows of column j -> its partial y
template <typename T>
__device__ __forceinline__ float fwd_step(float (&st)[WKV_ROWS],
                                          const T* rt, const T* kt,
                                          const float* wt, float vj) {
    float rr[4], kk[4], ww[4];
    ld4(rt, rr);
    ld4(kt, kk);
    ld4(wt, ww);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < WKV_ROWS; ++i) {
        const float kv = __fmul_rn(kk[i], vj);
        acc = __fmaf_rn(rr[i], st[i], acc);
        st[i] = __fmaf_rn(ww[i], st[i], kv);
    }
    return acc;
}

// dynamic shared memory of a forward CTA, bytes: WKV_FSTAGES stages of a
// tile's r, k (T), w rows of KPAD and the CTA's vs columns of v (T)
template <typename T, int KG>
struct FwdSmem {
    static constexpr int KPAD = WKV_ROWS * KG;
    static constexpr int kR = 0;
    static constexpr int kK = kR + WKV_TILE * KPAD * (int)sizeof(T);
    static constexpr int kW = kK + WKV_TILE * KPAD * (int)sizeof(T);
    static constexpr int kV = kW + WKV_TILE * KPAD * 4;
    static __host__ __device__ __forceinline__ int stage(int vs) {
        return (kV + WKV_TILE * vs * (int)sizeof(T) + 15) / 16 * 16;
    }
    // then u (KPAD) and a_t (WKV_FSTAGES x WKV_TILE)
    static __host__ __device__ __forceinline__ int bytes(int vs) {
        return WKV_FSTAGES * stage(vs) + KPAD * 4 + WKV_FSTAGES * WKV_TILE * 4;
    }
};

// registers capped for two CTAs an SM (decode's many small CTAs), but
// for fp32 at 8 and 16 k-groups, which would spill under that cap
template <typename T, int KG> struct FwdBlocks {
    static constexpr int v = sizeof(T) == 2 || KG < 8 ? 2 : 1;
};

template <typename T, int KG>
__global__ void __launch_bounds__(WKV_FWD_THREADS + 32, FwdBlocks<T, KG>::v)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s1,
                float* __restrict__ ckpt, int S, int H, int KP, int V,
                int VS, int chunk) {
    using L = FwdSmem<T, KG>;
    constexpr int KPAD = L::KPAD;             // rows, padded with zeros
    constexpr int NPT = WKV_TILE / KG;        // y's a thread writes a tile
    constexpr int D = WKV_FSTAGES - 2;        // tiles in flight ahead
    extern __shared__ __align__(16) unsigned char wkv_smem[];
    const int stage = L::stage(VS);
    float* us = reinterpret_cast<float*>(wkv_smem + WKV_FSTAGES * stage);
    float* as = us + KPAD;                    // [WKV_FSTAGES][WKV_TILE]
    const int tid = threadIdx.x;
    const int nthr = KG * VS, nall = nthr + 32;   // compute threads; + copier
    const int nvs = (V + VS - 1) / VS;
    const int bh = blockIdx.x / nvs, b = bh / H, h = bh - b * H;
    const int j0 = (blockIdx.x - bh * nvs) * VS, nv = min(VS, V - j0);
    const int n_tiles = (S + WKV_TILE - 1) / WKV_TILE;
    auto rs = [&](int st_) {
        return reinterpret_cast<T*>(wkv_smem + st_ * stage + L::kR);
    };
    auto ks = [&](int st_) {
        return reinterpret_cast<T*>(wkv_smem + st_ * stage + L::kK);
    };
    auto ws = [&](int st_) {
        return reinterpret_cast<float*>(wkv_smem + st_ * stage + L::kW);
    };
    auto vs = [&](int st_) {
        return reinterpret_cast<T*>(wkv_smem + st_ * stage + L::kV);
    };

    // what the copies never write stays zero: rows KP.., columns nv..
    if (KP < KPAD) {
        for (int i = tid; i < WKV_FSTAGES * WKV_TILE * KPAD; i += nall) {
            const int st_ = i / (WKV_TILE * KPAD), e = i % (WKV_TILE * KPAD);
            if (e % KPAD >= KP) {
                rs(st_)[e] = zero_of<T>();
                ks(st_)[e] = zero_of<T>();
                ws(st_)[e] = 0.f;
            }
        }
    }
    if (nv < VS) {
        for (int i = tid; i < WKV_FSTAGES * WKV_TILE * VS; i += nall) {
            const int st_ = i / (WKV_TILE * VS), e = i % (WKV_TILE * VS);
            if (e % VS >= nv) vs(st_)[e] = zero_of<T>();
        }
    }

    if (tid >= nthr) {
        // ---- the copier warp: every tile's async copies, D tiles ahead,
        // so that the compute warps never stall on issuing them ----
        const int lane = tid - nthr;
        const size_t o0 = (size_t)b * S * H + h;   // step 0's row of the head
        const int rb = KP * sizeof(T), vb = nv * sizeof(T);     // row bytes
        const RowCopy cpr = plan_rows(r + o0 * KP, H * rb, KPAD * sizeof(T),
                                      rb, lane, 32);
        const RowCopy cpk = plan_rows(k + o0 * KP, H * rb, KPAD * sizeof(T),
                                      rb, lane, 32);
        const RowCopy cpw = plan_rows(w + o0 * KP, H * KP * 4, KPAD * 4,
                                      KP * 4, lane, 32);
        const RowCopy cpv = plan_rows(v + o0 * V + j0, H * V * (int)sizeof(T),
                                      VS * sizeof(T), vb, lane, 32);
        auto load = [&](int tile) {            // into stage tile % NS
            if (tile < n_tiles) {
                const int t0 = tile * WKV_TILE, n = min(WKV_TILE, S - t0);
                unsigned char* sb = wkv_smem + tile % WKV_FSTAGES * stage;
                issue_rows(cpr, sb + L::kR, KPAD * sizeof(T), rb, t0, n, lane,
                           32);
                issue_rows(cpk, sb + L::kK, KPAD * sizeof(T), rb, t0, n, lane,
                           32);
                issue_rows(cpw, sb + L::kW, KPAD * 4, KP * 4, t0, n, lane,
                           32);
                issue_rows(cpv, sb + L::kV, VS * sizeof(T), vb, t0, n, lane,
                           32);
            }
            cp_async_commit();                 // a group a tile, empty or not
        };
#pragma unroll 1
        for (int i = 0; i < D; ++i) load(i);
        for (int it = 0; it <= n_tiles; ++it) {
            cp_async_wait<D - 1>();            // tile it has landed
            bar_sync(WKV_BAR_TILE, nall);      // ... for everyone
            load(it + D);                      // into tile it-2's stage
        }
        return;
    }

    // ---- the compute warps ----
    const int g = tid % KG, jl = tid / KG, j = j0 + jl;
    const int row0 = g * WKV_ROWS;
    const bool jok = jl < nv;
    const int n_ck = chunk > 0 ? (S + chunk - 1) / chunk : 0;
    float st[WKV_ROWS];
#pragma unroll
    for (int i = 0; i < WKV_ROWS; ++i) {
        const int q = row0 + i;
        st[i] = (jok && q < KP) ? s0[((size_t)bh * KP + q) * V + j] : 0.f;
    }
    for (int q = tid; q < KPAD; q += nthr)
        us[q] = q < KP ? u[h * KP + q] : 0.f;

    float p[WKV_TILE];
    for (int it = 0; it <= n_tiles; ++it) {
        const int cur = it % WKV_FSTAGES;
        const int last = (it + WKV_FSTAGES - 1) % WKV_FSTAGES;
        bar_sync(WKV_BAR_TILE, nall);  // tile it has landed; tile it-2 is done
        if (it < n_tiles)
            tile_a<T, KG>(as + cur * WKV_TILE, rs(cur), ks(cur), us,
                          min(WKV_TILE, S - it * WKV_TILE), tid, nthr);
        if (it > 0) {             // tile it-1's y (its a_t are visible now)
            const int t0 = (it - 1) * WKV_TILE, n = min(WKV_TILE, S - t0);
            ReduceScatter<KG / 2, WKV_TILE / 2>::run(p, g);
            const T* vl = vs(last) + jl;
#pragma unroll
            for (int i = 0; i < NPT; ++i) {
                const int tt = g * NPT + i;
                if (jok && tt < n)
                    y[(((size_t)b * S + t0 + tt) * H + h) * V + j] =
                        __fmaf_rn(to_f(vl[tt * VS]), as[last * WKV_TILE + tt],
                                  p[i]);
            }
        }
        if (it == n_tiles) break;
        const int t0 = it * WKV_TILE, n = min(WKV_TILE, S - t0);
        if (chunk > 0 && t0 % chunk == 0 && jok) {
            float* c = ckpt + ((size_t)bh * n_ck + t0 / chunk) * KP * V + j;
#pragma unroll
            for (int i = 0; i < WKV_ROWS; ++i)
                if (row0 + i < KP) c[(size_t)(row0 + i) * V] = st[i];
        }
        const T* rt = rs(cur) + row0;
        const T* kt = ks(cur) + row0;
        const float* wt = ws(cur) + row0;
        const T* vt = vs(cur) + jl;
        if (n == WKV_TILE) {
#pragma unroll
            for (int tt = 0; tt < WKV_TILE; ++tt)
                p[tt] = fwd_step(st, rt + tt * KPAD, kt + tt * KPAD,
                                 wt + tt * KPAD, to_f(vt[tt * VS]));
        } else {
#pragma unroll
            for (int tt = 0; tt < WKV_TILE; ++tt)
                p[tt] = tt < n ? fwd_step(st, rt + tt * KPAD, kt + tt * KPAD,
                                          wt + tt * KPAD, to_f(vt[tt * VS]))
                               : 0.f;
        }
    }
    if (jok) {
#pragma unroll
        for (int i = 0; i < WKV_ROWS; ++i)
            if (row0 + i < KP)
                s1[((size_t)bh * KP + row0 + i) * V + j] = st[i];
    }
}

// ==== backward ====

// dynamic shared memory of a backward CTA, byte offsets
template <typename T>
struct BwdSmem {
    // the chunk's states: [WKV_CHUNK][2 rows][WKV_BTHREADS][4 columns]
    static constexpr int kSst = 0;
    static constexpr int kSstBytes = WKV_CHUNK * 2 * WKV_BTHREADS * 4 * 4;
    // a ring slot, WKV_BT steps: r, k (T) and w rows of WKV_MAXK; the
    // CTA's WKV_BVS columns of gy and v (T)
    static constexpr int kR = 0;
    static constexpr int kK = kR + WKV_BT * WKV_MAXK * (int)sizeof(T);
    static constexpr int kW = kK + WKV_BT * WKV_MAXK * (int)sizeof(T);
    static constexpr int kG = kW + WKV_BT * WKV_MAXK * 4;
    static constexpr int kV = kG + WKV_BT * WKV_BVS * 4;
    static constexpr int kSlot =
        (kV + WKV_BT * WKV_BVS * (int)sizeof(T) + 15) / 16 * 16;
    static constexpr int kCk = kSst + kSstBytes;     // [2][MAXK][BVS]
    static constexpr int kPj = kCk + 2 * WKV_MAXK * WKV_BVS * 4;
    static constexpr int kPjBuf = WKV_BT * 3 * 4 * WKV_PJ;       // floats
    static constexpr int kPv = kPj + 2 * kPjBuf * 4;
    static constexpr int kPvBuf = WKV_BT * 32 * WKV_BVS;         // floats
    static constexpr int kQ = kPv + 2 * kPvBuf * 4;  // [CHUNK][3][MAXK]
    static constexpr int kQg = kQ + WKV_CHUNK * 3 * WKV_MAXK * 4;  // [CHUNK]
    static constexpr int kA = kQg + WKV_CHUNK * 4;   // [2][BT]
    static constexpr int kU = kA + 2 * WKV_BT * 4;   // [MAXK]
    static constexpr int kDu = kU + WKV_MAXK * 4;    // [BTHREADS]
    static constexpr int kRing = kDu + WKV_BTHREADS * 4;
    // as many ring slots as the rest of the SM's shared memory holds
    static constexpr int kSlots = (WKV_SMEM_MAX - kRing) / kSlot < 10
        ? (WKV_SMEM_MAX - kRing) / kSlot : 10;
    static constexpr int kBytes = kRing + kSlots * kSlot;
    static_assert(kSlots >= 4, "the backward's ring needs 4 slots");
};

// a tile of the backward's sequence: chunk c (from the last), its states
// recomputed tile by tile (walk 0, i = 0 ..) and then walked back (walk 1,
// i = .. 0)
struct BTile {
    int c, walk, i;
};
__device__ __forceinline__ int chunk_tiles(int c, int S) {
    return (min(WKV_CHUNK, S - c * WKV_CHUNK) + WKV_BT - 1) / WKV_BT;
}
// the tile at position p of the sequence; only the last chunk is ragged
__device__ __forceinline__ BTile tile_at(int p, int n_ck, int nt0) {
    constexpr int TPC = WKV_CHUNK / WKV_BT;
    int c = n_ck - 1, loc = p, nt = nt0;
    if (p >= 2 * nt0) {
        const int q = p - 2 * nt0;
        c = n_ck - 2 - q / (2 * TPC);
        loc = q % (2 * TPC);
        nt = TPC;
    }
    const int walk = loc >= nt;
    return {c, walk, walk ? 2 * nt - 1 - loc : loc};
}

template <typename T>
__global__ void __launch_bounds__(WKV_BTHREADS + WKV_BCOPY)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const float* __restrict__ gy, const float* __restrict__ gs,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ds0, int S,
                int H, int KP, int V) {
    using L = BwdSmem<T>;
    extern __shared__ __align__(16) unsigned char wkv_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int nvs = (V + WKV_BVS - 1) / WKV_BVS;
    const int rank = blockIdx.x % nvs;             // == the cluster rank
    const int bh = blockIdx.x / nvs, b = bh / H, h = bh - b * H;
    const int j0 = rank * WKV_BVS, nv = min(WKV_BVS, V - j0);
    const int tid = threadIdx.x, rg = tid >> 2, cq = tid & 3;
    // threads WKV_BTHREADS.. are the copier warps: every tile's async
    // copies, D tiles ahead, so that the compute warps never stall on
    // issuing them
    const bool cw = tid >= WKV_BTHREADS;
    const int nall = WKV_BTHREADS + WKV_BCOPY, lane = tid - WKV_BTHREADS;
    const int q0 = 2 * rg, c0 = 4 * cq;            // rows q0, q0+1
    float* Sst = reinterpret_cast<float*>(wkv_smem + L::kSst);
    float* ck = reinterpret_cast<float*>(wkv_smem + L::kCk);
    float* Pj = reinterpret_cast<float*>(wkv_smem + L::kPj);
    float* Pv = reinterpret_cast<float*>(wkv_smem + L::kPv);
    float* Q = reinterpret_cast<float*>(wkv_smem + L::kQ);
    float* Qg = reinterpret_cast<float*>(wkv_smem + L::kQg);
    float* A = reinterpret_cast<float*>(wkv_smem + L::kA);
    float* us = reinterpret_cast<float*>(wkv_smem + L::kU);
    float* dus = reinterpret_cast<float*>(wkv_smem + L::kDu);
    const int n_ck = (S + WKV_CHUNK - 1) / WKV_CHUNK;
    // the rows whose dr / dk / dw / du this rank writes: rows_per (a power
    // of 2, so it divides the CTA) from rank * rows_per; thread tid sums
    // row rank * rows_per + tid % rows_per at steps = tid / rows_per mod
    // n_sg
    int rows_per = 1;
    while (rows_per * nvs < KP) rows_per <<= 1;
    const int n_sg = WKV_BTHREADS / rows_per, xsg = tid / rows_per;
    const int xrow = rank * rows_per + tid % rows_per;
    const bool xown = !cw && xrow < KP;

    // what the copies never write stays zero: rows KP.. of r / k / w and
    // of the checkpoint block, columns nv.. of gy / v and the block
    for (int i = tid; i < L::kSlots * WKV_BT * WKV_MAXK; i += nall) {
        const int slot = i / (WKV_BT * WKV_MAXK), e = i % (WKV_BT * WKV_MAXK);
        unsigned char* sl = wkv_smem + L::kRing + slot * L::kSlot;
        if (e % WKV_MAXK >= KP) {
            reinterpret_cast<T*>(sl + L::kR)[e] = zero_of<T>();
            reinterpret_cast<T*>(sl + L::kK)[e] = zero_of<T>();
            reinterpret_cast<float*>(sl + L::kW)[e] = 0.f;
        }
    }
    for (int i = tid; i < L::kSlots * WKV_BT * WKV_BVS; i += nall) {
        const int slot = i / (WKV_BT * WKV_BVS), e = i % (WKV_BT * WKV_BVS);
        unsigned char* sl = wkv_smem + L::kRing + slot * L::kSlot;
        if (e % WKV_BVS >= nv) {
            reinterpret_cast<float*>(sl + L::kG)[e] = 0.f;
            reinterpret_cast<T*>(sl + L::kV)[e] = zero_of<T>();
        }
    }
    for (int i = tid; i < 2 * WKV_MAXK * WKV_BVS; i += nall)
        if ((i / WKV_BVS) % WKV_MAXK >= KP || i % WKV_BVS >= nv) ck[i] = 0.f;
    for (int q = tid; q < WKV_MAXK; q += nall)
        us[q] = q < KP ? u[h * KP + q] : 0.f;
    float ds[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            ds[i][c] = (q0 + i < KP && c0 + c < nv)
                ? gs[((size_t)bh * KP + q0 + i) * V + j0 + c0 + c] : 0.f;
    float du_acc = 0.f;

    const size_t o0 = (size_t)b * S * H + h;   // step 0's row of the head
    const int rb = KP * sizeof(T), vb = nv * sizeof(T);     // row bytes
    const RowCopy cpr = plan_rows(r + o0 * KP, H * rb, WKV_MAXK * sizeof(T),
                                  rb, lane, WKV_BCOPY);
    const RowCopy cpk = plan_rows(k + o0 * KP, H * rb, WKV_MAXK * sizeof(T),
                                  rb, lane, WKV_BCOPY);
    const RowCopy cpw = plan_rows(w + o0 * KP, H * KP * 4, WKV_MAXK * 4,
                                  KP * 4, lane, WKV_BCOPY);
    const RowCopy cpg = plan_rows(gy + o0 * V + j0, H * V * 4, WKV_BVS * 4,
                                  nv * 4, lane, WKV_BCOPY);
    const RowCopy cpv = plan_rows(v + o0 * V + j0, H * V * (int)sizeof(T),
                                  WKV_BVS * sizeof(T), vb, lane, WKV_BCOPY);
    const int nt0 = chunk_tiles(n_ck - 1, S);
    const int n_pos = 2 * nt0 + 2 * (WKV_CHUNK / WKV_BT) * (n_ck - 1);
    constexpr int D = L::kSlots - 2;           // tiles in flight ahead
    auto load = [&](int pos) {                 // into slot pos % kSlots
        if (!cw) return;
        if (pos >= n_pos) {
            cp_async_commit();                 // a group a tile, empty or not
            return;
        }
        const BTile x = tile_at(pos, n_ck, nt0);
        unsigned char* sl = wkv_smem + L::kRing + pos % L::kSlots * L::kSlot;
        const int t0 = x.c * WKV_CHUNK + x.i * WKV_BT;
        const int n = min(WKV_BT, S - t0);
        constexpr int tb = WKV_MAXK * sizeof(T), nb = WKV_BVS * sizeof(T);
        if (x.walk)
            issue_rows(cpr, sl + L::kR, tb, rb, t0, n, lane, WKV_BCOPY);
        issue_rows(cpk, sl + L::kK, tb, rb, t0, n, lane, WKV_BCOPY);
        issue_rows(cpw, sl + L::kW, WKV_MAXK * 4, KP * 4, t0, n, lane,
                   WKV_BCOPY);
        if (x.walk)
            issue_rows(cpg, sl + L::kG, WKV_BVS * 4, nv * 4, t0, n, lane,
                       WKV_BCOPY);
        issue_rows(cpv, sl + L::kV, nb, vb, t0, n, lane, WKV_BCOPY);
        if (!x.walk && x.i == 0)
            copy_rows(ck + (x.c & 1) * WKV_MAXK * WKV_BVS, WKV_BVS * 4,
                      ckpt + ((size_t)bh * n_ck + x.c) * KP * V + j0,
                      (size_t)V * 4, KP, nv * 4, lane, WKV_BCOPY);
        cp_async_commit();
    };

    // tile x's (walked in slot `slot`, partials in buffer pb) sums over
    // this CTA: dv whole, dr / dk / dw over its columns into Q
    auto local_reduce = [&](const BTile& x, int slot, int pb) {
        const int t0 = x.c * WKV_CHUNK + x.i * WKV_BT;
        const int n = min(WKV_BT, S - t0), tc0 = x.i * WKV_BT;
        const float* pj = Pj + pb * L::kPjBuf;
#pragma unroll
        for (int it = 0; it < WKV_BT * 3 * WKV_MAXK / WKV_BTHREADS; ++it) {
            const int o = tid + it * WKV_BTHREADS;
            const int tt = o / (3 * WKV_MAXK), q3 = (o / WKV_MAXK) % 3;
            const int kk = o % WKV_MAXK;
            if (tt < n) {
                const float* p = pj + (tt * 3 + q3) * 4 * WKV_PJ + kk;
                Q[((tc0 + tt) * 3 + q3) * WKV_MAXK + kk] =
                    ((p[0] + p[WKV_PJ]) + p[2 * WKV_PJ]) + p[3 * WKV_PJ];
            }
        }
        // dv: 4 steps x 16 columns x (even, odd row pairs)
        const int tt = tid >> 5, jl = (tid >> 1) & 15, par = tid & 1;
        const float* p = Pv + pb * L::kPvBuf + (tt * 32 + par) * WKV_BVS + jl;
        float s = p[0];
#pragma unroll
        for (int i = 1; i < 16; ++i) s += p[2 * i * WKV_BVS];
        s += __shfl_xor_sync(WKV_FULL, s, 1);
        if (par == 0 && tt < n && jl < nv) {
            const float* gsl = reinterpret_cast<const float*>(
                wkv_smem + L::kRing + slot * L::kSlot + L::kG);
            dv[(((size_t)b * S + t0 + tt) * H + h) * V + j0 + jl] =
                __fmaf_rn(gsl[tt * WKV_BVS + jl], A[pb * WKV_BT + tt], s);
        }
    };

    // chunk c's slices summed in rank order: dr / dk / dw of this thread's
    // row at its steps (from the last), and du's terms
    auto exchange = [&](int c) {
        const int t0 = c * WKV_CHUNK, n = min(WKV_CHUNK, S - t0);
        if (!xown || xsg >= n) return;
#pragma unroll 4
        for (int tt = xsg + (n - 1 - xsg) / n_sg * n_sg; tt >= 0; tt -= n_sg) {
            float gv = 0.f, s3[3] = {0.f, 0.f, 0.f};
            for (int rk = 0; rk < nvs; ++rk) {
                const float* qr = cluster.map_shared_rank(Q, rk);
                const float* qg = cluster.map_shared_rank(Qg, rk);
                gv = rk ? gv + qg[tt] : qg[tt];
#pragma unroll
                for (int q3 = 0; q3 < 3; ++q3) {
                    const float x = qr[(tt * 3 + q3) * WKV_MAXK + xrow];
                    s3[q3] = rk ? s3[q3] + x : x;
                }
            }
            const size_t o = (((size_t)b * S + t0 + tt) * H + h) * KP + xrow;
            const float rr = to_f(r[o]), kk = to_f(k[o]), uu = us[xrow];
            dr[o] = __fmaf_rn(__fmul_rn(uu, kk), gv, s3[0]);
            dk[o] = __fmaf_rn(__fmul_rn(uu, rr), gv, s3[1]);
            dw[o] = s3[2];
            du_acc = __fmaf_rn(__fmul_rn(rr, kk), gv, du_acc);
        }
    };

    BTile prev = {0, 0, 0};
    int prev_slot = 0, pb = 0, prev_pb = 0;
    bool pend = false, wait_reads = false;
    int exch = -1;                    // a chunk whose slices await summing
    float sv[2][4];                   // the recomputed state
#pragma unroll 1
    for (int i = 0; i < D; ++i) load(i);
    for (int pos = 0; pos < n_pos; ++pos) {
        cp_async_wait<D - 1>();       // this tile has landed (the copier's)
        __syncthreads();              // ... for everyone; tile pos-2 is done
        load(pos + D);                // into tile pos-2's slot
        if (pend) {                   // the last walked tile's sums
            if (!cw) local_reduce(prev, prev_slot, prev_pb);
            pend = false;
            if (prev.i == 0) {        // its chunk's slice sums are complete
                cluster_arrive();
                exch = prev.c;
            }
        }
        const BTile cur = tile_at(pos, n_ck, nt0);
        const int slot = pos % L::kSlots;
        const unsigned char* sl = wkv_smem + L::kRing + slot * L::kSlot;
        const T* rsl = reinterpret_cast<const T*>(sl + L::kR);
        const T* ksl = reinterpret_cast<const T*>(sl + L::kK);
        const float* wsl = reinterpret_cast<const float*>(sl + L::kW);
        const float* gsl = reinterpret_cast<const float*>(sl + L::kG);
        const T* vsl = reinterpret_cast<const T*>(sl + L::kV);
        const int t0 = cur.c * WKV_CHUNK + cur.i * WKV_BT;
        const int n = min(WKV_BT, S - t0), tc0 = cur.i * WKV_BT;
        if (!cur.walk) {
            if (cur.i == 0 && !cw) {
                const float* c_ = ck + (cur.c & 1) * WKV_MAXK * WKV_BVS;
                ld4(c_ + q0 * WKV_BVS + c0, sv[0]);
                ld4(c_ + (q0 + 1) * WKV_BVS + c0, sv[1]);
            }
#pragma unroll
            for (int tt = 0; tt < WKV_BT; ++tt) {  // S_{t-1} of the chunk
                if (tt >= n || cw) break;
                float* dst = Sst + (size_t)(tc0 + tt) * 2 * WKV_BTHREADS * 4;
                st4(dst + tid * 4, sv[0]);
                st4(dst + (WKV_BTHREADS + tid) * 4, sv[1]);
                float kk[2], ww[2], vv[4];
                ld2(ksl + tt * WKV_MAXK + q0, kk);
                ld2(wsl + tt * WKV_MAXK + q0, ww);
                ld4(vsl + tt * WKV_BVS + c0, vv);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        sv[i][c] = __fmaf_rn(ww[i], sv[i][c],
                                             __fmul_rn(kk[i], vv[c]));
            }
            if (exch >= 0 && cur.i == chunk_tiles(cur.c, S) - 1) {
                cluster_wait();       // every rank's slices of chunk exch
                exchange(exch);
                cluster_arrive();     // done reading them
                wait_reads = true;
                exch = -1;
            }
        } else {
            if (wait_reads) {         // before this chunk's Qg / Q writes
                cluster_wait();
                wait_reads = false;
            }
            float* Ab = A + pb * WKV_BT;
            if (cw) {
            } else if (tid < 64) {    // a_t: 16 runs of 4 rows, 4 steps
                const int tt = tid >> 4, c = tid & 15;
                float x = 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int q = 4 * c + i;
                    x = __fmaf_rn(
                        __fmul_rn(to_f(rsl[tt * WKV_MAXK + q]), us[q]),
                        to_f(ksl[tt * WKV_MAXK + q]), x);
                }
#pragma unroll
                for (int m = 1; m < 16; m <<= 1)
                    x = __fadd_rn(x, __shfl_xor_sync(WKV_FULL, x, m));
                if (c == 0 && tt < n) Ab[tt] = x;
            } else {                  // this slice's gy . v, 4 steps
                const int tt = (tid - 64) >> 4, c = tid & 15;
                float x = __fmul_rn(gsl[tt * WKV_BVS + c],
                                    to_f(vsl[tt * WKV_BVS + c]));
#pragma unroll
                for (int m = 1; m < 16; m <<= 1)
                    x = __fadd_rn(x, __shfl_xor_sync(WKV_FULL, x, m));
                if (c == 0 && tt < n) Qg[tc0 + tt] = x;
            }
            float* pjb = Pj + pb * L::kPjBuf;
            float* pvb = Pv + pb * L::kPvBuf;
#pragma unroll
            for (int tt = WKV_BT - 1; tt >= 0; --tt) {
                if (tt >= n || cw) continue;
                const float* src =
                    Sst + (size_t)(tc0 + tt) * 2 * WKV_BTHREADS * 4;
                float s[2][4], rr[2], kk[2], ww[2], gg[4], vv[4];
                ld4(src + tid * 4, s[0]);
                ld4(src + (WKV_BTHREADS + tid) * 4, s[1]);
                ld2(rsl + tt * WKV_MAXK + q0, rr);
                ld2(ksl + tt * WKV_MAXK + q0, kk);
                ld2(wsl + tt * WKV_MAXK + q0, ww);
                ld4(gsl + tt * WKV_BVS + c0, gg);
                ld4(vsl + tt * WKV_BVS + c0, vv);
                float pr[2], pk[2], pw[2], pv[4];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    pr[i] = __fmul_rn(gg[0], s[i][0]);
                    pk[i] = __fmul_rn(ds[i][0], vv[0]);
                    pw[i] = __fmul_rn(ds[i][0], s[i][0]);
#pragma unroll
                    for (int c = 1; c < 4; ++c) {
                        pr[i] = __fmaf_rn(gg[c], s[i][c], pr[i]);
                        pk[i] = __fmaf_rn(ds[i][c], vv[c], pk[i]);
                        pw[i] = __fmaf_rn(ds[i][c], s[i][c], pw[i]);
                    }
                }
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    pv[c] = __fmaf_rn(ds[1][c], kk[1],
                                      __fmul_rn(ds[0][c], kk[0]));
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        ds[i][c] = __fmaf_rn(ww[i], ds[i][c],
                                             __fmul_rn(rr[i], gg[c]));
                float* pj = pjb + (tt * 3 * 4 + cq) * WKV_PJ + q0;
                *reinterpret_cast<float2*>(pj) = make_float2(pr[0], pr[1]);
                *reinterpret_cast<float2*>(pj + 4 * WKV_PJ) =
                    make_float2(pk[0], pk[1]);
                *reinterpret_cast<float2*>(pj + 8 * WKV_PJ) =
                    make_float2(pw[0], pw[1]);
                st4(pvb + (tt * 32 + rg) * WKV_BVS + c0, pv);
            }
            pend = true;
            prev = cur;
            prev_slot = slot;
            prev_pb = pb;
            pb ^= 1;
        }
    }
    __syncthreads();
    if (!cw) local_reduce(prev, prev_slot, prev_pb);  // chunk 0's first tile
    cluster_arrive();
    cluster_wait();
    exchange(0);
    if (!cw) dus[tid] = du_acc;
    __syncthreads();
    if (tid < rows_per && xown) {
        float s = dus[tid];
        for (int sg = 1; sg < n_sg; ++sg) s += dus[sg * rows_per + tid];
        du_part[(size_t)bh * KP + xrow] = s;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            if (q0 + i < KP && c0 + c < nv)
                ds0[((size_t)bh * KP + q0 + i) * V + j0 + c0 + c] = ds[i][c];
    cluster_arrive();                 // no CTA leaves while another may
    cluster_wait();                   // still read its slice sums
}

// du[h, k] = sum over b of du_part[b, h, k], b in order.
__global__ void wkv6_du_kernel(const float* __restrict__ du_part,
                               float* __restrict__ du, int B, int HK) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= HK) return;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += du_part[(size_t)b * HK + i];
    du[i] = acc;
}

// Above 48 KB of dynamic shared memory a kernel needs the opt-in, which
// holds on the current device only: set once a device (`done`, by
// device, is the kernel instance's own record).
static int smem_opt_in(const void* kern, int bytes, bool (&done)[64]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!done[dev]) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
        done[dev] = true;
    }
    return 0;
}

// the opt-in at an instance's widest: vs = WKV_FWD_THREADS / KG columns
template <typename T, int KG>
static int launch_fwd_kg(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* s1, void* ckpt, int B, int S, int H,
                         int KP, int V, int chunk, int vs, cudaStream_t st) {
    using L = FwdSmem<T, KG>;
    constexpr int kMaxVs = WKV_FWD_THREADS / KG < WKV_MAXV
        ? WKV_FWD_THREADS / KG : WKV_MAXV;
    static bool opted[64] = {};
    const int attr = smem_opt_in((const void*)wkv6_fwd_kernel<T, KG>,
                                 L::bytes(kMaxVs), opted);
    if (attr != 0) return attr;
    wkv6_fwd_kernel<T, KG><<<B * H * ((V + vs - 1) / vs), KG * vs + 32,
                             L::bytes(vs), st>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w,
        (const float*)u, (const float*)s0, (float*)y, (float*)s1,
        (float*)ckpt, S, H, KP, V, vs, chunk);
    return (int)cudaGetLastError();
}

#define WKV_FWD_LAUNCH(KG_)                                                  \
    return launch_fwd_kg<T, KG_>(r, k, v, w, u, s0, y, s1, ckpt, B, S, H,   \
                                 KP, V, chunk, vs, st)

template <typename T>
static int launch_fwd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0, void* y,
                      void* s1, void* ckpt, int B, int S, int H, int KP,
                      int V, int chunk, int kg, int vs, cudaStream_t st) {
    switch (kg) {
        case 1: WKV_FWD_LAUNCH(1);
        case 2: WKV_FWD_LAUNCH(2);
        case 4: WKV_FWD_LAUNCH(4);
        case 8: WKV_FWD_LAUNCH(8);
        case 16: WKV_FWD_LAUNCH(16);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int launch_bwd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* ckpt,
                      const void* gy, const void* gs, void* dr, void* dk,
                      void* dv, void* dw, void* du_part, void* ds0, int B,
                      int S, int H, int KP, int V, cudaStream_t st) {
    using L = BwdSmem<T>;
    static bool opted[64] = {};
    const int attr = smem_opt_in((const void*)wkv6_bwd_kernel<T>, L::kBytes,
                                 opted);
    if (attr != 0) return attr;
    const int nvs = (V + WKV_BVS - 1) / WKV_BVS;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * H * nvs);
    cfg.blockDim = dim3(WKV_BTHREADS + WKV_BCOPY);
    cfg.dynamicSmemBytes = L::kBytes;
    cfg.stream = st;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = nvs;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(
        &cfg, wkv6_bwd_kernel<T>, (const T*)r, (const T*)k, (const T*)v,
        (const float*)w, (const float*)u, (const float*)ckpt,
        (const float*)gy, (const float*)gs, (float*)dr, (float*)dk,
        (float*)dv, (float*)dw, (float*)du_part, (float*)ds0, S, H, KP, V);
}

extern "C" {

// r, k, v: (B, S, H, K') / (B, S, H, V), float32 or (bf16 != 0) bfloat16;
// w (B, S, H, K'), u (H, K'), s0 (B, H, K', V) float32 -> y (B, S, H, V),
// s1 (B, H, K', V) and, with chunk > 0 (a multiple of WKV_TILE; WKV_CHUNK
// for a backward), ckpt (B, H, ceil(S/chunk), K', V), float32.  kg k-groups
// of 4 rows (1, 2, 4, 8 or 16, 4 kg >= K') and vs columns a CTA, kg * vs
// a multiple of 32 up to 256: kernels/wkv._plan.  Returns a cudaError_t.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s1, void* ckpt,
             int bf16, int B, int S, int H, int KP, int V, int chunk, int kg,
             int vs, void* stream) {
    if (B < 1 || S < 1 || H < 1 || KP < 1 || KP > WKV_MAXK || V < 1
        || V > WKV_MAXV || chunk < 0 || chunk % WKV_TILE != 0
        || KP > WKV_ROWS * kg || vs < 2 || vs > WKV_MAXV
        || (kg * vs) % 32 != 0 || kg * vs > WKV_FWD_THREADS
        || (long long)B * H * ((V + vs - 1) / vs) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        return launch_fwd<__nv_bfloat16>(r, k, v, w, u, s0, y, s1, ckpt, B, S,
                                         H, KP, V, chunk, kg, vs, st);
    return launch_fwd<float>(r, k, v, w, u, s0, y, s1, ckpt, B, S, H, KP, V,
                             chunk, kg, vs, st);
}

// The gradient of wkv6_fwd from its checkpoints (taken with chunk ==
// WKV_CHUNK), gy (B, S, H, V) and gs (B, H, K', V) float32 -> dr, dk, dw
// (B, S, H, K'), dv (B, S, H, V), du (H, K'), ds0 (B, H, K', V), float32;
// du_part (B, H, K') is scratch.
int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* ckpt, const void* gy, const void* gs,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* du_part, int bf16, int B, int S, int H, int KP, int V,
             int chunk, void* stream) {
    if (B < 1 || S < 1 || H < 1 || KP < 1 || KP > WKV_MAXK || V < 1
        || V > WKV_MAXV || chunk != WKV_CHUNK
        || (long long)B * H * ((V + WKV_BVS - 1) / WKV_BVS) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int e = bf16
        ? launch_bwd<__nv_bfloat16>(r, k, v, w, u, ckpt, gy, gs, dr, dk, dv,
                                    dw, du_part, ds0, B, S, H, KP, V, st)
        : launch_bwd<float>(r, k, v, w, u, ckpt, gy, gs, dr, dk, dv, dw,
                            du_part, ds0, B, S, H, KP, V, st);
    if (e != 0) return e;
    const int hk = H * KP;
    wkv6_du_kernel<<<(hk + 127) / 128, 128, 0, st>>>((const float*)du_part,
                                                     (float*)du, B, hk);
    return (int)cudaGetLastError();
}

}  // extern "C"
