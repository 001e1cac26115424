// The WKV recurrence of RWKV6 ("Finch"), forward and backward, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes
// (kernels/build.py); the wrappers live in kernels/wkv.py.
//
// Replaces no Pallas kernel: the reference writes the recurrence as one
// jax.lax.scan (src/repro/models/rwkv.py:103-116, time_mix_apply), which
// XLA compiles into a single loop.  Eager PyTorch ran it as a Python loop
// of five small ops a token; these kernels run the whole sequence of a
// (batch row, head) in one CTA.
//
// Per head, with the state S (K', V), for t = 0 .. S-1:
//   kv      = k_t v_t^T
//   y_t[j]  = sum_k r_t[k] (S[k,j] + u[k] kv[k,j])
//   S[k,j]  = w_t[k] S[k,j] + kv[k,j]
// in float32 whatever the inputs (bf16 r / k / v are widened exactly).
// Rounding: kv and u*kv are rounded products, S + u*kv a rounded sum, y
// accumulates over k = 0 .. K'-1 in order with fmaf; the state update is
// one fmaf (fmaf(w, S, kv): one rounding where the plain loop's
// w*S + kv rounds twice).  Every step runs the same instruction sequence
// whatever S is and wherever a tile or a chunk starts, so two calls over
// S/2 that carry the state give one call's bits over S.
//
// Forward (wkv6_fwd_kernel): one CTA per (b, h), V threads; thread j
// keeps column S[:, j] (K' <= 64 floats) in registers, so y_t[j] needs no
// reduction across threads.  One instance a dtype, unrolled to K' 64 with
// every row guarded by `q < KP`, serves any K' (a sharded decode's K
// slice too).  r / k / w and v come in tiles of WKV_TILE
// tokens through cp.async, double-buffered in shared memory (the next
// tile's copy overlaps this tile's steps).  With `chunk` > 0 the state
// before every chunk-th step is written to `ckpt` (B, H, ceil(S/chunk),
// K', V) for the backward.  Bound: a chain of S dependent steps of
// 5 K' instructions a thread, not bytes (B*H = 32-256 CTAs on 132 SMs).
//
// Backward (wkv6_bwd_kernel): one CTA per (b, h), 64 threads; thread k
// keeps row dS[k, :] (V <= 64 floats) in registers, so dr, dk, dw and du
// are sums inside a thread; dv sums over k across threads through shared
// memory, in a fixed order.  Time runs in reverse, a chunk of WKV_CHUNK
// steps at a time: the chunk's states are recomputed from its checkpoint
// (the same fmaf as the forward, so the same bits) into a per-CTA
// workspace, then walked back.  du is summed over t inside the CTA and
// over b by wkv6_du_kernel: no atomics, the same bits on every run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#define WKV_TILE 16          // tokens a forward tile
#define WKV_CHUNK 32         // steps between checkpoints = a backward chunk
#define WKV_MAXK 64          // K' and V the kernels take
#define WKV_MAXV 64
#define WKV_BWD_THREADS 64

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows t0 .. t0+n-1 of one head of x (B, S, H, row) into dst (n, row), as
// 4-byte words (row * sizeof(T) is a multiple of 4: the wrapper widens a
// bf16 operand whose row is odd).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* x, int b, int h,
                                          int t0, int n, int S, int H,
                                          int row) {
    const int wpr = row * (int)sizeof(T) / 4;
    for (int i = threadIdx.x; i < n * wpr; i += blockDim.x) {
        const int tt = i / wpr, wd = i - tt * wpr;
        const T* src = x + (((size_t)b * S + t0 + tt) * H + h) * row;
        cp_async4(reinterpret_cast<char*>(dst + tt * row) + 4 * wd,
                  reinterpret_cast<const char*>(src) + 4 * wd);
    }
}

template <typename T>
__global__ void __launch_bounds__(WKV_MAXV)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s1,
                float* __restrict__ ckpt, int S, int H, int KP, int V,
                int chunk) {
    __shared__ __align__(16) T rs[2][WKV_TILE * WKV_MAXK];
    __shared__ __align__(16) T ks[2][WKV_TILE * WKV_MAXK];
    __shared__ __align__(16) float ws[2][WKV_TILE * WKV_MAXK];
    __shared__ __align__(16) T vs[2][WKV_TILE * WKV_MAXV];
    __shared__ float us[WKV_MAXK];
    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int j = threadIdx.x;
    for (int q = j; q < KP; q += blockDim.x) us[q] = u[h * KP + q];
    float st[WKV_MAXK];
#pragma unroll
    for (int q = 0; q < WKV_MAXK; ++q)
        st[q] = q < KP ? s0[((size_t)bh * KP + q) * V + j] : 0.f;
    const int n_tiles = (S + WKV_TILE - 1) / WKV_TILE;
    const int n_ck = chunk > 0 ? (S + chunk - 1) / chunk : 0;

    auto load = [&](int tile, int buf) {
        const int t0 = tile * WKV_TILE, n = min(WKV_TILE, S - t0);
        copy_rows(rs[buf], r, b, h, t0, n, S, H, KP);
        copy_rows(ks[buf], k, b, h, t0, n, S, H, KP);
        copy_rows(ws[buf], w, b, h, t0, n, S, H, KP);
        copy_rows(vs[buf], v, b, h, t0, n, S, H, V);
        cp_async_commit();
    };
    load(0, 0);
    for (int it = 0; it < n_tiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < n_tiles) {
            load(it + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                // this tile (and us) has landed
        const int t0 = it * WKV_TILE, n = min(WKV_TILE, S - t0);
        for (int tt = 0; tt < n; ++tt) {
            const int t = t0 + tt;
            if (chunk > 0 && t % chunk == 0) {
                float* c = ckpt + ((size_t)bh * n_ck + t / chunk) * KP * V + j;
#pragma unroll
                for (int q = 0; q < WKV_MAXK; ++q)
                    if (q < KP) c[(size_t)q * V] = st[q];
            }
            const T* rt = rs[buf] + tt * KP;
            const T* kt = ks[buf] + tt * KP;
            const float* wt = ws[buf] + tt * KP;
            const float vj = to_f(vs[buf][tt * V + j]);
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < WKV_MAXK; ++q) {
                if (q < KP) {
                    const float kv = __fmul_rn(to_f(kt[q]), vj);
                    acc = __fmaf_rn(to_f(rt[q]),
                                    __fadd_rn(st[q], __fmul_rn(us[q], kv)),
                                    acc);
                    st[q] = __fmaf_rn(wt[q], st[q], kv);
                }
            }
            y[(((size_t)b * S + t) * H + h) * V + j] = acc;
        }
        __syncthreads();                // before the next copy overwrites
    }
#pragma unroll
    for (int q = 0; q < WKV_MAXK; ++q)
        if (q < KP) s1[((size_t)bh * KP + q) * V + j] = st[q];
}

template <typename T>
__global__ void __launch_bounds__(WKV_BWD_THREADS)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const float* __restrict__ gy, const float* __restrict__ gs,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ds0,
                float* __restrict__ work, int S, int H, int KP, int V) {
    __shared__ float vsm[WKV_CHUNK][WKV_MAXV];
    __shared__ float gsm[WKV_CHUNK][WKV_MAXV];
    __shared__ float part[WKV_MAXK][WKV_MAXV + 1];   // +1: no bank conflict
    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int tid = threadIdx.x;
    const bool row = tid < KP;
    const int q = row ? tid : 0;
    float ds[WKV_MAXV], sp[WKV_MAXV];
#pragma unroll
    for (int jj = 0; jj < WKV_MAXV; ++jj)
        ds[jj] = (row && jj < V) ? gs[((size_t)bh * KP + q) * V + jj] : 0.f;
    const float uq = row ? u[h * KP + q] : 0.f;
    float du_acc = 0.f;
    const int n_ck = (S + WKV_CHUNK - 1) / WKV_CHUNK;
    // this CTA's states of one chunk: (WKV_CHUNK, V, K'), k fastest
    float* wk = work + (size_t)bh * WKV_CHUNK * V * KP + q;
    for (int c = n_ck - 1; c >= 0; --c) {
        const int t0 = c * WKV_CHUNK, n = min(WKV_CHUNK, S - t0);
        __syncthreads();                // the last chunk's readers are done
        for (int i = tid; i < n * V; i += blockDim.x) {
            const int tt = i / V, jj = i - tt * V;
            const size_t o = (((size_t)b * S + t0 + tt) * H + h) * V + jj;
            vsm[tt][jj] = to_f(v[o]);
            gsm[tt][jj] = gy[o];
        }
        __syncthreads();
        if (row) {                      // S_{t-1} for t in the chunk
            const float* c0 = ckpt + (((size_t)bh * n_ck + c) * KP + q) * V;
#pragma unroll
            for (int jj = 0; jj < WKV_MAXV; ++jj)
                sp[jj] = jj < V ? c0[jj] : 0.f;
            for (int tt = 0; tt < n; ++tt) {
                const size_t o = (((size_t)b * S + t0 + tt) * H + h) * KP + q;
                const float kq = to_f(k[o]), wq = w[o];
                float* dst = wk + (size_t)tt * V * KP;
#pragma unroll
                for (int jj = 0; jj < WKV_MAXV; ++jj) {
                    if (jj < V) {
                        dst[(size_t)jj * KP] = sp[jj];
                        sp[jj] = __fmaf_rn(wq, sp[jj],
                                           __fmul_rn(kq, vsm[tt][jj]));
                    }
                }
            }
        }
        for (int tt = n - 1; tt >= 0; --tt) {
            const int t = t0 + tt;
            if (row) {
                const size_t o = (((size_t)b * S + t) * H + h) * KP + q;
                const float rq = to_f(r[o]), kq = to_f(k[o]), wq = w[o];
                const float* src = wk + (size_t)tt * V * KP;
                float gv = 0.f, a = 0.f, bsum = 0.f, csum = 0.f;
#pragma unroll
                for (int jj = 0; jj < WKV_MAXV; ++jj) {
                    if (jj < V) {
                        const float s_ = src[(size_t)jj * KP];
                        const float g_ = gsm[tt][jj], v_ = vsm[tt][jj];
                        gv = fmaf(g_, v_, gv);
                        a = fmaf(g_, s_, a);
                        bsum = fmaf(ds[jj], v_, bsum);
                        csum = fmaf(ds[jj], s_, csum);
                    }
                }
                dr[o] = a + uq * kq * gv;
                dk[o] = uq * rq * gv + bsum;
                dw[o] = csum;
                du_acc += rq * kq * gv;
                const float urq = uq * rq;
#pragma unroll
                for (int jj = 0; jj < WKV_MAXV; ++jj) {
                    if (jj < V) {
                        const float g_ = gsm[tt][jj];
                        part[q][jj] = (urq * g_ + ds[jj]) * kq;
                        ds[jj] = rq * g_ + wq * ds[jj];
                    }
                }
            }
            __syncthreads();
            if (tid < V) {
                float acc = 0.f;
                for (int qq = 0; qq < KP; ++qq) acc += part[qq][tid];
                dv[(((size_t)b * S + t) * H + h) * V + tid] = acc;
            }
            __syncthreads();
        }
    }
    if (row) {
#pragma unroll
        for (int jj = 0; jj < WKV_MAXV; ++jj)
            if (jj < V) ds0[((size_t)bh * KP + q) * V + jj] = ds[jj];
        du_part[(size_t)bh * KP + q] = du_acc;
    }
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

template <typename T>
static void launch_fwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* y,
                       void* s1, void* ckpt, int B, int S, int H, int KP,
                       int V, int chunk, cudaStream_t st) {
    wkv6_fwd_kernel<T><<<B * H, V, 0, st>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)w,
        (const float*)u, (const float*)s0, (float*)y, (float*)s1,
        (float*)ckpt, S, H, KP, V, chunk);
}

extern "C" {

// r, k, v: (B, S, H, K') / (B, S, H, V), float32 or (bf16 != 0) bfloat16;
// w (B, S, H, K'), u (H, K'), s0 (B, H, K', V) float32 -> y (B, S, H, V),
// s1 (B, H, K', V) and, with chunk > 0 (WKV_CHUNK for a backward),
// ckpt (B, H, ceil(S/chunk), K', V), float32.  Returns a cudaError_t.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* s1, void* ckpt,
             int bf16, int B, int S, int H, int KP, int V, int chunk,
             void* stream) {
    if (B < 1 || S < 1 || H < 1 || KP < 1 || KP > WKV_MAXK || V < 1
        || V > WKV_MAXV || chunk < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        launch_fwd<__nv_bfloat16>(r, k, v, w, u, s0, y, s1, ckpt, B, S, H,
                                  KP, V, chunk, st);
    else
        launch_fwd<float>(r, k, v, w, u, s0, y, s1, ckpt, B, S, H, KP, V,
                          chunk, st);
    return (int)cudaGetLastError();
}

// The gradient of wkv6_fwd from its checkpoints (taken with chunk ==
// WKV_CHUNK), gy (B, S, H, V) and gs (B, H, K', V) float32 -> dr, dk, dw
// (B, S, H, K'), dv (B, S, H, V), du (H, K'), ds0 (B, H, K', V), float32;
// du_part (B, H, K') and work (B * H, WKV_CHUNK, V, K') are scratch.
int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* ckpt, const void* gy, const void* gs,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* du_part, void* work, int bf16, int B, int S, int H, int KP,
             int V, int chunk, void* stream) {
    if (B < 1 || S < 1 || H < 1 || KP < 1 || KP > WKV_MAXK || V < 1
        || V > WKV_MAXV || chunk != WKV_CHUNK)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        wkv6_bwd_kernel<__nv_bfloat16><<<B * H, WKV_BWD_THREADS, 0, st>>>(
            (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
            (const __nv_bfloat16*)v, (const float*)w, (const float*)u,
            (const float*)ckpt, (const float*)gy, (const float*)gs,
            (float*)dr, (float*)dk, (float*)dv, (float*)dw, (float*)du_part,
            (float*)ds0, (float*)work, S, H, KP, V);
    else
        wkv6_bwd_kernel<float><<<B * H, WKV_BWD_THREADS, 0, st>>>(
            (const float*)r, (const float*)k, (const float*)v,
            (const float*)w, (const float*)u, (const float*)ckpt,
            (const float*)gy, (const float*)gs, (float*)dr, (float*)dk,
            (float*)dv, (float*)dw, (float*)du_part, (float*)ds0,
            (float*)work, S, H, KP, V);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int hk = H * KP;
    wkv6_du_kernel<<<(hk + 127) / 128, 128, 0, st>>>((const float*)du_part,
                                                     (float*)du, B, hk);
    return (int)cudaGetLastError();
}

}  // extern "C"
