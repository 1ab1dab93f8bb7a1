// Fused GRU recurrence for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the Pallas TPU kernels `_gru_fwd_kernel` and `_gru_bwd_kernel`
// of paddle_tpu/ops/pallas_rnn.py.  Both compute, for a pre-projected input
// x3 [B, T, 3D] (column order u, r, c; bias already added), a gate weight
// Wg [D, 2D] and a candidate weight Wc [D, D]:
//
//     [zu, zr] = x_t[:2D] + h Wg      u = gate(zu)      r = gate(zr)
//     c = act(x_t[2D:] + (r h) Wc)    h' = u h + (1 - u) c
//
// with the state of a row frozen at every step t >= lens[b].  `reverse`
// walks t = T-1 .. 0 (the padded tail first, so the valid prefix is visited
// backwards from h0).  All tensors are float32 and keep the [B, T, .]
// layout: the kernels index time themselves, nothing is flipped or
// transposed around them.  Wg and Wc are read through their row strides, so
// the two column slices of one [D, 3D] layer parameter go in as they are.
//
// Design: csrc/lstm.cu's.  The TPU grid is the time axis, run in order with
// h in VMEM scratch.  CUDA blocks run in no order, so the time loop lives
// inside the kernel and the grid is the batch: each CTA owns a tile of BT
// rows for all T steps, h of its rows stays in shared memory, and there is
// no synchronisation across CTAs.  A step is two dependent products: h Wg,
// which gives r, has to finish before (r h) Wc can start, so a step is two
// passes over the weights with a barrier between.  The weights do not fit
// on an SM (D = 512: 3 MiB of float32), so the CTA keeps as many of their
// rows as its shared memory holds (all of them up to D = 128; at D = 512
// about 30 of 512) and streams the other rows from L2, where the weights
// stay resident, every step.  Both go straight into the FMA loop with
// 16-byte loads: a thread owns four adjacent columns over every fourth row,
// neighbouring threads neighbouring columns, h is broadcast from shared
// memory, the loads of the rows still in L2 are started before the resident
// rows are summed, and the four partial sums are added in a fixed order.
// By the card's roofline the work is bound by operations (float32 FMAs; the
// bytes of x3 and hs are the smaller term), but the kernels stay bound by
// what one SM can read from L2 per step (at D = 512 every CTA streams ~3 MiB
// per step) and by the T dependent steps; the faster design (columns split
// over CTAs so that every weight slice is resident, a grid sync per step)
// is later work.  A step at which every row of the tile is frozen skips its
// products.
//
// Backward: a reverse walk over the same steps that recomputes u, r, c from
// the stored h (the forward stores only hs), forms dx3 = [dzu, dzr, dzc],
// writes it, and carries dh = dh_total u + drh r + dzg Wg^T in shared
// memory, drh = dzc Wc^T.  It also writes r h_prev per step, so that the
// weight gradients need no second recompute.  The sums over the batch are
// not taken with atomics: dWg = sum h_prev^T dzg and dWc = sum (r h_prev)^T
// dzc are one separate tiled product over the finished dx3 (split over
// ranges of (b, t) rows), summed in a fixed order by a last small kernel,
// so gradients are deterministic.
//
// Plain C interface (ctypes): each launcher returns the CUDA error code of
// its launches (0 = success) and never synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_BT = 4;          // largest batch tile
constexpr int K_GROUPS = 4;        // weight rows are summed in four groups
constexpr int PREFETCH = 8;        // loads of non-resident rows started early
constexpr int DW_TK = 32;          // dW tile: rows of W (k)
constexpr int DW_TJ = 32;          // dW tile: columns of [Wg | Wc] (j)
constexpr int DW_TN = 32;          // dW tile: (b, t) rows per stage
constexpr int DW_THREADS = 256;

// activation codes: 0 sigmoid, 1 tanh, 2 relu, 3 linear
__device__ __forceinline__ float act_fwd(int code, float x) {
    switch (code) {
        case 0: return 1.f / (1.f + expf(-x));
        case 1: return tanhf(x);
        case 2: return fmaxf(x, 0.f);
        default: return x;
    }
}

// derivative from the activation's output y
__device__ __forceinline__ float act_grad(int code, float y) {
    switch (code) {
        case 0: return y * (1.f - y);
        case 1: return 1.f - y * y;
        case 2: return y > 0.f ? 1.f : 0.f;
        default: return 1.f;
    }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
    acc.x = fmaf(a, w.x, acc.x);
    acc.y = fmaf(a, w.y, acc.y);
    acc.z = fmaf(a, w.z, acc.z);
    acc.w = fmaf(a, w.w, acc.w);
}

__device__ __forceinline__ const float4* row4(const float* w, int ldw, int k) {
    return reinterpret_cast<const float4*>(w + (size_t)k * ldw);
}

// Rows [0, n_rows) of a weight of N columns and row stride ldw into shared
// memory as [n_rows][N] (16-byte copies).
__device__ __forceinline__ void load_resident_rows(
        const float* __restrict__ w, int ldw, float* w_s, int n_rows, int N) {
    const int NQ = N / 4;
    float4* dst = reinterpret_cast<float4*>(w_s);
    for (int i = threadIdx.x; i < n_rows * NQ; i += blockDim.x) {
        const int k = i / NQ, q = i - k * NQ;
        dst[i] = __ldg(row4(w, ldw, k) + q);
    }
}

// part_s[q][r][j], q < K_GROUPS: the partial sums over the rows
// k = q, q + 4, q + 8, ... < K of sum_k a_s[r][k] W[k][j], j < N; the four
// add up to a_s W.  A work item is (group, four adjacent columns): one
// 16-byte load of W per row, neighbouring threads on neighbouring
// addresses.  Rows below n_res are read from w_s ([n_res][N]), the others
// from L2.
template <int BT>
__device__ __forceinline__ void matvec_part(
        const float* __restrict__ w, int ldw, const float* w_s, int n_res,
        const float* a_s, float* part_s, int K, int N) {
    const int NQ = N / 4, KQ = K / K_GROUPS;
    const float4* ws = reinterpret_cast<const float4*>(w_s);
    for (int i = threadIdx.x; i < K_GROUPS * NQ; i += blockDim.x) {
        const int kg = i / NQ, quad = i - kg * NQ;
        // this item's rows are k = kg + K_GROUPS * m, m < KQ; the first
        // m_res of them are resident
        const int m_res = min(KQ, max(0, (n_res - kg + K_GROUPS - 1)
                                          / K_GROUPS));
        float4 acc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 pre[PREFETCH];
#pragma unroll
        for (int p = 0; p < PREFETCH; ++p) {
            const int k = kg + K_GROUPS * (m_res + p);
            pre[p] = m_res + p < KQ ? __ldg(row4(w, ldw, k) + quad)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 4
        for (int m = 0; m < m_res; ++m) {
            const int k = kg + K_GROUPS * m;
            const float4 wv = ws[(size_t)k * NQ + quad];
#pragma unroll
            for (int r = 0; r < BT; ++r) fma4(acc[r], a_s[r * K + k], wv);
        }
#pragma unroll
        for (int p = 0; p < PREFETCH; ++p) {
            const int k = kg + K_GROUPS * (m_res + p);
            if (m_res + p < KQ) {
#pragma unroll
                for (int r = 0; r < BT; ++r)
                    fma4(acc[r], a_s[r * K + k], pre[p]);
            }
        }
#pragma unroll 8
        for (int m = m_res + PREFETCH; m < KQ; ++m) {
            const int k = kg + K_GROUPS * m;
            const float4 wv = __ldg(row4(w, ldw, k) + quad);
#pragma unroll
            for (int r = 0; r < BT; ++r) fma4(acc[r], a_s[r * K + k], wv);
        }
#pragma unroll
        for (int r = 0; r < BT; ++r)
            reinterpret_cast<float4*>(part_s + (size_t)(kg * BT + r) * N)[quad]
                = acc[r];
    }
}

// Column j of tile row r of a_s W: the four partial sums in order.
template <int BT>
__device__ __forceinline__ float part_sum(const float* part_s, int r, int j,
                                          int N) {
    float g = part_s[(size_t)r * N + j];
#pragma unroll
    for (int q = 1; q < K_GROUPS; ++q)
        g += part_s[(size_t)(q * BT + r) * N + j];
    return g;
}

// out_s[r][k] = sum_j a_s[r][j] W[k][j] over j < N, k < K: a warp takes
// four rows k of W (resident or in L2) at a time, lanes along j four
// columns at a time (16-byte loads), and the four shuffle trees run
// interleaved.
template <int BT>
__device__ __forceinline__ void matvec_t(
        const float* __restrict__ w, int ldw, const float* w_s, int n_res,
        const float* a_s, float* out_s, int K, int N) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5, NQ = N / 4;
    for (int k0 = 4 * warp; k0 < K; k0 += 4 * n_warps) {
        float acc[4][BT];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int r = 0; r < BT; ++r) acc[u][r] = 0.f;
            const int k = k0 + u;
            const bool resident = k < n_res;
            const float4* wk = resident
                ? reinterpret_cast<const float4*>(w_s + (size_t)k * N)
                : row4(w, ldw, k);
#pragma unroll 4
            for (int q = lane; q < NQ; q += 32) {
                const float4 wv = resident ? wk[q] : __ldg(wk + q);
#pragma unroll
                for (int r = 0; r < BT; ++r) {
                    const float4 av =
                        reinterpret_cast<const float4*>(a_s + r * N)[q];
                    acc[u][r] = fmaf(av.x, wv.x, acc[u][r]);
                    acc[u][r] = fmaf(av.y, wv.y, acc[u][r]);
                    acc[u][r] = fmaf(av.z, wv.z, acc[u][r]);
                    acc[u][r] = fmaf(av.w, wv.w, acc[u][r]);
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int r = 0; r < BT; ++r)
                    acc[u][r] += __shfl_xor_sync(0xffffffffu, acc[u][r], off);
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int r = 0; r < BT; ++r) out_s[r * K + k0 + u] = acc[u][r];
            }
        }
    }
}

// The tile's lengths into shared memory (0 for rows beyond B); returns the
// largest.  Ends in a __syncthreads.
template <int BT>
__device__ __forceinline__ int load_lens(const int* __restrict__ lens,
                                         int* len_s, int b0, int B) {
    if (threadIdx.x < BT) {
        const int b = b0 + threadIdx.x;
        len_s[threadIdx.x] = b < B ? lens[b] : 0;
    }
    __syncthreads();
    int max_len = 0;
#pragma unroll
    for (int r = 0; r < BT; ++r) max_len = max(max_len, len_s[r]);
    return max_len;
}

template <int BT>
__global__ void gru_fwd_kernel(
        const float* __restrict__ x3, const float* __restrict__ wg, int ldg,
        const float* __restrict__ wc, int ldc, const int* __restrict__ lens,
        const float* __restrict__ h0, float* __restrict__ hs,
        int B, int T, int D, int n_res, int reverse, int act, int gate) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int len_s[MAX_BT];
    const int D2 = 2 * D, D3 = 3 * D;
    float* wg_s = smem;                           // [n_res][2D] rows of Wg
    float* wc_s = wg_s + (size_t)n_res * D2;      // [n_res][D]  rows of Wc
    float* part_s = wc_s + (size_t)n_res * D;     // [K_GROUPS][BT][2D]
    float* h_s = part_s + K_GROUPS * BT * D2;     // [BT][D]
    float* rh_s = h_s + BT * D;                   // [BT][D]  r h
    float* u_s = rh_s + BT * D;                   // [BT][D]
    const int b0 = blockIdx.x * BT;
    const int max_len = load_lens<BT>(lens, len_s, b0, B);
    load_resident_rows(wg, ldg, wg_s, n_res, D2);
    load_resident_rows(wc, ldc, wc_s, n_res, D);
    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx - r * D, b = b0 + r;
        h_s[idx] = b < B ? h0[(size_t)b * D + d] : 0.f;
    }
    __syncthreads();

    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        if (t >= max_len) {                       // uniform over the CTA
            for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
                const int r = idx / D, d = idx - r * D, b = b0 + r;
                if (b < B) hs[((size_t)b * T + t) * D + d] = h_s[idx];
            }
            continue;
        }
        matvec_part<BT>(wg, ldg, wg_s, n_res, h_s, part_s, D, D2);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            float xu = 0.f, xr = 0.f;
            if (b < B) {
                const float* xb = x3 + ((size_t)b * T + t) * D3;
                xu = xb[d];
                xr = xb[D + d];
            }
            const float u = act_fwd(gate, part_sum<BT>(part_s, r, d, D2) + xu);
            const float rr = act_fwd(gate,
                                     part_sum<BT>(part_s, r, D + d, D2) + xr);
            u_s[idx] = u;
            rh_s[idx] = rr * h_s[idx];
        }
        __syncthreads();
        matvec_part<BT>(wc, ldc, wc_s, n_res, rh_s, part_s, D, D);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            float h = h_s[idx];
            if (t < len_s[r]) {
                const float xc = x3[((size_t)b * T + t) * D3 + D2 + d];
                const float c = act_fwd(act, part_sum<BT>(part_s, r, d, D)
                                             + xc);
                const float u = u_s[idx];
                h = u * h + (1.f - u) * c;
                h_s[idx] = h;
            }
            if (b < B) hs[((size_t)b * T + t) * D + d] = h;
        }
        __syncthreads();
    }
}

// The reverse walk.  Per step s (scan order, T-1 .. 0; time t as in the
// forward) it recomputes u, r, c from the state before the step (h0 at
// s = 0, else hs at the previous scan step's time), then
//   dh_total = dh + g_hs[t]
//   dzu = dh_total (h_prev - c) gate'(u)     dzc = dh_total (1 - u) act'(c)
//   drh = dzc Wc^T                           dzr = drh h_prev gate'(r)
//   dh <- dh_total u + drh r + [dzu, dzr] Wg^T
// and at a frozen step (t >= len): dx3 = 0, dh <- dh_total.  rh_out [B, T, D]
// gets r h_prev of every step (0 where the whole tile is frozen), the
// operand of the candidate weight's gradient.
template <int BT>
__global__ void gru_bwd_kernel(
        const float* __restrict__ x3, const float* __restrict__ wg, int ldg,
        const float* __restrict__ wc, int ldc, const int* __restrict__ lens,
        const float* __restrict__ h0, const float* __restrict__ hs,
        const float* __restrict__ g_hs, const float* __restrict__ g_hl,
        float* __restrict__ dx, float* __restrict__ dh0,
        float* __restrict__ rh_out, int B, int T, int D, int n_res,
        int reverse, int act, int gate) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int len_s[MAX_BT];
    const int D2 = 2 * D, D3 = 3 * D;
    float* wg_s = smem;                           // [n_res][2D] rows of Wg
    float* wc_s = wg_s + (size_t)n_res * D2;      // [n_res][D]  rows of Wc
    float* part_s = wc_s + (size_t)n_res * D;     // [K_GROUPS][BT][2D]
    float* dzg_s = part_s + K_GROUPS * BT * D2;   // [BT][2D] [dzu, dzr]
    float* hp_s = dzg_s + BT * D2;                // [BT][D]  h before the step
    float* u_s = hp_s + BT * D;                   // [BT][D]
    float* r_s = u_s + BT * D;                    // [BT][D]
    float* rh_s = r_s + BT * D;                   // [BT][D]  r h_prev
    float* dzc_s = rh_s + BT * D;                 // [BT][D]
    float* drh_s = dzc_s + BT * D;                // [BT][D]  dzc Wc^T
    float* dhp_s = drh_s + BT * D;                // [BT][D]  dzg Wg^T
    float* dh_s = dhp_s + BT * D;                 // [BT][D]  carried dh
    float* dht_s = dh_s + BT * D;                 // [BT][D]  dh_total
    const int b0 = blockIdx.x * BT;
    const int max_len = load_lens<BT>(lens, len_s, b0, B);

    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx - r * D, b = b0 + r;
        dh_s[idx] = b < B ? g_hl[(size_t)b * D + d] : 0.f;
    }
    load_resident_rows(wg, ldg, wg_s, n_res, D2);
    load_resident_rows(wc, ldc, wc_s, n_res, D);
    __syncthreads();

    for (int s = T - 1; s >= 0; --s) {
        const int t = reverse ? T - 1 - s : s;
        const int t_prev = reverse ? t + 1 : t - 1;
        if (t >= max_len) {
            // every row of the tile is frozen here: dx3 = 0 and dh takes
            // the step's output cotangent along
            for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
                const int r = idx / D, d = idx - r * D, b = b0 + r;
                if (b < B) {
                    const size_t o = ((size_t)b * T + t) * D + d;
                    dh_s[idx] += g_hs[o];
                    rh_out[o] = 0.f;
                }
            }
            for (int idx = threadIdx.x; idx < BT * D3; idx += blockDim.x) {
                const int r = idx / D3, j = idx - r * D3, b = b0 + r;
                if (b < B) dx[((size_t)b * T + t) * D3 + j] = 0.f;
            }
            __syncthreads();
            continue;
        }
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            float hp = 0.f, gh = 0.f;
            if (b < B) {
                gh = g_hs[((size_t)b * T + t) * D + d];
                hp = s == 0 ? h0[(size_t)b * D + d]
                            : hs[((size_t)b * T + t_prev) * D + d];
            }
            hp_s[idx] = hp;
            dht_s[idx] = dh_s[idx] + gh;
        }
        __syncthreads();
        matvec_part<BT>(wg, ldg, wg_s, n_res, hp_s, part_s, D, D2);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            float xu = 0.f, xr = 0.f;
            if (b < B) {
                const float* xb = x3 + ((size_t)b * T + t) * D3;
                xu = xb[d];
                xr = xb[D + d];
            }
            const float u = act_fwd(gate, part_sum<BT>(part_s, r, d, D2) + xu);
            const float rr = act_fwd(gate,
                                     part_sum<BT>(part_s, r, D + d, D2) + xr);
            u_s[idx] = u;
            r_s[idx] = rr;
            rh_s[idx] = rr * hp_s[idx];
        }
        __syncthreads();
        matvec_part<BT>(wc, ldc, wc_s, n_res, rh_s, part_s, D, D);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            const bool valid = t < len_s[r];
            float xc = 0.f;
            if (b < B) xc = x3[((size_t)b * T + t) * D3 + D2 + d];
            const float c = act_fwd(act, part_sum<BT>(part_s, r, d, D) + xc);
            const float dht = dht_s[idx], u = u_s[idx];
            // a frozen row's dx3 is 0; its dh is set from dh_total below
            const float dzu = valid
                ? dht * (hp_s[idx] - c) * act_grad(gate, u) : 0.f;
            const float dzc = valid
                ? dht * (1.f - u) * act_grad(act, c) : 0.f;
            dzg_s[r * D2 + d] = dzu;
            dzc_s[idx] = dzc;
            if (b < B) {
                const size_t o = ((size_t)b * T + t) * D;
                dx[o * 3 + d] = dzu;
                dx[o * 3 + D2 + d] = dzc;
                rh_out[o + d] = rh_s[idx];
            }
        }
        __syncthreads();
        matvec_t<BT>(wc, ldc, wc_s, n_res, dzc_s, drh_s, D, D);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            const bool valid = t < len_s[r];
            const float rr = r_s[idx];
            const float dzr = valid
                ? drh_s[idx] * hp_s[idx] * act_grad(gate, rr) : 0.f;
            dzg_s[r * D2 + D + d] = dzr;
            if (b < B) dx[((size_t)b * T + t) * D3 + D + d] = dzr;
        }
        __syncthreads();
        matvec_t<BT>(wg, ldg, wg_s, n_res, dzg_s, dhp_s, D, D2);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D;
            const float dht = dht_s[idx];
            dh_s[idx] = t < len_s[r]
                ? dht * u_s[idx] + drh_s[idx] * r_s[idx] + dhp_s[idx] : dht;
        }
        __syncthreads();
    }

    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx - r * D, b = b0 + r;
        if (b < B) dh0[(size_t)b * D + d] = dh_s[idx];
    }
}

// Weight gradients, one split of them: part[z][k][j], j < 3D, summed over
// the rows n = (b, t) of split z of a(n)[k] dx[n][j], where a(n) is the
// state before the step for the gate columns j < 2D (h0[b] at the first
// scan step, else hs at the previous scan step's time) and r h_prev (rh)
// for the candidate columns.  A [32 x 32] output tile per CTA, 4 outputs
// per thread, the (b, t) axis staged through shared memory.
__global__ void gru_dw_kernel(
        const float* __restrict__ hs, const float* __restrict__ h0,
        const float* __restrict__ rh, const float* __restrict__ dx,
        float* __restrict__ part, int B, int T, int D, int reverse,
        int rows_per_split) {
    __shared__ float a_s[DW_TN][DW_TK + 1];
    __shared__ float b_s[DW_TN][DW_TJ];
    const int D3 = 3 * D;
    const int N = B * T;
    const int j0 = blockIdx.x * DW_TJ, k0 = blockIdx.y * DW_TK;
    const bool from_h = j0 < 2 * D;               // uniform: 2D % DW_TJ == 0
    const int n_begin = blockIdx.z * rows_per_split;
    const int n_end = min(N, n_begin + rows_per_split);
    const int tid = threadIdx.x;
    const int tk = tid / 8, tj = tid % 8;
    const int step = reverse ? 1 : -1;
    const int t_first = reverse ? T - 1 : 0;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int n0 = n_begin; n0 < n_end; n0 += DW_TN) {
        for (int i = tid; i < DW_TN * DW_TK; i += DW_THREADS) {
            const int nn = i / DW_TK, kk = i - nn * DW_TK, n = n0 + nn;
            float v = 0.f;
            if (n < n_end) {
                if (!from_h) {
                    v = rh[(size_t)n * D + k0 + kk];
                } else {
                    const int b = n / T, t = n - b * T;
                    v = t == t_first ? h0[(size_t)b * D + k0 + kk]
                                     : hs[(size_t)(n + step) * D + k0 + kk];
                }
            }
            a_s[nn][kk] = v;
        }
        for (int i = tid; i < DW_TN * DW_TJ; i += DW_THREADS) {
            const int nn = i / DW_TJ, jj = i - nn * DW_TJ, n = n0 + nn;
            b_s[nn][jj] = n < n_end ? dx[(size_t)n * D3 + j0 + jj] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int nn = 0; nn < DW_TN; ++nn) {
            const float a = a_s[nn][tk];
#pragma unroll
            for (int c = 0; c < 4; ++c)
                acc[c] = fmaf(a, b_s[nn][tj + 8 * c], acc[c]);
        }
        __syncthreads();
    }
    float* out = part + (size_t)blockIdx.z * D * D3;
#pragma unroll
    for (int c = 0; c < 4; ++c)
        out[(size_t)(k0 + tk) * D3 + j0 + tj + 8 * c] = acc[c];
}

// dwg [D, 2D] and dwc [D, D] = the splits of `part` [splits, D, 3D] summed
// in order.
__global__ void gru_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ dwg,
                                  float* __restrict__ dwc, int D,
                                  int splits) {
    const int D3 = 3 * D, n = D * D3;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
    const int k = i / D3, j = i - k * D3;
    if (j < 2 * D) dwg[(size_t)k * 2 * D + j] = s;
    else dwc[(size_t)k * D + j - 2 * D] = s;
}

int block_threads(int D) { return 2 * D < 512 ? 2 * D : 512; }

// How many rows of Wg and Wc ([D, 3D] together) fit into the shared memory
// a block may use on this device beside `state` bytes of the kernel's own
// (and 1 KB of slack for its static shared memory).
cudaError_t resident_rows(size_t state, int D, int* n_res) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const size_t row = (size_t)3 * D * sizeof(float);
    const size_t room = (size_t)limit > state + 1024
        ? (size_t)limit - state - 1024 : 0;
    *n_res = (int)(room / row < (size_t)D ? room / row : (size_t)D);
    return cudaSuccess;
}

template <int BT>
cudaError_t launch_fwd(const float* x3, const float* wg, int ldg,
                       const float* wc, int ldc, const int* lens,
                       const float* h0, float* hs, int B, int T, int D,
                       int reverse, int act, int gate, cudaStream_t stream) {
    const size_t state = (size_t)BT * D * (2 * K_GROUPS + 3) * sizeof(float);
    int n_res = 0;
    cudaError_t err = resident_rows(state, D, &n_res);
    if (err != cudaSuccess) return err;
    const size_t smem = state + (size_t)n_res * 3 * D * sizeof(float);
    err = cudaFuncSetAttribute(
        gru_fwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    gru_fwd_kernel<BT><<<(B + BT - 1) / BT, block_threads(D), smem, stream>>>(
        x3, wg, ldg, wc, ldc, lens, h0, hs, B, T, D, n_res, reverse, act,
        gate);
    return cudaGetLastError();
}

template <int BT>
cudaError_t launch_bwd(const float* x3, const float* wg, int ldg,
                       const float* wc, int ldc, const int* lens,
                       const float* h0, const float* hs, const float* g_hs,
                       const float* g_hl, float* dx, float* dh0, float* rh,
                       int B, int T, int D, int reverse, int act, int gate,
                       cudaStream_t stream) {
    const size_t state =
        (size_t)BT * D * (2 * K_GROUPS + 2 + 9) * sizeof(float);
    int n_res = 0;
    cudaError_t err = resident_rows(state, D, &n_res);
    if (err != cudaSuccess) return err;
    const size_t smem = state + (size_t)n_res * 3 * D * sizeof(float);
    err = cudaFuncSetAttribute(
        gru_bwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    gru_bwd_kernel<BT><<<(B + BT - 1) / BT, block_threads(D), smem, stream>>>(
        x3, wg, ldg, wc, ldc, lens, h0, hs, g_hs, g_hl, dx, dh0, rh, B, T, D,
        n_res, reverse, act, gate);
    return cudaGetLastError();
}

bool shape_ok(int B, int T, int D, int bt) {
    return B >= 1 && T >= 1 && D >= 32 && D <= 512 && D % 32 == 0
        && (bt == 1 || bt == 2 || bt == 4);
}

// Both weights 16-byte aligned with row strides of whole 16-byte units that
// hold their columns.
bool weights_ok(const void* wg, int ldg, const void* wc, int ldc, int D) {
    return ((size_t)wg & 15) == 0 && ((size_t)wc & 15) == 0
        && ldg % 4 == 0 && ldc % 4 == 0 && ldg >= 2 * D && ldc >= D;
}

}  // namespace

extern "C" {

// hs [B, T, D] <- the recurrence over x3 [B, T, 3D]; wg [D, 2D] and wc
// [D, D] with row strides ldg, ldc; bt = batch rows per CTA (1, 2 or 4).
int gru_fwd_launch(const void* x3, const void* wg, int ldg, const void* wc,
                   int ldc, const void* lens, const void* h0, void* hs,
                   int B, int T, int D, int reverse, int act, int gate,
                   int bt, void* stream) {
    if (!shape_ok(B, T, D, bt) || !weights_ok(wg, ldg, wc, ldc, D))
        return (int)cudaErrorInvalidValue;
    decltype(&launch_fwd<1>) fn = &launch_fwd<1>;
    if (bt == 2) fn = &launch_fwd<2>;
    if (bt == 4) fn = &launch_fwd<4>;
    return (int)fn((const float*)x3, (const float*)wg, ldg,
                   (const float*)wc, ldc, (const int*)lens,
                   (const float*)h0, (float*)hs, B, T, D, reverse, act, gate,
                   (cudaStream_t)stream);
}

// dx [B, T, 3D], dh0 [B, D], dwg [D, 2D], dwc [D, D] from the stored hs
// and the cotangents g_hs [B, T, D], g_hl [B, D].  Scratch: rh [B, T, D]
// and dw_part [splits, D, 3D].
int gru_bwd_launch(const void* x3, const void* wg, int ldg, const void* wc,
                   int ldc, const void* lens, const void* h0, const void* hs,
                   const void* g_hs, const void* g_hl, void* dx, void* dh0,
                   void* dwg, void* dwc, void* rh, void* dw_part, int splits,
                   int B, int T, int D, int reverse, int act, int gate,
                   int bt, void* stream) {
    if (!shape_ok(B, T, D, bt) || splits < 1
            || !weights_ok(wg, ldg, wc, ldc, D))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    decltype(&launch_bwd<1>) fn = &launch_bwd<1>;
    if (bt == 2) fn = &launch_bwd<2>;
    if (bt == 4) fn = &launch_bwd<4>;
    cudaError_t err = fn(
        (const float*)x3, (const float*)wg, ldg, (const float*)wc, ldc,
        (const int*)lens, (const float*)h0, (const float*)hs,
        (const float*)g_hs, (const float*)g_hl, (float*)dx, (float*)dh0,
        (float*)rh, B, T, D, reverse, act, gate, st);
    if (err != cudaSuccess) return (int)err;
    const int N = B * T;
    const int rows_per_split = (N + splits - 1) / splits;
    dim3 grid(3 * D / DW_TJ, D / DW_TK, splits);
    gru_dw_kernel<<<grid, DW_THREADS, 0, st>>>(
        (const float*)hs, (const float*)h0, (const float*)rh,
        (const float*)dx, (float*)dw_part, B, T, D, reverse, rows_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_dw = D * 3 * D;
    gru_reduce_kernel<<<(n_dw + 255) / 256, 256, 0, st>>>(
        (const float*)dw_part, (float*)dwg, (float*)dwc, D, splits);
    return (int)cudaGetLastError();
}

const char* gru_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
