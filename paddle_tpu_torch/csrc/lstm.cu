// Fused LSTM recurrence for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the Pallas TPU kernels `_lstm_fwd_kernel` and `_lstm_bwd_kernel`
// of paddle_tpu/ops/pallas_rnn.py.  Both compute, for a pre-projected input
// x4 [B, T, 4D] (gate order a, i, f, o; bias already added), a recurrent
// weight W [D, 4D] and peephole vectors peeps [3, D] (i, f, o):
//
//     g = x_t + h W            a = act(g_a)
//     i = gate(g_i + c p_i)    f = gate(g_f + c p_f)
//     c' = a i + f c           o = gate(g_o + c' p_o)      h' = o state(c')
//
// with the state of a row frozen at every step t >= lens[b].  `reverse`
// walks t = T-1 .. 0 (the padded tail first, so the valid prefix is visited
// backwards from the zero state).  All tensors are float32 and keep the
// [B, T, .] layout: the kernels index time themselves, nothing is flipped
// or transposed around them.
//
// Design.  The TPU grid is the time axis, run in order with h and c in VMEM
// scratch.  CUDA blocks run in no order, so the time loop lives inside the
// kernel and the grid is the batch: the recurrence is independent across
// batch rows, each CTA owns a tile of BT rows for all T steps, h and c of its
// rows stay in shared memory, and there is no synchronisation across CTAs.
// W does not fit on an SM (D = 128: 256 KiB of float32), so the CTA keeps as
// many of W's rows as its shared memory holds (D = 128: 105-108 of 128; the
// launcher sizes it to the device's limit) and streams the other rows from
// L2, where W stays resident, every step.  Both go straight into the FMA
// loop with 16-byte loads: a thread owns four adjacent gate columns over
// every fourth row of W, neighbouring threads neighbouring columns, h is
// broadcast from shared memory, the loads of the rows still in L2 are
// started before the resident rows are summed, and the four partial sums are
// added in a fixed order.  By the card's roofline the work is bound by
// operations (float32 FMAs; the bytes of x4, hs and cs are the smaller
// term), but the kernels stay bound by what one SM can read per step and by
// latency (T dependent steps, each a [BT, D] x [D, 4D] product at BT of
// 1..4), far from the card's float32 rate; the faster design (gate columns
// split over CTAs so that every W slice is resident, a grid sync per step)
// is later work.  A step at which every row of the tile is frozen skips its
// products.
//
// Backward: a reverse walk over the same steps that recomputes a, i, f, o
// from the stored h and c (the forward stores only those), forms
// dx4 = [dza, dzi, dzf, dzo], writes it, and carries dh = dx4 W^T and dc in
// shared memory.  The sums over the batch are not taken with atomics: the
// peephole gradients are kept per row and the weight gradient
// dW = sum_{b,t} h_prev^T dx4 is a separate tiled product over the finished
// dx4 (split over row ranges), both summed in a fixed order by a last small
// kernel, so gradients are deterministic.
//
// Plain C interface (ctypes): each launcher returns the CUDA error code of
// its launches (0 = success) and never synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_BT = 4;          // largest batch tile
constexpr int DW_TK = 32;          // dW tile: rows of W (k)
constexpr int DW_TJ = 64;          // dW tile: gate columns (j)
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

constexpr int K_GROUPS = 4;        // W's rows are summed in four interleaved groups
constexpr int PREFETCH = 8;        // loads of non-resident rows started early

__device__ __forceinline__ void fma4(float4& acc, float h, const float4& w) {
    acc.x = fmaf(h, w.x, acc.x);
    acc.y = fmaf(h, w.y, acc.y);
    acc.z = fmaf(h, w.z, acc.z);
    acc.w = fmaf(h, w.w, acc.w);
}

// The first `n_rows` rows of W into shared memory (16-byte copies).
__device__ __forceinline__ void load_resident_rows(
        const float* __restrict__ w, float* w_s, int n_rows, int D) {
    const float4* src = reinterpret_cast<const float4*>(w);
    float4* dst = reinterpret_cast<float4*>(w_s);
    for (int i = threadIdx.x; i < n_rows * D; i += blockDim.x)
        dst[i] = __ldg(src + i);
}

// part_s[q][r][j], q < K_GROUPS: the partial sums over the rows
// k = q, q + 4, q + 8, ... of W of sum_k h_s[r][k] W[k][j]; group 0
// also holds x4[b0 + r, t, j] (0 for rows beyond B), so the four add up to
// the gate pre-activations.  A work item is (group, four adjacent columns): one
// 16-byte load of W per row, neighbouring threads on neighbouring addresses.
// Rows below n_res are read from w_s, the others from L2.
template <int BT>
__device__ __forceinline__ void gates_matvec(
        const float* __restrict__ x4, const float* __restrict__ w,
        const float* w_s, int n_res, const float* h_s, float* part_s,
        int b0, int B, int T, int t, int D) {
    const int D4 = 4 * D, KQ = D / K_GROUPS;
    const float4* wg = reinterpret_cast<const float4*>(w);
    const float4* ws = reinterpret_cast<const float4*>(w_s);
    for (int i = threadIdx.x; i < D4; i += blockDim.x) {
        const int kg = i / D, quad = i - kg * D;
        // this item's rows are k = kg + K_GROUPS * m, m < KQ; the first
        // m_res of them are resident
        const int m_res = min(KQ, max(0, (n_res - kg + K_GROUPS - 1)
                                          / K_GROUPS));
        // x4 is loaded first and added last: its latency hides behind the
        // products
        float4 xv[BT], acc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) {
            const int b = b0 + r;
            xv[r] = (kg == 0 && b < B)
                ? __ldg(reinterpret_cast<const float4*>(
                            x4 + ((size_t)b * T + t) * D4) + quad)
                : make_float4(0.f, 0.f, 0.f, 0.f);
            acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4 pre[PREFETCH];
#pragma unroll
        for (int p = 0; p < PREFETCH; ++p) {
            const int k = kg + K_GROUPS * (m_res + p);
            pre[p] = m_res + p < KQ ? __ldg(wg + (size_t)k * D + quad)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 4
        for (int m = 0; m < m_res; ++m) {
            const int k = kg + K_GROUPS * m;
            const float4 wv = ws[(size_t)k * D + quad];
#pragma unroll
            for (int r = 0; r < BT; ++r) fma4(acc[r], h_s[r * D + k], wv);
        }
#pragma unroll
        for (int p = 0; p < PREFETCH; ++p) {
            const int k = kg + K_GROUPS * (m_res + p);
            if (m_res + p < KQ) {
#pragma unroll
                for (int r = 0; r < BT; ++r)
                    fma4(acc[r], h_s[r * D + k], pre[p]);
            }
        }
#pragma unroll 8
        for (int m = m_res + PREFETCH; m < KQ; ++m) {
            const int k = kg + K_GROUPS * m;
            const float4 wv = __ldg(wg + (size_t)k * D + quad);
#pragma unroll
            for (int r = 0; r < BT; ++r) fma4(acc[r], h_s[r * D + k], wv);
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
            acc[r].x += xv[r].x;
            acc[r].y += xv[r].y;
            acc[r].z += xv[r].z;
            acc[r].w += xv[r].w;
            reinterpret_cast<float4*>(part_s + (size_t)(kg * BT + r) * D4)[quad]
                = acc[r];
        }
    }
}

// The gate pre-activation of column j of tile row r: the four partial sums
// in order.
template <int BT>
__device__ __forceinline__ float gate_sum(const float* part_s, int r, int j,
                                          int D4) {
    float g = part_s[(size_t)r * D4 + j];
#pragma unroll
    for (int q = 1; q < K_GROUPS; ++q)
        g += part_s[(size_t)(q * BT + r) * D4 + j];
    return g;
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
__global__ void lstm_fwd_kernel(
        const float* __restrict__ x4, const float* __restrict__ w,
        const float* __restrict__ peeps, const int* __restrict__ lens,
        const float* __restrict__ h0, const float* __restrict__ c0,
        float* __restrict__ hs, float* __restrict__ cs,
        int B, int T, int D, int n_res, int reverse, int act, int gate,
        int state_act) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int len_s[MAX_BT];
    const int D4 = 4 * D;
    float* w_s = smem;                    // [n_res][4D] resident rows of W
    float* g_s = w_s + (size_t)n_res * D4;        // [K_GROUPS][BT][4D]
    float* h_s = g_s + K_GROUPS * BT * D4;        // [BT][D]
    float* c_s = h_s + BT * D;            // [BT][D]
    const int b0 = blockIdx.x * BT;
    const int max_len = load_lens<BT>(lens, len_s, b0, B);
    load_resident_rows(w, w_s, n_res, D);

    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx - r * D, b = b0 + r;
        h_s[idx] = b < B ? h0[(size_t)b * D + d] : 0.f;
        c_s[idx] = b < B ? c0[(size_t)b * D + d] : 0.f;
    }
    __syncthreads();

    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        const bool live = t < max_len;            // uniform over the CTA
        if (live)
            gates_matvec<BT>(x4, w, w_s, n_res, h_s, g_s, b0, B, T, t, D);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            float h = h_s[idx], c = c_s[idx];
            if (t < len_s[r]) {
                const float a = act_fwd(act, gate_sum<BT>(g_s, r, d, D4));
                const float ig = act_fwd(gate, gate_sum<BT>(g_s, r, D + d, D4)
                                         + c * peeps[d]);
                const float fg = act_fwd(gate,
                                         gate_sum<BT>(g_s, r, 2 * D + d, D4)
                                         + c * peeps[D + d]);
                const float cn = a * ig + fg * c;
                const float og = act_fwd(gate,
                                         gate_sum<BT>(g_s, r, 3 * D + d, D4)
                                         + cn * peeps[2 * D + d]);
                h = og * act_fwd(state_act, cn);
                c = cn;
                h_s[idx] = h;
                c_s[idx] = c;
            }
            if (b < B) {
                const size_t o = ((size_t)b * T + t) * D + d;
                hs[o] = h;
                cs[o] = c;
            }
        }
        __syncthreads();
    }
}

// The reverse walk.  Per step s (scan order, T-1 .. 0; time t as in the
// forward) it recomputes the gates from the state before the step
// (h0/c0 at s = 0, else hs/cs at the previous scan step's time) and
// cs[t], then
//   dh_total = dh + g_hs[t]                 do = dh_total state(c')
//   dzo = do gate'(o)
//   dc_in = dh_total o state'(.) + dc + dzo p_o
//   dza = dc_in i act'(a)   dzi = dc_in a gate'(i)   dzf = dc_in c gate'(f)
//   dc <- dc_in f + dzi p_i + dzf p_f       dh <- dx4 W^T
// and at a frozen step (t >= len): dx4 = 0, dh <- dh_total, dc kept.
// dpeep_part [B, 3, D] gets each row's own sums over time.
template <int BT>
__global__ void lstm_bwd_kernel(
        const float* __restrict__ x4, const float* __restrict__ w,
        const float* __restrict__ peeps, const int* __restrict__ lens,
        const float* __restrict__ h0, const float* __restrict__ c0,
        const float* __restrict__ hs, const float* __restrict__ cs,
        const float* __restrict__ g_hs, const float* __restrict__ g_hl,
        const float* __restrict__ g_cl,
        float* __restrict__ dx, float* __restrict__ dh0,
        float* __restrict__ dc0, float* __restrict__ dpeep_part,
        int B, int T, int D, int n_res, int reverse, int act, int gate,
        int state_act) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int len_s[MAX_BT];
    const int D4 = 4 * D;
    float* w_s = smem;                    // [n_res][4D] resident rows of W
    float* g_s = w_s + (size_t)n_res * D4;        // [K_GROUPS][BT][4D]
    float* dx_s = g_s + K_GROUPS * BT * D4;       // [BT][4D]
    float* hp_s = dx_s + BT * D4;         // [BT][D]  h before the step
    float* cp_s = hp_s + BT * D;          // [BT][D]  c before the step
    float* dh_s = cp_s + BT * D;          // [BT][D]  carried dh
    float* dc_s = dh_s + BT * D;          // [BT][D]  carried dc
    float* dht_s = dc_s + BT * D;         // [BT][D]  dh_total of the step
    float* dp_s = dht_s + BT * D;         // [BT][3][D] peephole sums
    float* cn_s = dp_s + BT * 3 * D;      // [BT][D]  c after the step
    float* gh_s = cn_s + BT * D;          // [BT][D]  the step's g_hs
    const int b0 = blockIdx.x * BT;
    const int max_len = load_lens<BT>(lens, len_s, b0, B);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;

    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx - r * D, b = b0 + r;
        dh_s[idx] = b < B ? g_hl[(size_t)b * D + d] : 0.f;
        dc_s[idx] = b < B ? g_cl[(size_t)b * D + d] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BT * 3 * D; idx += blockDim.x)
        dp_s[idx] = 0.f;
    load_resident_rows(w, w_s, n_res, D);
    __syncthreads();

    for (int s = T - 1; s >= 0; --s) {
        const int t = reverse ? T - 1 - s : s;
        const int t_prev = reverse ? t + 1 : t - 1;
        if (t >= max_len) {
            // every row of the tile is frozen here: dx4 = 0 and dh takes
            // the step's output cotangent along
            for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
                const int r = idx / D, d = idx - r * D, b = b0 + r;
                if (b < B) dh_s[idx] += g_hs[((size_t)b * T + t) * D + d];
            }
            for (int idx = threadIdx.x; idx < BT * D4; idx += blockDim.x) {
                const int r = idx / D4, j = idx - r * D4, b = b0 + r;
                if (b < B) dx[((size_t)b * T + t) * D4 + j] = 0.f;
            }
            __syncthreads();
            continue;
        }
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            // the step's four reads from device memory start together
            float hp = 0.f, cp = 0.f, cn = 0.f, gh = 0.f;
            if (b < B) {
                const size_t o = ((size_t)b * T + t) * D + d;
                cn = cs[o];
                gh = g_hs[o];
                if (s == 0) {
                    hp = h0[(size_t)b * D + d];
                    cp = c0[(size_t)b * D + d];
                } else {
                    const size_t op = ((size_t)b * T + t_prev) * D + d;
                    hp = hs[op];
                    cp = cs[op];
                }
            }
            hp_s[idx] = hp;
            cp_s[idx] = cp;
            cn_s[idx] = cn;
            gh_s[idx] = gh;
        }
        __syncthreads();
        gates_matvec<BT>(x4, w, w_s, n_res, hp_s, g_s, b0, B, T, t, D);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
            const int r = idx / D, d = idx - r * D, b = b0 + r;
            const bool valid = t < len_s[r];
            const float p_i = peeps[d], p_f = peeps[D + d],
                        p_o = peeps[2 * D + d];
            const float c_prev = cp_s[idx];
            const float c_new = cn_s[idx];
            const float a = act_fwd(act, gate_sum<BT>(g_s, r, d, D4));
            const float ig = act_fwd(gate, gate_sum<BT>(g_s, r, D + d, D4)
                                     + c_prev * p_i);
            const float fg = act_fwd(gate, gate_sum<BT>(g_s, r, 2 * D + d, D4)
                                     + c_prev * p_f);
            const float og = act_fwd(gate, gate_sum<BT>(g_s, r, 3 * D + d, D4)
                                     + c_new * p_o);
            const float sc = act_fwd(state_act, c_new);
            const float dh_total = dh_s[idx] + gh_s[idx];
            float dzo = dh_total * sc * act_grad(gate, og);
            const float dc_in = dh_total * og * act_grad(state_act, sc)
                                + dc_s[idx] + dzo * p_o;
            float dza = dc_in * ig * act_grad(act, a);
            float dzi = dc_in * a * act_grad(gate, ig);
            float dzf = dc_in * c_prev * act_grad(gate, fg);
            if (valid) {
                dc_s[idx] = dc_in * fg + dzi * p_i + dzf * p_f;
                dp_s[(r * 3 + 0) * D + d] += dzi * c_prev;
                dp_s[(r * 3 + 1) * D + d] += dzf * c_prev;
                dp_s[(r * 3 + 2) * D + d] += dzo * c_new;
            } else {
                dza = dzi = dzf = dzo = 0.f;
            }
            dht_s[idx] = dh_total;
            float* dxr = dx_s + r * D4;
            dxr[d] = dza;
            dxr[D + d] = dzi;
            dxr[2 * D + d] = dzf;
            dxr[3 * D + d] = dzo;
            if (b < B) {
                float* dxg = dx + ((size_t)b * T + t) * D4;
                dxg[d] = dza;
                dxg[D + d] = dzi;
                dxg[2 * D + d] = dzf;
                dxg[3 * D + d] = dzo;
            }
        }
        __syncthreads();
        // dh_prev[r][k] = sum_j dx4[r][j] W[k][j]: a warp takes four rows k
        // of W (resident or in L2) at a time, lanes along j four columns at
        // a time (16-byte loads), and the four shuffle trees run interleaved
        for (int k0 = 4 * warp; k0 < D; k0 += 4 * n_warps) {
            float acc[4][BT];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int r = 0; r < BT; ++r) acc[u][r] = 0.f;
                const int k = k0 + u;
                const bool resident = k < n_res;
                const float4* wk = reinterpret_cast<const float4*>(
                                       (resident ? w_s : w) + (size_t)k * D4);
#pragma unroll 4
                for (int q = lane; q < D; q += 32) {
                    const float4 wv = resident ? wk[q] : __ldg(wk + q);
#pragma unroll
                    for (int r = 0; r < BT; ++r) {
                        const float4 dv =
                            reinterpret_cast<const float4*>(dx_s + r * D4)[q];
                        acc[u][r] = fmaf(dv.x, wv.x, acc[u][r]);
                        acc[u][r] = fmaf(dv.y, wv.y, acc[u][r]);
                        acc[u][r] = fmaf(dv.z, wv.z, acc[u][r]);
                        acc[u][r] = fmaf(dv.w, wv.w, acc[u][r]);
                    }
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
#pragma unroll
                    for (int r = 0; r < BT; ++r)
                        acc[u][r] += __shfl_xor_sync(0xffffffffu, acc[u][r],
                                                     off);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
#pragma unroll
                    for (int r = 0; r < BT; ++r) {
                        const int o = r * D + k0 + u;
                        dh_s[o] = t < len_s[r] ? acc[u][r] : dht_s[o];
                    }
                }
            }
        }
        __syncthreads();
    }

    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
        const int r = idx / D, d = idx - r * D, b = b0 + r;
        if (b < B) {
            dh0[(size_t)b * D + d] = dh_s[idx];
            dc0[(size_t)b * D + d] = dc_s[idx];
#pragma unroll
            for (int q = 0; q < 3; ++q)
                dpeep_part[((size_t)b * 3 + q) * D + d] =
                    dp_s[(r * 3 + q) * D + d];
        }
    }
}

// Weight gradient, one split of it: part[z][k][j] = sum over the rows
// n = (b, t) of split z of h_prev(n)[k] dx[n][j], where h_prev(n) is the
// state before the step at time t: h0[b] at the first scan step, else hs at
// the previous scan step's time.  A [32 x 64] output tile per CTA, 2 x 4
// outputs per thread, the (b, t) axis staged through shared memory.
__global__ void lstm_dw_kernel(
        const float* __restrict__ hs, const float* __restrict__ h0,
        const float* __restrict__ dx, float* __restrict__ part,
        int B, int T, int D, int reverse, int rows_per_split) {
    __shared__ float a_s[DW_TN][DW_TK + 1];
    __shared__ float b_s[DW_TN][DW_TJ];
    const int D4 = 4 * D;
    const int N = B * T;
    const int j0 = blockIdx.x * DW_TJ, k0 = blockIdx.y * DW_TK;
    const int n_begin = blockIdx.z * rows_per_split;
    const int n_end = min(N, n_begin + rows_per_split);
    const int tid = threadIdx.x;
    const int tk = tid / 16, tj = tid % 16;
    const int step = reverse ? 1 : -1;
    const int t_first = reverse ? T - 1 : 0;
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int n0 = n_begin; n0 < n_end; n0 += DW_TN) {
        for (int i = tid; i < DW_TN * DW_TK; i += DW_THREADS) {
            const int nn = i / DW_TK, kk = i - nn * DW_TK, n = n0 + nn;
            float v = 0.f;
            if (n < n_end) {
                const int b = n / T, t = n - b * T;
                v = t == t_first
                    ? h0[(size_t)b * D + k0 + kk]
                    : hs[(size_t)(n + step) * D + k0 + kk];
            }
            a_s[nn][kk] = v;
        }
        for (int i = tid; i < DW_TN * DW_TJ; i += DW_THREADS) {
            const int nn = i / DW_TJ, jj = i - nn * DW_TJ, n = n0 + nn;
            b_s[nn][jj] = n < n_end ? dx[(size_t)n * D4 + j0 + jj] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int nn = 0; nn < DW_TN; ++nn) {
            const float a0 = a_s[nn][2 * tk], a1 = a_s[nn][2 * tk + 1];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float bv = b_s[nn][tj + 16 * c];
                acc[0][c] = fmaf(a0, bv, acc[0][c]);
                acc[1][c] = fmaf(a1, bv, acc[1][c]);
            }
        }
        __syncthreads();
    }
    float* out = part + (size_t)blockIdx.z * D * D4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            out[(size_t)(k0 + 2 * tk + i) * D4 + j0 + tj + 16 * c] = acc[i][c];
}

// dw = the splits of `part` summed in order; dpeep = the rows of dpeep_part
// summed in order.
__global__ void lstm_reduce_kernel(
        const float* __restrict__ part, float* __restrict__ dw, int n_dw,
        int splits, const float* __restrict__ dpeep_part,
        float* __restrict__ dpeep, int B, int D3) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_dw) {
        float s = 0.f;
        for (int z = 0; z < splits; ++z) s += part[(size_t)z * n_dw + i];
        dw[i] = s;
    } else if (i - n_dw < D3) {
        const int q = i - n_dw;
        float s = 0.f;
        for (int b = 0; b < B; ++b) s += dpeep_part[(size_t)b * D3 + q];
        dpeep[q] = s;
    }
}

int block_threads(int D) { return 4 * D < 512 ? 4 * D : 512; }

// How many rows of W [D, 4D] fit into the shared memory a block may use on
// this device beside `state` bytes of the kernel's own (and 1 KB of slack for
// its static shared memory).
cudaError_t resident_rows(size_t state, int D, int* n_res) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const size_t row = (size_t)4 * D * sizeof(float);
    const size_t room = (size_t)limit > state + 1024
        ? (size_t)limit - state - 1024 : 0;
    *n_res = (int)(room / row < (size_t)D ? room / row : (size_t)D);
    return cudaSuccess;
}

template <int BT>
cudaError_t launch_fwd(const float* x4, const float* w, const float* peeps,
                       const int* lens, const float* h0, const float* c0,
                       float* hs, float* cs, int B, int T, int D, int reverse,
                       int act, int gate, int state_act, cudaStream_t stream) {
    const size_t state = (size_t)BT * D * (4 * K_GROUPS + 2) * sizeof(float);
    int n_res = 0;
    cudaError_t err = resident_rows(state, D, &n_res);
    if (err != cudaSuccess) return err;
    const size_t smem = state + (size_t)n_res * 4 * D * sizeof(float);
    err = cudaFuncSetAttribute(
        lstm_fwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    lstm_fwd_kernel<BT><<<(B + BT - 1) / BT, block_threads(D), smem, stream>>>(
        x4, w, peeps, lens, h0, c0, hs, cs, B, T, D, n_res, reverse, act,
        gate, state_act);
    return cudaGetLastError();
}

template <int BT>
cudaError_t launch_bwd(const float* x4, const float* w, const float* peeps,
                       const int* lens, const float* h0, const float* c0,
                       const float* hs, const float* cs, const float* g_hs,
                       const float* g_hl, const float* g_cl, float* dx,
                       float* dh0, float* dc0, float* dpeep_part, int B,
                       int T, int D, int reverse, int act, int gate,
                       int state_act, cudaStream_t stream) {
    const size_t state = (size_t)BT * D * (4 * K_GROUPS + 14) * sizeof(float);
    int n_res = 0;
    cudaError_t err = resident_rows(state, D, &n_res);
    if (err != cudaSuccess) return err;
    const size_t smem = state + (size_t)n_res * 4 * D * sizeof(float);
    err = cudaFuncSetAttribute(
        lstm_bwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    lstm_bwd_kernel<BT><<<(B + BT - 1) / BT, block_threads(D), smem, stream>>>(
        x4, w, peeps, lens, h0, c0, hs, cs, g_hs, g_hl, g_cl, dx, dh0, dc0,
        dpeep_part, B, T, D, n_res, reverse, act, gate, state_act);
    return cudaGetLastError();
}

// (the backward's own shared memory is 120 bytes per tile row and hidden
// unit; the launcher refuses a tile that does not fit the device's limit)
bool shape_ok(int B, int T, int D, int bt) {
    return B >= 1 && T >= 1 && D >= 32 && D <= 512 && D % 32 == 0
        && (bt == 1 || bt == 2 || bt == 4);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

extern "C" {

// hs, cs [B, T, D] <- the recurrence over x4 [B, T, 4D]; bt = batch rows
// per CTA (1, 2 or 4).
int lstm_fwd_launch(const void* x4, const void* w, const void* peeps,
                    const void* lens, const void* h0, const void* c0,
                    void* hs, void* cs, int B, int T, int D, int reverse,
                    int act, int gate, int state_act, int bt, void* stream) {
    if (!shape_ok(B, T, D, bt) || !aligned16(x4) || !aligned16(w))
        return (int)cudaErrorInvalidValue;
    decltype(&launch_fwd<1>) fn = &launch_fwd<1>;
    if (bt == 2) fn = &launch_fwd<2>;
    if (bt == 4) fn = &launch_fwd<4>;
    return (int)fn((const float*)x4, (const float*)w, (const float*)peeps,
                   (const int*)lens, (const float*)h0, (const float*)c0,
                   (float*)hs, (float*)cs, B, T, D, reverse, act, gate,
                   state_act, (cudaStream_t)stream);
}

// dx [B, T, 4D], dh0, dc0 [B, D], dw [D, 4D], dpeep [3, D] from the stored
// hs, cs and the cotangents g_hs [B, T, D], g_hl, g_cl [B, D].  Scratch:
// dpeep_part [B, 3, D] and dw_part [splits, D, 4D].
int lstm_bwd_launch(const void* x4, const void* w, const void* peeps,
                    const void* lens, const void* h0, const void* c0,
                    const void* hs, const void* cs, const void* g_hs,
                    const void* g_hl, const void* g_cl, void* dx, void* dh0,
                    void* dc0, void* dw, void* dpeep, void* dpeep_part,
                    void* dw_part, int splits, int B, int T, int D,
                    int reverse, int act, int gate, int state_act, int bt,
                    void* stream) {
    if (!shape_ok(B, T, D, bt) || splits < 1 || !aligned16(x4)
            || !aligned16(w))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    decltype(&launch_bwd<1>) fn = &launch_bwd<1>;
    if (bt == 2) fn = &launch_bwd<2>;
    if (bt == 4) fn = &launch_bwd<4>;
    cudaError_t err = fn(
        (const float*)x4, (const float*)w, (const float*)peeps,
        (const int*)lens, (const float*)h0, (const float*)c0,
        (const float*)hs, (const float*)cs, (const float*)g_hs,
        (const float*)g_hl, (const float*)g_cl, (float*)dx, (float*)dh0,
        (float*)dc0, (float*)dpeep_part, B, T, D, reverse, act, gate,
        state_act, st);
    if (err != cudaSuccess) return (int)err;
    const int N = B * T;
    const int rows_per_split = (N + splits - 1) / splits;
    dim3 grid(4 * D / DW_TJ, D / DW_TK, splits);
    lstm_dw_kernel<<<grid, DW_THREADS, 0, st>>>(
        (const float*)hs, (const float*)h0, (const float*)dx,
        (float*)dw_part, B, T, D, reverse, rows_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_dw = D * 4 * D, total = n_dw + 3 * D;
    lstm_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
        (const float*)dw_part, (float*)dw, n_dw, splits,
        (const float*)dpeep_part, (float*)dpeep, B, 3 * D);
    return (int)cudaGetLastError();
}

const char* lstm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
