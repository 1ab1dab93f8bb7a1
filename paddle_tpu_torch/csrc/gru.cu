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
// What bounds it on this card.  A step is two dependent products of the
// batch's state with the weights (h Wg gives r, which (r h) Wc needs), and
// the T steps depend on each other, so the work is a chain of 2T small
// products.  By the roofline it is bound by float32 operations (45 us at
// [64, 30, 512]), but a design that gives each CTA whole batch rows has to
// read all of W (3 MiB at D = 512) every step: an SM reads ~130 GB/s from
// L2, so a step costs ~24 us however few rows it has.  The weights fit the
// card's shared memory many times over (132 x 227 KB), only not one SM's.
//
// The design.  The batch is split into G_b groups of R rows, and within a
// group G_c CTAs each own a slice of U = D / G_c hidden units d: the three
// weight columns of each of its units (Wg[:, d], Wg[:, D + d], Wc[:, d])
// stay in shared memory for the whole launch, so no weight is read from
// L2 after the first step, and a CTA owns the u, r and c columns of the
// same units, so all of a step's elementwise work is local to it.  What a
// CTA needs of the others is the group's full state: a step reads the
// group's h rows (written by the previous step into hs), computes h Wg for
// its u and r columns, writes r h of its units to an exchange buffer,
// meets the group's other CTAs at a barrier, reads the group's full r h,
// computes (r h) Wc for its c columns and the new h of its units, writes
// them into hs and meets them again.  So a step costs its share of the
// arithmetic, ~2 R D floats read from L2 and two group barriers.  The grid
// is G_b G_c CTAs launched cooperatively, so every CTA is resident (or the
// launch fails): a barrier is a counter in global memory per group, raised
// with release semantics and read with acquire loads, zeroed per launch by
// the caller.  Exchanged data (hs, r h, the partial sums below) is read
// through L2 only (cp.async.cg, __ldcg), never through the non-coherent or
// L1 path; the group's state arrives in four column ranges, so that a
// product starts on the first while the others are in flight.  A step at
// which every row of a group is frozen skips its products and its
// barriers; the next step reads h from the last step that changed it.
// The launch plan (G_b, G_c, R, U) is chosen by ops/gru_fused.py
// (`gru_plan`) and re-checked here.  Where one CTA can hold all of W
// (D <= 96) G_c = 1 and the barriers are __syncthreads.  A batch too large
// for any plan (a group's rows must fit one CTA's shared memory, and there
// is at most one CTA per SM) is walked in slices of rows, one launch after
// another on the same stream; rows never meet in the recurrence, so that is
// exact, and the weight-gradient product runs once over the whole batch.
//
// Backward.  When a gradient is wanted the forward also saves u, r and c
// [B, T, 3D], so the reverse walk needs only the two transposed products
// dzc Wc^T and [dzu, dzr] Wg^T, not four dependent passes.  Each CTA holds
// its weight columns transposed, forms the partial sums of a product over
// its own columns for every k, writes them to scratch, meets its group,
// and sums the partials of its own k-slice in the fixed order of the CTAs
// (no atomics: gradients are deterministic).  Phase A gives drh = dzc Wc^T,
// phase B the rest of dh.  The walk also writes each valid step's operands
// of the weight gradients, [h_prev, r h_prev] (0 on frozen steps); dWg =
// sum h_prev^T [dzu, dzr] and dWc = sum (r h_prev)^T dzc over the (b, t)
// rows are then one register-tiled float32 product (8 x 8 outputs a
// thread, operands staged through shared memory with cp.async, double-
// buffered), split over ranges of (b, t) rows and summed in order.
//
// Plain C interface (ctypes): each launcher returns the CUDA error code of
// its launches (0 = success) and never synchronises.  The `_phases`
// launchers are a measurement export, not used by the op: they run the same
// kernels with CTA 0 stamping clock64() around each part of a step.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;       // walk kernels
constexpr int MAX_KS = 16;         // forward products: k-splits at most
constexpr long long BARRIER_TIMEOUT_CYCLES = 20000000000LL;   // ~10 s
constexpr int DW_BM = 64;          // dW tile: rows of W (k)
constexpr int DW_BN = 64;          // dW tile: columns of [Wg | Wc] (j)
constexpr int DW_BK = 16;          // dW tile: (b, t) rows per stage
constexpr int DW_THREADS = 64;     // 8 x 8 outputs each
constexpr int N_FWD_STAMPS = 9;    // per step, see gru_fwd_kernel
constexpr int N_BWD_STAMPS = 8;    // per step, see gru_bwd_kernel

// activation codes: 0 sigmoid, 1 tanh, 2 relu, 3 linear
__device__ __forceinline__ float act_fwd(int code, float x) {
    switch (code) {
        case 0: return __frcp_rn(1.f + expf(-x));    // = 1 / (1 + e^-x)
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

__device__ __forceinline__ float4 zero4() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The launch plan as the kernels read it.
struct Plan {
    int groups;        // G_b
    int ctas;          // G_c, CTAs per group
    int rows;          // R, batch rows per group
    int rows_pad;      // R rounded up to 8 (the row tiles)
    int units;         // U = D / G_c
    int chunk;         // forward: rows of the group's state staged at once
};

// The group barrier: every CTA of the group arrives (release, after the
// CTA's own barrier, so its threads' writes go with it) and waits until
// all G_c of this barrier's generation have (acquire, then the CTA's
// barrier).  `gen` counts the group's barriers so far, the same in all of
// its CTAs; the counter was zeroed before the launch.  With one CTA a group
// it is __syncthreads.  A wait of ~10 s traps (the launch fails, the
// caller sees the error) rather than hang the card.
__device__ __forceinline__ void group_barrier(unsigned int* counter,
                                              int n_ctas, unsigned int& gen) {
    __syncthreads();
    if (n_ctas > 1) {
        ++gen;
        if (threadIdx.x == 0) {
            asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                         :: "l"(counter) : "memory");
            const unsigned int want = gen * (unsigned int)n_ctas;
            const long long t0 = clock64();
            unsigned int seen;
            do {
                asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                             : "=r"(seen) : "l"(counter) : "memory");
                // a CTA of the group that never arrives is a fault of the
                // launch: end it with an error instead of spinning forever
                if (seen < want && clock64() - t0 > BARRIER_TIMEOUT_CYCLES)
                    __trap();
            } while (seen < want);
        }
        __syncthreads();
    }
}

// The lengths of the group's rows into shared memory (0 beyond B); returns
// the largest.  Ends in a __syncthreads.
__device__ __forceinline__ int load_lens(const int* __restrict__ lens,
                                         int* len_s, int b0, int rows_pad,
                                         int rows, int B) {
    for (int r = threadIdx.x; r < rows_pad; r += blockDim.x) {
        const int b = b0 + r;
        len_s[r] = (r < rows && b < B) ? lens[b] : 0;
    }
    __syncthreads();
    int max_len = 0;
    for (int r = 0; r < rows_pad; ++r) max_len = max(max_len, len_s[r]);
    return max_len;
}

// CTA 0 of a `_phases` launch: clock64() into stamps[i] once the CTA has
// reached this point.
template <bool PH>
__device__ __forceinline__ void stamp(long long* stamps, int i) {
    if constexpr (PH) {
        if (stamps != nullptr) {
            __syncthreads();
            if (threadIdx.x == 0) stamps[i] = clock64();
        }
    }
}

// How many ranges of k a product's tiles split into so that `tiles` items
// fill the block (at most MAX_KS: each output sums that many partials).
__device__ __forceinline__ int k_splits(int tiles) {
    return tiles >= (int)blockDim.x ? 1 : min(MAX_KS, (int)blockDim.x / tiles);
}

// The forward's state chunks arrive in K_CHUNKS column ranges, each its own
// cp.async group, so that the product starts on the first range while the
// others are on their way from L2.
constexpr int K_CHUNKS = 4;

__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        default: cp_async_wait<3>(); break;
    }
}

// Starts copying rows [r0, r0 + C) of a [rows][D] state (row stride ld;
// through L2, as other CTAs of the launch wrote it) into a_s [C][D + 4]:
// K_CHUNKS commit groups of D / K_CHUNKS columns each; rows that are not
// live read 0.
__device__ __forceinline__ void stage_state(
        const float* src, size_t ld, int r0, int C, int live_rows, int D,
        float* a_s) {
    const int KQc = D / 4 / K_CHUNKS, ldA = D + 4;
    for (int q = 0; q < K_CHUNKS; ++q) {
        for (int i = threadIdx.x; i < C * KQc; i += blockDim.x) {
            const int rr = i / KQc, kq = q * KQc + (i - rr * KQc);
            const bool ok = r0 + rr < live_rows;
            cp_async16(a_s + rr * ldA + kq * 4,
                       ok ? src + (r0 + rr) * ld + kq * 4 : src, ok);
        }
        cp_async_commit();
    }
}

// The forward's products, over a chunk staged by stage_state.
// part_s[ks][rr][n] (rr < C, n < N) is the sum over k = 4 (ks + KS m) + e
// < D of a_s[rr][k] w_s[k][col0 + n]; w_s is the CTA's weight columns
// [D][ldw].  A thread owns RT = 4 rows x 4 columns (at most one such item:
// the plan keeps tiles x KS within the block, and so the partial sums
// within 16 floats a thread), both operands 16-byte loads; the column
// ranges are taken in the order they were asked for, each once it has
// arrived.  part_s may be a_s itself: it is written once every thread is
// done reading.
constexpr int RT = 4;

__device__ __forceinline__ int part_splits(int C, int N) {
    return k_splits((C / RT) * (N / 4));
}

__device__ __forceinline__ void matvec_part(
        const float* w_s, int ldw, int col0, int N, const float* a_s,
        float* part_s, int C, int D) {
    const int tn = N / 4, tiles = (C / RT) * tn, KS = k_splits(tiles);
    const int KQc = D / 4 / K_CHUNKS, ldA = D + 4;
    const int item = threadIdx.x;
    const bool active = item < tiles * KS;
    const int tile = item % tiles, ks = item / tiles;
    const int rt = tile / tn, nq = tile - rt * tn;
    const float* a0 = a_s + (size_t)rt * RT * ldA;
    const float* w0 = w_s + col0 + nq * 4;
    float4 acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = zero4();
    for (int q = 0; q < K_CHUNKS; ++q) {
        cp_async_wait_n(K_CHUNKS - 1 - q);
        __syncthreads();
        if (!active) continue;
        const int kq_lo = q * KQc, kq_hi = kq_lo + KQc;
        for (int kq = kq_lo + ((ks - kq_lo) % KS + KS) % KS; kq < kq_hi;
             kq += KS) {
            const int k = 4 * kq;
            float4 w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                w[i] = *reinterpret_cast<const float4*>(
                    w0 + (size_t)(k + i) * ldw);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float4 a =
                    *reinterpret_cast<const float4*>(a0 + r * ldA + k);
                fma4(acc[r], a.x, w[0]);
                fma4(acc[r], a.y, w[1]);
                fma4(acc[r], a.z, w[2]);
                fma4(acc[r], a.w, w[3]);
            }
        }
    }
    __syncthreads();                 // part_s takes a_s's room
    if (active) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
            *reinterpret_cast<float4*>(
                part_s + ((size_t)ks * C + rt * RT + r) * N + nq * 4) = acc[r];
    }
}

// Column n of chunk row rr of the product: the k-splits summed in order.
__device__ __forceinline__ float part_sum(const float* part_s, int KS, int C,
                                          int N, int rr, int n) {
    float s = 0.f;
    for (int ks = 0; ks < KS; ++ks) s += part_s[((size_t)ks * C + rr) * N + n];
    return s;
}

// Starts copying, for `nseg` segments of U columns each at column offsets
// 0, seg_stride, 2 seg_stride .. of a [B, T, width] tensor, the CTA's
// units (d0 ..) of rows
// [0, R_pad) at time t into dst [R_pad][ld] (at dst + seg U; cp.async, one
// commit group; rows beyond `live` zero-filled).  Waited for with
// cp_async_wait<0>() and a __syncthreads.
__device__ __forceinline__ void prefetch_rows(
        const float* src, int width, int T, int t, int nseg, int seg_stride,
        int b0, int live, int Rp, int U, int d0, float* dst, int ld) {
    const int UQ = U / 4, per_row = nseg * UQ;
    for (int i = threadIdx.x; i < Rp * per_row; i += blockDim.x) {
        const int r = i / per_row, q = i - r * per_row;
        const int seg = q / UQ, qq = q - seg * UQ;
        const bool ok = r < live;
        const float* from = ok
            ? src + ((size_t)(b0 + r) * T + t) * width + seg * seg_stride
                  + d0 + qq * 4
            : src;
        cp_async16(dst + (size_t)r * ld + seg * U + qq * 4, from, ok);
    }
    cp_async_commit();
}

// Shared memory of the forward (floats, then the lengths): the CTA's weight
// columns [D][3U], a state chunk [C][D + 4] whose room the products' k-split
// partial sums (at most 16 a thread) take once it has been read, its units'
// h and u [R_pad][U], two steps' inputs x3 of its units [2][R_pad][3U].
// ops/gru_fused.py `gru_plan` computes the same.
size_t fwd_smem_bytes(int D, const Plan& p) {
    const int U = p.units, C = p.chunk;
    const size_t chunk = (size_t)C * (D + 4), part = 16 * (size_t)THREADS;
    const size_t floats = (size_t)D * 3 * U + (chunk > part ? chunk : part)
        + 8 * (size_t)p.rows_pad * U;
    return floats * sizeof(float) + (size_t)p.rows_pad * sizeof(int);
}

// The forward.  CTA (group g, slice c) owns batch rows [g R, g R + R) and
// hidden units [c U, c U + U).  Per step (time t, scan order s), unless
// every row of the group is frozen there:
//   phase 1: the group's h (h0, or hs at the last step that changed it)
//            staged chunk by chunk; h Wg for the CTA's u and r columns;
//            u, r of its units; r h written to exch, u kept;
//   barrier;
//   phase 2: the group's r h staged; (r h) Wc for its c columns; c and the
//            new h (kept where t >= len) of its units into hs;
//   barrier.
// `gates` (may be null) gets u, r, c [B, T, 3D] of the live rows.  Stamps
// (a `_phases` launch, CTA 0): per step [start, h staged, h Wg, gates,
// barrier 1, r h staged, (r h) Wc, new h, barrier 2] — the chunk loop's
// points as its last chunk left them.
template <bool PH>
__global__ void __launch_bounds__(THREADS, 1) gru_fwd_kernel(
        const float* __restrict__ x3, const float* __restrict__ wg, int ldg,
        const float* __restrict__ wc, int ldc, const int* __restrict__ lens,
        const float* __restrict__ h0, float* hs, float* gates, float* exch,
        unsigned int* counters, int B, int T, int D, Plan p, int reverse,
        int act, int gate, long long* stamps) {
    extern __shared__ __align__(16) float smem[];
    const int U = p.units, U3 = 3 * U, Rp = p.rows_pad, C = p.chunk;
    const int D3 = 3 * D;
    const int g = blockIdx.x / p.ctas, c = blockIdx.x - g * p.ctas;
    const int d0 = c * U, b0 = g * p.rows;
    const int live = max(0, min(p.rows, B - b0));     // rows of the batch
    const int KS1 = part_splits(C, 2 * U), KS2 = part_splits(C, U);
    float* w_s = smem;                                 // [D][3U] u | r | c
    float* a_s = w_s + (size_t)D * U3;                 // [C][D + 4]
    float* part_s = a_s;                               // after the product
    float* h_own = a_s + max(C * (D + 4), 16 * THREADS);  // [Rp][U]
    float* u_own = h_own + Rp * U;                     // [Rp][U]
    float* x_s = u_own + Rp * U;                       // [2][Rp][3U]
    int* len_s = reinterpret_cast<int*>(x_s + 2 * Rp * U3);
    float* exch_g = exch + (size_t)g * Rp * D;         // [Rp][D] r h
    unsigned int* counter = counters + g;
    unsigned int gen = 0;
    long long* st = (PH && blockIdx.x == 0) ? stamps : nullptr;

    const int max_len = load_lens(lens, len_s, b0, Rp, p.rows, B);
    const int UQ = U3 / 4;
    for (int i = threadIdx.x; i < D * UQ; i += blockDim.x) {
        const int k = i / UQ, col = 4 * (i - k * UQ);
        const int which = col / U, off = col - which * U;
        const float* src = which == 2
            ? wc + (size_t)k * ldc + d0 + off
            : wg + (size_t)k * ldg + which * D + d0 + off;
        reinterpret_cast<float4*>(w_s)[i] =
            __ldg(reinterpret_cast<const float4*>(src));
    }
    for (int i = threadIdx.x; i < Rp * U; i += blockDim.x) {
        const int r = i / U, j = i - r * U;
        h_own[i] = r < live ? h0[(size_t)(b0 + r) * D + d0 + j] : 0.f;
    }
    __syncthreads();

    int src_t = -1;              // the last step that changed h; -1: h0
    bool fetched = false;        // this step's x3 already on its way
    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        if (t >= max_len) {      // uniform over the group's CTAs
            for (int i = threadIdx.x; i < live * U; i += blockDim.x) {
                const int r = i / U, j = i - r * U;
                hs[((size_t)(b0 + r) * T + t) * D + d0 + j] = h_own[i];
            }
            continue;
        }
        long long* sts = st ? st + (size_t)s * N_FWD_STAMPS : nullptr;
        stamp<PH>(sts, 0);
        const float* xs = x_s + (size_t)(s & 1) * Rp * U3;
        if (!fetched)
            prefetch_rows(x3, D3, T, t, 3, D, b0, live, Rp, U, d0,
                          x_s + (size_t)(s & 1) * Rp * U3, U3);
        const float* h_src = src_t < 0 ? h0 + (size_t)b0 * D
                                       : hs + ((size_t)b0 * T + src_t) * D;
        const size_t h_ld = src_t < 0 ? (size_t)D : (size_t)T * D;
        for (int r0 = 0; r0 < Rp; r0 += C) {
            stage_state(h_src, h_ld, r0, C, live, D, a_s);
            stamp<PH>(sts, 1);
            matvec_part(w_s, U3, 0, 2 * U, a_s, part_s, C, D);
            cp_async_wait<0>();
            __syncthreads();
            stamp<PH>(sts, 2);
            for (int i = threadIdx.x; i < C * U; i += blockDim.x) {
                const int rr = i / U, j = i - rr * U, r = r0 + rr;
                const size_t xo = ((size_t)(b0 + r) * T + t) * D3 + d0 + j;
                const float u = act_fwd(
                    gate, part_sum(part_s, KS1, C, 2 * U, rr, j)
                              + xs[r * U3 + j]);
                const float rv = act_fwd(
                    gate, part_sum(part_s, KS1, C, 2 * U, rr, U + j)
                              + xs[r * U3 + U + j]);
                u_own[r * U + j] = u;
                exch_g[(size_t)r * D + d0 + j] = rv * h_own[r * U + j];
                if (gates != nullptr && r < live) {
                    gates[xo] = u;
                    gates[xo + D] = rv;
                }
            }
            __syncthreads();
        }
        stamp<PH>(sts, 3);
        group_barrier(counter, p.ctas, gen);
        stamp<PH>(sts, 4);
        for (int r0 = 0; r0 < Rp; r0 += C) {
            stage_state(exch_g, (size_t)D, r0, C, Rp, D, a_s);
            stamp<PH>(sts, 5);
            matvec_part(w_s, U3, 2 * U, U, a_s, part_s, C, D);
            __syncthreads();
            stamp<PH>(sts, 6);
            for (int i = threadIdx.x; i < C * U; i += blockDim.x) {
                const int rr = i / U, j = i - rr * U, r = r0 + rr;
                if (t < len_s[r]) {          // live, and not frozen
                    const size_t xo =
                        ((size_t)(b0 + r) * T + t) * D3 + d0 + j;
                    const float zc = part_sum(part_s, KS2, C, U, rr, j)
                        + xs[r * U3 + 2 * U + j];
                    const float cv = act_fwd(act, zc);
                    const float u = u_own[r * U + j], h = h_own[r * U + j];
                    h_own[r * U + j] = u * h + (1.f - u) * cv;
                    if (gates != nullptr) gates[xo + 2 * D] = cv;
                }
                if (r < live)
                    hs[((size_t)(b0 + r) * T + t) * D + d0 + j] =
                        h_own[r * U + j];
            }
            __syncthreads();
        }
        // the next step's x3, on its way while the group meets
        const int t_next = reverse ? T - 2 - s : s + 1;
        fetched = s + 1 < T && t_next < max_len;
        if (fetched)
            prefetch_rows(x3, D3, T, t_next, 3, D, b0, live, Rp, U, d0,
                          x_s + (size_t)((s + 1) & 1) * Rp * U3, U3);
        stamp<PH>(sts, 7);
        group_barrier(counter, p.ctas, gen);
        stamp<PH>(sts, 8);
        src_t = t;
    }
    cp_async_wait<0>();
}

// The backward's products.  out[r][k] (r < R_pad, k < D; a CTA's slice of
// scratch, written through L2) = sum over j in [j0, j0 + J) of
// zT_s[j][r] wT_s[j][k]: the partial sums over the CTA's own columns of
// z W^T.  A thread owns 8 rows x 4 k; the weight is 16-byte loads along k,
// the operand two broadcast 16-byte loads.
__device__ __forceinline__ void matvec_t(const float* wT_s, const float* zT_s,
                                         int j0, int J, int Rp, int D,
                                         float* out) {
    const int KQ = D / 4, items = (Rp / 8) * KQ;
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        const int rt = item / KQ, kq = item - rt * KQ;
        float4 acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = zero4();
        for (int j = j0; j < j0 + J; ++j) {
            const float4 w =
                *reinterpret_cast<const float4*>(wT_s + (size_t)j * D + kq * 4);
            const float4 a0 =
                *reinterpret_cast<const float4*>(zT_s + j * Rp + rt * 8);
            const float4 a1 =
                *reinterpret_cast<const float4*>(zT_s + j * Rp + rt * 8 + 4);
            fma4(acc[0], a0.x, w);
            fma4(acc[1], a0.y, w);
            fma4(acc[2], a0.z, w);
            fma4(acc[3], a0.w, w);
            fma4(acc[4], a1.x, w);
            fma4(acc[5], a1.y, w);
            fma4(acc[6], a1.z, w);
            fma4(acc[7], a1.w, w);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
            __stcg(reinterpret_cast<float4*>(out + (size_t)(rt * 8 + i) * D
                                             + kq * 4), acc[i]);
    }
}

// Row r, unit d0 + j of a product: the group's CTAs' partial sums
// ([G_c][R_pad][D] from scr_g) added in CTA order, SUM_LOADS loads in
// flight at a time.
constexpr int SUM_LOADS = 16;

__device__ __forceinline__ float slice_sum(const float* scr_g, int n_ctas,
                                           int Rp, int D, int r, int d) {
    const float* p = scr_g + (size_t)r * D + d;
    const size_t step = (size_t)Rp * D;
    float s = 0.f;
    int cc = 0;
    for (; cc + SUM_LOADS <= n_ctas; cc += SUM_LOADS) {
        float v[SUM_LOADS];
#pragma unroll
        for (int m = 0; m < SUM_LOADS; ++m) v[m] = __ldcg(p + (cc + m) * step);
#pragma unroll
        for (int m = 0; m < SUM_LOADS; ++m) s += v[m];
    }
    for (; cc < n_ctas; ++cc) s += __ldcg(p + cc * step);
    return s;
}

// Starts copying the inputs of walk step s for the CTA's units into ys
// [R_pad][5U]: g_hs, u, r, c at its time t, and h_prev (h0 at s = 0, else
// hs at the previous scan step's time).
__device__ __forceinline__ void prefetch_bwd_step(
        int s, int T, int reverse, const float* g_hs, const float* gates,
        const float* hs, const float* h0, int D, int b0, int live, int Rp,
        int U, int d0, float* ys) {
    const int t = reverse ? T - 1 - s : s, U5 = 5 * U;
    prefetch_rows(g_hs, D, T, t, 1, 0, b0, live, Rp, U, d0, ys, U5);
    prefetch_rows(gates, 3 * D, T, t, 3, D, b0, live, Rp, U, d0, ys + U, U5);
    if (s == 0)
        prefetch_rows(h0, D, 1, 0, 1, 0, b0, live, Rp, U, d0, ys + 4 * U,
                      U5);
    else
        prefetch_rows(hs, D, T, reverse ? t + 1 : t - 1, 1, 0, b0, live, Rp,
                      U, d0, ys + 4 * U, U5);
}

// Shared memory of the backward walk (floats, then the lengths): the CTA's
// weight columns transposed [3U][D], the step's [dzu | dzr | dzc]
// transposed [3U][R_pad], six [R_pad][U] arrays of its units' state, two
// steps' inputs [2][R_pad][5U] (g_hs, u, r, c, h_prev of its units).
size_t bwd_smem_bytes(int D, const Plan& p) {
    const int U = p.units, Rp = p.rows_pad;
    const size_t floats = (size_t)3 * U * D + (size_t)3 * U * Rp
        + (size_t)6 * Rp * U + (size_t)10 * Rp * U;
    return floats * sizeof(float) + (size_t)Rp * sizeof(int);
}

// The reverse walk, from the forward's saved gates [B, T, 3D] (u, r, c).
// Per step s (scan order T-1 .. 0; time t as in the forward; h_prev = h0
// at s = 0, else hs at the previous scan step's time), for the CTA's units:
//   dh_total = dh + g_hs[t]
//   dzu = dh_total (h_prev - c) gate'(u)     dzc = dh_total (1 - u) act'(c)
//   phase A: drh = dzc Wc^T (partials, barrier, own k-slice summed)
//   dzr = drh h_prev gate'(r)
//   phase B: dhg = [dzu, dzr] Wg^T (likewise)
//   dh <- dh_total u + drh r + dhg
// and on a frozen row (t >= len) dx3 = 0, dh <- dh_total; a step at which
// the whole group is frozen skips the products and the barriers.  aop
// [B, T, 2D] gets [h_prev, r h_prev] of valid rows (0 elsewhere), the
// operands of the weight gradients.  Stamps (a `_phases` launch, CTA 0):
// per step [start, dzu and dzc, product A, barrier A, dzr, product B,
// barrier B, dh].
template <bool PH>
__global__ void __launch_bounds__(THREADS, 1) gru_bwd_kernel(
        const float* __restrict__ wg, int ldg, const float* __restrict__ wc,
        int ldc, const int* __restrict__ lens, const float* __restrict__ h0,
        const float* __restrict__ hs, const float* __restrict__ gates,
        const float* __restrict__ g_hs, const float* __restrict__ g_hl,
        float* __restrict__ dx, float* __restrict__ dh0,
        float* __restrict__ aop, float* scr_a, float* scr_b,
        unsigned int* counters, int B, int T, int D, Plan p, int reverse,
        int act, int gate, long long* stamps) {
    extern __shared__ __align__(16) float smem[];
    const int U = p.units, U3 = 3 * U, Rp = p.rows_pad, D2 = 2 * D;
    const int D3 = 3 * D;
    const int g = blockIdx.x / p.ctas, c = blockIdx.x - g * p.ctas;
    const int d0 = c * U, b0 = g * p.rows;
    const int live = max(0, min(p.rows, B - b0));
    float* wT_s = smem;                            // [3U][D]
    float* zT_s = wT_s + (size_t)U3 * D;           // [3U][Rp] dzu|dzr|dzc
    float* dh_s = zT_s + (size_t)U3 * Rp;          // [Rp][U] each:
    float* dht_s = dh_s + Rp * U;                  //   dh_total
    float* u_s = dht_s + Rp * U;
    float* r_s = u_s + Rp * U;
    float* hp_s = r_s + Rp * U;                    //   h_prev
    float* drh_s = hp_s + Rp * U;
    float* y_s = drh_s + Rp * U;                   // [2][Rp][5U]
    int* len_s = reinterpret_cast<int*>(y_s + 2 * Rp * 5 * U);
    const int U5 = 5 * U;
    bool fetched = false;          // this step's inputs already on their way
    const size_t scr_group = (size_t)g * p.ctas * Rp * D;
    float* scr_a_own = scr_a + scr_group + (size_t)c * Rp * D;
    float* scr_b_own = scr_b + scr_group + (size_t)c * Rp * D;
    unsigned int* counter = counters + g;
    unsigned int gen = 0;
    long long* st = (PH && blockIdx.x == 0) ? stamps : nullptr;

    const int max_len = load_lens(lens, len_s, b0, Rp, p.rows, B);
    for (int i = threadIdx.x; i < U3 * D; i += blockDim.x) {
        const int j = i / D, k = i - j * D;
        const int which = j / U, jj = j - which * U;
        wT_s[i] = which == 2 ? wc[(size_t)k * ldc + d0 + jj]
                             : wg[(size_t)k * ldg + which * D + d0 + jj];
    }
    for (int i = threadIdx.x; i < Rp * U; i += blockDim.x) {
        const int r = i / U, j = i - r * U;
        dh_s[i] = r < live ? g_hl[(size_t)(b0 + r) * D + d0 + j] : 0.f;
    }
    __syncthreads();

    for (int s = T - 1; s >= 0; --s) {
        const int t = reverse ? T - 1 - s : s;
        if (t >= max_len) {      // uniform over the group's CTAs
            for (int i = threadIdx.x; i < live * U; i += blockDim.x) {
                const int r = i / U, j = i - r * U;
                const size_t o = (size_t)(b0 + r) * T + t;
                dh_s[i] += g_hs[o * D + d0 + j];
                dx[o * D3 + d0 + j] = 0.f;
                dx[o * D3 + D + d0 + j] = 0.f;
                dx[o * D3 + D2 + d0 + j] = 0.f;
                aop[o * D2 + d0 + j] = 0.f;
                aop[o * D2 + D + d0 + j] = 0.f;
            }
            continue;
        }
        long long* sts =
            st ? st + (size_t)(T - 1 - s) * N_BWD_STAMPS : nullptr;
        stamp<PH>(sts, 0);
        if (!fetched)
            prefetch_bwd_step(s, T, reverse, g_hs, gates, hs, h0, D, b0, live,
                              Rp, U, d0, y_s + (size_t)(s & 1) * Rp * U5);
        cp_async_wait<0>();
        __syncthreads();
        const float* ys = y_s + (size_t)(s & 1) * Rp * U5;
        for (int i = threadIdx.x; i < Rp * U; i += blockDim.x) {
            const int r = i / U, j = i - r * U;
            const bool valid = t < len_s[r];
            const size_t o = (size_t)(b0 + r) * T + t;
            const float* y = ys + r * U5 + j;
            const float gh = y[0], u = y[U], rv = y[2 * U];
            const float cv = valid ? y[3 * U] : 0.f, hp = y[4 * U];
            const float dht = dh_s[i] + gh;
            const float dzc = valid ? dht * (1.f - u) * act_grad(act, cv) : 0.f;
            const float dzu = valid ? dht * (hp - cv) * act_grad(gate, u) : 0.f;
            dht_s[i] = dht;
            u_s[i] = u;
            r_s[i] = rv;
            hp_s[i] = hp;
            zT_s[j * Rp + r] = dzu;
            zT_s[(2 * U + j) * Rp + r] = dzc;
            if (r < live) {
                dx[o * D3 + d0 + j] = dzu;
                dx[o * D3 + D2 + d0 + j] = dzc;
                aop[o * D2 + d0 + j] = valid ? hp : 0.f;
                aop[o * D2 + D + d0 + j] = valid ? rv * hp : 0.f;
            }
        }
        __syncthreads();
        // the next walk step's inputs, on their way while the group works
        fetched = s > 0 && (reverse ? T - s : s - 1) < max_len;
        if (fetched)
            prefetch_bwd_step(s - 1, T, reverse, g_hs, gates, hs, h0, D, b0,
                              live, Rp, U, d0,
                              y_s + (size_t)((s - 1) & 1) * Rp * U5);
        stamp<PH>(sts, 1);
        matvec_t(wT_s, zT_s, 2 * U, U, Rp, D, scr_a_own);
        stamp<PH>(sts, 2);
        group_barrier(counter, p.ctas, gen);
        stamp<PH>(sts, 3);
        const float* scr_a_g = scr_a + scr_group;
        for (int i = threadIdx.x; i < Rp * U; i += blockDim.x) {
            const int r = i / U, j = i - r * U;
            const bool valid = t < len_s[r];
            const float drh = slice_sum(scr_a_g, p.ctas, Rp, D, r, d0 + j);
            const float dzr = valid
                ? drh * hp_s[i] * act_grad(gate, r_s[i]) : 0.f;
            drh_s[i] = drh;
            zT_s[(U + j) * Rp + r] = dzr;
            if (r < live)
                dx[((size_t)(b0 + r) * T + t) * D3 + D + d0 + j] = dzr;
        }
        __syncthreads();
        stamp<PH>(sts, 4);
        matvec_t(wT_s, zT_s, 0, 2 * U, Rp, D, scr_b_own);
        stamp<PH>(sts, 5);
        group_barrier(counter, p.ctas, gen);
        stamp<PH>(sts, 6);
        const float* scr_b_g = scr_b + scr_group;
        for (int i = threadIdx.x; i < Rp * U; i += blockDim.x) {
            const int r = i / U, j = i - r * U;
            const float dhg = slice_sum(scr_b_g, p.ctas, Rp, D, r, d0 + j);
            const float dht = dht_s[i];
            dh_s[i] = t < len_s[r]
                ? dht * u_s[i] + drh_s[i] * r_s[i] + dhg : dht;
        }
        __syncthreads();
        stamp<PH>(sts, 7);
    }
    cp_async_wait<0>();
    for (int i = threadIdx.x; i < live * U; i += blockDim.x) {
        const int r = i / U, j = i - r * U;
        dh0[(size_t)(b0 + r) * D + d0 + j] = dh_s[i];
    }
}

// Weight gradients over one range of the (b, t) rows n: C[k][j] = sum_n
// aop[n][a(j) + k] dx[n][j], a(j) = 0 for the gate columns j < 2D (h_prev)
// and D for the candidate columns (r h_prev).  A [64 x 64] tile per CTA,
// 8 x 8 outputs a thread (two 4-wide runs of k and of j, 16-byte shared
// loads), 16 rows n a stage, two stages in flight through cp.async (rows
// and columns beyond the edges zero-filled).  Written to dwg / dwc when
// `direct` (one range), else to part[z] for gru_reduce_kernel.  2D is a
// multiple of 64, so a tile lies within one of the two weights.
// One stage of the dW product: rows [n0, n0 + DW_BK) of the operands, the
// tile's k columns of aop and j columns of dx, into a_s / b_s (cp.async,
// one commit group; beyond the edges zero-filled).
__device__ __forceinline__ void dw_load_stage(
        const float* aop, const float* dx, float* a_s, float* b_s, int n0,
        int n_end, int k0, int j0, int acol, int D) {
    const int tid = threadIdx.x;
    for (int q = tid; q < DW_BK * DW_BM / 4; q += DW_THREADS) {
        const int nn = q / (DW_BM / 4), kq = q - nn * (DW_BM / 4);
        const int n = n0 + nn;
        const bool ok = n < n_end && k0 + kq * 4 < D;
        cp_async16(a_s + nn * DW_BM + kq * 4,
                   ok ? aop + (size_t)n * 2 * D + acol + kq * 4 : aop, ok);
    }
    for (int q = tid; q < DW_BK * DW_BN / 4; q += DW_THREADS) {
        const int nn = q / (DW_BN / 4), jq = q - nn * (DW_BN / 4);
        const int n = n0 + nn;
        const bool ok = n < n_end && j0 + jq * 4 < 3 * D;
        cp_async16(b_s + nn * DW_BN + jq * 4,
                   ok ? dx + (size_t)n * 3 * D + j0 + jq * 4 : dx, ok);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(DW_THREADS) gru_dw_kernel(
        const float* __restrict__ aop, const float* __restrict__ dx,
        float* __restrict__ dwg, float* __restrict__ dwc,
        float* __restrict__ part, int N, int D, int rows_per_split,
        int direct) {
    __shared__ __align__(16) float a_s[2][DW_BK][DW_BM];
    __shared__ __align__(16) float b_s[2][DW_BK][DW_BN];
    const int D2 = 2 * D, D3 = 3 * D;
    const int j0 = blockIdx.x * DW_BN, k0 = blockIdx.y * DW_BM;
    const int acol = (j0 < D2 ? 0 : D) + k0;
    const int n_begin = blockIdx.z * rows_per_split;
    const int n_end = min(N, n_begin + rows_per_split);
    const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
    const int n_stages = n_end > n_begin
        ? (n_end - n_begin + DW_BK - 1) / DW_BK : 0;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (n_stages > 0)
        dw_load_stage(aop, dx, &a_s[0][0][0], &b_s[0][0][0], n_begin, n_end,
                      k0, j0, acol, D);
    for (int st = 0; st < n_stages; ++st) {
        if (st + 1 < n_stages) {
            const int nxt = (st + 1) & 1;
            dw_load_stage(aop, dx, &a_s[nxt][0][0], &b_s[nxt][0][0],
                          n_begin + (st + 1) * DW_BK, n_end, k0, j0, acol, D);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int cur = st & 1;
#pragma unroll
        for (int nn = 0; nn < DW_BK; ++nn) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(&a_s[cur][nn][ty * 4]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&a_s[cur][nn][32 + ty * 4]);
            const float4 b0 =
                *reinterpret_cast<const float4*>(&b_s[cur][nn][tx * 4]);
            const float4 b1 =
                *reinterpret_cast<const float4*>(&b_s[cur][nn][32 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int k = k0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
        if (k >= D) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = j0 + h * 32 + tx * 4;
            if (j >= D3) continue;
            const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                         acc[i][4 * h + 2], acc[i][4 * h + 3]);
            float* dst = !direct
                ? part + ((size_t)blockIdx.z * D + k) * D3 + j
                : j < D2 ? dwg + (size_t)k * D2 + j
                         : dwc + (size_t)k * D + j - D2;
            *reinterpret_cast<float4*>(dst) = v;
        }
    }
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

// The plan's invariants: every batch row in exactly one group (no group
// empty), every hidden unit owned by one CTA of a group, slices of whole
// 16-byte units, row tiles of 8, the forward's state chunks dividing them
// and small enough that each thread owns at most one product tile.
bool plan_ok(int B, int D, const Plan& p) {
    return p.groups >= 1 && p.ctas >= 1 && p.rows >= 1 && p.units >= 4
        && p.units % 4 == 0 && p.ctas * p.units == D
        && p.rows_pad == (p.rows + 7) / 8 * 8
        && p.chunk >= 4 && p.chunk % 4 == 0 && p.rows_pad % p.chunk == 0
        && (p.chunk / 4) * (p.units / 2) <= THREADS
        && (long long)p.groups * p.rows >= B
        && (long long)(p.groups - 1) * p.rows < B;
}

bool shape_ok(int B, int T, int D) {
    return B >= 1 && T >= 1 && D >= 32 && D <= 512 && D % 32 == 0;
}

// Both weights 16-byte aligned with row strides of whole 16-byte units that
// hold their columns.
bool weights_ok(const void* wg, int ldg, const void* wc, int ldc, int D) {
    return ((size_t)wg & 15) == 0 && ((size_t)wc & 15) == 0
        && ldg % 4 == 0 && ldc % 4 == 0 && ldg >= 2 * D && ldc >= D;
}

// Sets the kernel's dynamic shared memory and checks that `grid` CTAs of it
// can all be resident on this device (a cooperative launch needs that).
cudaError_t prepare_cooperative(const void* kernel, int threads, size_t smem,
                                int grid) {
    int dev = 0, limit = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)limit) return cudaErrorInvalidValue;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if ((long long)per_sm * sms < grid)
        return cudaErrorCooperativeLaunchTooLarge;
    return cudaSuccess;
}

template <bool PH>
cudaError_t launch_fwd(const float* x3, const float* wg, int ldg,
                       const float* wc, int ldc, const int* lens,
                       const float* h0, float* hs, float* gates, float* exch,
                       unsigned int* counters, int B, int T, int D,
                       Plan p, int reverse, int act, int gate,
                       long long* stamps, cudaStream_t stream) {
    const void* fn = reinterpret_cast<const void*>(&gru_fwd_kernel<PH>);
    const size_t smem = fwd_smem_bytes(D, p);
    const int grid = p.groups * p.ctas;
    cudaError_t err = prepare_cooperative(fn, THREADS, smem, grid);
    if (err != cudaSuccess) return err;
    void* args[] = {&x3, &wg, &ldg, &wc, &ldc, &lens, &h0, &hs, &gates,
                    &exch, &counters, &B, &T, &D, &p, &reverse, &act, &gate,
                    &stamps};
    return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS),
                                       args, smem, stream);
}

template <bool PH>
cudaError_t launch_bwd_walk(const float* wg, int ldg, const float* wc,
                            int ldc, const int* lens, const float* h0,
                            const float* hs, const float* gates,
                            const float* g_hs, const float* g_hl, float* dx,
                            float* dh0, float* aop, float* scr_a,
                            float* scr_b, unsigned int* counters, int B,
                            int T, int D, Plan p, int reverse, int act,
                            int gate, long long* stamps,
                            cudaStream_t stream) {
    const void* fn = reinterpret_cast<const void*>(&gru_bwd_kernel<PH>);
    const size_t smem = bwd_smem_bytes(D, p);
    const int grid = p.groups * p.ctas;
    cudaError_t err = prepare_cooperative(fn, THREADS, smem, grid);
    if (err != cudaSuccess) return err;
    void* args[] = {&wg, &ldg, &wc, &ldc, &lens, &h0, &hs, &gates, &g_hs,
                    &g_hl, &dx, &dh0, &aop, &scr_a, &scr_b, &counters, &B,
                    &T, &D, &p, &reverse, &act, &gate, &stamps};
    return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS),
                                       args, smem, stream);
}

// The weight-gradient product over the walk's aop and dx, then (splits > 1)
// the ordered sum of its splits.
cudaError_t launch_dw(const float* aop, const float* dx, float* dwg,
                      float* dwc, float* dw_part, int splits, int B, int T,
                      int D, cudaStream_t stream) {
    const int N = B * T;
    const int rows_per_split = (N + splits - 1) / splits;
    dim3 grid((3 * D + DW_BN - 1) / DW_BN, (D + DW_BM - 1) / DW_BM, splits);
    gru_dw_kernel<<<grid, DW_THREADS, 0, stream>>>(
        aop, dx, dwg, dwc, dw_part, N, D, rows_per_split, splits == 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const int n_dw = D * 3 * D;
    gru_reduce_kernel<<<(n_dw + 255) / 256, 256, 0, stream>>>(
        dw_part, dwg, dwc, D, splits);
    return cudaGetLastError();
}

Plan make_plan(int groups, int ctas, int rows, int units, int chunk) {
    return Plan{groups, ctas, rows, (rows + 7) / 8 * 8, units, chunk};
}

}  // namespace

extern "C" {

// hs [B, T, D] <- the recurrence over x3 [B, T, 3D]; wg [D, 2D] and wc
// [D, D] with row strides ldg, ldc; gates [B, T, 3D] (u, r, c) or null;
// scratch: exch [groups * rows_pad, D] and counters [groups] (zeroed).  The
// plan: `groups` groups of `rows` batch rows, `ctas` CTAs of `units`
// hidden units each, the forward staging `chunk` rows at once.
int gru_fwd_launch(const void* x3, const void* wg, int ldg, const void* wc,
                   int ldc, const void* lens, const void* h0, void* hs,
                   void* gates, void* exch, void* counters, int B, int T,
                   int D, int reverse, int act, int gate, int groups,
                   int ctas, int rows, int units, int chunk, void* stream) {
    const Plan p = make_plan(groups, ctas, rows, units, chunk);
    if (!shape_ok(B, T, D) || !plan_ok(B, D, p)
            || !weights_ok(wg, ldg, wc, ldc, D))
        return (int)cudaErrorInvalidValue;
    return (int)launch_fwd<false>(
        (const float*)x3, (const float*)wg, ldg, (const float*)wc, ldc,
        (const int*)lens, (const float*)h0, (float*)hs, (float*)gates,
        (float*)exch, (unsigned int*)counters, B, T, D, p, reverse, act,
        gate, nullptr, (cudaStream_t)stream);
}

// The reverse walk: dx [B, T, 3D], dh0 [B, D] and the weight gradients'
// operands aop [B, T, 2D] from the stored hs, the forward's gates and the
// cotangents g_hs [B, T, D], g_hl [B, D].  Scratch: scr_a and scr_b
// [groups * ctas * rows_pad, D], counters [groups] (zeroed).
int gru_bwd_launch(const void* wg, int ldg, const void* wc, int ldc,
                   const void* lens, const void* h0, const void* hs,
                   const void* gates, const void* g_hs, const void* g_hl,
                   void* dx, void* dh0, void* aop, void* scr_a, void* scr_b,
                   void* counters, int B, int T, int D, int reverse, int act,
                   int gate, int groups, int ctas, int rows, int units,
                   int chunk, void* stream) {
    const Plan p = make_plan(groups, ctas, rows, units, chunk);
    if (!shape_ok(B, T, D) || !plan_ok(B, D, p)
            || !weights_ok(wg, ldg, wc, ldc, D))
        return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_walk<false>(
        (const float*)wg, ldg, (const float*)wc, ldc, (const int*)lens,
        (const float*)h0, (const float*)hs, (const float*)gates,
        (const float*)g_hs, (const float*)g_hl, (float*)dx, (float*)dh0,
        (float*)aop, (float*)scr_a, (float*)scr_b, (unsigned int*)counters,
        B, T, D, p, reverse, act, gate, nullptr, (cudaStream_t)stream);
}

// dwg [D, 2D] and dwc [D, D] from the walk's aop [B, T, 2D] and dx
// [B, T, 3D], the (b, t) rows in `splits` ranges summed in order; dw_part
// [splits, D, 3D] (unused at 1 split).
int gru_dw_launch(const void* aop, const void* dx, void* dwg, void* dwc,
                  void* dw_part, int splits, int B, int T, int D,
                  void* stream) {
    if (!shape_ok(B, T, D) || splits < 1 || (splits > 1 && !dw_part))
        return (int)cudaErrorInvalidValue;
    return (int)launch_dw((const float*)aop, (const float*)dx, (float*)dwg,
                          (float*)dwc, (float*)dw_part, splits, B, T, D,
                          (cudaStream_t)stream);
}

// Measurement export: the forward kernel (as gru_fwd_launch) or the
// backward walk (as gru_bwd_launch) with CTA
// 0 writing clock64() stamps: [T][9] (forward) or [T][8] (walk, in walk
// order), rows of steps that a frozen group skips left as they were.
int gru_fwd_phases_launch(const void* x3, const void* wg, int ldg,
                          const void* wc, int ldc, const void* lens,
                          const void* h0, void* hs, void* gates, void* exch,
                          void* counters, int B, int T, int D, int reverse,
                          int act, int gate, int groups, int ctas, int rows,
                          int units, int chunk, void* stamps, void* stream) {
    const Plan p = make_plan(groups, ctas, rows, units, chunk);
    if (!shape_ok(B, T, D) || !plan_ok(B, D, p)
            || !weights_ok(wg, ldg, wc, ldc, D))
        return (int)cudaErrorInvalidValue;
    return (int)launch_fwd<true>(
        (const float*)x3, (const float*)wg, ldg, (const float*)wc, ldc,
        (const int*)lens, (const float*)h0, (float*)hs, (float*)gates,
        (float*)exch, (unsigned int*)counters, B, T, D, p, reverse, act,
        gate, (long long*)stamps, (cudaStream_t)stream);
}

int gru_bwd_phases_launch(const void* wg, int ldg, const void* wc, int ldc,
                          const void* lens, const void* h0, const void* hs,
                          const void* gates, const void* g_hs,
                          const void* g_hl, void* dx, void* dh0, void* aop,
                          void* scr_a, void* scr_b, void* counters, int B,
                          int T, int D, int reverse, int act, int gate,
                          int groups, int ctas, int rows, int units,
                          int chunk, void* stamps, void* stream) {
    const Plan p = make_plan(groups, ctas, rows, units, chunk);
    if (!shape_ok(B, T, D) || !plan_ok(B, D, p)
            || !weights_ok(wg, ldg, wc, ldc, D))
        return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_walk<true>(
        (const float*)wg, ldg, (const float*)wc, ldc, (const int*)lens,
        (const float*)h0, (const float*)hs, (const float*)gates,
        (const float*)g_hs, (const float*)g_hl, (float*)dx, (float*)dh0,
        (float*)aop, (float*)scr_a, (float*)scr_b, (unsigned int*)counters,
        B, T, D, p, reverse, act, gate, (long long*)stamps,
        (cudaStream_t)stream);
}

// The runtime's account of a kernel (which: 0 forward, 1 backward walk,
// 2 dW product, 3 ordered sum) for the plan's shared memory at hidden size
// D: out = {registers, local memory bytes per thread, static shared memory
// bytes, dynamic shared memory bytes}.
int gru_kernel_attributes(int which, int D, int groups, int ctas, int rows,
                          int units, int chunk, int* out) {
    const Plan p = make_plan(groups, ctas, rows, units, chunk);
    const void* fns[] = {
        reinterpret_cast<const void*>(&gru_fwd_kernel<false>),
        reinterpret_cast<const void*>(&gru_bwd_kernel<false>),
        reinterpret_cast<const void*>(&gru_dw_kernel),
        reinterpret_cast<const void*>(&gru_reduce_kernel)};
    if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
    size_t dyn = 0;
    if (which < 2) {
        dyn = which == 0 ? fwd_smem_bytes(D, p) : bwd_smem_bytes(D, p);
        cudaError_t err = cudaFuncSetAttribute(
            fns[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)dyn);
        if (err != cudaSuccess) return (int)err;
    }
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = (int)dyn;
    return 0;
}

// The device's SM count and the shared memory a block may opt into, which
// the launch plan is sized against.
int gru_device_limits(int* sm_count, int* smem_optin) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

const char* gru_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
