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
// What bounds it on this card.  A step is one product of the batch's state
// with W (h W gives all four gates), and the T steps depend on each other.
// By the roofline the work is bound by float32 operations (25 us at
// [128, 100, 128]), but W (16 D^2 bytes, 256 KiB at D = 128) does not fit
// one SM, and a design that gives each CTA whole batch rows reads all of W
// every step for a handful of rows: the product is then bound by what one
// SM can load per step, not by arithmetic.  Split over the SMs, a step is a
// chain of short latencies: a product of a few hundred FMAs a lane, the
// elementwise step, the exchange of h between the SMs.
//
// The design.  The batch is split into groups of R rows, each run by one
// thread-block cluster of C CTAs (C = 1, 2, 4, 8 or 16).  CTA q of a
// cluster owns U = D / C hidden units and, for them, all four gate columns
// of W: an [D, 4U] slice kept on chip for the whole launch.  Because it
// owns all four gates of its units, the cell state c, the peepholes and the
// whole elementwise step stay local.  What a CTA needs of the others is the
// group's full h: each CTA keeps the group's h [R, D] in its own shared
// memory, double-buffered by the parity of the step.
//
// The product.  A step's [R, 4U] gate pre-activations are cut into tiles
// of 4 rows x two units' four gates; the KS (>= 8) lanes of a tile split
// k, and xor shuffles within the warp add their partials, leaving each of
// eight lanes with one row's four gates of one unit, so the elementwise
// step runs in the lane that holds them, h and c in its registers for the
// whole launch.  With W in shared memory a k-quad costs a lane 8 + 4
// 16-byte loads for 128 FMAs and the SM's shared-memory wavefronts bound
// it; so where each lane's share of the slice is 2 or 4 k-quads (64 or
// 128 floats) it is held in registers instead (the NM template
// instances), and only h is read from shared memory.
//
// The exchange.  A CTA sends its new h [R, U] into the other h buffer of
// every CTA of the cluster with st.async, which counts the bytes against
// an mbarrier in the receiving CTA; each CTA arms its barrier for the
// R x D floats a step brings and waits on its phase.  No release fence and
// no cluster barrier sit on the step's path (a release-ordered barrier
// waited for every write of the step, device memory included), and the
// writes of hs, cs and the gates to device memory and the next step's x4
// loads go out while the exchange is in flight.  Double buffering needs no
// barrier either: a CTA writes a peer's buffer of parity p for step s + 2
// only after it has received that peer's h of step s + 1, which the peer
// sent after it finished reading that buffer at step s.  A step at which
// all R rows are frozen skips its product and its exchange; every CTA of a
// cluster sees the same lengths, so they skip together.  Clusters never
// meet, so no cooperative launch is needed and a batch of any size runs in
// waves of clusters.  The launch plan (clusters, C, R, U and how many rows
// of the W slice stay resident) is chosen by ops/lstm_fused.py
// (`lstm_plan`, ranked on the card by `ranked_plans` with the clusters
// cudaOccupancyMaxActiveClusters says it holds) and re-checked here; a
// plan whose clusters the card cannot hold is refused.
//
// Shapes a cluster cannot hold.  The slice is 16 D U bytes; a cluster of
// 16 holds W up to about D = 448 beside its state.  Beyond that (D up to
// 512) the CTA keeps as many rows of its slice as its shared memory holds
// and reads the others from L2 (where W stays resident) every step, inside
// the same cluster design: one code path for every shape, and no group
// spans clusters (which would need K1's global-memory barrier again).
//
// Backward from saved gates.  The reverse walk reads the forward's a, i,
// f, o, so a step needs one product, dh_prev = dx4 W^T.  Each CTA holds its
// slice transposed ([4U, D], in registers where it fits, as above), forms
// the partial sums of that product over its own 4U columns for every k
// and sends each 4-wide piece to the CTA that owns those k (st.async, into
// a slot per sending rank); each CTA then sums its own units' partials in
// the fixed order of the cluster ranks.  The cell gradient dc stays local.
// The peephole gradients are kept per row and summed in a fixed order by
// the last kernel; the weight gradient dW = sum h_prev^T dx4 over the
// (b, t) rows is a register-tiled float32 product (64 x 64 tiles, operands
// staged by cp.async, double-buffered), split over ranges of rows and
// summed in order; it skips stages whose 16 rows are all frozen (their dx4
// is 0).  No atomics anywhere: gradients are bit-identical run to run.
//
// Plain C interface (ctypes): each launcher returns the CUDA error code of
// its launches (0 = success) and never synchronises.  The `_phases`
// launchers are a measurement export, not used by the op: they run the same
// kernels with CTA 0 stamping clock64() around each part of a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;       // walk kernels
constexpr int RT = 4;              // products: rows of a tile
constexpr int CQ = 2;              // products: column quads of a tile
constexpr int MAX_KS = 16;         // products: k-splits at most
constexpr int MAX_CTAS = 16;       // cluster size (above 8: non-portable)
constexpr int DW_BM = 64;          // dW tile: rows of W (k)
constexpr int DW_BN = 64;          // dW tile: columns of W (j)
constexpr int DW_BK = 16;          // dW tile: (b, t) rows per stage
constexpr int DW_THREADS = 64;     // 8 x 8 outputs each
constexpr int N_FWD_STAMPS = 6;    // per step, see lstm_fwd_kernel
constexpr int N_BWD_STAMPS = 6;    // per step, see lstm_bwd_kernel

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

// The cluster barrier: every thread of every CTA of the cluster arrives
// (release) and waits for all (acquire); used once after the set-up and
// once before the exit.
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The exchange between a cluster's CTAs.  A CTA writes into a peer's
// shared memory with st.async, which counts the bytes against an mbarrier
// in the peer's shared memory (complete_tx); the peer arms that barrier
// for the bytes it expects (arrive.expect_tx, count 1) and waits on its
// phase, which completes when all have landed and makes them visible.  No
// release fence or cluster barrier is needed on the data's path.
__device__ __forceinline__ unsigned int smem_u32(const void* p) {
    return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (this CTA's shared memory) in the
// CTA of cluster rank `rank`.
__device__ __forceinline__ unsigned int peer_addr(unsigned int addr,
                                                  int rank) {
    unsigned int out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned int parity) {
    unsigned int done = 0;
    while (!done)
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void st_async(unsigned int addr, float v,
                                         unsigned int bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32"
                 " [%0], %1, [%2];" :: "r"(addr), "f"(v), "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void st_async4(unsigned int addr, const float4& v,
                                          unsigned int bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                 ".v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
                 :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
                    "r"(bar) : "memory");
}

// The launch plan as the kernels read it.
struct Plan {
    int clusters;      // groups of rows, one cluster each
    int ctas;          // C, CTAs of a cluster
    int rows;          // R, batch rows of a group
    int rows_pad;      // R rounded up to the product's row tiles (4)
    int units;         // U = D / C
    int res_fwd;       // rows of the forward's slice [D][4U] in shared memory
    int res_bwd;       // rows of the backward's slice [4U][D] in shared memory
};

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

// How many lanes share a product tile, each summing one range of k, so that
// `tiles` tiles fill the block: a power of two up to MAX_KS (the lanes of a
// tile are combined by xor shuffles within a warp).
__host__ __device__ __forceinline__ int k_splits(int tiles) {
    int ks = 1;
    while (2 * ks <= MAX_KS && tiles * 2 * ks <= THREADS) ks *= 2;
    return ks;
}

// One lane's share of a product tile: acc[r][c] (r < RT, c < CQ) = the
// partial sums over its k of A[r][k] B[k][n0 + 4 c .. n0 + 4 c + 3] for the
// tile's RT rows of A ([RT][lda] at a0, shared memory) and its 4 CQ
// columns n0 .. of B.  The KS lanes of a tile (lane = ks 32 / KS + its
// place in the warp) each take the k-quads kq = ks, ks + KS, .. < KQ in
// increasing order.  B's rows k < n_res are b_s[k][.] (row stride ldb) in
// shared memory, the others are read from device memory through L2: the
// forward's B is the CTA's W slice with its columns interleaved by unit
// (column 4 j + g is gate g of unit j: row k from w [k][g D + d0 + j]), the
// backward's the slice transposed (row g U + j from W^T, wt[g D + d0 +
// j][.]).  Only `active` lanes load.
template <bool FWD>
__device__ __forceinline__ void tile_product(
        const float* a0, int lda, int KQ, int ks, int KS, const float* b_s,
        int ldb, int n_res, const float* __restrict__ bg, int n0, int D,
        int U, int d0, bool active, float4 (&acc)[RT][CQ]) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) acc[r][c] = zero4();
    if (!active) return;
    for (int kq = ks; kq < KQ; kq += KS) {
        const int k = 4 * kq;
        float4 w[4][CQ];
        if (k < n_res) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < CQ; ++c)
                    w[i][c] = *reinterpret_cast<const float4*>(
                        b_s + (size_t)(k + i) * ldb + n0 + 4 * c);
        } else if (FWD) {
            const float* src = bg + (size_t)k * 4 * D + d0 + n0 / 4;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < CQ; ++c) {
                    const float* row = src + (size_t)i * 4 * D + c;
                    w[i][c] = make_float4(__ldg(row), __ldg(row + D),
                                          __ldg(row + 2 * D),
                                          __ldg(row + 3 * D));
                }
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int j = k + i, g = j / U;
                const float* row = bg + ((size_t)g * D + d0 + j - g * U) * D
                    + n0;
#pragma unroll
                for (int c = 0; c < CQ; ++c)
                    w[i][c] = __ldg(reinterpret_cast<const float4*>(
                        row + 4 * c));
            }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const float4 a =
                *reinterpret_cast<const float4*>(a0 + r * lda + k);
#pragma unroll
            for (int c = 0; c < CQ; ++c) {
                fma4(acc[r][c], a.x, w[0][c]);
                fma4(acc[r][c], a.y, w[1][c]);
                fma4(acc[r][c], a.z, w[2][c]);
                fma4(acc[r][c], a.w, w[3][c]);
            }
        }
    }
}

// k-quads of W a lane keeps in registers for the whole launch (32 floats
// each): KQ / KS when that is 2 or 4 and every lane has one tile (`tiles`
// <= THREADS), else 0 (the slice stays in shared memory, or partly in L2).
__host__ __device__ __forceinline__ int reg_quads(int KQ, int KS, int tiles) {
    const int nm = KQ / KS;
    return (tiles <= THREADS && KQ % KS == 0 && (nm == 2 || nm == 4))
        ? nm : 0;
}

// The same share of a tile with B in registers: wreg[m][i][c] is row
// 4 (ks + KS m) + i of the tile's column quad c.
template <int NM>
__device__ __forceinline__ void tile_product_reg(
        const float* a0, int lda, int ks, int KS,
        const float4 (&wreg)[NM][4][CQ], float4 (&acc)[RT][CQ]) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) acc[r][c] = zero4();
#pragma unroll
    for (int m = 0; m < NM; ++m) {
        const int k = 4 * (ks + KS * m);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const float4 a =
                *reinterpret_cast<const float4*>(a0 + r * lda + k);
#pragma unroll
            for (int c = 0; c < CQ; ++c) {
                fma4(acc[r][c], a.x, wreg[m][0][c]);
                fma4(acc[r][c], a.y, wreg[m][1][c]);
                fma4(acc[r][c], a.z, wreg[m][2][c]);
                fma4(acc[r][c], a.w, wreg[m][3][c]);
            }
        }
    }
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(const float4& v, int off) {
    return make_float4(__shfl_xor_sync(0xffffffffu, v.x, off),
                       __shfl_xor_sync(0xffffffffu, v.y, off),
                       __shfl_xor_sync(0xffffffffu, v.z, off),
                       __shfl_xor_sync(0xffffffffu, v.w, off));
}

__device__ __forceinline__ float4 sel4(bool c, const float4& a,
                                       const float4& b) {
    return make_float4(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z,
                       c ? a.w : b.w);
}

// The (row, column quad) of a tile whose full sum lane ks (< 8) holds after
// reduce_one.
__device__ __forceinline__ int lane_row(int ks) {
    return 2 * (ks & 1) + ((ks >> 1) & 1);
}

__device__ __forceinline__ int lane_quad(int ks) {
    return (ks >> 2) & 1;
}

// The tile's sums from its KS >= 8 lanes' partials, scattered: three xor
// rounds halve what a lane keeps (over ks bit 0 the rows {0, 1} or {2, 3},
// over bit 1 one row, over bit 2 one column quad), the remaining rounds add
// the rest; lane ks then holds the full sum of row lane_row(ks) and column
// quad lane_quad(ks).  Every lane of the warp calls it.  The order of the
// additions is fixed, so the bits are the same every run.
__device__ __forceinline__ float4 reduce_one(const float4 (&acc)[RT][CQ],
                                             int ks, int KS) {
    const int tw = 32 / KS;
    const bool b0 = ks & 1, b1 = (ks >> 1) & 1, b2 = (ks >> 2) & 1;
    float4 k[2][CQ];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < CQ; ++c)
            k[e][c] = add4(sel4(b0, acc[2 + e][c], acc[e][c]),
                           shfl_xor4(sel4(b0, acc[e][c], acc[2 + e][c]),
                                     tw));
    float4 kk[CQ];
#pragma unroll
    for (int c = 0; c < CQ; ++c)
        kk[c] = add4(sel4(b1, k[1][c], k[0][c]),
                     shfl_xor4(sel4(b1, k[0][c], k[1][c]), 2 * tw));
    float4 v = add4(sel4(b2, kk[1], kk[0]),
                    shfl_xor4(sel4(b2, kk[0], kk[1]), 4 * tw));
    for (int off = 8 * tw; off < 32; off <<= 1)
        v = add4(v, shfl_xor4(v, off));
    return v;
}

// The tile's sums from its KS < 8 lanes' partials, on every lane.
__device__ __forceinline__ void reduce_all(float4 (&acc)[RT][CQ], int KS) {
    for (int off = 32 / KS; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < CQ; ++c)
                acc[r][c] = add4(acc[r][c], shfl_xor4(acc[r][c], off));
    }
}

// Shared memory of the forward (floats, then the lengths): the resident rows
// of the CTA's slice [res_fwd][4U + 4] (columns interleaved by unit; none
// when in registers), the group's h [2][R_pad][D + 4].
// ops/lstm_fused.py `fwd_smem_bytes` computes the same.
int fwd_quads(int D, const Plan& p) {
    const int tiles = p.rows_pad / RT * (p.units / CQ);
    return reg_quads(D / 4, k_splits(tiles), tiles);
}

size_t fwd_smem_bytes(int D, const Plan& p) {
    const size_t floats =
        (fwd_quads(D, p) ? 0 : (size_t)p.res_fwd * (4 * p.units + 4))
        + 2 * (size_t)p.rows_pad * (D + 4);
    return floats * sizeof(float) + (size_t)p.rows_pad * sizeof(int);
}

// The forward.  CTA (cluster g, rank q) owns batch rows [g R, g R + R) and
// hidden units [q U, q U + U).  Its product tiles are (4 rows, two units'
// four gates); the KS >= 8 lanes of a tile split k and, after the
// shuffles, lane ks < 8 runs the elementwise step of row lane_row(ks) of
// unit lane_quad(ks) of the tile, keeping its h and c in registers for the
// whole launch.  Per step (time t, scan order s), unless every row of the
// group is frozen there: the product h W of the units' gate columns, the
// elementwise step,
// the new h sent into the other h buffer of every CTA of the cluster
// (st.async), hs, cs (and the gates) written and the next step's x4 loaded
// into registers, then the wait until the whole next h has landed in its
// own buffer (the buffer's mbarrier).  `gates` (may be null) gets a, i, f,
// o [B, T, 4D] of the valid steps (frozen rows' entries are left unset).
// W is in registers for NM > 0 (wreg), else in shared memory (w_s) and L2.
// Stamps (a `_phases` launch, CTA 0): per step [start, product,
// elementwise, sent, hs/cs written, received].
template <bool PH, int NM>
__global__ void __launch_bounds__(THREADS, 1) lstm_fwd_kernel(
        const float* __restrict__ x4, const float* __restrict__ w,
        const float* __restrict__ peeps, const int* __restrict__ lens,
        const float* __restrict__ h0, const float* __restrict__ c0,
        float* __restrict__ hs, float* __restrict__ cs,
        float* __restrict__ gates, int B, int T, int D, Plan p, int reverse,
        int act, int gate, int state_act, long long* stamps) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) unsigned long long h_bar[2];   // the h buffers'
    const int U = p.units, U4 = 4 * U, Rp = p.rows_pad, C = p.ctas;
    const int D4 = 4 * D, ldh = D + 4, ldw = U4 + 4;
    const int q = (int)cluster.block_rank();
    const int g = blockIdx.x / C;
    const int d0 = q * U, b0 = g * p.rows;
    const int live = max(0, min(p.rows, B - b0));     // rows of the batch
    // product tiles: 4 rows x the four gates of 2 units (UP unit pairs)
    const int UP = U / CQ, tiles = (Rp / RT) * UP, KS = k_splits(tiles);
    const int TW = 32 / KS, lane = threadIdx.x & 31, ks = lane / TW;
    const int tile = (threadIdx.x >> 5) * TW + lane % TW;
    const bool active = tile < tiles;
    const int rt = active ? tile / UP : 0;
    const int j0 = active ? CQ * (tile - rt * UP) : 0;    // the pair's first
    float* w_s = smem;                                 // [res][4U + 4]
    float* hb_s = w_s + (NM ? 0 : (size_t)p.res_fwd * ldw);  // [2][Rp][D + 4]
    int* len_s = reinterpret_cast<int*>(hb_s + 2 * Rp * ldh);
    long long* st = (PH && blockIdx.x == 0) ? stamps : nullptr;

    const int max_len = load_lens(lens, len_s, b0, Rp, p.rows, B);
    // w_s[k][4 jj + gg] = W[k][gg D + d0 + jj]: neighbouring threads read
    // neighbouring columns of W
    for (int i = threadIdx.x; i < (NM ? 0 : p.res_fwd * U4);
         i += blockDim.x) {
        const int k = i / U4, n = i - k * U4;
        const int gg = n / U, jj = n - gg * U;
        w_s[(size_t)k * ldw + 4 * jj + gg] =
            __ldg(w + (size_t)k * D4 + gg * D + d0 + jj);
    }
    // NM > 0: the lane's k-quads of its units' gate columns in registers,
    // row 4 (ks + KS m) + i of unit j0 + c in wreg[m][i][c]
    float4 wreg[NM > 0 ? NM : 1][4][CQ];
#pragma unroll
    for (int m = 0; m < (NM > 0 ? NM : 1); ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int c = 0; c < CQ; ++c) {
                const float* src =
                    w + (size_t)(4 * (ks + KS * m) + i) * D4 + d0 + j0 + c;
                wreg[m][i][c] = NM > 0 && active
                    ? make_float4(__ldg(src), __ldg(src + D),
                                  __ldg(src + 2 * D), __ldg(src + 3 * D))
                    : zero4();
            }
        }
    }
    for (int i = threadIdx.x; i < Rp * D; i += blockDim.x) {
        const int r = i / D, k = i - r * D;
        hb_s[r * ldh + k] = r < live ? h0[(size_t)(b0 + r) * D + k] : 0.f;
    }
    // the lane's (row, unit) of its tile (KS >= 8: lane ks < 8 takes row
    // lane_row(ks) of unit j0 + lane_quad(ks)), its h and c kept in
    // registers
    const bool mine = active && ks < RT * CQ;
    const int r = rt * RT + (mine ? lane_row(ks) : 0);
    const int j = j0 + (mine ? lane_quad(ks) : 0);
    const float p_i = peeps[d0 + j], p_f = peeps[D + d0 + j];
    const float p_o = peeps[2 * D + d0 + j];
    const bool in_batch = mine && r < live;
    const int len = mine ? len_s[r] : 0;
    const size_t row = (size_t)(b0 + r) * T;
    float h = in_batch ? h0[(size_t)(b0 + r) * D + d0 + j] : 0.f;
    float c = in_batch ? c0[(size_t)(b0 + r) * D + d0 + j] : 0.f;
    if (threadIdx.x == 0) {
        mbar_init(&h_bar[0]);
        mbar_init(&h_bar[1]);
        mbar_init_fence();
    }
    // every CTA of the cluster is running (and initialised) before any
    // writes into another's shared memory
    cluster_barrier();

    const unsigned int h_bytes = (unsigned int)(Rp * D * sizeof(float));
    unsigned int parity = 0;     // bit b: the phase h_bar[b] completes next
    int cur = 0;                 // the h buffer that holds the state
    bool loaded = false;         // xv holds this step's x4
    float4 xv = zero4();
    for (int s = 0; s < T; ++s) {
        const int t = reverse ? T - 1 - s : s;
        if (t >= max_len) {      // uniform over the cluster's CTAs
            if (in_batch) {
                hs[(row + t) * D + d0 + j] = h;
                cs[(row + t) * D + d0 + j] = c;
            }
            continue;
        }
        long long* sts = st ? st + (size_t)s * N_FWD_STAMPS : nullptr;
        stamp<PH>(sts, 0);
        const bool valid = t < len;
        if (!loaded && valid) {
            const float* xr = x4 + (row + t) * D4 + d0 + j;
            xv = make_float4(__ldg(xr), __ldg(xr + D), __ldg(xr + 2 * D),
                             __ldg(xr + 3 * D));
        }
        const float* hcur = hb_s + (size_t)cur * Rp * ldh;
        float4 acc[RT][CQ];
        if constexpr (NM > 0)
            tile_product_reg<NM>(hcur + (size_t)rt * RT * ldh, ldh, ks, KS,
                                 wreg, acc);
        else
            tile_product<true>(hcur + (size_t)rt * RT * ldh, ldh, D / 4, ks,
                               KS, w_s, ldw, p.res_fwd, w, 4 * j0, D, U, d0,
                               active, acc);
        const float4 gz = reduce_one(acc, ks, KS);
        stamp<PH>(sts, 1);
        float4 gv = zero4();     // the activated gates a, i, f, o
        if (valid) {
            gv.x = act_fwd(act, gz.x + xv.x);
            gv.y = act_fwd(gate, gz.y + xv.y + c * p_i);
            gv.z = act_fwd(gate, gz.z + xv.z + c * p_f);
            c = gv.x * gv.y + gv.z * c;
            gv.w = act_fwd(gate, gz.w + xv.w + c * p_o);
            h = gv.w * act_fwd(state_act, c);
        }
        stamp<PH>(sts, 2);
        // the new h into the other buffer of every CTA of the cluster
        const int nxt = cur ^ 1;
        if (threadIdx.x == 0) mbar_expect(&h_bar[nxt], h_bytes);
        if (mine) {
            const unsigned int dst = smem_u32(
                hb_s + (size_t)nxt * Rp * ldh + r * ldh + d0 + j);
            const unsigned int bar = smem_u32(&h_bar[nxt]);
#pragma unroll
            for (int qq = 0; qq < MAX_CTAS; ++qq)
                if (qq < C)
                    st_async(peer_addr(dst, qq), h, peer_addr(bar, qq));
        }
        stamp<PH>(sts, 3);
        if (in_batch) {
            hs[(row + t) * D + d0 + j] = h;
            cs[(row + t) * D + d0 + j] = c;
            if (gates != nullptr && valid) {
                float* gr = gates + (row + t) * D4 + d0 + j;
                gr[0] = gv.x;
                gr[D] = gv.y;
                gr[2 * D] = gv.z;
                gr[3 * D] = gv.w;
            }
        }
        const int t_next = reverse ? T - 2 - s : s + 1;
        loaded = s + 1 < T && t_next < max_len;
        if (loaded && t_next < len) {
            const float* xr = x4 + (row + t_next) * D4 + d0 + j;
            xv = make_float4(__ldg(xr), __ldg(xr + D), __ldg(xr + 2 * D),
                             __ldg(xr + 3 * D));
        }
        stamp<PH>(sts, 4);
        mbar_wait(&h_bar[nxt], (parity >> nxt) & 1u);
        parity ^= 1u << nxt;
        stamp<PH>(sts, 5);
        cur ^= 1;
    }
    // no CTA leaves while its writes into another may be in flight
    cluster_barrier();
}

// Shared memory of the backward walk (floats, then the lengths): the
// resident rows of the CTA's slice transposed [res_bwd][D + 4] (none when
// in registers), the partial dh_prev of its units from each rank
// [2][C][R_pad][U], the step's dx4 of its units [R_pad][4U + 4].
int bwd_quads(int D, const Plan& p) {
    const int tiles = p.rows_pad / RT * (D / (4 * CQ));
    return reg_quads(p.units, k_splits(tiles), tiles);
}

size_t bwd_smem_bytes(int D, const Plan& p) {
    const size_t Rp = p.rows_pad;
    const size_t floats =
        (bwd_quads(D, p) ? 0 : (size_t)p.res_bwd * (D + 4)) + 2 * Rp * D
        + Rp * (4 * p.units + 4);
    return floats * sizeof(float) + Rp * sizeof(int);
}

// The reverse walk, from the forward's saved gates [B, T, 4D] and cs.  Per
// step s (scan order T-1 .. 0; time t as in the forward), for each (row,
// unit) item of the CTA (one a thread; its dh, dc and peephole sums stay in
// registers):
//   dh_total = dh + g_hs[t]                 do = dh_total state(c')
//   dzo = do gate'(o)
//   dc_in = dh_total o state'(.) + dc + dzo p_o
//   dza = dc_in i act'(a)   dzi = dc_in a gate'(i)   dzf = dc_in c gate'(f)
//   dc <- dc_in f + dzi p_i + dzf p_f
//   dh <- dx4 W^T: partials over the CTA's columns (product tiles of 4 rows
//         x 8 k, lanes splitting the columns), each 4-wide piece sent
//         (st.async) to the CTA that owns those k; once all have landed
//         (mbarrier), its units' sums over the cluster's ranks in order
// and on a frozen row (t >= len) dx4 = 0, dh <- dh_total, dc kept (selected,
// never multiplied, so the unset gates of frozen rows cannot leak in); a
// step at which the whole group is frozen skips the product and the
// exchange.  While the partials travel, the step's dx4 is written and the
// next step's seven inputs of each item are loaded into registers.
// dpeep_part [B, 3, D] gets each row's own sums over time.  `wt` (W^T
// [4D, D]) is read for the slice's rows beyond res_bwd, and may be null
// when all are resident.  Stamps (a `_phases` launch, CTA 0): per step
// [start, elementwise, product and sends, dx4 written, received, summed].
template <bool PH, int NM>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_kernel(
        const float* __restrict__ w, const float* __restrict__ wt,
        const float* __restrict__ peeps, const int* __restrict__ lens,
        const float* __restrict__ c0, const float* __restrict__ cs,
        const float* __restrict__ gates, const float* __restrict__ g_hs,
        const float* __restrict__ g_hl, const float* __restrict__ g_cl,
        float* __restrict__ dx, float* __restrict__ dh0,
        float* __restrict__ dc0, float* __restrict__ dpeep_part, int B,
        int T, int D, Plan p, int reverse, int act, int gate, int state_act,
        long long* stamps) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) unsigned long long p_bar[2];   // recv_s's
    const int U = p.units, U4 = 4 * U, Rp = p.rows_pad, C = p.ctas;
    const int D4 = 4 * D, ldt = D + 4, ldz = U4 + 4;
    const int q = (int)cluster.block_rank();
    const int g = blockIdx.x / C;
    const int d0 = q * U, b0 = g * p.rows;
    const int live = max(0, min(p.rows, B - b0));
    // product tiles: 4 rows x 8 k of dh_prev (OQ of them across D)
    const int OQ = D / (4 * CQ), tiles = (Rp / RT) * OQ, KS = k_splits(tiles);
    const int TW = 32 / KS, lane = threadIdx.x & 31, ks = lane / TW;
    const int tw = (threadIdx.x >> 5) * TW + lane % TW;
    float* wT_s = smem;                                // [res][D + 4]
    // the partials of the CTA's units from each rank [2][C][Rp][U]
    float* recv_s = wT_s + (NM ? 0 : (size_t)p.res_bwd * ldt);
    float* dz_s = recv_s + 2 * Rp * D;                 // [Rp][4U + 4]
    int* len_s = reinterpret_cast<int*>(dz_s + Rp * ldz);
    long long* st = (PH && blockIdx.x == 0) ? stamps : nullptr;

    const int max_len = load_lens(lens, len_s, b0, Rp, p.rows, B);
    // wT_s[gg U + jj][k] = W[k][gg D + d0 + jj]: neighbouring threads read
    // neighbouring columns of W
    for (int i = threadIdx.x; i < (NM ? 0 : p.res_bwd * D);
         i += blockDim.x) {
        const int k = i / p.res_bwd, jx = i - k * p.res_bwd;
        const int gg = jx / U, jj = jx - gg * U;
        wT_s[(size_t)jx * ldt + k] = __ldg(w + (size_t)k * D4 + gg * D + d0
                                           + jj);
    }
    // NM > 0 (then one product tile a lane, tiles <= THREADS): the lane's
    // rows of the slice transposed in registers, row 4 (ks + KS m) + i of
    // column quad c in wreg[m][i][c]: W[n0 + 4 c + 0 .. 3][g D + d0 + jj]
    // for that row g U + jj, n0 = 8 (the tile's place across D)
    float4 wreg[NM > 0 ? NM : 1][4][CQ];
    {
        const int n0 = tw < tiles ? 4 * CQ * (tw % OQ) : 0;
#pragma unroll
        for (int m = 0; m < (NM > 0 ? NM : 1); ++m) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int jx = 4 * (ks + KS * m) + i, gg = jx / U;
#pragma unroll
                for (int c = 0; c < CQ; ++c) {
                    const float* src = w + (size_t)(n0 + 4 * c) * D4
                        + gg * D + d0 + jx - gg * U;
                    wreg[m][i][c] = NM > 0 && tw < tiles
                        ? make_float4(__ldg(src), __ldg(src + D4),
                                      __ldg(src + 2 * D4),
                                      __ldg(src + 3 * D4))
                        : zero4();
                }
            }
        }
    }
    // the thread's item: (row, unit) = (tid / U, tid % U); its dh, dc and
    // peephole sums stay in registers
    const bool mine = (int)threadIdx.x < Rp * U;
    const int r = mine ? threadIdx.x / U : 0, jj = threadIdx.x - r * U;
    const bool in_batch = mine && r < live;
    const int len = mine ? len_s[r] : 0;
    const size_t row = (size_t)(b0 + r) * T, unit = (size_t)d0 + jj;
    float dh = in_batch ? g_hl[(size_t)(b0 + r) * D + unit] : 0.f;
    float dc = in_batch ? g_cl[(size_t)(b0 + r) * D + unit] : 0.f;
    float dht = 0.f, dp0 = 0.f, dp1 = 0.f, dp2 = 0.f;
    const float p_i = peeps[unit], p_f = peeps[D + unit];
    const float p_o = peeps[2 * D + unit];
    if (threadIdx.x == 0) {
        mbar_init(&p_bar[0]);
        mbar_init(&p_bar[1]);
        mbar_init_fence();
    }
    // every CTA of the cluster is running (and initialised) before any
    // writes into another's shared memory
    cluster_barrier();
    const unsigned int p_bytes = (unsigned int)(Rp * D * sizeof(float));
    unsigned int parity = 0;       // bit b: the phase p_bar[b] completes next

    // y <- the inputs of walk step s: g_hs, a, i, f, o, c at its time t,
    // c_prev (c0 at s = 0, else cs at the previous scan step's time); an
    // item beyond the batch or frozen at t reads nothing
    float y[7];
    auto load_step = [&](int s) {
        const int t = reverse ? T - 1 - s : s;
        const int tp = reverse ? t + 1 : t - 1;
        const bool valid = in_batch && t < len;
        y[0] = in_batch ? __ldg(g_hs + (row + t) * D + unit) : 0.f;
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
            y[1 + gg] = valid ? __ldg(gates + (row + t) * D4 + gg * D + unit)
                              : 0.f;
        y[5] = valid ? __ldg(cs + (row + t) * D + unit) : 0.f;
        y[6] = !valid ? 0.f
            : s == 0 ? __ldg(c0 + (size_t)(b0 + r) * D + unit)
                     : __ldg(cs + (row + tp) * D + unit);
    };

    int cur = 0;                   // the partial buffer of this step
    bool loaded = false;           // y holds this step's inputs
    for (int s = T - 1; s >= 0; --s) {
        const int t = reverse ? T - 1 - s : s;
        if (t >= max_len) {        // uniform over the cluster's CTAs
            if (in_batch) {
                dh += g_hs[(row + t) * D + unit];
#pragma unroll
                for (int gg = 0; gg < 4; ++gg)
                    dx[(row + t) * D4 + gg * D + unit] = 0.f;
            }
            continue;
        }
        long long* sts =
            st ? st + (size_t)(T - 1 - s) * N_BWD_STAMPS : nullptr;
        stamp<PH>(sts, 0);
        if (!loaded) load_step(s);
        const bool valid = t < len;
        float4 dz = zero4();       // dza, dzi, dzf, dzo
        dht = dh + y[0];
        if (valid) {
            const float a = y[1], ig = y[2], fg = y[3], og = y[4];
            const float cn = y[5], cp = y[6];
            const float sc = act_fwd(state_act, cn);
            dz.w = dht * sc * act_grad(gate, og);
            const float dc_in = dht * og * act_grad(state_act, sc) + dc
                + dz.w * p_o;
            dz.x = dc_in * ig * act_grad(act, a);
            dz.y = dc_in * a * act_grad(gate, ig);
            dz.z = dc_in * cp * act_grad(gate, fg);
            dc = dc_in * fg + dz.y * p_i + dz.z * p_f;
            dp0 += dz.y * cp;
            dp1 += dz.z * cp;
            dp2 += dz.w * cn;
        }
        if (mine) {
            float* dzs = dz_s + r * ldz + jj;
            dzs[0] = dz.x;
            dzs[U] = dz.y;
            dzs[2 * U] = dz.z;
            dzs[3 * U] = dz.w;
        }
        __syncthreads();
        stamp<PH>(sts, 1);
        // each partial row of 4 k goes to the CTA that owns those units,
        // into its slot for this rank
        if (threadIdx.x == 0) mbar_expect(&p_bar[cur], p_bytes);
        const unsigned int slot =
            smem_u32(recv_s + ((size_t)cur * C + q) * Rp * U);
        const unsigned int bar = smem_u32(&p_bar[cur]);
        for (int base = 0; base < tiles; base += 8 * TW) {
            const int tile = base + tw;
            const bool active = tile < tiles;
            const int rt = active ? tile / OQ : 0;
            const int n0 = active ? 4 * CQ * (tile - rt * OQ) : 0;
            float4 acc[RT][CQ];
            if constexpr (NM > 0)
                tile_product_reg<NM>(dz_s + (size_t)rt * RT * ldz, ldz, ks,
                                     KS, wreg, acc);
            else
                tile_product<false>(dz_s + (size_t)rt * RT * ldz, ldz, U, ks,
                                    KS, wT_s, ldt, p.res_bwd, wt, n0, D, U,
                                    d0, active, acc);
            // row rr's 4 k from n: to the rank that owns them
            auto send = [&](int rr, int n, const float4& v) {
                const int to = n / U;
                st_async4(peer_addr(slot + 4u * (rr * U + n - to * U), to), v,
                          peer_addr(bar, to));
            };
            if (KS >= RT * CQ) {
                const float4 v = reduce_one(acc, ks, KS);
                if (active && ks < RT * CQ)
                    send(rt * RT + lane_row(ks), n0 + 4 * lane_quad(ks), v);
            } else {
                reduce_all(acc, KS);
#pragma unroll
                for (int e = 0; e < RT; ++e)
#pragma unroll
                    for (int c = 0; c < CQ; ++c)
                        if (active && (e * CQ + c) % KS == ks)
                            send(rt * RT + e, n0 + 4 * c, acc[e][c]);
            }
        }
        stamp<PH>(sts, 2);
        if (in_batch) {
            float* dxr = dx + (row + t) * D4 + unit;
            dxr[0] = dz.x;
            dxr[D] = dz.y;
            dxr[2 * D] = dz.z;
            dxr[3 * D] = dz.w;
        }
        loaded = s > 0 && (reverse ? T - s : s - 1) < max_len;
        if (loaded) load_step(s - 1);
        stamp<PH>(sts, 3);
        mbar_wait(&p_bar[cur], (parity >> cur) & 1u);
        parity ^= 1u << cur;
        stamp<PH>(sts, 4);
        // dh of the item: the cluster's partials in rank order
        if (mine) {
            const float* in = recv_s + (size_t)cur * C * Rp * U + r * U + jj;
            float sum = 0.f;
            for (int qq = 0; qq < C; ++qq) sum += in[(size_t)qq * Rp * U];
            dh = valid ? sum : dht;
        }
        stamp<PH>(sts, 5);
        cur ^= 1;
    }
    if (in_batch) {
        const size_t o = (size_t)(b0 + r) * D + unit;
        dh0[o] = dh;
        dc0[o] = dc;
        float* dp = dpeep_part + (size_t)(b0 + r) * 3 * D + unit;
        dp[0] = dp0;
        dp[D] = dp1;
        dp[2 * D] = dp2;
    }
    // no CTA leaves while its writes into another may be in flight
    cluster_barrier();
}

// One stage of the dW product: rows [n0, n0 + DW_BK) of the operands, the
// tile's k columns of h_prev and j columns of dx, into a_s / b_s (cp.async,
// one commit group; beyond the edges zero-filled).  h_prev of row n =
// (b, t) is h0[b] at the first scan step, else hs at the previous scan
// step's time.
__device__ __forceinline__ void dw_load_stage(
        const float* hs, const float* h0, const float* dx, float* a_s,
        float* b_s, int n0, int n_end, int k0, int j0, int T, int D,
        int reverse) {
    const int tid = threadIdx.x;
    const int t_first = reverse ? T - 1 : 0, step = reverse ? 1 : -1;
    for (int q = tid; q < DW_BK * DW_BM / 4; q += DW_THREADS) {
        const int nn = q / (DW_BM / 4), kq = q - nn * (DW_BM / 4);
        const int n = n0 + nn;
        const bool ok = n < n_end && k0 + kq * 4 < D;
        const float* src = hs;
        if (ok) {
            const int b = n / T, t = n - b * T;
            src = (t == t_first ? h0 + (size_t)b * D
                                : hs + (size_t)(n + step) * D)
                + k0 + kq * 4;
        }
        cp_async16(a_s + nn * DW_BM + kq * 4, src, ok);
    }
    for (int q = tid; q < DW_BK * DW_BN / 4; q += DW_THREADS) {
        const int nn = q / (DW_BN / 4), jq = q - nn * (DW_BN / 4);
        const int n = n0 + nn;
        const bool ok = n < n_end;
        cp_async16(b_s + nn * DW_BN + jq * 4,
                   ok ? dx + (size_t)n * 4 * D + j0 + jq * 4 : dx, ok);
    }
    cp_async_commit();
}

// The first stage at or after `from` (of n_stages from n_begin) that holds
// a valid (b, t) row; n_stages when there is none.  Uniform over the block.
__device__ __forceinline__ int next_live_stage(const int* lens, int from,
                                               int n_stages, int n_begin,
                                               int n_end, int T) {
    for (int st = from; st < n_stages; ++st) {
        bool any = false;
        if (threadIdx.x < DW_BK) {
            const int n = n_begin + st * DW_BK + threadIdx.x;
            if (n < n_end) {
                const int b = n / T;
                any = n - b * T < lens[b];
            }
        }
        if (__syncthreads_or(any)) return st;
    }
    return n_stages;
}

// Weight gradient over one range of the (b, t) rows n: C[k][j] = sum_n
// h_prev(n)[k] dx[n][j].  A [64 x 64] tile per CTA, 8 x 8 outputs a thread
// (two 4-wide runs of k and of j, 16-byte shared loads), 16 rows n a stage,
// two stages in flight through cp.async; stages whose rows are all frozen
// (dx = 0 there) are skipped.  Written to dw when `direct` (one range),
// else to part[z] for lstm_reduce_kernel.
__global__ void __launch_bounds__(DW_THREADS) lstm_dw_kernel(
        const float* __restrict__ hs, const float* __restrict__ h0,
        const float* __restrict__ dx, const int* __restrict__ lens,
        float* __restrict__ dw, float* __restrict__ part, int B, int T,
        int D, int reverse, int rows_per_split, int direct) {
    __shared__ __align__(16) float a_s[2][DW_BK][DW_BM];
    __shared__ __align__(16) float b_s[2][DW_BK][DW_BN];
    const int D4 = 4 * D, N = B * T;
    const int j0 = blockIdx.x * DW_BN, k0 = blockIdx.y * DW_BM;
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
    int st = next_live_stage(lens, 0, n_stages, n_begin, n_end, T);
    int buf = 0;
    if (st < n_stages)
        dw_load_stage(hs, h0, dx, &a_s[0][0][0], &b_s[0][0][0],
                      n_begin + st * DW_BK, n_end, k0, j0, T, D, reverse);
    while (st < n_stages) {
        const int nxt = next_live_stage(lens, st + 1, n_stages, n_begin,
                                        n_end, T);
        if (nxt < n_stages) {
            dw_load_stage(hs, h0, dx, &a_s[buf ^ 1][0][0],
                          &b_s[buf ^ 1][0][0], n_begin + nxt * DW_BK, n_end,
                          k0, j0, T, D, reverse);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
#pragma unroll
        for (int nn = 0; nn < DW_BK; ++nn) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(&a_s[buf][nn][ty * 4]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&a_s[buf][nn][32 + ty * 4]);
            const float4 b0 =
                *reinterpret_cast<const float4*>(&b_s[buf][nn][tx * 4]);
            const float4 b1 =
                *reinterpret_cast<const float4*>(&b_s[buf][nn][32 + tx * 4]);
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
        st = nxt;
        buf ^= 1;
    }
    float* out = direct ? dw : part + (size_t)blockIdx.z * D * D4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int k = k0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
        if (k >= D) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = j0 + h * 32 + tx * 4;
            *reinterpret_cast<float4*>(out + (size_t)k * D4 + j) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
    }
}

// dw = the splits of `part` summed in order (n_dw = 0: the dW product wrote
// dw itself); dpeep = the rows of dpeep_part summed in order.
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

// The plan's invariants: every batch row in exactly one group (no group
// empty), every hidden unit owned by one CTA of a cluster, slices of whole
// 16-byte units, a cluster of at most MAX_CTAS, row tiles of 4, one (row,
// unit) item a thread (R_pad U <= 256: the forward's product tiles then
// get at least 8 lanes each, one a (row, unit)), resident rows in whole
// k-quads.
bool plan_ok(int B, int D, const Plan& p) {
    return p.clusters >= 1 && p.ctas >= 1 && p.ctas <= MAX_CTAS
        && p.rows >= 1 && p.units >= 4 && p.units % 4 == 0
        && (long long)p.rows_pad * p.units <= THREADS
        && p.ctas * p.units == D && p.rows_pad == (p.rows + RT - 1) / RT * RT
        && p.res_fwd >= 0 && p.res_fwd <= D && p.res_fwd % 4 == 0
        && p.res_bwd >= 0 && p.res_bwd <= 4 * p.units && p.res_bwd % 4 == 0
        && (long long)p.clusters * p.rows >= B
        && (long long)(p.clusters - 1) * p.rows < B;
}

bool shape_ok(int B, int T, int D) {
    return B >= 1 && T >= 1 && D >= 32 && D <= 512 && D % 32 == 0;
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// The launch configuration of a walk kernel: its dynamic shared memory set
// (and checked against the device's limit), clusters of p.ctas CTAs; fails
// when the card cannot hold one such cluster.
cudaError_t prepare_cluster(const void* fn, size_t smem, const Plan& p,
                            cudaStream_t stream, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
    int dev = 0, limit = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)limit) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (p.ctas > 8) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(p.clusters * p.ctas);
    cfg->blockDim = dim3(THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, fn, cfg);
    if (err != cudaSuccess) return err;
    return n >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The instance of a walk kernel for `nm` k-quads of W in registers (0: W in
// shared memory).
template <bool PH>
decltype(&lstm_fwd_kernel<PH, 0>) fwd_instance(int nm) {
    switch (nm) {
        case 2: return &lstm_fwd_kernel<PH, 2>;
        case 4: return &lstm_fwd_kernel<PH, 4>;
        default: return &lstm_fwd_kernel<PH, 0>;
    }
}

template <bool PH>
decltype(&lstm_bwd_kernel<PH, 0>) bwd_instance(int nm) {
    switch (nm) {
        case 2: return &lstm_bwd_kernel<PH, 2>;
        case 4: return &lstm_bwd_kernel<PH, 4>;
        default: return &lstm_bwd_kernel<PH, 0>;
    }
}

template <bool PH>
cudaError_t launch_fwd(const float* x4, const float* w, const float* peeps,
                       const int* lens, const float* h0, const float* c0,
                       float* hs, float* cs, float* gates, int B, int T,
                       int D, Plan p, int reverse, int act, int gate,
                       int state_act, long long* stamps,
                       cudaStream_t stream) {
    const auto kern = fwd_instance<PH>(fwd_quads(D, p));
    const void* fn = reinterpret_cast<const void*>(kern);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = prepare_cluster(fn, fwd_smem_bytes(D, p), p, stream,
                                      &cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&cfg, kern, x4, w, peeps, lens,
                              h0, c0, hs, cs, gates, B, T, D, p, reverse,
                              act, gate, state_act, stamps);
}

template <bool PH>
cudaError_t launch_bwd_walk(const float* w, const float* wt,
                            const float* peeps, const int* lens,
                            const float* c0, const float* cs,
                            const float* gates, const float* g_hs,
                            const float* g_hl, const float* g_cl, float* dx,
                            float* dh0, float* dc0, float* dpeep_part, int B,
                            int T, int D, Plan p, int reverse, int act,
                            int gate, int state_act, long long* stamps,
                            cudaStream_t stream) {
    const auto kern = bwd_instance<PH>(bwd_quads(D, p));
    const void* fn = reinterpret_cast<const void*>(kern);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = prepare_cluster(fn, bwd_smem_bytes(D, p), p, stream,
                                      &cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&cfg, kern, w, wt, peeps, lens,
                              c0, cs, gates, g_hs, g_hl, g_cl, dx, dh0, dc0,
                              dpeep_part, B, T, D, p, reverse, act, gate,
                              state_act, stamps);
}

Plan make_plan(int clusters, int ctas, int rows, int units, int res_fwd,
               int res_bwd) {
    return Plan{clusters, ctas, rows, (rows + RT - 1) / RT * RT, units,
                res_fwd, res_bwd};
}

// The walk's arguments a plan needs: W^T when the backward's slice is not
// all resident.
bool walk_ok(int B, int T, int D, const Plan& p, const void* w,
             const void* wt) {
    return shape_ok(B, T, D) && plan_ok(B, D, p) && aligned16(w)
        && (p.res_bwd == 4 * p.units || (wt != nullptr && aligned16(wt)));
}

}  // namespace

extern "C" {

// hs, cs [B, T, D] <- the recurrence over x4 [B, T, 4D]; gates [B, T, 4D]
// (a, i, f, o) or null.  The plan: `clusters` groups of `rows` batch rows,
// clusters of `ctas` CTAs of `units` hidden units each, res_fwd rows of a
// CTA's W slice resident (res_bwd: the backward's).
int lstm_fwd_launch(const void* x4, const void* w, const void* peeps,
                    const void* lens, const void* h0, const void* c0,
                    void* hs, void* cs, void* gates, int B, int T, int D,
                    int reverse, int act, int gate, int state_act,
                    int clusters, int ctas, int rows, int units, int res_fwd,
                    int res_bwd, void* stream) {
    const Plan p = make_plan(clusters, ctas, rows, units, res_fwd, res_bwd);
    if (!shape_ok(B, T, D) || !plan_ok(B, D, p) || !aligned16(w))
        return (int)cudaErrorInvalidValue;
    return (int)launch_fwd<false>(
        (const float*)x4, (const float*)w, (const float*)peeps,
        (const int*)lens, (const float*)h0, (const float*)c0, (float*)hs,
        (float*)cs, (float*)gates, B, T, D, p, reverse, act, gate, state_act,
        nullptr, (cudaStream_t)stream);
}

// The reverse walk: dx [B, T, 4D], dh0, dc0 [B, D] and dpeep_part
// [B, 3, D] from the forward's cs and gates and the cotangents g_hs
// [B, T, D], g_hl, g_cl [B, D]; wt = W^T [4D, D] (null when the plan keeps
// the backward's slice resident).
int lstm_bwd_launch(const void* w, const void* wt, const void* peeps,
                    const void* lens, const void* c0, const void* cs,
                    const void* gates, const void* g_hs, const void* g_hl,
                    const void* g_cl, void* dx, void* dh0, void* dc0,
                    void* dpeep_part, int B, int T, int D, int reverse,
                    int act, int gate, int state_act, int clusters, int ctas,
                    int rows, int units, int res_fwd, int res_bwd,
                    void* stream) {
    const Plan p = make_plan(clusters, ctas, rows, units, res_fwd, res_bwd);
    if (!walk_ok(B, T, D, p, w, wt)) return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_walk<false>(
        (const float*)w, (const float*)wt, (const float*)peeps,
        (const int*)lens, (const float*)c0, (const float*)cs,
        (const float*)gates, (const float*)g_hs, (const float*)g_hl,
        (const float*)g_cl, (float*)dx, (float*)dh0, (float*)dc0,
        (float*)dpeep_part, B, T, D, p, reverse, act, gate, state_act,
        nullptr, (cudaStream_t)stream);
}

// dw [D, 4D] from hs, h0 and the walk's dx, the (b, t) rows in `splits`
// ranges summed in order (dw_part [splits, D, 4D], unused at 1 split), and
// dpeep [3, D] = dpeep_part [B, 3, D] summed over the rows in order.
int lstm_dw_launch(const void* hs, const void* h0, const void* dx,
                   const void* lens, const void* dpeep_part, void* dw,
                   void* dpeep, void* dw_part, int splits, int B, int T,
                   int D, int reverse, void* stream) {
    if (!shape_ok(B, T, D) || splits < 1 || (splits > 1 && !dw_part))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int N = B * T, rows_per_split = (N + splits - 1) / splits;
    dim3 grid(4 * D / DW_BN, (D + DW_BM - 1) / DW_BM, splits);
    lstm_dw_kernel<<<grid, DW_THREADS, 0, st>>>(
        (const float*)hs, (const float*)h0, (const float*)dx,
        (const int*)lens, (float*)dw, (float*)dw_part, B, T, D, reverse,
        rows_per_split, splits == 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_dw = splits == 1 ? 0 : D * 4 * D, total = n_dw + 3 * D;
    lstm_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
        (const float*)dw_part, (float*)dw, n_dw, splits,
        (const float*)dpeep_part, (float*)dpeep, B, 3 * D);
    return (int)cudaGetLastError();
}

// Measurement export: the forward kernel (as lstm_fwd_launch) or the
// backward walk (as lstm_bwd_launch) with CTA 0 writing clock64() stamps:
// [T][6] (forward) or [T][6] (walk, in walk order), rows of steps that a
// frozen group skips left as they were.
int lstm_fwd_phases_launch(const void* x4, const void* w, const void* peeps,
                           const void* lens, const void* h0, const void* c0,
                           void* hs, void* cs, void* gates, int B, int T,
                           int D, int reverse, int act, int gate,
                           int state_act, int clusters, int ctas, int rows,
                           int units, int res_fwd, int res_bwd, void* stamps,
                           void* stream) {
    const Plan p = make_plan(clusters, ctas, rows, units, res_fwd, res_bwd);
    if (!shape_ok(B, T, D) || !plan_ok(B, D, p) || !aligned16(w))
        return (int)cudaErrorInvalidValue;
    return (int)launch_fwd<true>(
        (const float*)x4, (const float*)w, (const float*)peeps,
        (const int*)lens, (const float*)h0, (const float*)c0, (float*)hs,
        (float*)cs, (float*)gates, B, T, D, p, reverse, act, gate, state_act,
        (long long*)stamps, (cudaStream_t)stream);
}

int lstm_bwd_phases_launch(const void* w, const void* wt, const void* peeps,
                           const void* lens, const void* c0, const void* cs,
                           const void* gates, const void* g_hs,
                           const void* g_hl, const void* g_cl, void* dx,
                           void* dh0, void* dc0, void* dpeep_part, int B,
                           int T, int D, int reverse, int act, int gate,
                           int state_act, int clusters, int ctas, int rows,
                           int units, int res_fwd, int res_bwd, void* stamps,
                           void* stream) {
    const Plan p = make_plan(clusters, ctas, rows, units, res_fwd, res_bwd);
    if (!walk_ok(B, T, D, p, w, wt)) return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_walk<true>(
        (const float*)w, (const float*)wt, (const float*)peeps,
        (const int*)lens, (const float*)c0, (const float*)cs,
        (const float*)gates, (const float*)g_hs, (const float*)g_hl,
        (const float*)g_cl, (float*)dx, (float*)dh0, (float*)dc0,
        (float*)dpeep_part, B, T, D, p, reverse, act, gate, state_act,
        (long long*)stamps, (cudaStream_t)stream);
}

// How many clusters of the plan the card holds at once: out = {forward,
// backward walk} (cudaOccupancyMaxActiveClusters; 0 where it holds none, or
// where a kernel's shared memory exceeds the device's limit).
int lstm_plan_occupancy(int D, int clusters, int ctas, int rows, int units,
                        int res_fwd, int res_bwd, int* out) {
    const Plan p = make_plan(clusters, ctas, rows, units, res_fwd, res_bwd);
    const void* fns[] = {
        reinterpret_cast<const void*>(fwd_instance<false>(fwd_quads(D, p))),
        reinterpret_cast<const void*>(bwd_instance<false>(bwd_quads(D, p)))};
    const size_t smem[] = {fwd_smem_bytes(D, p), bwd_smem_bytes(D, p)};
    for (int which = 0; which < 2; ++which) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        out[which] = 0;
        cudaError_t err = prepare_cluster(fns[which], smem[which], p, nullptr,
                                          &cfg, attr);
        if (err == cudaErrorInvalidValue
                || err == cudaErrorInvalidConfiguration) {
            cudaGetLastError();
            continue;
        }
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveClusters(&out[which], fns[which], &cfg);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// The runtime's account of a kernel (which: 0 forward, 1 backward walk,
// 2 dW product, 3 ordered sums) for the plan's shared memory at hidden size
// D: out = {registers, local memory bytes per thread, static shared memory
// bytes, dynamic shared memory bytes}.
int lstm_kernel_attributes(int which, int D, int clusters, int ctas,
                           int rows, int units, int res_fwd, int res_bwd,
                           int* out) {
    const Plan p = make_plan(clusters, ctas, rows, units, res_fwd, res_bwd);
    const void* fns[] = {
        reinterpret_cast<const void*>(fwd_instance<false>(fwd_quads(D, p))),
        reinterpret_cast<const void*>(bwd_instance<false>(bwd_quads(D, p))),
        reinterpret_cast<const void*>(&lstm_dw_kernel),
        reinterpret_cast<const void*>(&lstm_reduce_kernel)};
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
int lstm_device_limits(int* sm_count, int* smem_optin) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

const char* lstm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
