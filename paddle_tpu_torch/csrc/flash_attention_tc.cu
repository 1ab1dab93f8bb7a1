// Flash attention on Hopper's tensor cores (sm_90a), bfloat16 inputs:
// forward, backward dQ, backward dK/dV.
//
// Replaces, for bfloat16, the three Pallas TPU kernels of
// paddle_tpu/ops/pallas_attention.py:
//   flash_fwd_tc_kernel     <- _fwd_kernel      (launched by _fwd_call)
//   flash_bwd_dq_tc_kernel  <- _bwd_dq_kernel   (launched by _bwd_call)
//   flash_bwd_dkv_tc_kernel <- _bwd_dkv_kernel  (launched by _bwd_call)
// float32 inputs go to flash_attention.cu (three TF32 passes, the card's
// counterpart of the TPU kernels' Precision.HIGHEST).  For bf16 inputs the TPU
// kernels multiply at the MXU's default precision: bf16 operands, float32
// sums, p and dS rounded to bf16 where they enter a product.  These kernels
// compute the same, every product mma.sync m16n8k16 bf16 x bf16 -> f32,
// with one exception: the forward's p enters P V as two bf16 terms,
// bf16(p) + bf16(p - bf16(p)), two products.  With one term, o misses its
// limit against the float32 version (2^-7 |o| + 1e-3) on causal rows with
// few keys whose values cancel; the gradients, held to 1e-2 of their max,
// keep one term (tests/test_torch_flash_attention.py models both).
//
// The function and layout are flash_attention.cu's: q [B, Tq, H, D], k/v
// [B, Tk, Hkv, D], kv_mask [B, Tk] (uint8), lse/delta [B, H, Tq] float32;
// grouped query heads resolved here; causal and window masks on global
// positions q_off + row / k_off + column; tiles the causal/window mask kills
// are skipped; a fully masked row gives o = 0 and lse = -inf; D <= 128
// (instances for D <= 64 and D <= 128, zero-filled) and the ragged edges of
// Tq and Tk masked here.  Where D % 8 != 0 or a row is not 16-byte aligned
// the same kernels load element by element instead of by cp.async.
//
// What bounds it: at the training shape ([8, 2048, 8, 64] causal) attention
// does ~4 T^2 D flops per head (forward) against ~4 T D bytes, so the bound
// is the tensor-core rate, 989 TFLOP/s bf16.  The design, FlashAttention-2's:
//   - one CTA of 4 warps per 64-row tile, one warp per 16 rows, so each
//     warp's softmax rows never leave its registers;
//   - the streamed tiles (K/V in the forward and dQ, Q/dO in dK/dV) go
//     through a 2-stage cp.async ring in shared memory, the next tile's copy
//     in flight while the current one is multiplied; rows are XOR-swizzled
//     in 16-byte chunks so the ldmatrix reads hit 32 distinct banks;
//   - S = Q K^T and P V (and the backward's products) are mma.sync with
//     float32 sums; P (or dS) goes from the accumulator fragment straight to
//     the A fragment(s) of the next product as bf16 (the m16n8 C layout
//     pairs into the m16n8k16 A layout), never through shared memory;
//   - the online softmax runs in registers with quad shuffles and exp2f,
//     scale * log2(e) folded into one multiply; masks are per element from
//     positions, applied only on tiles that need them;
//   - dK/dV compute S^T = K Q^T directly, so P^T and dS^T come out of the
//     accumulator already in the A layout; one CTA owns each dK/dV tile
//     (walking every query head of the kv head's group), so there are no
//     atomics and the gradients are deterministic, at the cost of
//     recomputing S and dP in both backward kernels;
//   - q tiles are walked longest-first (reverse blockIdx.x) so the causal
//     triangle's heavy tiles do not form a tail;
//   - the kernels are bound by latency (each warp's chain of ldmatrix, mma,
//     softmax and barrier), so their time follows the warps resident per
//     SM: at D <= 64 the backward kernels walk each tile in passes of 16
//     columns, which leaves their registers few enough for 4 (dQ) and 3
//     (dK/dV) CTAs per SM (__launch_bounds__), and each lane keeps one
//     ldmatrix address per operand (see lane_a) instead of one per block.
// Left to later: wgmma with TMA staging and warp specialisation (one
// producer warp, consumer warpgroups, FlashAttention-3's shape), which
// mma.sync cannot reach.
//
// C interface (bound with ctypes, the same as flash_attention.cu's): each
// *_launch() launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
// Two more entries serve chip_smoke.py's checks only: each instance's
// registers, local memory and shared memory (flash_kernel_attributes), and
// the forward with one-term p (flash_fwd_one_term_launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 128;    // 4 warps, 16 tile rows each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Mask {
  int causal;   // 0/1
  int window;   // < 0: none; else keep |qpos - kpos| < window
  int q_off;
  int k_off;

  // false iff the causal/window mask kills the whole 64 x 64 tile
  // (pallas_attention._tile_live)
  __device__ bool live(int q0, int k0) const {
    const int q_lo = q_off + q0, q_hi = q_lo + kBQ - 1;
    const int k_lo = k_off + k0, k_hi = k_lo + kBK - 1;
    bool ok = true;
    if (causal) ok = ok && (k_lo <= q_hi);
    if (window >= 0) {
      ok = ok && (k_hi > q_lo - window);
      if (!causal) ok = ok && (k_lo < q_hi + window);
    }
    return ok;
  }
  // (query row r, key column c) kept (pallas_attention._tile_mask)
  __device__ bool keep(int r, int c) const {
    const int qp = q_off + r, kp = k_off + c;
    if (causal && kp > qp) return false;
    if (window >= 0 && abs(qp - kp) >= window) return false;
    return true;
  }
  // some pair of rows [q0, q0 + nq) x columns [k0, k0 + nk) is masked
  __device__ bool partial(int q0, int nq, int k0, int nk) const {
    const int qa = q_off + q0, qb = qa + nq - 1;
    const int ka = k_off + k0, kb = ka + nk - 1;
    if (causal && kb > qa) return true;
    return window >= 0 && (qb - ka >= window || kb - qa >= window);
  }
};

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills when !full (src is then
// not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), D 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) - bf16(x0, x1): the second bf16 term of a two-term split
__device__ __forceinline__ uint32_t pack_bf16_rest(float x0, float x1,
                                                   uint32_t first) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&first);
  return pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// -- shared-memory tiles ------------------------------------------------------
// A tile is [64][DM] bf16 at a 1 KB-aligned shared address, row r's 16-byte
// chunk c stored at chunk c ^ (r & 7): the 8 rows one ldmatrix phase reads
// land in 8 distinct 16-byte bank groups.  For the 8 rows r0..r0+7 (r0 % 8
// == 0) that a lane's ldmatrix address walks, the chunk 2j + h (h = 0, 1)
// sits at byte (2j + h) ^ (r & 7) = ((h ^ (r & 7)) << 4) ^ (j << 5) of the
// row: each lane keeps one address per operand and XORs in the 32-byte
// column block j, so no per-block address is held in a register.

template <int DM>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row,
                                              int col) {
  return base + row * (DM * 2) + ((((col >> 3) ^ (row & 7))) << 4);
}

// this lane's ldmatrix.x4 address for an A operand (rows row0..row0+15,
// columns 0..15); column block kb at lane_a ^ (kb << 5)
template <int DM>
__device__ __forceinline__ uint32_t lane_a(uint32_t tile, int row0) {
  const int lane = threadIdx.x & 31;
  return tile + (row0 + (lane & 15)) * (DM * 2) +
         (((lane >> 4) ^ (lane & 7)) << 4);
}
// ... for two 8-column B operands read as stored (rows row0..row0+15 are
// the product's columns, 16 columns the k block); k block kb at
// lane_b ^ (kb << 5), the next 16 rows at + 16 * DM * 2
template <int DM>
__device__ __forceinline__ uint32_t lane_b(uint32_t tile, int row0) {
  const int lane = threadIdx.x & 31;
  return tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * (DM * 2) +
         ((((lane >> 3) & 1) ^ (lane & 7)) << 4);
}
// ... for two 8-column B operands read transposed (rows row0..row0+15 are
// the k block, 16 columns the product's); column block n2 at
// lane_t ^ (n2 << 5), the next 16 rows at + 16 * DM * 2
template <int DM>
__device__ __forceinline__ uint32_t lane_t(uint32_t tile, int row0) {
  const int lane = threadIdx.x & 31;
  return tile + (row0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * (DM * 2) +
         (((lane >> 4) ^ (lane & 7)) << 4);
}

// rows [0, 64) x columns [0, DM) of a [n_rows, D] slice (row stride `stride`
// elements) into a tile; rows >= n_rows and columns >= D are zero.  vec:
// 16-byte cp.async copies; else element-wise loads and stores.
template <int DM>
__device__ __forceinline__ void load_tile(uint32_t base, const bf16* src,
                                          int n_rows, int64_t stride, int D,
                                          bool vec) {
  constexpr int CH = DM / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < 64 * CH / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / CH, c = e % CH;
    const uint32_t d = tile_addr<DM>(base, r, c * 8);
    if (vec) {
      const bool ok = r < n_rows && c * 8 < D;
      cp_async16(d, ok ? src + r * stride + c * 8 : src, ok);
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = c * 8 + 2 * j;
        const uint32_t lo =
            (r < n_rows && c0 < D) ? s[r * stride + c0] : 0u;
        const uint32_t hi =
            (r < n_rows && c0 + 1 < D) ? s[r * stride + c0 + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
    }
  }
}

// acc[16 x 8N] = A[16 x DM] B[8N x DM]^T from shared tiles: a_addr from
// lane_a (A's rows), b_addr from lane_b (B's rows are the product's columns).
// At DM = 128 the k blocks are unrolled by 2 only: fully unrolled, ptxas
// hoists all their fragment loads and the dK/dV kernel spills.
template <int DM, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], uint32_t a_addr,
                                        uint32_t b_addr) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
#pragma unroll(DM <= 64 ? DM / 16 : 2)
  for (int kb = 0; kb < DM / 16; ++kb) {
    uint32_t a[4];
    ldsm_x4(a, a_addr ^ (kb << 5));
#pragma unroll
    for (int n2 = 0; n2 < N / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, (b_addr ^ (kb << 5)) + n2 * 16 * DM * 2);
      mma(acc[2 * n2], a, b[0], b[1]);
      mma(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x DM] += P[16 x 8N] V[8N x DM]: P is this warp's accumulator
// fragment of a 16 x 8N product, V a shared tile read transposed (v_addr
// from lane_t).  P enters as bf16(P), or with TWO_TERMS as bf16(P) +
// bf16(P - bf16(P)) (two products, 16 significant bits).
template <int DM, bool TWO_TERMS, int N>
__device__ __forceinline__ void mma_pv(float (&acc)[DM / 8][4],
                                       const float (&p)[N][4],
                                       uint32_t v_addr) {
#pragma unroll
  for (int kb = 0; kb < N / 2; ++kb) {
    const float* p0 = p[2 * kb];
    const float* p1 = p[2 * kb + 1];
    const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                           pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
    uint32_t r[4];
    if (TWO_TERMS) {
      r[0] = pack_bf16_rest(p0[0], p0[1], a[0]);
      r[1] = pack_bf16_rest(p0[2], p0[3], a[1]);
      r[2] = pack_bf16_rest(p1[0], p1[1], a[2]);
      r[3] = pack_bf16_rest(p1[2], p1[3], a[3]);
    }
#pragma unroll
    for (int n2 = 0; n2 < DM / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4_t(b, (v_addr ^ (n2 << 5)) + kb * 16 * DM * 2);
      mma(acc[2 * n2], a, b[0], b[1]);
      mma(acc[2 * n2 + 1], a, b[2], b[3]);
      if (TWO_TERMS) {
        mma(acc[2 * n2], r, b[0], b[1]);
        mma(acc[2 * n2 + 1], r, b[2], b[3]);
      }
    }
  }
}

// the 1 KB-aligned start of the dynamic shared memory (kSmemAlign bytes are
// requested beyond the tiles) as a shared address and a generic pointer
constexpr int kSmemAlign = 1024;
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw, uint8_t*& ptr) {
  const uint32_t at = smem_u32(raw);
  const uint32_t base = (at + kSmemAlign - 1) & ~(kSmemAlign - 1u);
  ptr = raw + (base - at);
  return base;
}

// first and last index i in [0, n) with live(i), lo > hi when none
template <typename F>
__device__ __forceinline__ void live_range(int n, F live, int& lo, int& hi) {
  lo = n;
  hi = -1;
  for (int i = 0; i < n; ++i)
    if (live(i)) {
      if (lo == n) lo = i;
      hi = i;
    }
}

// two values of one output row at columns col, col + 1 (< D)
__device__ __forceinline__ void store_pair(bf16* row, int col, float x0,
                                           float x1, int D, bool vec) {
  if (vec) {
    if (col < D)
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < D) row[col] = __float2bfloat16(x0);
    if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// key validity of column `col` of a key tile (kv_mask and the ragged edge)
__device__ __forceinline__ int key_valid(const uint8_t* kv_row, int col,
                                         int Tk) {
  return (col < Tk && kv_row[col] != 0) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// forward: CTA (q tile, head, batch); warp w owns rows 16w..16w+15 and the
// online-softmax state (m, l, o) of its rows in registers.  TWO_TERMS =
// false rounds p to one bf16 term in P V, the TPU kernel's arithmetic; only
// flash_fwd_one_term_launch (a measurement of what the second term costs)
// takes it
// ---------------------------------------------------------------------------
template <int DM, bool TWO_TERMS = true>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask, bf16* __restrict__ o,
                    float* __restrict__ lse, int Tq, int Tk, int H, int Hkv,
                    int D, float scale, Mask mk, int vec) {
  constexpr int TB = 64 * DM * 2;  // bytes of one tile
  constexpr int NB = DM / 8;       // 8-column blocks of the output
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t sQ = smem_base(smem_raw, smem);
  const uint32_t sK = sQ + TB;           // [2] tiles
  const uint32_t sV = sK + 2 * TB;       // [2] tiles
  uint8_t* sKv = smem + 5 * TB;          // [2][kBK]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const bf16* qb = q + (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                   static_cast<int64_t>(h) * D;
  const bf16* kb = k + static_cast<int64_t>(b) * Tk * k_stride +
                   static_cast<int64_t>(hk) * D;
  const bf16* vb = v + static_cast<int64_t>(b) * Tk * k_stride +
                   static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;

  int lo, hi;
  live_range((Tk + kBK - 1) / kBK,
             [&](int i) { return mk.live(q0, i * kBK); }, lo, hi);

  // group 0: Q; group 1: the first live K/V tile
  load_tile<DM>(sQ, qb, Tq - q0, q_stride, D, vec);
  cp_async_commit();
  int kv_ok = 1;  // this thread's key validity (threads < kBK) of the tile
  if (lo <= hi) {
    load_tile<DM>(sK, kb + lo * kBK * k_stride, Tk - lo * kBK, k_stride, D,
                  vec);
    load_tile<DM>(sV, vb + lo * kBK * k_stride, Tk - lo * kBK, k_stride, D,
                  vec);
    if (tid < kBK) {
      kv_ok = key_valid(kv_row, lo * kBK + tid, Tk);
      sKv[tid] = kv_ok;
    }
  }
  cp_async_commit();
  cp_async_wait_1();
  __syncthreads();

  uint32_t qf[DM / 16][4];
  const uint32_t q_addr = lane_a<DM>(sQ, warp * 16);
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) ldsm_x4(qf[kk], q_addr ^ (kk << 5));
  const uint32_t k_addr = lane_b<DM>(sK, 0), v_addr = lane_t<DM>(sV, 0);

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

  for (int t = lo; t <= hi; ++t) {
    const int st = (t - lo) & 1;
    const bool next = t < hi;
    int kv_next = 1;
    if (next) {
      const int kn = (t + 1) * kBK;
      load_tile<DM>(sK + (st ^ 1) * TB, kb + kn * k_stride, Tk - kn,
                    k_stride, D, vec);
      load_tile<DM>(sV + (st ^ 1) * TB, vb + kn * k_stride, Tk - kn,
                    k_stride, D, vec);
      if (tid < kBK) kv_next = key_valid(kv_row, kn + tid, Tk);
    }
    cp_async_commit();
    cp_async_wait_1();
    const int all_kv = __syncthreads_and(kv_ok);

    const int k0 = t * kBK;
    const uint32_t kt = k_addr + st * TB;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, (kt ^ (kk << 5)) + n2 * 16 * DM * 2);
        mma(s[2 * n2], qf[kk], bf[0], bf[1]);
        mma(s[2 * n2 + 1], qf[kk], bf[2], bf[3]);
      }

    if (!all_kv || mk.partial(q0 + warp * 16, 16, k0, kBK)) {
      const uint8_t* kvs = sKv + st * kBK;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t4 + e;
          const bool ok = kvs[c] != 0;
          s[n][e] = (ok && mk.keep(r0, k0 + c)) ? s[n][e] * sl2
                                                 : -CUDART_INF_F;
          s[n][2 + e] = (ok && mk.keep(r0 + 8, k0 + c)) ? s[n][2 + e] * sl2
                                                         : -CUDART_INF_F;
        }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] *= sl2;
    }

    // online softmax in the log2 domain; rows r0 (i = 0) and r0 + 8 (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][2 * i] = exp2f(s[n][2 * i] - base);
        s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - base);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l[i] = l[i] * corr + sum;  // this thread's columns; quad-summed last
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
    mma_pv<DM, TWO_TERMS>(acc, s, v_addr + st * TB);

    if (next && tid < kBK) sKv[(st ^ 1) * kBK + tid] = kv_next;
    kv_ok = kv_next;
    __syncthreads();  // stage st is read; the next copy may overwrite it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float li = quad_sum(l[i]);
    if (r >= Tq) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    bf16* orow = o + (static_cast<int64_t>(b) * Tq + r) * q_stride +
                 static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store_pair(orow, n * 8 + 2 * t4, acc[n][2 * i] * inv,
                 acc[n][2 * i + 1] * inv, D, vec);
    if (t4 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + r] =
          li > 0.f ? m[i] * kLn2 + logf(li) : -CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// backward dQ: CTA (q tile, head, batch) walks the live key tiles;
// p = exp(s - lse), ds = p (dp - delta) scale, dq += bf16(ds) k
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads, DM <= 64 ? 4 : 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const uint8_t* __restrict__ kv_mask,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Tq, int Tk, int H, int Hkv, int D, float scale,
                       Mask mk, int vec) {
  constexpr int TB = 64 * DM * 2;
  constexpr int NB = DM / 8;
  constexpr int KC = DM <= 64 ? 16 : 32;  // keys per pass
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t sQ = smem_base(smem_raw, smem);
  const uint32_t sdO = sQ + TB;
  const uint32_t sK = sdO + TB;          // [2] tiles
  const uint32_t sV = sK + 2 * TB;       // [2] tiles
  uint8_t* sKv = smem + 6 * TB;          // [2][kBK]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                         static_cast<int64_t>(h) * D;
  const bf16* kb = k + static_cast<int64_t>(b) * Tk * k_stride +
                   static_cast<int64_t>(hk) * D;
  const bf16* vb = v + static_cast<int64_t>(b) * Tk * k_stride +
                   static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;
  const int64_t row_base = (static_cast<int64_t>(b) * H + h) * Tq;

  int lo, hi;
  live_range((Tk + kBK - 1) / kBK,
             [&](int i) { return mk.live(q0, i * kBK); }, lo, hi);

  int kv_ok = 1;
  if (lo <= hi) {  // else no copy: dq = 0 and nothing may be in flight
    load_tile<DM>(sQ, q + q_base, Tq - q0, q_stride, D, vec);
    load_tile<DM>(sdO, dout + q_base, Tq - q0, q_stride, D, vec);
  }
  cp_async_commit();
  if (lo <= hi) {
    load_tile<DM>(sK, kb + lo * kBK * k_stride, Tk - lo * kBK, k_stride, D,
                  vec);
    load_tile<DM>(sV, vb + lo * kBK * k_stride, Tk - lo * kBK, k_stride, D,
                  vec);
    if (tid < kBK) {
      kv_ok = key_valid(kv_row, lo * kBK + tid, Tk);
      sKv[tid] = kv_ok;
    }
  }
  cp_async_commit();

  // rows r0 (i = 0) and r0 + 8 (i = 1): lse in the log2 domain (+inf for
  // rows past Tq or without a key: p = 0 there) and delta
  const int r0 = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float x = r < Tq ? lse[row_base + r] : -CUDART_INF_F;
    lse2[i] = x > -CUDART_INF_F ? x * kLog2e : CUDART_INF_F;
    dl[i] = r < Tq ? delta[row_base + r] : 0.f;
  }

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  const float sl2 = scale * kLog2e;
  const uint32_t q_addr = lane_a<DM>(sQ, warp * 16);
  const uint32_t do_addr = lane_a<DM>(sdO, warp * 16);
  const uint32_t k_addr = lane_b<DM>(sK, 0), v_addr = lane_b<DM>(sV, 0);
  const uint32_t kt_addr = lane_t<DM>(sK, 0);

  for (int t = lo; t <= hi; ++t) {
    const int st = (t - lo) & 1;
    const bool next = t < hi;
    int kv_next = 1;
    if (next) {
      const int kn = (t + 1) * kBK;
      load_tile<DM>(sK + (st ^ 1) * TB, kb + kn * k_stride, Tk - kn,
                    k_stride, D, vec);
      load_tile<DM>(sV + (st ^ 1) * TB, vb + kn * k_stride, Tk - kn,
                    k_stride, D, vec);
      if (tid < kBK) kv_next = key_valid(kv_row, kn + tid, Tk);
    }
    cp_async_commit();
    cp_async_wait_1();
    const int all_kv = __syncthreads_and(kv_ok);

    const int k0 = t * kBK;
    const bool need = !all_kv || mk.partial(q0 + warp * 16, 16, k0, kBK);
    const uint8_t* kvs = sKv + st * kBK;
    // the tile's keys in passes of KC: the dQ sums and both 16 x KC
    // fragments stay in registers, few enough for 4 CTAs per SM at DM = 64
#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      mma_abt<DM>(s, q_addr, k_addr + st * TB + c0 * DM * 2);
      mma_abt<DM>(dp, do_addr, v_addr + st * TB + c0 * DM * 2);
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + n * 8 + 2 * t4 + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * i + e;
            float p = exp2f(fmaf(s[n][j], sl2, -lse2[i]));
            if (need && !(kvs[c] != 0 && mk.keep(r0 + 8 * i, k0 + c)))
              p = 0.f;
            s[n][j] = p * (dp[n][j] - dl[i]) * scale;
          }
        }
      // dq += bf16(ds) k
      mma_pv<DM, false>(acc, s, kt_addr + st * TB + c0 * DM * 2);
    }

    if (next && tid < kBK) sKv[(st ^ 1) * kBK + tid] = kv_next;
    kv_ok = kv_next;
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Tq) continue;
    bf16* row = dq + (static_cast<int64_t>(b) * Tq + r) * q_stride +
                static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      store_pair(row, n * 8 + 2 * t4, acc[n][2 * i], acc[n][2 * i + 1], D,
                 vec);
  }
}

// ---------------------------------------------------------------------------
// backward dK, dV: CTA (k tile, kv head, batch); warp w owns keys
// 16w..16w+15 and walks every (query head of the group) x (live q tile);
// S^T = K Q^T, dP^T = V dO^T, dv += bf16(p^T) do, dk += bf16(ds^T) q
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads, DM <= 64 ? 3 : 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const uint8_t* __restrict__ kv_mask,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq,
                        int Tk, int H, int Hkv, int D, float scale, Mask mk,
                        int vec) {
  constexpr int TB = 64 * DM * 2;
  constexpr int NB = DM / 8;
  constexpr int QC = DM <= 64 ? 16 : 32;  // q columns of S^T per pass
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t sK = smem_base(smem_raw, smem);
  const uint32_t sV = sK + TB;
  const uint32_t sQ = sV + TB;           // [2] tiles
  const uint32_t sdO = sQ + 2 * TB;      // [2] tiles
  float* sL = reinterpret_cast<float*>(smem + 6 * TB);  // [2][kBQ]
  float* sDl = sL + 2 * kBQ;  // [2][kBQ]: lse * log2(e) and delta of q rows

  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Tk + k0) * k_stride +
                         static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;

  int lo, hi;
  live_range((Tq + kBQ - 1) / kBQ,
             [&](int i) { return mk.live(i * kBQ, k0); }, lo, hi);
  const int n_live = hi >= lo ? hi - lo + 1 : 0;
  const int n_items = rep * n_live;  // (group head, q tile) pairs

  // item -> its head's q/dO tile, and this thread's lse (tid < 64) or delta
  // (tid >= 64) value for row tid & 63 of it
  auto issue = [&](int item, int stage) -> float {
    const int h = hk * rep + item / n_live;
    const int q0 = (lo + item % n_live) * kBQ;
    const int64_t q_base = (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                           static_cast<int64_t>(h) * D;
    load_tile<DM>(sQ + stage * TB, q + q_base, Tq - q0, q_stride, D, vec);
    load_tile<DM>(sdO + stage * TB, dout + q_base, Tq - q0, q_stride, D,
                  vec);
    const int r = q0 + (tid & 63);
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + r;
    if (tid < 64) {
      const float x = r < Tq ? lse[at] : -CUDART_INF_F;
      return x > -CUDART_INF_F ? x * kLog2e : CUDART_INF_F;
    }
    return r < Tq ? delta[at] : 0.f;
  };
  auto stash = [&](float x, int stage) {
    (tid < 64 ? sL : sDl)[stage * kBQ + (tid & 63)] = x;
  };

  if (n_items > 0) {  // else no copy: dk = dv = 0, nothing in flight
    load_tile<DM>(sK, k + k_base, Tk - k0, k_stride, D, vec);
    load_tile<DM>(sV, v + k_base, Tk - k0, k_stride, D, vec);
  }
  cp_async_commit();
  if (n_items > 0) stash(issue(0, 0), 0);
  cp_async_commit();

  // this thread's key rows kr0 (i = 0) and kr0 + 8 (i = 1)
  const int kr0 = k0 + warp * 16 + g;
  const bool kv0 = key_valid(kv_row, kr0, Tk) != 0;
  const bool kv1 = key_valid(kv_row, kr0 + 8, Tk) != 0;
  const int all_kv = __syncthreads_and(kv0 && kv1);

  float dka[NB][4], dva[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;
  const float sl2 = scale * kLog2e;
  const uint32_t k_addr = lane_a<DM>(sK, warp * 16);
  const uint32_t v_addr = lane_a<DM>(sV, warp * 16);

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    const bool next = it + 1 < n_items;
    float ld_next = 0.f;
    if (next) ld_next = issue(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const int q0 = (lo + it % n_live) * kBQ;
    const uint32_t sQt = sQ + st * TB, sdOt = sdO + st * TB;
    const float* lt = sL + st * kBQ;
    const float* dt = sDl + st * kBQ;
    const bool need = !all_kv || q0 + kBQ > Tq ||
                      mk.partial(q0, kBQ, k0 + warp * 16, 16);

    // the tile's q rows in passes of QC columns of S^T: the dK/dV sums and
    // both 16 x QC fragments stay in registers, few enough for 3 CTAs per
    // SM at DM = 64
#pragma unroll 1
    for (int c0 = 0; c0 < kBQ; c0 += QC) {
      float s[QC / 8][4];  // S^T, then P^T
      mma_abt<DM>(s, k_addr, lane_b<DM>(sQt, c0));
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + n * 8 + 2 * t4 + e;
          const float l2 = lt[c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float p = exp2f(fmaf(s[n][2 * i + e], sl2, -l2));
            if (need && !((i ? kv1 : kv0) && q0 + c < Tq &&
                          mk.keep(q0 + c, kr0 + 8 * i)))
              p = 0.f;
            s[n][2 * i + e] = p;
          }
        }
      mma_pv<DM, false>(dva, s, lane_t<DM>(sdOt, c0));  // dv += bf16(p^T) do

      float dp[QC / 8][4];  // dP^T, then dS^T
      mma_abt<DM>(dp, v_addr, lane_b<DM>(sdOt, c0));
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = dt[c0 + n * 8 + 2 * t4 + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * i + e;
            dp[n][j] = s[n][j] * (dp[n][j] - d) * scale;
          }
        }
      mma_pv<DM, false>(dka, dp, lane_t<DM>(sQt, c0));  // dk += bf16(ds^T) q
    }

    if (next) stash(ld_next, st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = kr0 + 8 * i;
    if (kr >= Tk) continue;
    const int64_t at = (static_cast<int64_t>(b) * Tk + kr) * k_stride +
                       static_cast<int64_t>(hk) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      store_pair(dk + at, n * 8 + 2 * t4, dka[n][2 * i], dka[n][2 * i + 1], D,
                 vec);
      store_pair(dv + at, n * 8 + 2 * t4, dva[n][2 * i], dva[n][2 * i + 1], D,
                 vec);
    }
  }
}

// dynamic shared memory of each kernel, in bytes
template <int DM>
constexpr size_t fwd_smem() {
  return kSmemAlign + 5 * 64 * DM * sizeof(bf16) + 2 * kBK;
}
template <int DM>
constexpr size_t dq_smem() {
  return kSmemAlign + 6 * 64 * DM * sizeof(bf16) + 2 * kBK;
}
template <int DM>
constexpr size_t dkv_smem() {
  return kSmemAlign + 6 * 64 * DM * sizeof(bf16) + 4 * kBQ * sizeof(float);
}

template <typename K>
int attributes(K kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem);
  return 0;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool bad_shape(int B, int Tq, int Tk, int H, int Hkv, int D) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         D <= 0 || D > 128 || B > 65535 || H > 65535;
}

// 16-byte copies need D % 8 == 0 (16-byte rows) and 16-byte aligned bases
bool vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int DM, bool TWO_TERMS = true>
int fwd_dm(const void* q, const void* k, const void* v, const uint8_t* kvm,
           void* o, float* lse, int B, int Tq, int Tk, int H, int Hkv, int D,
           float scale, Mask mk, int vec, cudaStream_t stream) {
  const size_t bytes = fwd_smem<DM>();
  if (int rc = set_smem(flash_fwd_tc_kernel<DM, TWO_TERMS>, bytes)) return rc;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_tc_kernel<DM, TWO_TERMS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kvm, static_cast<bf16*>(o), lse, Tq, Tk,
      H, Hkv, D, scale, mk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int dq_dm(const void* q, const void* k, const void* v, const uint8_t* kvm,
          const void* dout, const float* lse, const float* delta, void* dq,
          int B, int Tq, int Tk, int H, int Hkv, int D, float scale, Mask mk,
          int vec, cudaStream_t stream) {
  const size_t bytes = dq_smem<DM>();
  if (int rc = set_smem(flash_bwd_dq_tc_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_tc_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kvm, static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), Tq, Tk, H, Hkv, D, scale, mk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int dkv_dm(const void* q, const void* k, const void* v, const uint8_t* kvm,
           const void* dout, const float* lse, const float* delta, void* dk,
           void* dv, int B, int Tq, int Tk, int H, int Hkv, int D,
           float scale, Mask mk, int vec, cudaStream_t stream) {
  const size_t bytes = dkv_smem<DM>();
  if (int rc = set_smem(flash_bwd_dkv_tc_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkv_tc_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kvm, static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H, Hkv,
      D, scale, mk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// window < 0 = no sliding window.  Each returns a cudaError_t value.
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* o, void* lse, int B, int Tq,
                     int Tk, int H, int Hkv, int D, float scale, int causal,
                     int window, int q_off, int k_off, void* stream) {
  if (bad_shape(B, Tq, Tk, H, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{causal, window, q_off, k_off};
  const int vec = vec_ok(D, {q, k, v, o});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* l = static_cast<float*>(lse);
  return D <= 64 ? fwd_dm<64>(q, k, v, kvm, o, l, B, Tq, Tk, H, Hkv, D, scale,
                              mk, vec, s)
                 : fwd_dm<128>(q, k, v, kvm, o, l, B, Tq, Tk, H, Hkv, D,
                               scale, mk, vec, s);
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* kv_mask, const void* dout,
                        const void* lse, const void* delta, void* dq, int B,
                        int Tq, int Tk, int H, int Hkv, int D, float scale,
                        int causal, int window, int q_off, int k_off,
                        void* stream) {
  if (bad_shape(B, Tq, Tk, H, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{causal, window, q_off, k_off};
  const int vec = vec_ok(D, {q, k, v, dout, dq});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return D <= 64 ? dq_dm<64>(q, k, v, kvm, dout, l, dl, dq, B, Tq, Tk, H, Hkv,
                             D, scale, mk, vec, s)
                 : dq_dm<128>(q, k, v, kvm, dout, l, dl, dq, B, Tq, Tk, H,
                              Hkv, D, scale, mk, vec, s);
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* kv_mask, const void* dout,
                         const void* lse, const void* delta, void* dk,
                         void* dv, int B, int Tq, int Tk, int H, int Hkv,
                         int D, float scale, int causal, int window,
                         int q_off, int k_off, void* stream) {
  if (bad_shape(B, Tq, Tk, H, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{causal, window, q_off, k_off};
  const int vec = vec_ok(D, {q, k, v, dout, dk, dv});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return D <= 64 ? dkv_dm<64>(q, k, v, kvm, dout, l, dl, dk, dv, B, Tq, Tk, H,
                              Hkv, D, scale, mk, vec, s)
                 : dkv_dm<128>(q, k, v, kvm, dout, l, dl, dk, dv, B, Tq, Tk,
                               H, Hkv, D, scale, mk, vec, s);
}

// the forward with p as one bf16 term in P V, the TPU kernel's rounding,
// D <= 64 only: not on any path, it measures what the second term costs
int flash_fwd_one_term_launch(const void* q, const void* k, const void* v,
                              const void* kv_mask, void* o, void* lse, int B,
                              int Tq, int Tk, int H, int Hkv, int D,
                              float scale, int causal, int window, int q_off,
                              int k_off, void* stream) {
  if (bad_shape(B, Tq, Tk, H, Hkv, D) || D > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return fwd_dm<64, false>(
      q, k, v, static_cast<const uint8_t*>(kv_mask), o,
      static_cast<float*>(lse), B, Tq, Tk, H, Hkv, D, scale,
      Mask{causal, window, q_off, k_off}, vec_ok(D, {q, k, v, o}),
      static_cast<cudaStream_t>(stream));
}

// registers, local memory bytes per thread (spills and stack; 0 = none) and
// dynamic shared memory of one kernel instance, as the runtime reports
// them, into out[0..2]: which 0 = forward, 1 = dQ, 2 = dK/dV; dm 64 or
// 128.  Returns a cudaError_t value.
int flash_kernel_attributes(int which, int dm, int* out) {
  if (dm != 64 && dm != 128) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = dm == 64;
  switch (which) {
    case 0:
      return small ? attributes(flash_fwd_tc_kernel<64>, fwd_smem<64>(), out)
                   : attributes(flash_fwd_tc_kernel<128>, fwd_smem<128>(),
                                out);
    case 1:
      return small ? attributes(flash_bwd_dq_tc_kernel<64>, dq_smem<64>(),
                                out)
                   : attributes(flash_bwd_dq_tc_kernel<128>, dq_smem<128>(),
                                out);
    case 2:
      return small ? attributes(flash_bwd_dkv_tc_kernel<64>, dkv_smem<64>(),
                                out)
                   : attributes(flash_bwd_dkv_tc_kernel<128>,
                                dkv_smem<128>(), out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
