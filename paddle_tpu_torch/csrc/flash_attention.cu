// Flash attention for Hopper (sm_90a) on the tensor cores, float32 inputs:
// forward, backward dQ, backward dK/dV.  bfloat16 inputs go to the kernels
// of flash_attention_tc.cu.
//
// Replaces, for float32, the three Pallas TPU kernels of
// paddle_tpu/ops/pallas_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (launched by _fwd_call)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (launched by _bwd_call)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (launched by _bwd_call)
// For float32 inputs the TPU kernels multiply at Precision.HIGHEST
// (_in_kernel_precision), fp32 emulated on the MXU in several bf16 passes.
// Hopper's counterpart is the three-pass TF32 split ("3xTF32"): each
// operand x is hi = tf32(x) and lo = tf32(x - hi), both rounded with
// cvt.rna, and a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b (the small terms
// first), every product an mma.sync m16n8k8 tf32 x tf32 -> f32 with float32
// sums.  That keeps ~22 significant bits against 11 for one TF32 pass; one
// pass errs by ~1e-3 in lse at scores of a few units, against a limit of
// 2e-5 (tests/test_torch_flash_attention.py models both).
//
// The function and layout are those of the kernels it replaces: q [B, Tq,
// H, D], k/v [B, Tk, Hkv, D], kv_mask [B, Tk] (uint8), lse/delta [B, H, Tq]
// float32; grouped query heads resolved here (query head h reads kv head
// h / (H / Hkv)); causal and window masks on global positions q_off + row /
// k_off + column; tiles the causal/window mask kills are skipped; a fully
// masked row gives o = 0 and lse = -inf; D <= 128 (instances for D <= 64
// and D <= 128, zero-filled) and the ragged edges of Tq and Tk masked here.
// Where D % 4 != 0 or a base is not 16-byte aligned the same kernels load
// element by element instead of by cp.async.  dK/dV have one owner per tile
// (the CTA walks the kv head's whole query-head group): no atomics, and the
// gradients repeat bit for bit.
//
// What bounds it: at the training shape ([8, 2048, 8, 64] causal) attention
// does ~4 T^2 D flops per head (forward) against ~4 T D bytes, so the bound
// is the rate of the products: three TF32 passes at the dense TF32 rate,
// 494.7 / 3 TFLOP/s of fp32 work (the CUDA cores' fp32 peak is 67).  The
// design, FlashAttention-2's as in flash_attention_tc.cu:
//   - one CTA of 4 warps per 64-row tile, one warp per 16 rows, so each
//     warp's softmax rows never leave its registers; q tiles walked
//     longest-first;
//   - the streamed tiles (K/V in the forward and dQ, Q/dO in dK/dV) are
//     split ONCE per tile into hi and lo planes in shared memory: cp.async
//     brings tile t + 1 raw into a staging buffer while tile t is
//     multiplied; then each thread splits the 16-byte chunks it copied
//     itself (no barrier guards the staging buffer) into the planes, between
//     two barriers.  Planes: 4 x 64 x DM floats, staging 2 x 64 x DM: 96 KB
//     at DM = 64, 2 CTAs per SM (__launch_bounds__), 192 KB at DM = 128, 1.
//     The split phase is not overlapped with the products (on an H100 at
//     [8, 2048, 8, 64] causal the forward took ~1070 us, ~730 with the
//     split left out); splitting B at each use instead, from a 2-stage ring
//     of raw tiles, was slower still (~1370 us): each warp then splits every
//     value it reads, 4x the work;
//   - the A operands that stay (Q, dO of the row tile in the forward and
//     dQ; K, V of the key tile in dK/dV) are held raw in registers at
//     DM = 64 (32 a lane) and split at each use; dK/dV's K and V, and
//     every A operand at DM = 128, are read again from global memory (L1)
//     at each use.  Held split they would take 64 registers each;
//   - registers: 2 CTAs per SM leave 255 a thread, and ptxas fills them.
//     What made every instance spill was the compiler keeping the staging
//     loops' per-chunk offsets (dozens of them) live through the products:
//     they are derived afresh from threadIdx.x at each use (tid_here).
//     At DM = 128 the o (and dK, dV) sums would take 64 (128) registers a
//     lane: the forward and dK/dV kernels produce their output columns in
//     two sweeps of 64, each walking every tile again (S and dP computed
//     twice, 1.5x the products; DM = 128 is on no path of the system);
//   - the tensor cores' float32 sums are not rounded to nearest, so their
//     error grows with the number of products summed in one accumulator:
//     summed straight into o, dK and dV over T = 2048, the gradients missed
//     2e-5 of their max.  Each product of P (or dS) with a tile goes into
//     fresh registers (24 products an element at most), which are added to
//     the running sums in float32 (add_product);
//   - accumulator to A operand: in tf32 the m16n8 accumulator does not pair
//     into the m16n8k8 A fragment (A's lane holds (g, t), (g + 8, t),
//     (g, t + 4), (g + 8, t + 4); C holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
//     (g + 8, 2t + 1)).  The sum over keys (or queries) does not depend on
//     their order, so C's columns 2t and 2t + 1 are read as A's k-columns t
//     and t + 4, and the B operand is read with the same permutation (rows
//     8 kb + 2t and 8 kb + 2t + 1 for b0 and b1): P V, dS K, P^T dO and
//     dS^T Q take P and dS straight from the accumulator, no shuffle, no
//     trip through shared memory;
//   - 32-bit operands: ldmatrix is 16-bit, so B is read with 32- and 64-bit
//     shared loads.  A product that contracts over d (S = Q K^T, dP = dO
//     V^T and their transposes) reads a plane along its rows: d is permuted
//     the same way (k-columns t and t + 4 hold d = 8 kk + 2t and 8 kk + 2t +
//     1, in A and in B), so b0 and b1 are one 64-bit load per plane.  A
//     product that contracts over the tile's rows (P V, dS K, P^T dO, dS^T
//     Q) reads a plane down its rows: two 32-bit loads per plane;
//   - one swizzle serves both reads: float column c of row r is stored at
//     c ^ (sw(r) << 3), sw(r) = (r ^ (r >> 2)) & 3 on r mod 8, rows DM
//     floats apart (a multiple of 32 banks).  Banks, as ncu cannot show them
//     on the chip machine:
//       row read, 64-bit, a half-warp per phase: lanes (g, t) read row
//       8n + g, words 8 (kk ^ sw(g)) + 2t, +1; the half-warp's 4 rows have
//       sw = 0, 1, 2, 3 (g 0-3) or 1, 0, 3, 2 (g 4-7): 4 x 8 distinct banks;
//       down the rows, 32-bit: lanes read rows 8 kb + 2t + e, word
//       8 (nb ^ sw(2t + e)) + g; sw(2t) = 0, 2, 1, 3 and sw(2t + 1) = 1, 3,
//       0, 2 over t: 32 distinct banks;
//       split writes, 128-bit, a quarter-warp per phase: 8 consecutive
//       chunks of one row, XORed within its 32 words: 32 distinct banks;
//     the staging buffer is read back by each thread's own consecutive
//     chunks, also free of conflicts;
//   - dQ walks each key tile in passes of 32 keys at DM = 64 (64 at 128),
//     so its fragments fit the registers beside Q and dO; dK/dV takes a q
//     tile whole (a pass of 32 was 14% slower at [8, 2048, 8, 64]);
//   - the online softmax runs in registers with quad shuffles and exp2f,
//     scale * log2(e) folded into one multiply; masks per element from
//     positions, applied only on tiles that need them.
// Left to later: wgmma (which takes tf32 too) with TMA staging and warp
// specialisation (a producer warp could split while the others multiply).
//
// C interface (bound with ctypes, the same as flash_attention_tc.cu's): each
// *_launch() launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
// flash_kernel_attributes serves chip_smoke.py's check of each instance's
// registers, local memory and shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

namespace {

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
// every group has landed (this thread's copies are visible to it)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest, ties away
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + O(2^-22 |x|), both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// the same, never moved out of the loop it sits in: an operand split at
// each use stays a split at each use, not a hoisted hi/lo copy that the
// registers cannot hold
__device__ __forceinline__ void split_here(float x, uint32_t& hi,
                                          uint32_t& lo) {
  asm volatile(
      "{\n .reg .f32 r;\n cvt.rna.tf32.f32 %0, %2;\n"
      " sub.f32 r, %2, %0;\n cvt.rna.tf32.f32 %1, r;\n}\n"
      : "=r"(hi), "=r"(lo)
      : "f"(x));
}
// a float from global memory, read where it stands (not hoisted)
__device__ __forceinline__ float ld_here(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(x) : "l"(p));
  return x;
}

// shared-memory loads at a shared address (asm volatile: never moved across
// the barriers that order them against the tile loads)
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// d += a b: A 16 x 8 tf32 (row), B 8 x 8 tf32 (col), D 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// o, dK and dV are summed in registers in sweeps of at most this many
// columns: at DM = 128 the forward and dK/dV kernels walk their tiles twice
constexpr int kSweepCols = 64;
// k steps unrolled together where the A operand comes from global memory
constexpr int kGlobalUnroll = 2;

// An operand split in hi and lo: A's four registers, or B's two
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

// d[n] += a b[n] for each n in three passes, the small terms first; each
// pass runs over every n, so consecutive products feed different
// accumulators
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const Split<4>& a,
                                     const Split<2> (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.hi, b[n].hi[0], b[n].hi[1]);
}

// the A operand of an accumulator fragment c (16 x 8, C layout): C's
// columns 2t, 2t + 1 become A's k-columns t, t + 4
__device__ __forceinline__ Split<4> a_from_acc(const float (&c)[4]) {
  Split<4> a;
  split(c[0], a.hi[0], a.lo[0]);  // (g, 2t)
  split(c[2], a.hi[1], a.lo[1]);  // (g + 8, 2t)
  split(c[1], a.hi[2], a.lo[2]);  // (g, 2t + 1)
  split(c[3], a.hi[3], a.lo[3]);  // (g + 8, 2t + 1)
  return a;
}

// -- shared-memory planes -----------------------------------------------------
// A plane is [64][DM] tf32 words at a 1 KB-aligned shared address, float
// column c of row r at c ^ (sw(r) << 3) (head note); a tile's lo plane
// follows its hi plane (TB bytes on).

__device__ __forceinline__ int sw(int r) { return (r ^ (r >> 2)) & 3; }

// this lane's byte offset in a plane for row reads (row g, words 2t, 2t + 1
// of column block 0); column block kk at lane_row ^ (kk << 5), row block
// 8n at + 8n * DM * 4
template <int DM>
__device__ __forceinline__ int lane_row() {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return g * DM * 4 + ((sw(g) << 5) | (t << 3));
}
// ... for reads down the rows: row 2t + e, word g of column block 0;
// column block nb at lane_col ^ (nb << 5), rows 8kb.. at + 8kb * DM * 4
template <int DM>
__device__ __forceinline__ int lane_col(int e) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 2 * t + e;
  return r * DM * 4 + ((sw(r) << 5) | (g << 2));
}

// B (n = tile rows row8 + g, k = d of column block kk), hi and lo planes
// at shared address `plane`
template <int DM>
__device__ __forceinline__ Split<2> b_row(uint32_t plane, int row8, int lrow,
                                          int kk) {
  constexpr int TB = 64 * DM * 4;
  const uint32_t at = plane + row8 * DM * 4 + (lrow ^ (kk << 5));
  const uint2 h = lds64(at);
  const uint2 l = lds64(at + TB);
  Split<2> b;
  b.hi[0] = h.x;
  b.hi[1] = h.y;
  b.lo[0] = l.x;
  b.lo[1] = l.y;
  return b;
}
// B (k = tile rows row8 + 2t, row8 + 2t + 1, n = d of column block nb)
template <int DM>
__device__ __forceinline__ Split<2> b_col(uint32_t plane, int row8, int lcol0,
                                          int lcol1, int nb) {
  constexpr int TB = 64 * DM * 4;
  const uint32_t p = plane + row8 * DM * 4;
  const uint32_t a0 = p + (lcol0 ^ (nb << 5)), a1 = p + (lcol1 ^ (nb << 5));
  Split<2> b;
  b.hi[0] = lds32(a0);
  b.hi[1] = lds32(a1);
  b.lo[0] = lds32(a0 + TB);
  b.lo[1] = lds32(a1 + TB);
  return b;
}

// acc[16 x 8 NO] += F X: F the accumulator fragments f[NF] (16 x 8 NF;
// column 8 blk + 2t + e of f[blk] is row 8 blk + 2t + e of X), X rows
// row8.. and column blocks nb0.. of a plane pair, read down its rows.  The
// product is summed in fresh registers (3 NF products an element) and
// added to acc in float32, rounded to nearest: the tensor cores' sums are
// not (head note).
template <int DM, int NF, int NO>
__device__ __forceinline__ void add_product(float (&acc)[NO][4],
                                            const float (&f)[NF][4],
                                            uint32_t plane, int row8, int nb0,
                                            int lcol0, int lcol1) {
  float part[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[nb][j] = 0.f;
#pragma unroll
  for (int blk = 0; blk < NF; ++blk) {
    Split<2> b[NO];
#pragma unroll
    for (int nb = 0; nb < NO; ++nb)
      b[nb] = b_col<DM>(plane, row8 + 8 * blk, lcol0, lcol1, nb0 + nb);
    mma3(part, a_from_acc(f[blk]), b);
  }
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nb][j] += part[nb][j];
}

// threadIdx.x, read where it stands: the staging loops' per-chunk offsets
// are derived from it at each use, not hoisted out of the tile loops into
// dozens of registers held through the products
__device__ __forceinline__ int tid_here() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// Staging of one streamed tile: rows [0, 64) x columns [0, DM) of a
// [n_rows, D] slice (row stride `stride` floats); rows >= n_rows and
// columns >= D are zero.  Thread tid owns the 16-byte chunks
// e = tid + i * kThreads (row e / (DM / 4), chunk e % (DM / 4)).
// stage_issue: vec: cp.async of its chunks into the staging buffer `raw`
// (natural layout); else nothing.  stage_split: its chunks (from `raw`, or
// element-wise from global memory when !vec) split into the hi/lo planes.
template <int DM>
__device__ __forceinline__ void stage_issue(uint32_t raw, const float* src,
                                            int n_rows, int64_t stride, int D,
                                            bool vec) {
  constexpr int CH = DM / 4;
  if (!vec) return;
#pragma unroll
  for (int i = 0; i < 64 * CH / kThreads; ++i) {
    const int e = tid_here() + i * kThreads;
    const int r = e / CH, c = e % CH;
    const bool ok = r < n_rows && c * 4 < D;
    cp_async16(raw + (r * DM + c * 4) * 4, ok ? src + r * stride + c * 4 : src,
               ok);
  }
}
template <int DM>
__device__ __forceinline__ void stage_split(uint8_t* plane,
                                            const uint8_t* raw,
                                            const float* src, int n_rows,
                                            int64_t stride, int D, bool vec) {
  constexpr int CH = DM / 4;
  constexpr int TB = 64 * DM * 4;
#pragma unroll
  for (int i = 0; i < 64 * CH / kThreads; ++i) {
    const int e = tid_here() + i * kThreads;
    const int r = e / CH, c = e % CH;
    float x[4];
    if (vec) {
      const float4 v =
          *reinterpret_cast<const float4*>(raw + (r * DM + c * 4) * 4);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = (r < n_rows && c * 4 + j < D) ? src[r * stride + c * 4 + j]
                                             : 0.f;
    }
    uint4 h, l;
    split(x[0], h.x, l.x);
    split(x[1], h.y, l.y);
    split(x[2], h.z, l.z);
    split(x[3], h.w, l.w);
    const int at = r * DM * 4 + ((c << 4) ^ (sw(r & 7) << 5));
    *reinterpret_cast<uint4*>(plane + at) = h;
    *reinterpret_cast<uint4*>(plane + TB + at) = l;
  }
}

// -- A operands held by a warp --------------------------------------------
// This lane's share of a warp's 16 rows x DM columns of a [n_rows, D] slice
// as A fragments, with the row reads' d permutation: k step kk holds
// (g, 8kk + 2t), (g + 8, 8kk + 2t), (g, 8kk + 2t + 1), (g + 8, 8kk + 2t + 1).
// kRawRes keeps the raw values in registers, kFromGlobal nothing (reads
// them from global memory, through L1, at each use); both split at each
// use.
enum AMode { kRawRes, kFromGlobal };

template <int DM, AMode MODE>
struct AOp {
  static constexpr int KS = DM / 8;
  float x[MODE == kRawRes ? KS : 1][4];
  const float* row0;  // rows g and g + 8 of the slice; nullptr past n_rows
  const float* row1;
  int D;

  __device__ __forceinline__ float at(const float* row, int d) const {
    return (row != nullptr && d < D) ? ld_here(row + d) : 0.f;
  }
  __device__ __forceinline__ void load(int kk, float (&v)[4]) const {
    const int d = 8 * kk + 2 * (threadIdx.x & 3);
    v[0] = at(row0, d);
    v[1] = at(row1, d);
    v[2] = at(row0, d + 1);
    v[3] = at(row1, d + 1);
  }
  // row = the slice row of this lane's first row (warp * 16 + g)
  __device__ __forceinline__ void init(const float* base, int64_t stride,
                                       int row, int n_rows, int D_) {
    D = D_;
    row0 = row < n_rows ? base + row * stride : nullptr;
    row1 = row + 8 < n_rows ? base + (row + 8) * stride : nullptr;
    if constexpr (MODE == kRawRes) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) load(kk, x[kk]);
    }
  }
  __device__ __forceinline__ Split<4> get(int kk) const {
    float v[4];
    if constexpr (MODE == kRawRes) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = x[kk][j];
    } else {
      load(kk, v);
    }
    Split<4> a;
#pragma unroll
    for (int j = 0; j < 4; ++j) split_here(v[j], a.hi[j], a.lo[j]);
    return a;
  }
};

// acc[16 x 8N] = A X^T: A a warp's operand (AOp, contracting over d), X the
// rows row8 .. row8 + 8N of a plane pair, read along its rows
template <int DM, int N, AMode M>
__device__ __forceinline__ void mma_rows(float (&acc)[N][4],
                                         const AOp<DM, M>& a, uint32_t plane,
                                         int row8, int lrow) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
#pragma unroll(M == kFromGlobal ? kGlobalUnroll : DM / 8)
  for (int kk = 0; kk < DM / 8; ++kk) {
    Split<2> b[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      b[n] = b_row<DM>(plane, row8 + 8 * n, lrow, kk);
    mma3(acc, a.get(kk), b);
  }
}

// the 1 KB-aligned start of the dynamic shared memory (kSmemAlign bytes are
// requested beyond the tiles) as a generic pointer
constexpr int kSmemAlign = 1024;
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  const uint32_t at = smem_u32(raw);
  const uint32_t base = (at + kSmemAlign - 1) & ~(kSmemAlign - 1u);
  return raw + (base - at);
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

// two values of one output row at columns col, col + 1
__device__ __forceinline__ void store_pair(float* row, int col, float x0,
                                           float x1, int D, bool vec) {
  if (vec) {
    if (col < D) *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
  } else {
    if (col < D) row[col] = x0;
    if (col + 1 < D) row[col + 1] = x1;
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

// shared memory of the forward and dQ kernels: K planes, V planes (each a
// hi/lo pair), K and V staging, the key tile's validity flags; dK/dV's holds
// Q and dO in their places and the q rows' lse and delta after them
template <int DM>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * DM * 4;
}
template <int DM>
constexpr size_t fwd_smem() {
  return kSmemAlign + 6 * tile_bytes<DM>() + kBK;
}
template <int DM>
constexpr size_t dq_smem() {
  return fwd_smem<DM>();
}
template <int DM>
constexpr size_t dkv_smem() {
  return kSmemAlign + 6 * tile_bytes<DM>() + 2 * kBQ * sizeof(float);
}

// ---------------------------------------------------------------------------
// forward: CTA (q tile, head, batch); warp w owns rows 16w..16w+15 and the
// online-softmax state (m, l, o) of its rows in registers
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads, DM <= 64 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, int Hkv,
                 int D, float scale, Mask mk, int vec) {
  constexpr int TB = tile_bytes<DM>();
  constexpr int SWC = DM < kSweepCols ? DM : kSweepCols;  // o columns a sweep
  constexpr int NO = SWC / 8;
  constexpr AMode AM = DM <= 64 ? kRawRes : kFromGlobal;  // Q (head note)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  uint8_t* pK = smem;                // hi, lo planes
  uint8_t* pV = smem + 2 * TB;       // hi, lo planes
  uint8_t* rK = smem + 4 * TB;       // staging
  uint8_t* rV = smem + 5 * TB;
  uint8_t* sKv = smem + 6 * TB;      // [kBK]
  const uint32_t sK = smem_u32(pK), sV = smem_u32(pV);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const float* qb = q + (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                    static_cast<int64_t>(h) * D;
  const float* kb = k + static_cast<int64_t>(b) * Tk * k_stride +
                    static_cast<int64_t>(hk) * D;
  const float* vb = v + static_cast<int64_t>(b) * Tk * k_stride +
                    static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;

  int lo, hi;
  live_range((Tk + kBK - 1) / kBK,
             [&](int i) { return mk.live(q0, i * kBK); }, lo, hi);

  // raw copies of key tile t; returns this thread's key flag (threads
  // < kBK: key tid of the tile)
  auto issue = [&](int t) -> int {
    const int kn = t * kBK;
    stage_issue<DM>(smem_u32(rK), kb + kn * k_stride, Tk - kn, k_stride, D,
                    vec);
    stage_issue<DM>(smem_u32(rV), vb + kn * k_stride, Tk - kn, k_stride, D,
                    vec);
    return tid < kBK ? key_valid(kv_row, kn + tid, Tk) : 1;
  };
  // planes <- key tile t (its copies landed); returns whether all its keys
  // are valid
  auto unpack = [&](int t, int kv) -> int {
    const int kn = t * kBK;
    stage_split<DM>(pK, rK, kb + kn * k_stride, Tk - kn, k_stride, D, vec);
    stage_split<DM>(pV, rV, vb + kn * k_stride, Tk - kn, k_stride, D, vec);
    if (tid < kBK) sKv[tid] = kv;
    return __syncthreads_and(kv);
  };

  AOp<DM, AM> qa;
  qa.init(qb, q_stride, warp * 16 + g, Tq - q0, D);
  const int lrow = lane_row<DM>();
  const int lcol0 = lane_col<DM>(0), lcol1 = lane_col<DM>(1);
  const float sl2 = scale * kLog2e;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

  // o's columns in sweeps of SWC, each walking every key tile
#pragma unroll 1
  for (int sw = 0; sw < DM / SWC; ++sw) {
    if (sw > 0) __syncthreads();  // the last sweep is done with the planes
    int kv = 1, all_kv = 1;
    if (lo <= hi) {
      kv = issue(lo);
      cp_async_commit();
      cp_async_wait_all();
      all_kv = unpack(lo, kv);
      if (lo < hi) kv = issue(lo + 1);
      cp_async_commit();
    }

    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

    for (int t = lo; t <= hi; ++t) {
      const int k0 = t * kBK;
      float s[8][4];
      mma_rows(s, qa, sK, 0, lrow);

      if (!all_kv || mk.partial(q0 + warp * 16, 16, k0, kBK)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + 2 * t4 + e;
            const bool ok = sKv[c] != 0;
            s[n][e] = (ok && mk.keep(r0, k0 + c)) ? s[n][e] * sl2
                                                   : -CUDART_INF_F;
            s[n][2 + e] = (ok && mk.keep(r0 + 8, k0 + c))
                              ? s[n][2 + e] * sl2
                              : -CUDART_INF_F;
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] *= sl2;
      }

      // online softmax in the log2 domain; rows r0 (i = 0), r0 + 8 (i = 1)
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
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }

      // o += P V: keys 8 blk + 2t, + 1 of P's fragment blk
      add_product<DM>(acc, s, sV, 0, sw * NO, lcol0, lcol1);

      if (t < hi) {
        cp_async_wait_all();
        __syncthreads();  // every warp is done with the planes of tile t
        all_kv = unpack(t + 1, kv);
        if (t + 1 < hi) kv = issue(t + 2);
        cp_async_commit();
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float li = quad_sum(l[i]);
      if (r >= Tq) continue;
      const float inv = li > 0.f ? 1.f / li : 0.f;
      float* orow = o + (static_cast<int64_t>(b) * Tq + r) * q_stride +
                    static_cast<int64_t>(h) * D + sw * SWC;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store_pair(orow, n * 8 + 2 * t4, acc[n][2 * i] * inv,
                   acc[n][2 * i + 1] * inv, D - sw * SWC, vec);
      if (t4 == 0 && sw == 0)
        lse[(static_cast<int64_t>(b) * H + h) * Tq + r] =
            li > 0.f ? m[i] * kLn2 + logf(li) : -CUDART_INF_F;
    }
  }
}

// ---------------------------------------------------------------------------
// backward dQ: CTA (q tile, head, batch) walks the live key tiles;
// p = exp(s - lse), ds = p (dp - delta) scale, dq += ds k
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads, DM <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int H, int Hkv, int D, float scale,
                    Mask mk, int vec) {
  constexpr int TB = tile_bytes<DM>();
  constexpr int NB = DM / 8;
  constexpr int KC = DM <= 64 ? 32 : 64;  // keys per pass
  constexpr AMode AM = DM <= 64 ? kRawRes : kFromGlobal;  // Q, dO
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  uint8_t* pK = smem;
  uint8_t* pV = smem + 2 * TB;
  uint8_t* rK = smem + 4 * TB;
  uint8_t* rV = smem + 5 * TB;
  uint8_t* sKv = smem + 6 * TB;
  const uint32_t sK = smem_u32(pK), sV = smem_u32(pV);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                         static_cast<int64_t>(h) * D;
  const float* kb = k + static_cast<int64_t>(b) * Tk * k_stride +
                    static_cast<int64_t>(hk) * D;
  const float* vb = v + static_cast<int64_t>(b) * Tk * k_stride +
                    static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;
  const int64_t row_base = (static_cast<int64_t>(b) * H + h) * Tq;

  int lo, hi;
  live_range((Tk + kBK - 1) / kBK,
             [&](int i) { return mk.live(q0, i * kBK); }, lo, hi);

  auto issue = [&](int t) -> int {
    const int kn = t * kBK;
    stage_issue<DM>(smem_u32(rK), kb + kn * k_stride, Tk - kn, k_stride, D,
                    vec);
    stage_issue<DM>(smem_u32(rV), vb + kn * k_stride, Tk - kn, k_stride, D,
                    vec);
    return tid < kBK ? key_valid(kv_row, kn + tid, Tk) : 1;
  };
  auto unpack = [&](int t, int kv) -> int {
    const int kn = t * kBK;
    stage_split<DM>(pK, rK, kb + kn * k_stride, Tk - kn, k_stride, D, vec);
    stage_split<DM>(pV, rV, vb + kn * k_stride, Tk - kn, k_stride, D, vec);
    if (tid < kBK) sKv[tid] = kv;
    return __syncthreads_and(kv);
  };

  int kv = 1, all_kv = 1;
  if (lo <= hi) {
    kv = issue(lo);
    cp_async_commit();
    cp_async_wait_all();
    all_kv = unpack(lo, kv);
    if (lo < hi) kv = issue(lo + 1);
    cp_async_commit();
  }

  AOp<DM, AM> qa, da;
  qa.init(q + q_base, q_stride, warp * 16 + g, Tq - q0, D);
  da.init(dout + q_base, q_stride, warp * 16 + g, Tq - q0, D);
  const int lrow = lane_row<DM>();
  const int lcol0 = lane_col<DM>(0), lcol1 = lane_col<DM>(1);

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

  for (int t = lo; t <= hi; ++t) {
    const int k0 = t * kBK;
    const bool need = !all_kv || mk.partial(q0 + warp * 16, 16, k0, kBK);
    // the tile's keys in passes of KC: both 16 x KC fragments stay in
    // registers beside the dQ sums
#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      mma_rows(s, qa, sK, c0, lrow);
      mma_rows(dp, da, sV, c0, lrow);
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + n * 8 + 2 * t4 + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * i + e;
            float p = exp2f(fmaf(s[n][j], sl2, -lse2[i]));
            if (need && !(sKv[c] != 0 && mk.keep(r0 + 8 * i, k0 + c)))
              p = 0.f;
            s[n][j] = p * (dp[n][j] - dl[i]) * scale;
          }
        }
      // dq += ds k: keys c0 + 8 blk + 2t, + 1 of dS's fragment blk
      add_product<DM>(acc, s, sK, c0, 0, lcol0, lcol1);
    }

    if (t < hi) {
      cp_async_wait_all();
      __syncthreads();
      all_kv = unpack(t + 1, kv);
      if (t + 1 < hi) kv = issue(t + 2);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Tq) continue;
    float* row = dq + (static_cast<int64_t>(b) * Tq + r) * q_stride +
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
// S^T = K Q^T, dP^T = V dO^T, dv += p^T do, dk += ds^T q
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads, DM <= 64 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ kv_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int H, int Hkv,
                     int D, float scale, Mask mk, int vec) {
  constexpr int TB = tile_bytes<DM>();
  constexpr int SWC = DM < kSweepCols ? DM : kSweepCols;  // dK, dV columns
  constexpr int NO = SWC / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  uint8_t* pQ = smem;
  uint8_t* pO = smem + 2 * TB;          // dO planes
  uint8_t* rQ = smem + 4 * TB;
  uint8_t* rO = smem + 5 * TB;
  float* sL = reinterpret_cast<float*>(smem + 6 * TB);  // [kBQ]
  float* sDl = sL + kBQ;  // [kBQ]: lse * log2(e) and delta of the q rows
  const uint32_t sQ = smem_u32(pQ), sO = smem_u32(pO);

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

  // item -> its head h and first q row q0
  auto item_q = [&](int item, int& h, int& q0) {
    h = hk * rep + item / n_live;
    q0 = (lo + item % n_live) * kBQ;
  };
  auto q_ptr = [&](const float* x, int h, int q0) {
    return x + (static_cast<int64_t>(b) * Tq + q0) * q_stride +
           static_cast<int64_t>(h) * D;
  };
  // raw copies of the item's Q and dO tiles; returns this thread's lse
  // (tid < 64) or delta (tid >= 64) value for row tid & 63 of it
  auto issue = [&](int item) -> float {
    int h, q0;
    item_q(item, h, q0);
    stage_issue<DM>(smem_u32(rQ), q_ptr(q, h, q0), Tq - q0, q_stride, D,
                    vec);
    stage_issue<DM>(smem_u32(rO), q_ptr(dout, h, q0), Tq - q0, q_stride, D,
                    vec);
    const int r = q0 + (tid & 63);
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Tq + r;
    if (tid < 64) {
      const float x = r < Tq ? lse[at] : -CUDART_INF_F;
      return x > -CUDART_INF_F ? x * kLog2e : CUDART_INF_F;
    }
    return r < Tq ? delta[at] : 0.f;
  };
  auto unpack = [&](int item, float ld) {
    int h, q0;
    item_q(item, h, q0);
    stage_split<DM>(pQ, rQ, q_ptr(q, h, q0), Tq - q0, q_stride, D, vec);
    stage_split<DM>(pO, rO, q_ptr(dout, h, q0), Tq - q0, q_stride, D, vec);
    (tid < 64 ? sL : sDl)[tid & 63] = ld;
    __syncthreads();
  };

  AOp<DM, kFromGlobal> ka, va;  // read once a q tile (head note)
  ka.init(k + k_base, k_stride, warp * 16 + g, Tk - k0, D);
  va.init(v + k_base, k_stride, warp * 16 + g, Tk - k0, D);
  const int lrow = lane_row<DM>();
  const int lcol0 = lane_col<DM>(0), lcol1 = lane_col<DM>(1);

  // this thread's key rows kr0 (i = 0) and kr0 + 8 (i = 1)
  const int kr0 = k0 + warp * 16 + g;
  const bool kv0 = key_valid(kv_row, kr0, Tk) != 0;
  const bool kv1 = key_valid(kv_row, kr0 + 8, Tk) != 0;
  const int all_kv = __syncthreads_and(kv0 && kv1);
  const float sl2 = scale * kLog2e;

  // dK's and dV's columns in sweeps of SWC, each walking every item
#pragma unroll 1
  for (int sw = 0; sw < DM / SWC; ++sw) {
    if (sw > 0) __syncthreads();  // the last sweep is done with the planes
    float ld = 0.f;
    if (n_items > 0) {
      ld = issue(0);
      cp_async_commit();
      cp_async_wait_all();
      unpack(0, ld);
      if (n_items > 1) ld = issue(1);
      cp_async_commit();
    }

    float dka[NO][4], dva[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;

    for (int it = 0; it < n_items; ++it) {
      const int q0 = (lo + it % n_live) * kBQ;
      const bool need = !all_kv || q0 + kBQ > Tq ||
                        mk.partial(q0, kBQ, k0 + warp * 16, 16);

      float s[kBQ / 8][4];  // S^T, then P^T
      mma_rows(s, ka, sQ, 0, lrow);
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t4 + e;
          const float l2 = sL[c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float p = exp2f(fmaf(s[n][2 * i + e], sl2, -l2));
            if (need && !((i ? kv1 : kv0) && q0 + c < Tq &&
                          mk.keep(q0 + c, kr0 + 8 * i)))
              p = 0.f;
            s[n][2 * i + e] = p;
          }
        }
      // dv += p^T do: q rows 8 blk + 2t, + 1 of P^T's fragment blk
      add_product<DM>(dva, s, sO, 0, sw * NO, lcol0, lcol1);

      float dp[kBQ / 8][4];  // dP^T, then dS^T
      mma_rows(dp, va, sO, 0, lrow);
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = sDl[n * 8 + 2 * t4 + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * i + e;
            dp[n][j] = s[n][j] * (dp[n][j] - d) * scale;
          }
        }
      // dk += ds^T q
      add_product<DM>(dka, dp, sQ, 0, sw * NO, lcol0, lcol1);

      if (it + 1 < n_items) {
        cp_async_wait_all();
        __syncthreads();  // every warp is done with the planes of item it
        unpack(it + 1, ld);
        if (it + 2 < n_items) ld = issue(it + 2);
        cp_async_commit();
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kr0 + 8 * i;
      if (kr >= Tk) continue;
      const int64_t at = (static_cast<int64_t>(b) * Tk + kr) * k_stride +
                         static_cast<int64_t>(hk) * D + sw * SWC;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store_pair(dk + at, n * 8 + 2 * t4, dka[n][2 * i], dka[n][2 * i + 1],
                   D - sw * SWC, vec);
        store_pair(dv + at, n * 8 + 2 * t4, dva[n][2 * i], dva[n][2 * i + 1],
                   D - sw * SWC, vec);
      }
    }
  }
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

// A launch above 48 KB of dynamic shared memory is refused unless the
// kernel's limit was raised first; a refused launch never runs.
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

// 16-byte copies need D % 4 == 0 (16-byte rows) and 16-byte aligned bases
bool vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int DM>
int fwd_dm(const float* q, const float* k, const float* v,
           const uint8_t* kvm, float* o, float* lse, int B, int Tq, int Tk,
           int H, int Hkv, int D, float scale, Mask mk, int vec,
           cudaStream_t stream) {
  const size_t bytes = fwd_smem<DM>();
  if (int rc = set_smem(flash_fwd_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kvm, o, lse, Tq, Tk, H, Hkv, D, scale, mk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int dq_dm(const float* q, const float* k, const float* v, const uint8_t* kvm,
          const float* dout, const float* lse, const float* delta, float* dq,
          int B, int Tq, int Tk, int H, int Hkv, int D, float scale, Mask mk,
          int vec, cudaStream_t stream) {
  const size_t bytes = dq_smem<DM>();
  if (int rc = set_smem(flash_bwd_dq_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kvm, dout, lse, delta, dq, Tq, Tk, H, Hkv, D, scale, mk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int dkv_dm(const float* q, const float* k, const float* v, const uint8_t* kvm,
           const float* dout, const float* lse, const float* delta,
           float* dk, float* dv, int B, int Tq, int Tk, int H, int Hkv,
           int D, float scale, Mask mk, int vec, cudaStream_t stream) {
  const size_t bytes = dkv_smem<DM>();
  if (int rc = set_smem(flash_bwd_dkv_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkv_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kvm, dout, lse, delta, dk, dv, Tq, Tk, H, Hkv, D, scale, mk,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 tensors; window < 0 = no sliding window.  Each returns a
// cudaError_t value.
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* o, void* lse, int B, int Tq,
                     int Tk, int H, int Hkv, int D, float scale, int causal,
                     int window, int q_off, int k_off, void* stream) {
  if (bad_shape(B, Tq, Tk, H, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{causal, window, q_off, k_off};
  const int vec = vec_ok(D, {q, k, v, o});
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* of = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? fwd_dm<64>(f(q), f(k), f(v), kvm, of, l, B, Tq, Tk, H, Hkv,
                              D, scale, mk, vec, s)
                 : fwd_dm<128>(f(q), f(k), f(v), kvm, of, l, B, Tq, Tk, H,
                               Hkv, D, scale, mk, vec, s);
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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* g = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? dq_dm<64>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                             f(delta), g, B, Tq, Tk, H, Hkv, D, scale, mk,
                             vec, s)
                 : dq_dm<128>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                              f(delta), g, B, Tq, Tk, H, Hkv, D, scale, mk,
                              vec, s);
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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? dkv_dm<64>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                              f(delta), gk, gv, B, Tq, Tk, H, Hkv, D, scale,
                              mk, vec, s)
                 : dkv_dm<128>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                               f(delta), gk, gv, B, Tq, Tk, H, Hkv, D, scale,
                               mk, vec, s);
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
      return small ? attributes(flash_fwd_kernel<64>, fwd_smem<64>(), out)
                   : attributes(flash_fwd_kernel<128>, fwd_smem<128>(), out);
    case 1:
      return small ? attributes(flash_bwd_dq_kernel<64>, dq_smem<64>(), out)
                   : attributes(flash_bwd_dq_kernel<128>, dq_smem<128>(),
                                out);
    case 2:
      return small ? attributes(flash_bwd_dkv_kernel<64>, dkv_smem<64>(), out)
                   : attributes(flash_bwd_dkv_kernel<128>, dkv_smem<128>(),
                                out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
