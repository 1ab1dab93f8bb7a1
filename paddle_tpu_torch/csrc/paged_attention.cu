// Ragged paged attention for Hopper (sm_90a), float32 or bfloat16 pools.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_paged.py:_kernel
// (launched by pallas_paged.paged_attention).  Query row r attends the
// pages table[row_slot[r], p] of its table row for positions t < lengths[r]:
// an online softmax over the keys, grouped-query heads resolved here (the
// pools keep H_kv heads), pages past a row's length never read.  Scores,
// softmax and sums are float32; the output is in q's dtype.
//
// What bounds it: the bytes of the live K/V pages.  Each live page is read
// for 4 D flops per (query head, token), far below the card's ~300 flops
// per byte of balance.  At the serving shapes (16 slots, 8 kv heads) the
// first version -- one CTA per (row, kv head) walking its keys one at a
// time behind a warp reduction -- left 128 small CTAs and a latency chain
// per token (41x its byte bound).  This design answers that:
//
// * Keys split over CTAs.  The grid is (row, kv head, split); the splits of
//   one (row, kv head) form a thread-block cluster (1, 1, splits).  Split z
//   takes the tokens [z spl, (z + 1) spl) of the row and keeps its own
//   online softmax state (m, l, acc).  A split past the row's length
//   leaves at once (a cluster barrier waits only for CTAs that have not
//   exited); a lone live split writes its state as the output; else, after
//   a cluster barrier, the live CTAs merge the states through distributed
//   shared memory, each a share of the outputs, the splits in rank order:
//   one launch, no workspace, no atomics, the same bits from run to run.
//   The split count and spl come from shapes only (ops/paged_attention.py
//   `split_plan`: more splits for longer tables, fewer for launches with
//   more rows than table rows).
// * A CTA holds the query heads of one kv head of one row (NQ, their count
//   rounded up to a power of two).  The rows of a prompt chunk are CTAs of
//   their own and read their table row's pages each; those re-reads hit
//   L2.  A tile of a chunk's consecutive rows against each staged page
//   (tensor cores for bfloat16) was built and timed at the serving run's
//   mixed launches: it was slower than these CTAs of one row (PERF.md).
// * No per-token warp reduction.  Blocks of 32 tokens of K and V are staged
//   in shared memory by cp.async (each token's head row fetched through
//   the split's page indices, loaded beside the queries; every live page
//   read once per CTA), and walked one of two ways:
//   - 1 or 2 query heads where a stage per warp fits: each warp walks its
//     own blocks (no CTA barrier per block), a lane owning a token for Q.K
//     and a column pair for P.V; the warps' states merge once (walk_warp);
//   - otherwise CUDA cores: a lane owns a token and a warp a quarter of the
//     head dim for Q.K, one warp reduction per query and block for the
//     softmax, a thread two columns of some queries for P.V (walk_cuda).
// * A CTA's dependent loads are three rounds (its row's table row and
//   length, then the page indices, then the pages), two when row r reads
//   table row r (row_slot None, the engine's decode step).
//
// What bounds it now (an H100, the serving run; PERF.md): per-launch fixed
// latency -- those rounds, the cluster barrier's wait for the slowest
// split, the merge -- not bytes: the live pages of a serving step are ~1.4
// us of the card's bandwidth.
//
// C interface (bound with ctypes): paged_attention_launch() launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 32;              // tokens per staged block
constexpr int PST = BT + 4;         // row stride of the probabilities
constexpr int MAX_SPLITS = 8;       // portable cluster size
constexpr int MAX_PAGES = 128;      // page indices of a split kept on chip
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;          // [R, H, D]
  const void* k_pages;    // [P, ps, Hkv, D]
  const void* v_pages;    // [P, ps, Hkv, D]
  const int* table;       // [S, maxp]
  const int* lengths;     // [R]
  const int* row_slot;    // [R]
  void* out;              // [R, H, D]
  int R, H, Hkv, D, ps, maxp;
  int spl;                // tokens per split (a multiple of BT)
  int vec16;              // 16-byte rows of q and the pools: cp.async
  int identity;           // row r reads table row r (row_slot not read)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// N consecutive elements of a shared row (16-byte aligned) as float.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 f = reinterpret_cast<const float4*>(p)[k];
    out[4 * k] = f.x;
    out[4 * k + 1] = f.y;
    out[4 * k + 2] = f.z;
    out[4 * k + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int k = 0; k < N / 8; ++k) {
    // a bfloat16 is the high half of its float32
    const uint4 raw = reinterpret_cast<const uint4*>(p)[k];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      out[8 * k + 2 * m] = __uint_as_float(w[m] << 16);
      out[8 * k + 2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared-memory geometry of an instance: DP is the head dim padded to 32,
// 64 or 128; a staged row holds DP elements and 16 bytes of padding (so
// the lanes' 16-byte reads of 32 rows fall in distinct banks).  A stage per
// warp where blocks are small (the warp walk needs them), else two.
template <typename T, int DP>
struct Ring {
  static constexpr int ROW = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int BLOCK_BYTES =
      2 * BT * ROW * static_cast<int>(sizeof(T));      // K and V
  static constexpr int STAGES = BLOCK_BYTES <= 10240 ? WARPS : 2;
  static constexpr int BYTES = STAGES * BLOCK_BYTES;
};

// A CTA's walk over its split's keys, after the prologue: the queries in
// qs ([NQ][DP] float32, zero-padded), their lengths in qlen, the ring and
// the issue of block b (`issue(b)`).  It leaves the split's state, (m, l)
// per query and the unnormalised output, in st_m, st_l, st_acc.
struct Walk {
  const float* qs;
  const int* qlen;
  float* st_m;
  float* st_l;
  float* st_acc;
  int t_begin;      // the split's first token
  int t_end;        // its end, capped at the row's length
  int nblk;         // blocks of BT tokens
  float scale;
};

// CUDA cores, NQ queries.  Q.K: a lane owns a token and a warp a quarter of
// the head dim (q read as a broadcast), the quarters summed in a fixed
// order; the softmax of a block is one warp reduction per query (warp w
// owns queries w, w + 4, ...); P.V: a thread owns two columns of some
// queries and, for few queries, a slice of the block's tokens.
template <typename T, int NQ, int DP, typename Issue>
__device__ __forceinline__ void walk_cuda(const Walk& w, const T* ring,
                                          float* red, float* pr,
                                          float* corr_s, Issue& issue) {
  constexpr int ROW = Ring<T, DP>::ROW;
  constexpr int STAGES = Ring<T, DP>::STAGES;
  constexpr int DQ = DP / WARPS;             // a warp's quarter of DP
  constexpr int NPAIR = DP / 2;              // column pairs of P.V
  constexpr int GROUPS = THREADS / NPAIR;    // threads per column pair
  constexpr int QPT = NQ >= GROUPS ? NQ / GROUPS : 1;
  constexpr int TS = NQ >= GROUPS ? 1 : GROUPS / NQ;   // token slices
  constexpr int QPW = (NQ + WARPS - 1) / WARPS;        // softmax rows/warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cpair = tid % NPAIR;
  const int rest = tid / NPAIR;
  const int qfirst = TS == 1 ? rest : rest % NQ;
  const int slice = TS == 1 ? 0 : rest / NQ;
  float acc[QPT][2];
  float m_r[QPW], l_r[QPW];
#pragma unroll
  for (int k = 0; k < QPT; ++k) acc[k][0] = acc[k][1] = 0.f;
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
    m_r[k] = kNegInf;
    l_r[k] = 0.f;
  }

#pragma unroll
  for (int b = 0; b < STAGES - 1; ++b) {
    if (b < w.nblk) issue(b);
    cp_async_commit();
  }
  for (int b = 0; b < w.nblk; ++b) {
    // block b has landed and every thread is done with block b - 1, whose
    // stage the next issue refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (b + STAGES - 1 < w.nblk) issue(b + STAGES - 1);
    cp_async_commit();
    const int tb = w.t_begin + b * BT;
    const int nvalid = min(BT, w.t_end - tb);
    const T* kst = ring + (b % STAGES) * 2 * BT * ROW;
    const T* vst = kst + BT * ROW;
    {
      float kr[DQ];
      load_row<DQ>(kst + lane * ROW + warp * DQ, kr);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float* qi = w.qs + i * DP + warp * DQ;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DQ; d += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qi + d);
          s = fmaf(qq.x, kr[d], s);
          s = fmaf(qq.y, kr[d + 1], s);
          s = fmaf(qq.z, kr[d + 2], s);
          s = fmaf(qq.w, kr[d + 3], s);
        }
        red[(warp * NQ + i) * BT + lane] = s;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < QPW; ++k) {
      const int i = warp + WARPS * k;
      if (i < NQ) {
        float s = red[i * BT + lane] + red[(NQ + i) * BT + lane];
        s += red[(2 * NQ + i) * BT + lane];
        s += red[(3 * NQ + i) * BT + lane];
        s *= w.scale;
        const bool valid = tb + lane < w.qlen[i];
        const float m_new = fmaxf(m_r[k], warp_max(valid ? s : kNegInf));
        const float corr = expf(m_r[k] - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        l_r[k] = l_r[k] * corr + warp_sum(p);
        m_r[k] = m_new;
        pr[i * PST + lane] = p;
        if (lane == 0) corr_s[i] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const float c = corr_s[qfirst + GROUPS * k];
      acc[k][0] *= c;
      acc[k][1] *= c;
    }
    for (int j = slice; j < nvalid; j += TS) {
      const float2 vv = load2(vst + j * ROW + 2 * cpair);
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const float p = pr[(qfirst + GROUPS * k) * PST + j];
        acc[k][0] = fmaf(p, vv.x, acc[k][0]);
        acc[k][1] = fmaf(p, vv.y, acc[k][1]);
      }
    }
  }
  __syncthreads();

  // the split's state: (m, l) per query, acc summed over token slices
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
    const int i = warp + WARPS * k;
    if (i < NQ && lane == 0) {
      w.st_m[i] = m_r[k];
      w.st_l[i] = l_r[k];
    }
  }
  if (TS == 1) {
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const int i = qfirst + GROUPS * k;
      w.st_acc[i * DP + 2 * cpair] = acc[k][0];
      w.st_acc[i * DP + 2 * cpair + 1] = acc[k][1];
    }
  } else {
    red[(slice * NQ + qfirst) * DP + 2 * cpair] = acc[0][0];
    red[(slice * NQ + qfirst) * DP + 2 * cpair + 1] = acc[0][1];
    __syncthreads();
    if (slice == 0) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        s0 += red[(s * NQ + qfirst) * DP + 2 * cpair];
        s1 += red[(s * NQ + qfirst) * DP + 2 * cpair + 1];
      }
      w.st_acc[qfirst * DP + 2 * cpair] = s0;
      w.st_acc[qfirst * DP + 2 * cpair + 1] = s1;
    }
  }
}

// A row of G = 1 or 2 queries (more would spill registers),
// where a stage per warp fits (Ring STAGES == WARPS): warp w walks the
// blocks w, w + 4, ... of the split on its own, staging each with cp.async
// into its own stage and waiting for its own copies (no CTA barrier per
// block).  A lane owns a token for Q.K and a column pair for P.V (each p
// broadcast by a shuffle); the four warps' states merge once, in warp
// order, at the end.
template <typename T, int G, int DP, typename IssueW>
__device__ __forceinline__ void walk_warp(const Walk& w, T* ring,
                                          IssueW& issue_w) {
  static_assert(Ring<T, DP>::STAGES == WARPS, "a stage per warp");
  constexpr int ROW = Ring<T, DP>::ROW;
  constexpr int PPL = DP / 2 > 32 ? DP / 64 : 1;   // column pairs a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m_r[G], l_r[G], acc[G][PPL][2];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    m_r[q] = kNegInf;
    l_r[q] = 0.f;
#pragma unroll
    for (int c = 0; c < PPL; ++c) acc[q][c][0] = acc[q][c][1] = 0.f;
  }
  const T* kst = ring + warp * 2 * BT * ROW;
  const T* vst = kst + BT * ROW;
  for (int b = warp; b < w.nblk; b += WARPS) {
    issue_w(b, warp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    const int tb = w.t_begin + b * BT;
    const int nvalid = min(BT, w.t_end - tb);
    // Q.K: lane = token
    float s[G];
#pragma unroll
    for (int q = 0; q < G; ++q) s[q] = 0.f;
#pragma unroll 1
    for (int d = 0; d < DP; d += 8) {
      float kr[8];
      load_row<8>(kst + lane * ROW + d, kr);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float4 q0 = *reinterpret_cast<const float4*>(w.qs + q * DP + d);
        const float4 q1 =
            *reinterpret_cast<const float4*>(w.qs + q * DP + d + 4);
        s[q] = fmaf(q0.x, kr[0], s[q]);
        s[q] = fmaf(q0.y, kr[1], s[q]);
        s[q] = fmaf(q0.z, kr[2], s[q]);
        s[q] = fmaf(q0.w, kr[3], s[q]);
        s[q] = fmaf(q1.x, kr[4], s[q]);
        s[q] = fmaf(q1.y, kr[5], s[q]);
        s[q] = fmaf(q1.z, kr[6], s[q]);
        s[q] = fmaf(q1.w, kr[7], s[q]);
      }
    }
    float p[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const bool valid = tb + lane < w.qlen[q];
      const float sc = s[q] * w.scale;
      const float m_new = fmaxf(m_r[q], warp_max(valid ? sc : kNegInf));
      const float corr = expf(m_r[q] - m_new);
      p[q] = valid ? expf(sc - m_new) : 0.f;
      l_r[q] = l_r[q] * corr + warp_sum(p[q]);
      m_r[q] = m_new;
#pragma unroll
      for (int c = 0; c < PPL; ++c) {
        acc[q][c][0] *= corr;
        acc[q][c][1] *= corr;
      }
    }
    // P.V: lane = column pair (lane + 32 c)
    for (int j = 0; j < nvalid; ++j) {
      float pj[G];                  // every lane takes part in the shuffle
#pragma unroll
      for (int q = 0; q < G; ++q) pj[q] = __shfl_sync(kFull, p[q], j);
#pragma unroll
      for (int c = 0; c < PPL; ++c) {
        const int col = 2 * (lane + 32 * c);
        if (col < DP) {
          const float2 vv = load2(vst + j * ROW + col);
#pragma unroll
          for (int q = 0; q < G; ++q) {
            acc[q][c][0] = fmaf(pj[q], vv.x, acc[q][c][0]);
            acc[q][c][1] = fmaf(pj[q], vv.y, acc[q][c][1]);
          }
        }
      }
    }
    __syncwarp();      // the warp's stage is free for its next block
  }
  // the warps' states into shared memory (the ring, now free), merged in
  // warp order into the split's state
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);        // [WARPS][G]
  float* wl = wm + WARPS * G;                        // [WARPS][G]
  float* wa = wl + WARPS * G;                        // [WARPS][G][DP]
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (lane == 0) {
      wm[warp * G + q] = m_r[q];
      wl[warp * G + q] = l_r[q];
    }
#pragma unroll
    for (int c = 0; c < PPL; ++c) {
      const int col = 2 * (lane + 32 * c);
      if (col < DP) {
        wa[(warp * G + q) * DP + col] = acc[q][c][0];
        wa[(warp * G + q) * DP + col + 1] = acc[q][c][1];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * DP; e += THREADS) {
    const int q = e / DP;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) mx = fmaxf(mx, wm[k * G + q]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const float wt = expf(wm[k * G + q] - mx);
      lsum = fmaf(wt, wl[k * G + q], lsum);
      o = fmaf(wt, wa[(k * G + q) * DP + (e - q * DP)], o);
    }
    w.st_acc[e] = o;
    if (e - q * DP == 0) {
      w.st_m[q] = mx;
      w.st_l[q] = lsum;
    }
  }
}

// A row of G queries: the warp walk where it applies, else CUDA cores.
template <typename T, int G, int DP, typename Issue, typename IssueW>
__device__ __forceinline__ void walk_row(const Walk& w, T* ring, float* red,
                                         float* pr, float* corr_s,
                                         Issue& issue, IssueW& issue_w) {
  if constexpr (Ring<T, DP>::STAGES == WARPS && G <= 2)
    walk_warp<T, G, DP>(w, ring, issue_w);
  else
    walk_cuda<T, G, DP>(w, ring, red, pr, corr_s, issue);
}

// NQ: the query heads of one kv head rounded up to a power of two (the
// queries of a CTA, those past H / Hkv zero); DP: padded head dim.
template <typename T, int NQ, int DP>
__global__ void __launch_bounds__(THREADS, 4)
paged_attention_kernel(const Args a) {
  using RingT = Ring<T, DP>;
  constexpr int ROW = RingT::ROW;
  constexpr int STAGES = RingT::STAGES;
  constexpr int RED = 4 * NQ * BT > 2 * THREADS ? 4 * NQ * BT : 2 * THREADS;

  __shared__ __align__(16) float qs[NQ * DP];
  __shared__ __align__(16) float red[RED];
  __shared__ __align__(16) float pr[NQ * PST];
  __shared__ __align__(16) float st_acc[NQ * DP];
  __shared__ float corr_s[NQ];
  __shared__ float st_m[NQ];
  __shared__ float st_l[NQ];
  __shared__ int qlen[NQ];
  __shared__ int row_s[2];                  // the row's table row, length
  __shared__ int pages_s[MAX_PAGES];        // the split's page indices
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);

  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int rep = a.H / a.Hkv;
  const int cap = a.maxp * a.ps;
  const int t_begin = split * a.spl;
  const int pg_lo = t_begin / a.ps;
  // page indices the split could need, and whether they fit on chip
  const int pg_max = min(a.maxp, (t_begin + a.spl - 1) / a.ps + 1) - pg_lo;
  const bool listed = pg_max <= MAX_PAGES;

  // round 1: the row's table row, length and queries; with row r reading
  // table row r (identity), also the split's page indices
  if (tid == 0) {
    row_s[0] = a.identity ? r : a.row_slot[r];
    row_s[1] = min(max(a.lengths[r], 0), cap);
  }
  if (a.identity && listed) {
    const int* trow = a.table + static_cast<int64_t>(r) * a.maxp;
    for (int k = tid; k < pg_max; k += THREADS) pages_s[k] = trow[pg_lo + k];
  }
  const T* qg = static_cast<const T*>(a.q) +
                (static_cast<int64_t>(r) * a.H + g * rep) * a.D;
  for (int e = tid; e < NQ * DP; e += THREADS) {
    const int i = e / DP, d = e - (e / DP) * DP;
    qs[e] = (i < rep && d < a.D) ? to_f32(qg[i * a.D + d]) : 0.f;
  }
  __syncthreads();
  const int slot = row_s[0];
  const int len = row_s[1];
  // splits past the row's length leave now (a cluster barrier waits for
  // the CTAs that have not exited; no peer reads their shared memory);
  // split 0 stays, to write a row without a key
  const int live = max(1, min(static_cast<int>(gridDim.z),
                              (len + a.spl - 1) / a.spl));
  if (split >= live) return;
  const int t_end = min(t_begin + a.spl, len);
  const int nblk = t_end > t_begin ? (t_end - t_begin + BT - 1) / BT : 0;

  // round 2 (none for identity rows): the split's page indices
  const int* trow = a.table + static_cast<int64_t>(slot) * a.maxp;
  if (listed && !a.identity) {
    const int npg = nblk > 0 ? (t_end - 1) / a.ps - pg_lo + 1 : 0;
    for (int k = tid; k < npg; k += THREADS) pages_s[k] = trow[pg_lo + k];
  }
  if (tid < NQ) qlen[tid] = tid < rep ? len : 0;
  // the padding columns [D, DP) of every staged row read as 0
  if (a.D < DP) {
    for (int e = tid; e < STAGES * 2 * BT * (DP - a.D); e += THREADS) {
      const int row = e / (DP - a.D);
      ring[row * ROW + a.D + (e - row * (DP - a.D))] = from_f32<T>(0.f);
    }
  }
  __syncthreads();

  const int64_t tok_stride = static_cast<int64_t>(a.Hkv) * a.D;
  const T* kbase = static_cast<const T*>(a.k_pages) +
                   static_cast<int64_t>(g) * a.D;
  const T* vbase = static_cast<const T*>(a.v_pages) +
                   static_cast<int64_t>(g) * a.D;
  auto page_of = [&](int t) -> int64_t {
    return listed ? pages_s[t / a.ps - pg_lo] : trow[t / a.ps];
  };
  // block b of the split's tokens into ring stage b % STAGES: the K and V
  // head rows of tokens < t_end (nothing past the row's length is read)
  auto issue = [&](int b) {
    const int tb = t_begin + b * BT;
    T* kd = ring + (b % STAGES) * 2 * BT * ROW;
    T* vd = kd + BT * ROW;
    if (a.vec16) {
      const int ch = a.D * static_cast<int>(sizeof(T)) / 16;
      const int epc = 16 / static_cast<int>(sizeof(T));
      for (int e = tid; e < BT * ch; e += THREADS) {
        const int j = e / ch, c = e - (e / ch) * ch;
        const int t = tb + j;
        if (t < t_end) {
          const int64_t off =
              (page_of(t) * a.ps + t % a.ps) * tok_stride + c * epc;
          cp_async16(kd + j * ROW + c * epc, kbase + off);
          cp_async16(vd + j * ROW + c * epc, vbase + off);
        }
      }
    } else {
      for (int e = tid; e < BT * a.D; e += THREADS) {
        const int j = e / a.D, d = e - (e / a.D) * a.D;
        const int t = tb + j;
        if (t < t_end) {
          const int64_t off = (page_of(t) * a.ps + t % a.ps) * tok_stride + d;
          kd[j * ROW + d] = kbase[off];
          vd[j * ROW + d] = vbase[off];
        }
      }
    }
  };

  // the same for one warp, into its own stage
  auto issue_w = [&](int b, int wp) {
    const int tb = t_begin + b * BT;
    T* kd = ring + wp * 2 * BT * ROW;
    T* vd = kd + BT * ROW;
    const int ln = tid & 31;
    if (a.vec16) {
      const int ch = a.D * static_cast<int>(sizeof(T)) / 16;
      const int epc = 16 / static_cast<int>(sizeof(T));
      for (int e = ln; e < BT * ch; e += 32) {
        const int j = e / ch, c = e - (e / ch) * ch;
        const int t = tb + j;
        if (t < t_end) {
          const int64_t off =
              (page_of(t) * a.ps + t % a.ps) * tok_stride + c * epc;
          cp_async16(kd + j * ROW + c * epc, kbase + off);
          cp_async16(vd + j * ROW + c * epc, vbase + off);
        }
      }
    } else {
      for (int e = ln; e < BT * a.D; e += 32) {
        const int j = e / a.D, d = e - (e / a.D) * a.D;
        const int t = tb + j;
        if (t < t_end) {
          const int64_t off = (page_of(t) * a.ps + t % a.ps) * tok_stride + d;
          kd[j * ROW + d] = kbase[off];
          vd[j * ROW + d] = vbase[off];
        }
      }
    }
  };

  const Walk w{qs, qlen, st_m, st_l, st_acc, t_begin, t_end, nblk, a.scale};
  walk_row<T, NQ, DP>(w, ring, red, pr, corr_s, issue, issue_w);

  T* og = static_cast<T*>(a.out);
  if (live == 1) {
    // one live split: its state is the output (the other CTAs have left)
    __syncthreads();
    for (int e = tid; e < rep * DP; e += THREADS) {
      const int i = e / DP, d = e - (e / DP) * DP;
      if (d < a.D)
        store(og + (static_cast<int64_t>(r) * a.H + g * rep + i) * a.D + d,
              st_acc[e] / fmaxf(st_l[i], 1e-30f));
    }
    return;
  }
  // merge the live splits' states in rank order, each CTA a share of the
  // outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = split * THREADS + tid; e < rep * DP; e += live * THREADS) {
    const int i = e / DP, d = e - (e / DP) * DP;
    if (d >= a.D) continue;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], os[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < live) {
        ms[s] = *cluster.map_shared_rank(st_m + i, s);
        ls[s] = *cluster.map_shared_rank(st_l + i, s);
        os[s] = *cluster.map_shared_rank(st_acc + i * DP + d, s);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < live) mx = fmaxf(mx, ms[s]);
    float lsum = 0.f, o_sum = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < live) {
        const float wt = expf(ms[s] - mx);
        lsum = fmaf(wt, ls[s], lsum);
        o_sum = fmaf(wt, os[s], o_sum);
      }
    }
    store(og + (static_cast<int64_t>(r) * a.H + g * rep + i) * a.D + d,
          o_sum / fmaxf(lsum, 1e-30f));
  }
  // no CTA leaves while a peer may still read its shared memory
  cluster.sync();
}

using KernelFn = void (*)(const Args);

constexpr int NQ_CHOICES[] = {1, 2, 4, 8};
constexpr int DP_CHOICES[] = {32, 64, 128};
constexpr int N_INSTANCES = 2 * 4 * 3;

template <typename T, int NQ>
KernelFn pick_dp(int dp_idx, int* ring_bytes) {
  switch (dp_idx) {
    case 0:
      *ring_bytes = Ring<T, 32>::BYTES;
      return paged_attention_kernel<T, NQ, 32>;
    case 1:
      *ring_bytes = Ring<T, 64>::BYTES;
      return paged_attention_kernel<T, NQ, 64>;
    default:
      *ring_bytes = Ring<T, 128>::BYTES;
      return paged_attention_kernel<T, NQ, 128>;
  }
}

template <typename T>
KernelFn pick_nq(int nq_idx, int dp_idx, int* ring_bytes) {
  switch (nq_idx) {
    case 0: return pick_dp<T, 1>(dp_idx, ring_bytes);
    case 1: return pick_dp<T, 2>(dp_idx, ring_bytes);
    case 2: return pick_dp<T, 4>(dp_idx, ring_bytes);
    default: return pick_dp<T, 8>(dp_idx, ring_bytes);
  }
}

// instance index = (dtype * 4 + nq_idx) * 3 + dp_idx
KernelFn instance(int index, int* ring_bytes) {
  const int dtype = index / 12, nq_idx = (index / 3) % 4, dp_idx = index % 3;
  return dtype == 0 ? pick_nq<float>(nq_idx, dp_idx, ring_bytes)
                    : pick_nq<__nv_bfloat16>(nq_idx, dp_idx, ring_bytes);
}

// the instance's dynamic shared memory limit, set once per instance
cudaError_t prepare(int index, KernelFn* fn, int* ring_bytes) {
  static bool ready[N_INSTANCES] = {};
  *fn = instance(index, ring_bytes);
  if (!ready[index]) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(*fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, *ring_bytes);
    if (err != cudaSuccess) return err;
    ready[index] = true;
  }
  return cudaSuccess;
}

int index_of(int list_value, const int* list, int n) {
  for (int k = 0; k < n; ++k)
    if (list[k] == list_value) return k;
  return -1;
}

int pad_dim(int D) { return D <= 32 ? 32 : (D <= 64 ? 64 : 128); }

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  splits (1, 2, 4 or 8) CTAs of spl
// tokens each (a multiple of 32) cover a row's maxp * ps positions.
// identity: row r reads table row r and row_slot is not read (it may be
// null).  Returns a cudaError_t value.
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* table,
                           const void* lengths, const void* row_slot,
                           void* out, int R, int H, int Hkv, int D, int ps,
                           int maxp, float scale, int splits, int spl,
                           int identity, void* stream) {
  if (R <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 8 || D <= 0 ||
      D > 128 || ps <= 0 || maxp <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq_idx = index_of(pow2_at_least(H / Hkv), NQ_CHOICES, 4);
  if (splits < 1 || splits > MAX_SPLITS ||
      (splits & (splits - 1)) != 0 || spl <= 0 || spl % BT != 0 ||
      static_cast<int64_t>(spl) * splits <
          static_cast<int64_t>(maxp) * ps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = dtype == 0 ? 4 : 2;
  const int dp_idx = index_of(pad_dim(D), DP_CHOICES, 3);
  const int index = (dtype * 4 + nq_idx) * 3 + dp_idx;
  KernelFn fn;
  int ring_bytes = 0;
  cudaError_t err = prepare(index, &fn, &ring_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.row_slot = static_cast<const int*>(row_slot);
  a.out = out;
  a.R = R;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.ps = ps;
  a.maxp = maxp;
  a.spl = spl;
  a.vec16 = (D * elem) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  a.scale = scale;
  a.identity = identity != 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, Hkv, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = ring_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's account of instance `index` (0 .. paged_attention_instances()
// - 1; see `instance`): out = {registers, local memory bytes per thread,
// static shared memory bytes, dynamic shared memory bytes, nq, padded head
// dim, dtype}.
int paged_attention_instances() { return N_INSTANCES; }

int paged_attention_attributes(int index, int* out) {
  if (index < 0 || index >= N_INSTANCES)
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn fn;
  int ring_bytes = 0;
  cudaError_t err = prepare(index, &fn, &ring_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = ring_bytes;
  out[4] = NQ_CHOICES[(index / 3) % 4];
  out[5] = DP_CHOICES[index % 3];
  out[6] = index / 12;
  return 0;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
