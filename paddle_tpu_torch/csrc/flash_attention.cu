// Flash attention for Hopper (sm_90a) on CUDA cores, float32 inputs:
// forward, backward dQ, backward dK/dV.  bfloat16 inputs go to the
// tensor-core kernels of flash_attention_tc.cu.
//
// Replaces, for float32, the three Pallas TPU kernels of
// paddle_tpu/ops/pallas_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (launched by _fwd_call)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (launched by _bwd_call)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (launched by _bwd_call)
// They compute the same function, not a block-by-block copy: on the TPU the
// sequential innermost grid axis carries the online-softmax state (or the
// dq / dk,dv sums) in VMEM scratch; here one CTA owns one output tile and
// walks the other axis in a loop, so nothing carries between blocks.
//
// Layout is the JAX package's: q [B, Tq, H, D], k/v [B, Tk, Hkv, D], key
// validity kv_mask [B, Tk] (uint8), lse/delta [B, H, Tq] float32.  Grouped
// query heads are resolved here (query head h reads kv head h / (H / Hkv));
// K/V are never expanded.  Causal and sliding-window masks use global
// positions q_off + row and k_off + column; tiles that the causal/window mask
// kills entirely are skipped (the TPU kernel's _tile_live).  A fully masked
// row gives o = 0 and lse = -inf.  No padding of D or T: D <= 128 (template
// instances for D <= 64 and D <= 128, zero-filled in shared memory) and the
// ragged edges of Tq and Tk are masked here.
//
// What bounds it: at the training shapes (T = 2048, D = 64) attention does
// ~4 T^2 D flops per head against ~4 T D bytes, so the card's bound is its
// float32 rate.  Every product is a true-fp32 FMA on CUDA cores, as the TPU
// kernels' Precision.HIGHEST for float32 inputs (TF32 tensor cores would
// keep ~3 decimal digits), out of padded shared-memory tiles (rows of D + 1
// floats, no bank conflicts), each of 256 threads owning a 4 x 4 block of
// the 64 x 64 score tile.  The backward kernels recompute p = exp(s - lse)
// instead of reading a stored probability matrix.  dK/dV have one owner per
// tile (the CTA walks the kv head's whole query-head group), so there are no
// atomics and the gradients are deterministic.
//
// C interface (bound with ctypes, the same as flash_attention_tc.cu's): each
// *_launch() launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads, each a 4 x 4 score block
constexpr int kPLD = kBK + 1;    // row stride of the [BQ][BK] probability tiles
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

// sum / max over the 16 threads (tx = lane & 15) that share a score row
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

struct Mask {
  int causal;   // 0/1
  int window;   // < 0: none; else keep |qpos - kpos| < window
  int q_off;
  int k_off;

  // _tile_live: false iff the causal/window mask kills the whole tile
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
  // _tile_mask for one (row, column) of global tile coordinates
  __device__ bool keep(int r, int c) const {
    const int qp = q_off + r, kp = k_off + c;
    if (causal && kp > qp) return false;
    if (window >= 0 && abs(qp - kp) >= window) return false;
    return true;
  }
};

// rows [0, 64) of a [rows, D] slice with row stride `stride` elements into a
// float tile of row stride DM + 1; rows >= n_rows and columns >= D are 0
template <int DM>
__device__ void load_tile(float* dst, const float* __restrict__ src, int n_rows,
                          int64_t stride, int D) {
  for (int e = threadIdx.x; e < 64 * DM; e += kThreads) {
    const int r = e / DM, d = e - (e / DM) * DM;
    dst[r * (DM + 1) + d] =
        (r < n_rows && d < D) ? src[r * stride + d] : 0.f;
  }
}

// key validity of one key tile: kv_mask, and the ragged edge of Tk
__device__ void load_kvalid(int* dst, const uint8_t* __restrict__ kv_row,
                            int k0, int Tk) {
  for (int c = threadIdx.x; c < kBK; c += kThreads)
    dst[c] = (k0 + c < Tk && kv_row[k0 + c] != 0) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// forward: CTA (q tile, head, batch) walks the key tiles with the
// online-softmax state (m, l, acc) of its rows in registers
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, int Hkv,
                 int D, float scale, Mask mk) {
  constexpr int LD = DM + 1;
  constexpr int NJ = DM / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][LD]
  float* sK = sQ + kBQ * LD;        // [BK][LD]
  float* sV = sK + kBK * LD;        // [BK][LD]
  float* sP = sV + kBK * LD;        // [BQ][PLD]
  int* sKv = reinterpret_cast<int*>(sP + kBQ * kPLD);  // [BK]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const float* qb = q + (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                static_cast<int64_t>(h) * D;
  const float* kb = k + static_cast<int64_t>(b) * Tk * k_stride +
                static_cast<int64_t>(hk) * D;
  const float* vb = v + static_cast<int64_t>(b) * Tk * k_stride +
                static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;

  load_tile<DM>(sQ, qb, Tq - q0, q_stride, D);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Tk + kBK - 1) / kBK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kBK;
    if (!mk.live(q0, k0)) continue;  // uniform over the block
    __syncthreads();                 // the last tile's sK/sV/sP reads are done
    load_tile<DM>(sK, kb + k0 * k_stride, Tk - k0, k_stride, D);
    load_tile<DM>(sV, vb + k0 * k_stride, Tk - k0, k_stride, D);
    load_kvalid(sKv, kv_row, k0, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        keep[j] = sKv[c] && mk.keep(r, k0 + c);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ty + 16 * i) * kPLD + tx + 16 * j] = p;
      }
      l[i] = corr * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kPLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
    float* orow = o + (static_cast<int64_t>(b) * Tq + r) * q_stride +
              static_cast<int64_t>(h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = l[i] > 0.f ? acc[i][j] * inv : 0.f;
    }
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// backward dQ: CTA (q tile, head, batch) walks the key tiles;
// p = exp(s - lse), ds = p (dp - delta) scale, dq += ds k
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int H, int Hkv, int D, float scale,
                    Mask mk) {
  constexpr int LD = DM + 1;
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BQ][LD]
  float* sdO = sQ + kBQ * LD;        // [BQ][LD]
  float* sK = sdO + kBQ * LD;        // [BK][LD]
  float* sV = sK + kBK * LD;         // [BK][LD]
  float* sdS = sV + kBK * LD;        // [BQ][PLD]
  int* sKv = reinterpret_cast<int*>(sdS + kBQ * kPLD);  // [BK]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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

  load_tile<DM>(sQ, q + q_base, Tq - q0, q_stride, D);
  load_tile<DM>(sdO, dout + q_base, Tq - q0, q_stride, D);
  float lse_r[4], delta_r[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_ok[i] = r < Tq;
    lse_r[i] = row_ok[i] ? lse[row_base + r] : 0.f;
    delta_r[i] = row_ok[i] ? delta[row_base + r] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (Tk + kBK - 1) / kBK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kBK;
    if (!mk.live(q0, k0)) continue;
    __syncthreads();
    load_tile<DM>(sK, kb + k0 * k_stride, Tk - k0, k_stride, D);
    load_tile<DM>(sV, vb + k0 * k_stride, Tk - k0, k_stride, D);
    load_kvalid(sKv, kv_row, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + d];
        dov[i] = sdO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = row_ok[i] && sKv[c] && mk.keep(r, k0 + c);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sdS[(ty + 16 * i) * kPLD + c] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(ty + 16 * i) * kPLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    float* row = dq + q_base + (ty + 16 * i) * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward dK, dV: CTA (k tile, kv head, batch) walks every (query head of
// the group) x (q tile) pair; dv += p^T do, dk += ds^T q
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ kv_mask,
                     const float* __restrict__ dout,
                    const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int H, int Hkv,
                     int D, float scale, Mask mk) {
  constexpr int LD = DM + 1;
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // [BK][LD]
  float* sV = sK + kBK * LD;         // [BK][LD]
  float* sQ = sV + kBK * LD;         // [BQ][LD]
  float* sdO = sQ + kBQ * LD;        // [BQ][LD]
  float* sP = sdO + kBQ * LD;        // [BQ][PLD]
  float* sdS = sP + kBQ * kPLD;      // [BQ][PLD]
  int* sKv = reinterpret_cast<int*>(sdS + kBQ * kPLD);  // [BK]

  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Tk + k0) * k_stride +
                         static_cast<int64_t>(hk) * D;
  const uint8_t* kv_row = kv_mask + static_cast<int64_t>(b) * Tk;

  load_tile<DM>(sK, k + k_base, Tk - k0, k_stride, D);
  load_tile<DM>(sV, v + k_base, Tk - k0, k_stride, D);
  load_kvalid(sKv, kv_row, k0, Tk);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (Tq + kBQ - 1) / kBQ;
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const int64_t row_base = (static_cast<int64_t>(b) * H + h) * Tq;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * kBQ;
      if (!mk.live(q0, k0)) continue;
      __syncthreads();  // the last pair's sQ/sdO/sP/sdS reads are done
      const int64_t q_base = (static_cast<int64_t>(b) * Tq + q0) * q_stride +
                             static_cast<int64_t>(h) * D;
      load_tile<DM>(sQ, q + q_base, Tq - q0, q_stride, D);
      load_tile<DM>(sdO, dout + q_base, Tq - q0, q_stride, D);
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DM; ++d) {
        float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = sQ[(ty + 16 * i) * LD + d];
          dov[i] = sdO[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sK[(tx + 16 * j) * LD + d];
          vv[j] = sV[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        const bool row_ok = r < Tq;
        const float lse_r = row_ok ? lse[row_base + r] : 0.f;
        const float delta_r = row_ok ? delta[row_base + r] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool keep = row_ok && sKv[c] && mk.keep(r, k0 + c);
          const float p = keep ? expf(s[i][j] * scale - lse_r) : 0.f;
          sP[(ty + 16 * i) * kPLD + c] = p;
          sdS[(ty + 16 * i) * kPLD + c] = p * (dp[i][j] - delta_r) * scale;
        }
      }
      __syncthreads();

      // this thread's dk/dv rows are key rows c = ty + 16 i
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], dsv[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[r * kPLD + ty + 16 * i];
          dsv[i] = sdS[r * kPLD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = sdO[r * LD + tx + 16 * j];
          qv[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (k0 + c >= Tk) continue;
    float* dkr = dk + k_base + c * k_stride;
    float* dvr = dv + k_base + c * k_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkr[d] = dk_acc[i][j];
        dvr[d] = dv_acc[i][j];
      }
    }
  }
}

// dynamic shared memory of each kernel, in bytes
template <int DM>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kBQ * (DM + 1) + 2 * kBK * (DM + 1) + kBQ * kPLD) +
         sizeof(int) * kBK;
}
template <int DM>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBQ * (DM + 1) + 2 * kBK * (DM + 1) +
                          kBQ * kPLD) +
         sizeof(int) * kBK;
}
template <int DM>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kBK * (DM + 1) + 2 * kBQ * (DM + 1) +
                          2 * kBQ * kPLD) +
         sizeof(int) * kBK;
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

template <int DM>
int fwd_dm(const float* q, const float* k, const float* v,
           const uint8_t* kvm, float* o, float* lse, int B, int Tq, int Tk,
           int H, int Hkv, int D, float scale, Mask mk,
           cudaStream_t stream) {
  const size_t bytes = fwd_smem<DM>();
  if (int rc = set_smem(flash_fwd_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kvm, o, lse, Tq, Tk, H, Hkv, D, scale, mk);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int dq_dm(const float* q, const float* k, const float* v, const uint8_t* kvm,
          const float* dout, const float* lse, const float* delta, float* dq,
          int B, int Tq, int Tk, int H, int Hkv, int D, float scale, Mask mk,
          cudaStream_t stream) {
  const size_t bytes = dq_smem<DM>();
  if (int rc = set_smem(flash_bwd_dq_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kvm, dout, lse, delta, dq, Tq, Tk, H, Hkv, D, scale, mk);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int dkv_dm(const float* q, const float* k, const float* v, const uint8_t* kvm,
           const float* dout, const float* lse, const float* delta,
           float* dk, float* dv, int B, int Tq, int Tk, int H, int Hkv,
           int D, float scale, Mask mk, cudaStream_t stream) {
  const size_t bytes = dkv_smem<DM>();
  if (int rc = set_smem(flash_bwd_dkv_kernel<DM>, bytes)) return rc;
  const dim3 grid((Tk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkv_kernel<DM><<<grid, kThreads, bytes, stream>>>(
      q, k, v, kvm, dout, lse, delta, dk, dv, Tq, Tk, H, Hkv, D, scale, mk);
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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* of = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? fwd_dm<64>(f(q), f(k), f(v), kvm, of, l, B, Tq, Tk, H, Hkv,
                              D, scale, mk, s)
                 : fwd_dm<128>(f(q), f(k), f(v), kvm, of, l, B, Tq, Tk, H,
                               Hkv, D, scale, mk, s);
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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* g = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? dq_dm<64>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                             f(delta), g, B, Tq, Tk, H, Hkv, D, scale, mk, s)
                 : dq_dm<128>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                              f(delta), g, B, Tq, Tk, H, Hkv, D, scale, mk,
                              s);
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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const uint8_t* kvm = static_cast<const uint8_t*>(kv_mask);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? dkv_dm<64>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                              f(delta), gk, gv, B, Tq, Tk, H, Hkv, D, scale,
                              mk, s)
                 : dkv_dm<128>(f(q), f(k), f(v), kvm, f(dout), f(lse),
                               f(delta), gk, gv, B, Tq, Tk, H, Hkv, D, scale,
                               mk, s);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
