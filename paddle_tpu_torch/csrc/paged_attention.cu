// Ragged paged attention for Hopper (sm_90a), float32 or bfloat16 pools.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_paged.py:_kernel
// (launched by pallas_paged.paged_attention).  Query row r attends the
// pages table[row_slot[r], p] of its table row for positions t < lengths[r]:
// an online softmax across pages, grouped-query heads resolved here (the
// pools keep H_kv heads), pages past a row's length never read.
//
// What bounds it: the bytes of the live K/V pages.  Each (row, kv head)
// reads its live pages once and does 4*D flops per (query head, token), far
// below the card's ~300 flops per byte of balance, so it is memory-bound.
// This first version does that with plain loads: one CTA per (row, kv head)
// with 4 warps splitting the row's pages; inside a warp the lanes split the
// head dim, so the K and V vector of one token is one coalesced warp load;
// each warp keeps its own online-softmax state (m, l, acc) in registers for
// the group's query heads, and the warps merge through shared memory at
// the end.  Scores, softmax and accumulation are float32.  The TPU's
// padding of heads to >= 8 and of the head dim to 128 is not carried over.
// Splitting one row's pages across CTAs, cp.async/TMA staging and tensor
// cores are later work.
//
// C interface (bound with ctypes): paged_attention_launch() launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// DPL: head-dim elements per lane (D <= 32 * DPL); GROUP: the most query
// heads per kv head this instance handles (rep <= GROUP).
template <typename T, int DPL, int GROUP>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q,          // [R, H, D]
                       const T* __restrict__ k_pages,    // [P, ps, Hkv, D]
                       const T* __restrict__ v_pages,    // [P, ps, Hkv, D]
                       const int* __restrict__ table,    // [S, maxp]
                       const int* __restrict__ lengths,  // [R]
                       const int* __restrict__ row_slot, // [R]
                       T* __restrict__ out,              // [R, H, D]
                       int H, int Hkv, int D, int ps, int maxp, float scale) {
  __shared__ float sm_m[kWarps][GROUP];
  __shared__ float sm_l[kWarps][GROUP];
  __shared__ float sm_acc[kWarps][GROUP][DPL * 32];

  const int r = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rep = H / Hkv;
  const int len = lengths[r];
  const int* trow = table + static_cast<int64_t>(row_slot[r]) * maxp;
  int n_pages = (len + ps - 1) / ps;
  if (n_pages > maxp) n_pages = maxp;

  // this lane's slice of the group's query vectors
  float qv[GROUP][DPL];
#pragma unroll
  for (int h = 0; h < GROUP; ++h) {
    const T* qh = q + (static_cast<int64_t>(r) * H + g * rep + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qv[h][i] = (h < rep && d < D) ? to_f32(qh[d]) : 0.f;
    }
  }

  float m[GROUP], l[GROUP], acc[GROUP][DPL];
#pragma unroll
  for (int h = 0; h < GROUP; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[h][i] = 0.f;
  }

  const int64_t tok_stride = static_cast<int64_t>(Hkv) * D;
  for (int p = warp; p < n_pages; p += kWarps) {
    const int64_t page = trow[p];
    const T* kbase = k_pages + page * ps * tok_stride + static_cast<int64_t>(g) * D;
    const T* vbase = v_pages + page * ps * tok_stride + static_cast<int64_t>(g) * D;
    // a page is walked in blocks of up to 32 tokens: lane j of the warp
    // ends up holding the score of the block's token j
    for (int base = 0; base < ps; base += 32) {
      const int t0 = p * ps + base;
      if (t0 >= len) break;
      const int ntok = min(32, ps - base);
      float s_mine[GROUP];
#pragma unroll
      for (int h = 0; h < GROUP; ++h) s_mine[h] = kNegInf;
      for (int j = 0; j < ntok; ++j) {
        const T* kt = kbase + (base + j) * tok_stride;
        float kv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          kv[i] = d < D ? to_f32(kt[d]) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < GROUP; ++h) {
          if (h < rep) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < DPL; ++i) part += qv[h][i] * kv[i];
            const float sc = warp_sum(part) * scale;
            if (lane == j) s_mine[h] = sc;
          }
        }
      }
      const bool valid = lane < ntok && t0 + lane < len;
      float w[GROUP];
#pragma unroll
      for (int h = 0; h < GROUP; ++h) {
        w[h] = 0.f;
        if (h < rep) {
          const float sc = valid ? s_mine[h] : kNegInf;
          const float m_new = fmaxf(m[h], warp_max(sc));
          const float corr = expf(m[h] - m_new);
          w[h] = valid ? expf(sc - m_new) : 0.f;
          l[h] = l[h] * corr + warp_sum(w[h]);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[h][i] *= corr;
          m[h] = m_new;
        }
      }
      for (int j = 0; j < ntok; ++j) {
        const T* vt = vbase + (base + j) * tok_stride;
        float vv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < D ? to_f32(vt[d]) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < GROUP; ++h) {
          if (h < rep) {
            const float wj = __shfl_sync(kFull, w[h], j);
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[h][i] += wj * vv[i];
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int h = 0; h < GROUP; ++h) {
    if (h < rep) {
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][h][lane + 32 * i] = acc[h][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int h = e / D;
    const int d = e - h * D;
    float mx = kNegInf;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) mx = fmaxf(mx, sm_m[w2][h]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) {
      const float c = expf(sm_m[w2][h] - mx);
      lsum += sm_l[w2][h] * c;
      o += sm_acc[w2][h][d] * c;
    }
    store(out + (static_cast<int64_t>(r) * H + g * rep + h) * D + d,
          o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DPL>
void launch_group(int rep, dim3 grid, cudaStream_t stream, const void* q,
                  const void* kp, const void* vp, const int* table,
                  const int* lengths, const int* row_slot, void* out, int H,
                  int Hkv, int D, int ps, int maxp, float scale) {
  const dim3 block(kWarps * 32);
#define PA_LAUNCH(G)                                                        \
  paged_attention_kernel<T, DPL, G><<<grid, block, 0, stream>>>(            \
      static_cast<const T*>(q), static_cast<const T*>(kp),                  \
      static_cast<const T*>(vp), table, lengths, row_slot,                  \
      static_cast<T*>(out), H, Hkv, D, ps, maxp, scale)
  if (rep <= 1) {
    PA_LAUNCH(1);
  } else if (rep <= 2) {
    PA_LAUNCH(2);
  } else if (rep <= 4) {
    PA_LAUNCH(4);
  } else {
    PA_LAUNCH(8);
  }
#undef PA_LAUNCH
}

template <typename T>
void launch_dtype(int rep, dim3 grid, cudaStream_t stream, const void* q,
                  const void* kp, const void* vp, const int* table,
                  const int* lengths, const int* row_slot, void* out, int H,
                  int Hkv, int D, int ps, int maxp, float scale) {
  if (D <= 32) {
    launch_group<T, 1>(rep, grid, stream, q, kp, vp, table, lengths, row_slot,
                       out, H, Hkv, D, ps, maxp, scale);
  } else if (D <= 64) {
    launch_group<T, 2>(rep, grid, stream, q, kp, vp, table, lengths, row_slot,
                       out, H, Hkv, D, ps, maxp, scale);
  } else {
    launch_group<T, 4>(rep, grid, stream, q, kp, vp, table, lengths, row_slot,
                       out, H, Hkv, D, ps, maxp, scale);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t value.
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* table,
                           const void* lengths, const void* row_slot,
                           void* out, int R, int H, int Hkv, int D, int ps,
                           int maxp, float scale, void* stream) {
  if (R <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 8 || D <= 0 ||
      D > 128 || ps <= 0 || maxp <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(R, Hkv);
  const int rep = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  const int* rows = static_cast<const int*>(row_slot);
  if (dtype == 0) {
    launch_dtype<float>(rep, grid, s, q, k_pages, v_pages, tbl, len, rows, out,
                        H, Hkv, D, ps, maxp, scale);
  } else {
    launch_dtype<__nv_bfloat16>(rep, grid, s, q, k_pages, v_pages, tbl, len,
                                rows, out, H, Hkv, D, ps, maxp, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
