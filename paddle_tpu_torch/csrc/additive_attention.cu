// Bahdanau additive-attention step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of paddle_tpu/ops/pallas_additive.py
// (called by `_fwd_pallas`).  For each batch row b, with u = dec_state W
// computed outside the kernel (float32, [B, D]) and a scoring vector v [D]:
//
//     s_t = v . tanh(enc_proj[b, t] + u[b])            t < lens[b]
//     context[b] = sum_t softmax_t(s) enc_seq[b, t]
//
// enc_proj [B, T, D] and enc_seq [B, T, Dv] are float32 or bfloat16 (both
// the same type), read once each; every sum is taken in float32 and the
// context is written in enc_seq's type.  A row with no valid key gets a zero
// context (the running sum stays 0 and the accumulator is divided by
// max(l, 1e-30)), as the TPU kernel does.
//
// Design.  The TPU kernel tiles (batch rows, T) with T innermost and carries
// an online softmax over the T tiles in VMEM scratch.  Here one CTA owns one
// batch row and walks its valid keys in tiles of 64 with the same online
// softmax: the warps split the tile's keys, a key's score is a warp-wide
// dot product over D (lanes on neighbouring elements of enc_proj, a warp's
// keys loaded together), the running max and sum are kept in registers by
// every thread, and the threads split Dv, each holding its columns' context
// accumulator in registers and loading several keys' values at a time.
// Keys beyond lens[b] are never read.  The work is bound by bytes (each
// element of enc_proj and enc_seq is read once for a few flops); at the
// seq2seq decoder's shapes the B CTAs are fewer than the card's SMs, so each
// SM's read rate, not the card's, sets the time.
//
// Plain C interface (ctypes): the launcher returns the CUDA error code of its
// launch (0 = success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;           // keys per tile (<= THREADS)
constexpr int KEYS_PER_WARP = TILE / WARPS;
constexpr int MAX_COLS = 8;        // Dv <= THREADS * MAX_COLS
constexpr int MAX_D = 4096;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

template <typename T>
__global__ void additive_attention_kernel(
        const float* __restrict__ u, const float* __restrict__ v,
        const T* __restrict__ proj, const T* __restrict__ seq,
        const int* __restrict__ lens, T* __restrict__ out, int Tn, int D,
        int Dv) {
    extern __shared__ float smem[];
    float* u_s = smem;                  // [D]
    float* v_s = u_s + D;               // [D]
    __shared__ float s_s[TILE];         // the tile's scores
    __shared__ float p_s[TILE];         // their exp(s - m)
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int len = max(0, min(lens[b], Tn));
    for (int i = threadIdx.x; i < D; i += THREADS) {
        u_s[i] = u[(size_t)b * D + i];
        v_s[i] = v[i];
    }
    float acc[MAX_COLS];
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) acc[c] = 0.f;
    float m = -INFINITY, l = 0.f;
    __syncthreads();

    for (int t0 = 0; t0 < len; t0 += TILE) {
        const int n = min(TILE, len - t0);
        // warp w scores keys w, w + WARPS, ...: all of its keys' loads of
        // one column block are issued together
        const T* pr = proj + ((size_t)b * Tn + t0) * D;
        float s[KEYS_PER_WARP];
#pragma unroll
        for (int i = 0; i < KEYS_PER_WARP; ++i) s[i] = 0.f;
#pragma unroll 4
        for (int d = lane; d < D; d += 32) {
            const float ud = u_s[d], vd = v_s[d];
#pragma unroll
            for (int i = 0; i < KEYS_PER_WARP; ++i) {
                const int tt = warp + i * WARPS;
                if (tt < n)
                    s[i] = fmaf(vd, tanhf(to_f(pr[(size_t)tt * D + d]) + ud),
                                s[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < KEYS_PER_WARP; ++i) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
            const int tt = warp + i * WARPS;
            if (lane == 0 && tt < n) s_s[tt] = s[i];
        }
        __syncthreads();
        float m_new = m;
        for (int tt = 0; tt < n; ++tt) m_new = fmaxf(m_new, s_s[tt]);
        const float corr = expf(m - m_new);       // 0 at the first tile
        if (threadIdx.x < n) p_s[threadIdx.x] = expf(s_s[threadIdx.x] - m_new);
        __syncthreads();
        float tile_sum = 0.f;
        for (int tt = 0; tt < n; ++tt) tile_sum += p_s[tt];
        l = l * corr + tile_sum;
        m = m_new;
        const T* sq = seq + ((size_t)b * Tn + t0) * Dv;
#pragma unroll
        for (int c = 0; c < MAX_COLS; ++c) acc[c] *= corr;
#pragma unroll 4
        for (int tt = 0; tt < n; ++tt) {
            const float p = p_s[tt];
#pragma unroll
            for (int c = 0; c < MAX_COLS; ++c) {
                const int col = threadIdx.x + c * THREADS;
                if (col < Dv)
                    acc[c] = fmaf(p, to_f(sq[(size_t)tt * Dv + col]), acc[c]);
            }
        }
        __syncthreads();
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
        const int col = threadIdx.x + c * THREADS;
        if (col < Dv) store(out + (size_t)b * Dv + col, acc[c] * inv);
    }
}

template <typename T>
cudaError_t launch(const void* u, const void* v, const void* proj,
                   const void* seq, const void* lens, void* out, int B,
                   int Tn, int D, int Dv, cudaStream_t stream) {
    const size_t smem = (size_t)2 * D * sizeof(float);
    additive_attention_kernel<T><<<B, THREADS, smem, stream>>>(
        (const float*)u, (const float*)v, (const T*)proj, (const T*)seq,
        (const int*)lens, (T*)out, Tn, D, Dv);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B, Dv] <- the attention context of u [B, D] (float32), v [D]
// (float32) over enc_proj [B, T, D] and enc_seq [B, T, Dv] with lens [B]
// int32 valid keys; dtype 0 = float32, 1 = bfloat16 (enc_proj, enc_seq and
// out).
int additive_attention_launch(const void* u, const void* v, const void* proj,
                              const void* seq, const void* lens, void* out,
                              int B, int T, int D, int Dv, int dtype,
                              void* stream) {
    if (B < 1 || T < 1 || D < 1 || D > MAX_D || Dv < 1
            || Dv > THREADS * MAX_COLS || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(u, v, proj, seq, lens, out, B, T, D,
                                          Dv, st);
    return (int)launch<float>(u, v, proj, seq, lens, out, B, T, D, Dv, st);
}

const char* additive_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
