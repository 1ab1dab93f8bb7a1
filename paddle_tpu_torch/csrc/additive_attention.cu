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
// the same type), each byte read once; every sum is taken in float32 and
// the context is written in enc_seq's type.  A row with no valid key gets a
// zero context (the running sum stays 0 and the accumulator is divided by
// max(l, 1e-30)), as the TPU kernel does.  Keys beyond lens[b] are never
// read.
//
// What bounds it: bytes (each element of enc_proj and enc_seq is read once
// for a few flops).  One CTA per batch row (the first version) put 64 CTAs
// on the card's 132 SMs at the seq2seq decoder's training shape, each
// walking its keys behind a shuffle reduction per key, so each SM's read
// rate, not the card's, set the time.  This design spreads a row over a
// thread-block cluster of C CTAs (C = 1, 2, 4 or 8, from shapes:
// ops/additive_attention.py `additive_plan`):
//
// * CTA c owns a slice of D for the scores and a slice of Dv for the
//   context.  Keys are walked in tiles of 32: a lane owns a key and a warp
//   an eighth of the CTA's D slice (u and v read as broadcasts), so no
//   shuffle reduction per key; the eight partials are summed in a fixed
//   order into the CTA's partial scores.
// * The cluster exchanges the partial scores through distributed shared
//   memory, one cluster barrier per key tile (the buffers alternate
//   between tiles): every CTA sums the C partials in rank order, so all
//   hold the same scores bit for bit, and keeps the same online softmax.
// * The tile's enc_seq columns of the CTA's Dv slice are staged in shared
//   memory by cp.async while the scores are computed and exchanged, then
//   threads own columns (and, for a narrow slice, interleaved keys) for
//   the context; the key groups merge in a fixed order at the end.
//
// Plain C interface (ctypes): the launcher returns the CUDA error code of its
// launch (0 = success) and never synchronises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 32;             // keys per tile (one per lane)
constexpr int MAX_CTAS = 8;        // portable cluster size
constexpr int MAX_SLICE = THREADS; // Dv columns a CTA owns at most
constexpr int MAX_D = 4096;
constexpr int MAX_DV = 2048;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PRE = 4;             // enc_proj loads a lane issues up front
constexpr int ACC = 4;             // independent context sums a thread keeps

struct Args {
    const float* u;       // [B, D]
    const float* v;       // [D]
    const void* proj;     // [B, T, D]
    const void* seq;      // [B, T, Dv]
    const int* lens;      // [B]
    void* out;            // [B, Dv]
    int T, D, Dv;
    int ctas;             // C
    int dc;               // D slice of a CTA (a multiple of 4)
    int dvc;              // Dv slice of a CTA (a multiple of 8, <= 256)
    int vec_proj;         // D % 4 == 0: 4-element loads of enc_proj
    int vec_seq;          // 16-byte rows of enc_seq: cp.async
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// four consecutive elements (aligned to 4 elements): loaded as stored
// (Raw4), then as float
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 load_raw4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load_raw4(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float4 to_f4(float4 x) { return x; }
// a bfloat16 is the high half of its float32
__device__ __forceinline__ float4 to_f4(uint2 raw) {
    return make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
}

// tanh(x) = sign(x) (1 - 2 / (exp(2 |x|) + 1)): within ~1e-7 of tanh
// absolutely, and without the branches of the library's tanhf
__device__ __forceinline__ float tanh_f(float x) {
    const float e = __expf(2.f * fabsf(x));
    return copysignf(1.f - __fdividef(2.f, e + 1.f), x);
}

// The cluster barrier in two halves: arrive (release: this CTA's shared
// memory reads of its peers are done) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait() {
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
additive_attention_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char seq_raw[];
    T* seq_s = reinterpret_cast<T*>(seq_raw);        // [TK][dvc]
    __shared__ float red[WARPS][TK];                  // a warp's partials
    __shared__ float part[2][TK];                     // the exchanged scores
    __shared__ float p_s[TK];
    __shared__ float kacc[THREADS];
    __shared__ float corr_s, l_s;

    cg::cluster_group cluster = cg::this_cluster();
    const int C = a.ctas;
    const int rank = blockIdx.x % C;
    const int b = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int len = max(0, min(a.lens[b], a.T));
    const int dlo = rank * a.dc, dhi = min(a.D, dlo + a.dc);
    const int clo = rank * a.dvc, cn = max(0, min(a.Dv, clo + a.dvc) - clo);
    // a warp's eighth of the D slice, in whole 4-element groups
    const int dcw = ((max(0, dhi - dlo) + WARPS - 1) / WARPS + 3) & ~3;
    const int wlo = dlo + warp * dcw, whi = min(dhi, wlo + dcw);
    // threads per column (a power of two >= the slice, 32..256) and the
    // key groups that split a tile's keys between them
    int ct = 32;
    while (ct < cn) ct <<= 1;
    const int kg_n = THREADS / ct, col = tid % ct, kg = tid / ct;

    const T* proj = static_cast<const T*>(a.proj);
    const T* seq = static_cast<const T*>(a.seq);
    const float* ub = a.u + (size_t)b * a.D;
    float acc[ACC] = {};
    float m = -INFINITY, l = 0.f;
    const int ntiles = (len + TK - 1) / TK;

    for (int k = 0; k < ntiles; ++k) {
        const int t0 = k * TK, n = min(TK, len - t0);
        // the first of this warp's enc_proj loads, then the tile's enc_seq
        // columns of this CTA's slice (landing while the scores are
        // computed and exchanged)
        const T* row = proj + ((size_t)b * a.T + t0 + lane) * a.D;
        const int nvec = a.vec_proj ? (whi - wlo) / 4 : 0;
        typename Raw4<T>::type xr[PRE];
#pragma unroll
        for (int q = 0; q < PRE; ++q)
            if (lane < n && q < nvec) xr[q] = load_raw4(row + wlo + 4 * q);
        const T* sq = seq + ((size_t)b * a.T + t0) * a.Dv + clo;
        if (a.vec_seq) {
            const int ch = cn * (int)sizeof(T) / 16, epc = 16 / (int)sizeof(T);
            for (int e = tid; e < n * ch; e += THREADS) {
                const int j = e / ch, c = e - (e / ch) * ch;
                cp_async16(seq_s + j * a.dvc + c * epc,
                           sq + (size_t)j * a.Dv + c * epc);
            }
        } else {
            for (int e = tid; e < n * cn; e += THREADS) {
                const int j = e / cn, c = e - (e / cn) * cn;
                seq_s[j * a.dvc + c] = sq[(size_t)j * a.Dv + c];
            }
        }

        // this warp's share of the scores: lane = key
        float s = 0.f;
        if (lane < n) {
            if (a.vec_proj) {
#pragma unroll
                for (int q = 0; q < PRE; ++q) {
                    if (q < nvec) {
                        const int d = wlo + 4 * q;
                        const float4 x = to_f4(xr[q]);
                        const float4 uu = *reinterpret_cast<const float4*>(ub + d);
                        const float4 vv = *reinterpret_cast<const float4*>(a.v + d);
                        s = fmaf(vv.x, tanh_f(x.x + uu.x), s);
                        s = fmaf(vv.y, tanh_f(x.y + uu.y), s);
                        s = fmaf(vv.z, tanh_f(x.z + uu.z), s);
                        s = fmaf(vv.w, tanh_f(x.w + uu.w), s);
                    }
                }
#pragma unroll 1
                for (int d = wlo + 4 * PRE; d < whi; d += 4) {
                    const float4 x = to_f4(load_raw4(row + d));
                    const float4 uu = *reinterpret_cast<const float4*>(ub + d);
                    const float4 vv = *reinterpret_cast<const float4*>(a.v + d);
                    s = fmaf(vv.x, tanh_f(x.x + uu.x), s);
                    s = fmaf(vv.y, tanh_f(x.y + uu.y), s);
                    s = fmaf(vv.z, tanh_f(x.z + uu.z), s);
                    s = fmaf(vv.w, tanh_f(x.w + uu.w), s);
                }
            } else {
#pragma unroll 4
                for (int d = wlo; d < whi; ++d)
                    s = fmaf(a.v[d], tanh_f(to_f(row[d]) + ub[d]), s);
            }
        }
        red[warp][lane] = s;
        __syncthreads();
        if (tid < TK) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) sum += red[w][tid];
            part[k & 1][tid] = sum;
        }
        // the cluster's partial scores, summed in rank order by every CTA
        cluster.sync();
        if (warp == 0) {
            float pv[MAX_CTAS];
#pragma unroll
            for (int r = 0; r < MAX_CTAS; ++r)
                pv[r] = r < C ? *cluster.map_shared_rank(&part[k & 1][lane], r)
                              : 0.f;
            float sc = 0.f;
#pragma unroll
            for (int r = 0; r < MAX_CTAS; ++r)
                if (r < C) sc += pv[r];
            const bool valid = lane < n;
            const float m_new = fmaxf(m, warp_max(valid ? sc : -INFINITY));
            const float corr = expf(m - m_new);      // 0 at the first tile
            const float p = valid ? expf(sc - m_new) : 0.f;
            l = l * corr + warp_sum(p);
            m = m_new;
            p_s[lane] = p;
            if (lane == 0) corr_s = corr;
        }
        // after the last exchange a CTA only has to stay until its peers
        // have read its partial scores: arrive now, wait before leaving
        if (k == ntiles - 1) cluster_arrive();
        cp_async_commit_wait();
        __syncthreads();
        if (col < cn) {
            const float c = corr_s;
#pragma unroll
            for (int q = 0; q < ACC; ++q) acc[q] *= c;
            int j = kg;
#pragma unroll 1
            for (; j + (ACC - 1) * kg_n < n; j += ACC * kg_n) {
#pragma unroll
                for (int q = 0; q < ACC; ++q)
                    acc[q] = fmaf(p_s[j + q * kg_n],
                                  to_f(seq_s[(j + q * kg_n) * a.dvc + col]),
                                  acc[q]);
            }
#pragma unroll
            for (int q = 0; q < ACC - 1; ++q) {
                const int jj = j + q * kg_n;
                if (jj < n)
                    acc[q] = fmaf(p_s[jj], to_f(seq_s[jj * a.dvc + col]),
                                  acc[q]);
            }
        }
        __syncthreads();
    }

    float o = 0.f;
#pragma unroll
    for (int q = 0; q < ACC; ++q) o += acc[q];
    kacc[tid] = o;
    if (tid == 0) l_s = l;
    __syncthreads();
    if (kg == 0 && col < cn) {
        float sum = 0.f;
        for (int g = 0; g < kg_n; ++g) sum += kacc[g * ct + col];
        store(static_cast<T*>(a.out) + (size_t)b * a.Dv + clo + col,
              sum / fmaxf(l_s, 1e-30f));
    }
    if (ntiles > 0) cluster_wait();
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * a.ctas);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = (size_t)TK * a.dvc * sizeof(T);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, additive_attention_kernel<T>, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace

extern "C" {

// out [B, Dv] <- the attention context of u [B, D] (float32), v [D]
// (float32) over enc_proj [B, T, D] and enc_seq [B, T, Dv] with lens [B]
// int32 valid keys; dtype 0 = float32, 1 = bfloat16 (enc_proj, enc_seq and
// out); ctas = C, the CTAs of a row's cluster (1, 2, 4 or 8, with a Dv
// slice of at most 256 columns).
int additive_attention_launch(const void* u, const void* v, const void* proj,
                              const void* seq, const void* lens, void* out,
                              int B, int T, int D, int Dv, int dtype,
                              int ctas, void* stream) {
    if (B < 1 || T < 1 || D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_DV
            || (dtype != 0 && dtype != 1) || ctas < 1 || ctas > MAX_CTAS
            || (ctas & (ctas - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.u = (const float*)u;
    a.v = (const float*)v;
    a.proj = proj;
    a.seq = seq;
    a.lens = (const int*)lens;
    a.out = out;
    a.T = T;
    a.D = D;
    a.Dv = Dv;
    a.ctas = ctas;
    a.dc = round_up((D + ctas - 1) / ctas, 4);
    a.dvc = round_up((Dv + ctas - 1) / ctas, 8);
    if (a.dvc > MAX_SLICE) return (int)cudaErrorInvalidValue;
    const int elem = dtype == 1 ? 2 : 4;
    a.vec_proj = D % 4 == 0 && (uintptr_t)proj % 16 == 0
                 && (uintptr_t)u % 16 == 0 && (uintptr_t)v % 16 == 0;
    a.vec_seq = (Dv * elem) % 16 == 0 && (uintptr_t)seq % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B, st);
    return (int)launch<float>(a, B, st);
}

// The runtime's account of the kernel for dtype 0 (float32) or 1
// (bfloat16): out = {registers, local memory bytes per thread, static
// shared memory bytes, the most dynamic shared memory a launch asks}.
int additive_attention_attributes(int dtype, int* out) {
    void (*f32)(const Args) = additive_attention_kernel<float>;
    void (*bf16)(const Args) = additive_attention_kernel<__nv_bfloat16>;
    const void* fn = reinterpret_cast<const void*>(dtype == 1 ? bf16 : f32);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = TK * MAX_SLICE * (dtype == 1 ? 2 : 4);
    return 0;
}

const char* additive_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
