// Flash-attention forward (causal or full, grouped-query) for NVIDIA Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fwd_kernel (via _flash_fwd).
//
//   q (B*H, Sq, hd), k/v (B*G, Skv, hd), bf16 or f32 in, f32 math;
//   o (B*H, Sq, hd) in q's type, lse (B*H, Sq) f32.
//   Row b*H + h of q reads KV row (b*H + h) / (H/G) = b*G + h/(H/G).
//
// The TPU kernel walks a sequential grid (B*H, nQ, nK) and carries the
// online-softmax state (m, l, acc) in VMEM scratch across the nK axis.
// Hopper blocks run in any order, so here one block owns one tile of
// kBQ query rows of one head and loops over the KV tiles itself:
//   * the block stages the tile's K and V (kBK rows) in shared memory as
//     f32, K with a row stride of hd+1 so that 32 lanes reading 32 keys hit
//     32 banks;
//   * each warp owns kBQ/4 query rows and keeps their m, l and acc in f32
//     registers (acc: hd/32 values a lane);
//   * a lane scores one key (a dot product over hd, q broadcast from shared
//     memory), the warp reduces the row max and sum with shuffles, and the
//     PV product broadcasts each lane's p to the warp;
//   * causal tiles that lie wholly above the block's last query row are
//     never loaded.
// Semantics kept from the TPU kernel: masked scores are -1e30 (not -inf);
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); causal masking
// compares absolute positions counted from 0 for q and k.  The TPU kernel
// halves its block sizes until they divide S; this kernel masks the ragged
// tails instead (keys past Skv weigh exactly 0), the same function.
//
// Bound on this card: operations.  4*hd flops per (query, key) pair that
// the mask keeps, against about 2*hd bytes per query row moved.  This first
// kernel runs the products on the CUDA cores in f32 (no wgmma, no TMA), so
// it stays far from the bf16 tensor-core bound; chip_smoke.py prints both.
//
// C interface (loaded with ctypes); returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 32;        // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <int HD>
constexpr size_t smem_bytes() {
    return sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int rep, int sq, int skv,
                 int causal, float scale) {
    constexpr int C = HD / 32;  // acc values per lane
    extern __shared__ float smem[];
    float* qs = smem;                         // [kBQ][HD]
    float* ks = qs + kBQ * HD;                // [kBK][HD + 1]
    float* vs = ks + kBK * (HD + 1);          // [kBK][HD]

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * kBQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* qh = q + static_cast<size_t>(bh) * sq * HD;
    const T* kh = k + static_cast<size_t>(bh / rep) * skv * HD;
    const T* vh = v + static_cast<size_t>(bh / rep) * skv * HD;

    for (int i = threadIdx.x; i < kBQ * HD; i += blockDim.x) {
        const int r = i / HD;
        qs[i] = (q0 + r < sq) ? to_f(qh[static_cast<size_t>(q0) * HD + i]) : 0.0f;
    }

    float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        m[i] = kNegInf;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
    }

    // keys a row of this block can see: all of them, or up to its last row
    const int q_last = min(q0 + kBQ, sq) - 1;
    const int kv_end = causal ? min(skv, q_last + 1) : skv;
    for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
        __syncthreads();  // the previous tile is consumed (and qs is written)
        for (int i = threadIdx.x; i < kBK * HD; i += blockDim.x) {
            const int j = i / HD, d = i - j * HD;
            const bool in = kv0 + j < skv;
            const size_t g = static_cast<size_t>(kv0) * HD + i;
            ks[j * (HD + 1) + d] = in ? to_f(kh[g]) : 0.0f;
            vs[i] = in ? to_f(vh[g]) : 0.0f;
        }
        __syncthreads();
        const int key = kv0 + lane;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int r = warp * kRows + i;
            const float* qr = qs + r * HD;
            const float* kr = ks + lane * (HD + 1);
            float s = 0.0f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
            s *= scale;
            if (key >= skv) s = -INFINITY;                 // ragged tail: weight 0
            else if (causal && key > q0 + r) s = kNegInf;  // the TPU kernel's mask
            const float m_new = fmaxf(m[i], warp_max(s));
            const float p = expf(s - m_new);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + warp_sum(p);
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll 4
            for (int j = 0; j < kBK; ++j) {
                const float pj = __shfl_sync(0xffffffffu, p, j);
                const float* vr = vs + j * HD + lane;
#pragma unroll
                for (int c = 0; c < C; ++c) acc[i][c] += pj * vr[32 * c];
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = q0 + warp * kRows + i;
        if (row >= sq) continue;
        const float lc = fmaxf(l[i], 1e-30f);
        T* orow = o + (static_cast<size_t>(bh) * sq + row) * HD;
#pragma unroll
        for (int c = 0; c < C; ++c) orow[lane + 32 * c] = from_f<T>(acc[i][c] / lc);
        if (lane == 0) lse[static_cast<size_t>(bh) * sq + row] = m[i] + logf(lc);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int rep, int sq, int skv, int causal, float scale, cudaStream_t stream) {
    constexpr size_t bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kBQ - 1) / kBQ, bh);
    flash_fwd_kernel<T, HD><<<grid, kWarps * 32, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, rep, sq, skv, causal, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
             int rep, int sq, int skv, int hd, int causal, float scale, cudaStream_t s) {
    switch (hd) {
        case 32: return launch<T, 32>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        case 64: return launch<T, 64>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        case 128: return launch<T, 128>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        case 256: return launch<T, 256>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int bh, int bg, int sq,
                                          int skv, int hd, int causal, float scale,
                                          int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rep = bh / bg;
    float* lsep = static_cast<float*>(lse);
    if (is_bf16)
        return dispatch<__nv_bfloat16>(q, k, v, o, lsep, bh, rep, sq, skv, hd, causal, scale, s);
    return dispatch<float>(q, k, v, o, lsep, bh, rep, sq, skv, hd, causal, scale, s);
}
