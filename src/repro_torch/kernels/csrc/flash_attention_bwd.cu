// Flash-attention backward (causal or full, grouped-query) for NVIDIA Hopper
// (sm_90a).  Replaces the two Pallas TPU kernels of
// src/repro/kernels/flash_attention.py::_flash_bwd:
//   * _dq_kernel  -> flash_bwd_dq_kernel  (dq = sum over KV tiles of ds.k)
//   * _dkv_kernel -> flash_bwd_dkv_kernel (dv = sum p^T.do, dk = sum ds^T.q
//                    over the rep grouped heads and every q tile)
//
//   q, do (B*H, Sq, hd), k/v (B*G, Skv, hd), bf16 or f32 in, f32 math;
//   lse, delta (B*H, Sq) f32 (delta = rowsum(do*o), formed by the caller);
//   dq in q's type, dk/dv (B*G, Skv, hd) in k's type.
//   Row b*H + h of q reads KV row (b*H + h) / rep, rep = H/G.
//
// Both kernels recompute p = exp(s*scale - lse) from the saved lse, as the
// TPU kernels do, and form ds = p * (do.v^T - delta) * scale.
//
// The TPU grid runs in order and carries dq (or dk, dv) in VMEM scratch
// along its innermost axis.  Hopper blocks run in any order, so each block
// owns its output tile and loops over the other axis itself, and no block
// writes another's rows: no atomics, so the gradients are the same bits on
// every run (a preempted training run resumes bit-exactly).
//   * dq:  one block per (32-query tile, head).  Four warps own 8 query rows
//     each, with the rows' dq in f32 registers (hd/32 values a lane).  The
//     block stages each tile of 32 keys and values in shared memory (row
//     stride hd+1: 32 lanes reading 32 keys hit 32 banks); a lane scores
//     one key, and ds.k broadcasts each lane's ds over the warp.  Causal
//     tiles wholly above the block's last row are never loaded.
//   * dk/dv: one block per (32-key tile, KV head).  Eight warps own 4 keys
//     each, with their dk and dv in f32 registers.  The block walks the rep
//     grouped heads and, for each, the q tiles that can see its keys (all of
//     them, or from the diagonal on when causal), staging q, do, lse and
//     delta; a lane scores one query row against the warp's key.
// Masked pairs (causal, or past a ragged Skv / Sq tail) get p = 0 exactly,
// as the TPU kernel's -1e30 scores do after exp.
//
// Bound on this card: operations.  dq does 3 products of 2*hd flops per
// kept (query, key) pair (s, dp, ds.k), dk/dv 4 (s, dp, p^T.do, ds^T.q).
// These first kernels run them on the CUDA cores in f32 (no wgmma, no TMA),
// far from the bf16 tensor-core bound; chip_smoke.py prints both.
//
// C interface (loaded with ctypes); each entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // queries per dq tile, keys per dk/dv tile
constexpr int kDqWarps = 4;
constexpr int kDqRows = kTile / kDqWarps;
constexpr int kDkvWarps = 8;
constexpr int kDkvKeys = kTile / kDkvWarps;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// dq: q, do [kTile][HD] (broadcast reads); k, v [kTile][HD + 1]
template <int HD>
constexpr size_t dq_smem_bytes() {
    return sizeof(float) * (2 * kTile * HD + 2 * kTile * (HD + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDqWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int rep, int sq, int skv, int causal, float scale) {
    constexpr int C = HD / 32;
    extern __shared__ float smem[];
    float* qs = smem;                          // [kTile][HD]
    float* dos = qs + kTile * HD;              // [kTile][HD]
    float* ks = dos + kTile * HD;              // [kTile][HD + 1]
    float* vs = ks + kTile * (HD + 1);         // [kTile][HD + 1]

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t qoff = static_cast<size_t>(bh) * sq * HD;
    const size_t kvoff = static_cast<size_t>(bh / rep) * skv * HD;

    for (int i = threadIdx.x; i < kTile * HD; i += blockDim.x) {
        const bool in = q0 + i / HD < sq;
        const size_t g = qoff + static_cast<size_t>(q0) * HD + i;
        qs[i] = in ? to_f(q[g]) : 0.0f;
        dos[i] = in ? to_f(dout[g]) : 0.0f;
    }
    float row_lse[kDqRows], row_delta[kDqRows], acc[kDqRows][C];
#pragma unroll
    for (int i = 0; i < kDqRows; ++i) {
        const int row = q0 + warp * kDqRows + i;
        const size_t at = static_cast<size_t>(bh) * sq + row;
        row_lse[i] = row < sq ? lse[at] : 0.0f;
        row_delta[i] = row < sq ? delta[at] : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
    }

    const int q_last = min(q0 + kTile, sq) - 1;
    const int kv_end = causal ? min(skv, q_last + 1) : skv;
    for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
        __syncthreads();  // the previous tile is consumed (and qs, dos written)
        for (int i = threadIdx.x; i < kTile * HD; i += blockDim.x) {
            const int j = i / HD, d = i - j * HD;
            const bool in = kv0 + j < skv;
            const size_t g = kvoff + static_cast<size_t>(kv0) * HD + i;
            ks[j * (HD + 1) + d] = in ? to_f(k[g]) : 0.0f;
            vs[j * (HD + 1) + d] = in ? to_f(v[g]) : 0.0f;
        }
        __syncthreads();
        const int key = kv0 + lane;
        const float* kr = ks + lane * (HD + 1);
        const float* vr = vs + lane * (HD + 1);
#pragma unroll
        for (int i = 0; i < kDqRows; ++i) {
            const int r = warp * kDqRows + i;
            const float* qr = qs + r * HD;
            const float* dr = dos + r * HD;
            float s = 0.0f, dp = 0.0f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) {
                s += qr[d] * kr[d];
                dp += dr[d] * vr[d];
            }
            const bool kept = key < skv && !(causal && key > q0 + r);
            const float p = kept ? expf(s * scale - row_lse[i]) : 0.0f;
            const float ds = p * (dp - row_delta[i]) * scale;
#pragma unroll 4
            for (int j = 0; j < kTile; ++j) {
                const float dsj = __shfl_sync(0xffffffffu, ds, j);
                const float* kj = ks + j * (HD + 1) + lane;
#pragma unroll
                for (int c = 0; c < C; ++c) acc[i][c] += dsj * kj[32 * c];
            }
        }
    }

#pragma unroll
    for (int i = 0; i < kDqRows; ++i) {
        const int row = q0 + warp * kDqRows + i;
        if (row >= sq) continue;
        T* out = dq + qoff + static_cast<size_t>(row) * HD;
#pragma unroll
        for (int c = 0; c < C; ++c) out[lane + 32 * c] = from_f<T>(acc[i][c]);
    }
}

// dk/dv: k, v [kTile][HD] (broadcast reads); q, do [kTile][HD + 1]; lse, delta [kTile]
template <int HD>
constexpr size_t dkv_smem_bytes() {
    return sizeof(float) * (2 * kTile * HD + 2 * kTile * (HD + 1) + 2 * kTile);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDkvWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int rep, int sq, int skv,
                     int causal, float scale) {
    constexpr int C = HD / 32;
    extern __shared__ float smem[];
    float* ks = smem;                          // [kTile][HD]
    float* vs = ks + kTile * HD;               // [kTile][HD]
    float* qs = vs + kTile * HD;               // [kTile][HD + 1]
    float* dos = qs + kTile * (HD + 1);        // [kTile][HD + 1]
    float* lses = dos + kTile * (HD + 1);      // [kTile]
    float* deltas = lses + kTile;              // [kTile]

    const int bg = blockIdx.y;
    const int kv0 = blockIdx.x * kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t kvoff = static_cast<size_t>(bg) * skv * HD;

    for (int i = threadIdx.x; i < kTile * HD; i += blockDim.x) {
        const bool in = kv0 + i / HD < skv;
        const size_t g = kvoff + static_cast<size_t>(kv0) * HD + i;
        ks[i] = in ? to_f(k[g]) : 0.0f;
        vs[i] = in ? to_f(v[g]) : 0.0f;
    }
    float dk_acc[kDkvKeys][C], dv_acc[kDkvKeys][C];
#pragma unroll
    for (int jj = 0; jj < kDkvKeys; ++jj) {
#pragma unroll
        for (int c = 0; c < C; ++c) dk_acc[jj][c] = dv_acc[jj][c] = 0.0f;
    }

    // with the causal mask, query rows before kv0 see none of these keys
    // (kv0 is a multiple of kTile, the q tile's height)
    const int q_start = causal ? kv0 : 0;
    for (int r = 0; r < rep; ++r) {
        const int bh = bg * rep + r;
        const size_t qoff = static_cast<size_t>(bh) * sq * HD;
        for (int q0 = q_start; q0 < sq; q0 += kTile) {
            __syncthreads();  // the previous tile is consumed (and ks, vs written)
            for (int i = threadIdx.x; i < kTile * HD; i += blockDim.x) {
                const int rr = i / HD, d = i - rr * HD;
                const bool in = q0 + rr < sq;
                const size_t g = qoff + static_cast<size_t>(q0) * HD + i;
                qs[rr * (HD + 1) + d] = in ? to_f(q[g]) : 0.0f;
                dos[rr * (HD + 1) + d] = in ? to_f(dout[g]) : 0.0f;
            }
            if (threadIdx.x < kTile) {
                const int row = q0 + threadIdx.x;
                const size_t at = static_cast<size_t>(bh) * sq + row;
                lses[threadIdx.x] = row < sq ? lse[at] : 0.0f;
                deltas[threadIdx.x] = row < sq ? delta[at] : 0.0f;
            }
            __syncthreads();
            const int row = q0 + lane;
            const float* qr = qs + lane * (HD + 1);
            const float* dr = dos + lane * (HD + 1);
#pragma unroll
            for (int jj = 0; jj < kDkvKeys; ++jj) {
                const int j = warp * kDkvKeys + jj;
                const int key = kv0 + j;
                const float* kj = ks + j * HD;
                const float* vj = vs + j * HD;
                float s = 0.0f, dp = 0.0f;
#pragma unroll 8
                for (int d = 0; d < HD; ++d) {
                    s += qr[d] * kj[d];
                    dp += dr[d] * vj[d];
                }
                const bool kept = row < sq && key < skv && !(causal && key > row);
                const float p = kept ? expf(s * scale - lses[lane]) : 0.0f;
                const float ds = p * (dp - deltas[lane]) * scale;
#pragma unroll 4
                for (int l = 0; l < kTile; ++l) {
                    const float pl = __shfl_sync(0xffffffffu, p, l);
                    const float dsl = __shfl_sync(0xffffffffu, ds, l);
                    const float* dol = dos + l * (HD + 1) + lane;
                    const float* ql = qs + l * (HD + 1) + lane;
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        dv_acc[jj][c] += pl * dol[32 * c];
                        dk_acc[jj][c] += dsl * ql[32 * c];
                    }
                }
            }
        }
    }

#pragma unroll
    for (int jj = 0; jj < kDkvKeys; ++jj) {
        const int key = kv0 + warp * kDkvKeys + jj;
        if (key >= skv) continue;
        const size_t at = kvoff + static_cast<size_t>(key) * HD;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            dk[at + lane + 32 * c] = from_f<T>(dk_acc[jj][c]);
            dv[at + lane + 32 * c] = from_f<T>(dv_acc[jj][c]);
        }
    }
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    int rep, sq, skv, causal;
    float scale;
    cudaStream_t stream;
};

template <typename T, int HD>
int launch_dq(const Args& a, void* dq, int bh) {
    constexpr size_t bytes = dq_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + kTile - 1) / kTile, bh);
    flash_bwd_dq_kernel<T, HD><<<grid, kDqWarps * 32, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.rep, a.sq,
        a.skv, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const Args& a, void* dk, void* dv, int bg) {
    constexpr size_t bytes = dkv_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.skv + kTile - 1) / kTile, bg);
    flash_bwd_dkv_kernel<T, HD><<<grid, kDkvWarps * 32, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk),
        static_cast<T*>(dv), a.rep, a.sq, a.skv, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const Args& a, void* dq, int bh, int hd) {
    switch (hd) {
        case 32: return launch_dq<T, 32>(a, dq, bh);
        case 64: return launch_dq<T, 64>(a, dq, bh);
        case 128: return launch_dq<T, 128>(a, dq, bh);
        case 256: return launch_dq<T, 256>(a, dq, bh);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
int dispatch_dkv(const Args& a, void* dk, void* dv, int bg, int hd) {
    switch (hd) {
        case 32: return launch_dkv<T, 32>(a, dk, dv, bg);
        case 64: return launch_dkv<T, 64>(a, dk, dv, bg);
        case 128: return launch_dkv<T, 128>(a, dk, dv, bg);
        case 256: return launch_dkv<T, 256>(a, dk, dv, bg);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dq, int bh, int bg,
                                         int sq, int skv, int hd, int causal, float scale,
                                         int is_bf16, void* stream) {
    const Args a{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), bh / bg, sq, skv, causal, scale,
                 static_cast<cudaStream_t>(stream)};
    return is_bf16 ? dispatch_dq<__nv_bfloat16>(a, dq, bh, hd) : dispatch_dq<float>(a, dq, bh, hd);
}

extern "C" int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int bh,
                                          int bg, int sq, int skv, int hd, int causal,
                                          float scale, int is_bf16, void* stream) {
    const Args a{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), bh / bg, sq, skv, causal, scale,
                 static_cast<cudaStream_t>(stream)};
    return is_bf16 ? dispatch_dkv<__nv_bfloat16>(a, dk, dv, bg, hd)
                   : dispatch_dkv<float>(a, dk, dv, bg, hd);
}
