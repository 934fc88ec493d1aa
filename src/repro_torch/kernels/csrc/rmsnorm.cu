// RMSNorm over the last axis for NVIDIA Hopper (sm_90a):
//     out = x * rsqrt(mean(x^2) + eps) * (1 + w),  f32 math, out in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_kernel (and
// the jnp twin models/layers.py::rms_norm that the JAX model calls).  The TPU
// kernel takes tiles of 256 rows into VMEM; here one block of 256 threads
// owns one row: a strided pass sums the squares (warp shuffles, then one
// warp over the per-warp sums), and a second pass scales and writes.  The
// second pass reads the row again, from L1/L2 for every model width (a row
// is at most a few KB).
//
// Bound on this card: bytes.  Each element is read once and written once
// and costs about four flops, far below the H100's 295 flops per byte; the
// kernel moves the bytes in coalesced 2- or 4-byte loads per thread.  The
// decode shape (8 rows) fills 8 of the 132 SMs and is launch-bound.
//
// C interface (loaded with ctypes): device pointers, sizes, dtype flags and
// the stream; returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
               int d, float eps) {
    __shared__ float partial[kThreads / 32];
    const TX* xr = x + static_cast<size_t>(blockIdx.x) * d;
    TX* orow = out + static_cast<size_t>(blockIdx.x) * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
        const float v = to_f(xr[i]);
        ss += v * v;
    }
    ss = warp_sum(ss);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
        float v = lane < kThreads / 32 ? partial[lane] : 0.0f;
        v = warp_sum(v);
        if (lane == 0) partial[0] = v;
    }
    __syncthreads();
    const float r = rsqrtf(partial[0] / static_cast<float>(d) + eps);
    for (int i = threadIdx.x; i < d; i += kThreads) {
        orow[i] = from_f<TX>(to_f(xr[i]) * r * (1.0f + to_f(w[i])));
    }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int rows, int d, float eps,
            cudaStream_t stream) {
    rmsnorm_kernel<TX, TW><<<rows, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                              float eps, int x_bf16, int w_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16 && w_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
    else if (x_bf16) launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
    else if (w_bf16) launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
    else launch<float, float>(x, w, out, rows, d, eps, s);
    return static_cast<int>(cudaGetLastError());
}
