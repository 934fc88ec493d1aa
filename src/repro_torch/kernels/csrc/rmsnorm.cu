// RMSNorm over the last axis for NVIDIA Hopper (sm_90a):
//     out = x * rsqrt(mean(x^2) + eps) * (1 + w),  f32 math, out in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_kernel (and
// the jnp twin models/layers.py::rms_norm that the JAX model calls).  The TPU
// kernel takes tiles of 256 rows into VMEM and reads each row once.
//
// Bound on this card: bytes.  Each element is read once and written once
// and costs about four flops, far below the H100's 295 flops per byte, so
// the kernel's job is to keep enough 16-byte transactions in flight that
// HBM, not latency, sets the time.
//
// The design (rmsnorm_vec_kernel):
// - 128-bit loads and stores: 8 bf16 or 4 f32 a transaction, neighbouring
//   lanes on neighbouring 16 bytes.
// - A row is held in registers between the sum of squares and the scale,
//   so it is read from HBM once: lane l of the warps that own a row holds
//   the row's 16-byte chunks l, l + 32 W, l + 64 W, ... (N of them, a
//   template parameter, N <= 8; W warps a row, 1 up to 256 chunks a row,
//   which is d = 2,048 in bf16, and 2, 4 or 8 above; and, while the blocks
//   would not cover the SMs, doubled up to 8 or a chunk a lane, which
//   shortens the chain of a few rows).  At d = 1,536 bf16 one warp holds a
//   row in 6 chunks a lane from 1,049 rows up on 132 SMs.
// - (1 + w) is staged once per block in shared memory as f32, while the
//   first row's loads are in flight; the blocks are persistent (as many as
//   the SMs hold at once), each warp striding over rows.
// - The sum of squares: a per-lane partial over the lane's chunks in order
//   (an FMA chain), then a butterfly of warp shuffles (xor 16, 8, 4, 2, 1);
//   with W > 1 the W warp sums are added in warp order through shared
//   memory (one block barrier a row; none when a warp owns a row).
// The order of that sum differs from the plain version's; the tolerances
// stay those of the plain comparison (tests/test_torch_rmsnorm.py emulates
// this order on the CPU).
//
// Everything else (a width that is not a multiple of the 16-byte chunk, a
// pointer that is not 16-byte aligned, d above 8 warps' reach or beyond the
// 48 KB of staged weights) runs rmsnorm_edge_kernel: one block of 256
// threads a row, scalar loads, the row read twice.  No model width of the
// registry takes it.
//
// C interface (loaded with ctypes): device pointers, sizes, dtype flags and
// the stream; returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;               // N: 16-byte chunks a lane holds
constexpr int kMaxStagedWeights = 12288;    // 48 KB of f32 (1 + w)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// the elements of one 16-byte chunk as f32, and back
template <typename T> struct Chunk;
template <> struct Chunk<float> {
    static constexpr int kElems = 4;
    static __device__ __forceinline__ void unpack(const uint4& c, float (&v)[4]) {
        v[0] = __uint_as_float(c.x); v[1] = __uint_as_float(c.y);
        v[2] = __uint_as_float(c.z); v[3] = __uint_as_float(c.w);
    }
    static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
        return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
};
template <> struct Chunk<__nv_bfloat16> {
    static constexpr int kElems = 8;
    // element 2i is the low half of word i
    static __device__ __forceinline__ void unpack(const uint4& c, float (&v)[8]) {
        const unsigned u[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[2 * i] = __uint_as_float(u[i] << 16);
            v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ unsigned pack2(float a, float b) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);   // .x = a, the low half
        return *reinterpret_cast<const unsigned*>(&p);
    }
    static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
        return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                          pack2(v[6], v[7]));
    }
};

template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                   int rows, int d, int wpr, float eps) {
    using C = Chunk<TX>;
    constexpr int E = C::kElems;
    extern __shared__ float s_w1[];               // d floats: 1 + w
    __shared__ float s_part[2][kWarps];           // warp sums, W > 1
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int group = warp / wpr;                 // the row this warp works on
    const int rows_per_iter = kWarps / wpr;
    const int chunks = d / E;                     // 16-byte chunks a row
    const int first = (warp % wpr) * 32 + lane;   // this lane's first chunk
    const int step = wpr * 32;
    const int row_step = gridDim.x * rows_per_iter;

    uint4 buf[N];
    auto load = [&](int row) {
        const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);
#pragma unroll
        for (int n = 0; n < N; ++n)
            if (first + n * step < chunks) buf[n] = src[first + n * step];
    };
    int base = blockIdx.x * rows_per_iter;
    if (base + group < rows) load(base + group);   // in flight while w is staged
    for (int i = threadIdx.x; i < d; i += kThreads) s_w1[i] = 1.0f + to_f(w[i]);
    __syncthreads();

    for (int it = 0; base < rows; base += row_step, ++it) {   // uniform over the block
        const int row = base + group;
        const bool active = row < rows;
        float ss = 0.0f;
        if (active) {
#pragma unroll
            for (int n = 0; n < N; ++n) {
                if (first + n * step < chunks) {
                    float v[E];
                    C::unpack(buf[n], v);
#pragma unroll
                    for (int e = 0; e < E; ++e) ss = fmaf(v[e], v[e], ss);
                }
            }
        }
        ss = warp_sum(ss);
        if (wpr > 1) {
            if (lane == 0) s_part[it & 1][warp] = ss;
            __syncthreads();
            ss = 0.0f;
            for (int k = 0; k < wpr; ++k) ss += s_part[it & 1][group * wpr + k];
        }
        if (active) {
            const float r = rsqrtf(ss / static_cast<float>(d) + eps);
            uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * d);
#pragma unroll
            for (int n = 0; n < N; ++n) {
                const int c = first + n * step;
                if (c < chunks) {
                    float v[E];
                    C::unpack(buf[n], v);
#pragma unroll
                    for (int e = 0; e < E; ++e) v[e] = v[e] * r * s_w1[c * E + e];
                    dst[c] = C::pack(v);
                }
            }
        }
        if (base + row_step + group < rows) load(base + row_step + group);
    }
}

// Any shape: one block a row, scalar loads, the row read twice.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_edge_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                    int d, float eps) {
    __shared__ float partial[kWarps];
    const TX* xr = x + static_cast<size_t>(blockIdx.x) * d;
    TX* orow = out + static_cast<size_t>(blockIdx.x) * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
        const float v = to_f(xr[i]);
        ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
        float v = lane < kWarps ? partial[lane] : 0.0f;
        v = warp_sum(v);
        if (lane == 0) partial[0] = v;
    }
    __syncthreads();
    const float r = rsqrtf(partial[0] / static_cast<float>(d) + eps);
    for (int i = threadIdx.x; i < d; i += kThreads) {
        orow[i] = from_f<TX>(to_f(xr[i]) * r * (1.0f + to_f(w[i])));
    }
}

int sm_count() {
    static std::atomic<int> cached{0};
    int n = cached.load(std::memory_order_relaxed);
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (n <= 0) n = 1;
        cached.store(n, std::memory_order_relaxed);
    }
    return n;
}

template <typename TX, typename TW, int N>
void launch_vec(const void* x, const void* w, void* out, int rows, int d, int wpr, float eps,
                cudaStream_t stream) {
    auto kernel = rmsnorm_vec_kernel<TX, TW, N>;
    const int smem = d * static_cast<int>(sizeof(float));
    // persistent blocks: as many as the SMs hold at once, cached per
    // instantiation for the last width (staged bytes << 32 | blocks an SM)
    static std::atomic<long long> cached{0};
    long long c = cached.load(std::memory_order_relaxed);
    int resident = static_cast<int>(c & 0xffffffff);
    if ((c >> 32) != smem || resident == 0) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
        if (resident <= 0) resident = 1;
        cached.store((static_cast<long long>(smem) << 32) | resident, std::memory_order_relaxed);
    }
    const int rows_per_iter = kWarps / wpr;
    const int needed = (rows + rows_per_iter - 1) / rows_per_iter;
    const int blocks = needed < resident * sm_count() ? needed : resident * sm_count();
    kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const TX*>(x),
                                               static_cast<const TW*>(w),
                                               static_cast<TX*>(out), rows, d, wpr, eps);
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int rows, int d, float eps,
            cudaStream_t stream) {
    constexpr int E = Chunk<TX>::kElems;
    const bool aligned = d % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                         && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int chunks = d / E;
    // the fewest warps a row (1, 2, 4, 8) whose lanes hold the row in
    // kMaxChunks chunks or fewer; more while the blocks would not cover the
    // SMs and a lane holds more than one chunk (the decode shape: 8 rows of
    // 1,536 bf16 take 8 blocks of 8 warps a row, a chunk a lane)
    int wpr = 1;
    while (wpr < kWarps && chunks > 32 * wpr * kMaxChunks) wpr *= 2;
    while (wpr < kWarps && chunks > 32 * wpr
           && (static_cast<long long>(rows) * wpr + kWarps - 1) / kWarps < sm_count())
        wpr *= 2;
    const int n = (chunks + 32 * wpr - 1) / (32 * wpr);
    if (!aligned || d > kMaxStagedWeights || n > kMaxChunks) {
        rmsnorm_edge_kernel<TX, TW><<<rows, kThreads, 0, stream>>>(
            static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
        return;
    }
    switch (n) {
    case 1: launch_vec<TX, TW, 1>(x, w, out, rows, d, wpr, eps, stream); break;
    case 2: launch_vec<TX, TW, 2>(x, w, out, rows, d, wpr, eps, stream); break;
    case 3: launch_vec<TX, TW, 3>(x, w, out, rows, d, wpr, eps, stream); break;
    case 4: launch_vec<TX, TW, 4>(x, w, out, rows, d, wpr, eps, stream); break;
    case 5: launch_vec<TX, TW, 5>(x, w, out, rows, d, wpr, eps, stream); break;
    case 6: launch_vec<TX, TW, 6>(x, w, out, rows, d, wpr, eps, stream); break;
    case 7: launch_vec<TX, TW, 7>(x, w, out, rows, d, wpr, eps, stream); break;
    default: launch_vec<TX, TW, 8>(x, w, out, rows, d, wpr, eps, stream); break;
    }
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
