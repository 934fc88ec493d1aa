// Alg. 5 subset enumeration per host, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sched_weigh.py::_kernel
// (called through _sched_weigh_padded by sched_weigh / sched_weigh_gathered).
//
// What it computes, per host: over all 2^K termination subsets of the host's
// K preemptible slots, whether the subset frees enough on every resource dim
// (free_f + sum(res) >= req - 1e-6), the subset's cost (sum of slot costs,
// invalid slots at 1e30), the cheapest cost, the best mask (among masks with
// cost <= best + TIE_EPS: fewest instances, then lowest mask) and whether
// any subset is feasible.
//
// What bounds it on this card: operations.  A host reads K*D + 2K + D floats
// (about 130 bytes at K=8, D=3) and does about 2^K * K * (D + 1) adds and
// compares (8 K at K=8, 200 K at K=12), so the work per byte is in the
// hundreds: FP32 throughput, not HBM, is the limit.  On the main path the
// kernel runs on the M=64 shortlisted hosts, where the launch itself (a few
// microseconds) is the real cost.
//
// What the design does about it: one block per host, the threads striding
// over the 2^K masks, the host's slots in shared memory so every thread reads
// them at shared-memory speed; two block reductions (min cost, then min
// (popcount, mask) key among the ties).  Sums run in ascending slot order so
// the result equals the plain PyTorch version bit for bit (compiled with
// --fmad=false; there is no multiply-add here to contract).  The TPU kernel
// did the enumeration as a matmul on the MXU; a wgmma formulation is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

#define WEIGH_MAX_K 12
#define WEIGH_MAX_D 8
#define WEIGH_THREADS 256

static __device__ __forceinline__ float warp_min_f(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

static __device__ __forceinline__ unsigned warp_min_u(unsigned v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

static __device__ __forceinline__ int warp_or(int v) {
    for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(WEIGH_THREADS)
sched_weigh_kernel(const float* __restrict__ free_f,      // (N, D)
                   const float* __restrict__ inst_res,    // (N, K, D)
                   const float* __restrict__ inst_cost,   // (N, K)
                   const uint8_t* __restrict__ inst_valid,  // (N, K) 0/1
                   const float* __restrict__ req,         // (D,)
                   int k, int d, float tie_eps,
                   float* __restrict__ best_cost,         // (N,)
                   int32_t* __restrict__ best_mask,       // (N,)
                   uint8_t* __restrict__ feasible) {      // (N,) 0/1
    const int host = blockIdx.x;
    const int tid = threadIdx.x;
    __shared__ float s_res[WEIGH_MAX_K * WEIGH_MAX_D];
    __shared__ float s_cost[WEIGH_MAX_K];
    __shared__ float s_free[WEIGH_MAX_D];
    __shared__ float s_need[WEIGH_MAX_D];
    __shared__ float s_red_f[WEIGH_THREADS / 32];
    __shared__ unsigned s_red_u[WEIGH_THREADS / 32];
    __shared__ int s_red_i[WEIGH_THREADS / 32];
    __shared__ float s_best;

    // Invalid slots free nothing and poison any subset they join.
    for (int i = tid; i < k * d; i += blockDim.x) {
        const int s = i / d;
        const bool v = inst_valid[(size_t)host * k + s] != 0;
        s_res[i] = v ? inst_res[(size_t)host * k * d + i] : 0.0f;
    }
    for (int s = tid; s < k; s += blockDim.x) {
        const bool v = inst_valid[(size_t)host * k + s] != 0;
        s_cost[s] = v ? inst_cost[(size_t)host * k + s] : 1e30f;
    }
    for (int j = tid; j < d; j += blockDim.x) {
        s_free[j] = free_f[(size_t)host * d + j];
        s_need[j] = req[j] - 1e-6f;
    }
    __syncthreads();

    const int n_masks = 1 << k;
    float t_best = 1e30f;
    int t_feas = 0;
    for (int m = tid; m < n_masks; m += blockDim.x) {
        bool ok = true;
        for (int j = 0; j < d; ++j) {
            float freed = 0.0f;
            for (int s = 0; s < k; ++s)
                if ((m >> s) & 1) freed = freed + s_res[s * d + j];
            ok = ok && (s_free[j] + freed >= s_need[j]);
        }
        float sub = 0.0f;
        for (int s = 0; s < k; ++s)
            if ((m >> s) & 1) sub = sub + s_cost[s];
        sub = ok ? sub : 1e30f;
        t_best = fminf(t_best, sub);
        t_feas |= ok ? 1 : 0;
    }

    const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    float wb = warp_min_f(t_best);
    int wf = warp_or(t_feas);
    if (lane == 0) { s_red_f[warp] = wb; s_red_i[warp] = wf; }
    __syncthreads();
    if (tid == 0) {
        float b = s_red_f[0];
        int f = s_red_i[0];
        for (int w = 1; w < n_warps; ++w) { b = fminf(b, s_red_f[w]); f |= s_red_i[w]; }
        s_best = b;
        best_cost[host] = b;
        feasible[host] = f ? 1 : 0;
    }
    __syncthreads();

    // Tie-break among masks within tie_eps of the best: fewest instances,
    // then lowest mask index (the plain version's argmin first hit).
    const float bound = s_best + tie_eps;
    unsigned t_key = 0xffffffffu;
    for (int m = tid; m < n_masks; m += blockDim.x) {
        bool ok = true;
        for (int j = 0; j < d; ++j) {
            float freed = 0.0f;
            for (int s = 0; s < k; ++s)
                if ((m >> s) & 1) freed = freed + s_res[s * d + j];
            ok = ok && (s_free[j] + freed >= s_need[j]);
        }
        float sub = 0.0f;
        for (int s = 0; s < k; ++s)
            if ((m >> s) & 1) sub = sub + s_cost[s];
        sub = ok ? sub : 1e30f;
        if (sub <= bound) {
            const unsigned key = ((unsigned)__popc(m) << 16) | (unsigned)m;
            t_key = min(t_key, key);
        }
    }
    unsigned wk = warp_min_u(t_key);
    if (lane == 0) s_red_u[warp] = wk;
    __syncthreads();
    if (tid == 0) {
        unsigned key = s_red_u[0];
        for (int w = 1; w < n_warps; ++w) key = min(key, s_red_u[w]);
        best_mask[host] = (int32_t)(key & 0xffffu);
    }
}

extern "C" int sched_weigh_launch(const void* free_f, const void* inst_res,
                                  const void* inst_cost, const void* inst_valid,
                                  const void* req, int n, int k, int d,
                                  float tie_eps, void* best_cost, void* best_mask,
                                  void* feasible, void* stream) {
    if (n <= 0) return 0;
    int threads = 1 << k;
    if (threads < 32) threads = 32;
    if (threads > WEIGH_THREADS) threads = WEIGH_THREADS;
    sched_weigh_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
        (const float*)free_f, (const float*)inst_res, (const float*)inst_cost,
        (const uint8_t*)inst_valid, (const float*)req, k, d, tie_eps,
        (float*)best_cost, (int32_t*)best_mask, (uint8_t*)feasible);
    return (int)cudaGetLastError();
}
