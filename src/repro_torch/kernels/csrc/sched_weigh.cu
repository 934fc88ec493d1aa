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
// (about 130 bytes at K=8, D=3) and the enumeration needs about
// 2^(K-1) * K * (D + 1) adds and 2^K * (D + 3) compares and selects (5.6 K
// at K=8, D=3), far more than HBM's 295 operations a byte would allow.  On
// the main path the kernel runs on the M=64 shortlisted hosts, where that is
// a few nanoseconds of the card's FP32 rate: the launch and one chain of
// dependent loads, adds and shuffles set the time.
//
// What the design does about it:
// - One enumeration.  Every mask's cost stays in a register of the thread
//   that scored it (at most 16 a thread), so the tie-break reads them back
//   instead of enumerating again.
// - A warp per host up to K = 8 (four hosts a block), a block of 256 threads
//   per host above: lane t owns the masks whose low bits are t's low bits
//   (5 bits up to K = 8, 8 above; t mod 2^K below K = 5, where lanes repeat
//   masks, which changes no min) and whose high bits i run over the
//   2^(K - low) values unrolled at compile time.
// - Fewer adds, the same bits.  Each thread first sums its low slots once,
//   in ascending slot order (its row of the table of partial sums over the
//   low slots, kept in registers); each mask then starts from that partial
//   sum and adds the slots of its high bits in ascending order, which the
//   compiler knows per unrolled i.  That is the sequence of f32 additions of
//   sched_weigh_plain minus the slots outside the mask, whose +0.0 leaves a
//   partial sum unchanged (a sum that starts at +0.0 is never -0.0), so the
//   results equal the plain version bit for bit.  Compiled with
//   --fmad=false; there is no multiply here to contract anyway.
// - XLA's order at K = 4 and 5.  The reference sums a mask's slots with a
//   CPU dot against the 0/1 masks, which on two or more hosts adds
//   (c0 + c1) + (c2 + c3) at K = 4 and ((c0 + c2) + (c1 + c3)) + c4 at
//   K = 5 (slot order at every other K, and at one host).  There every mask
//   is one lane's low bits, so the table row is that tree over all K slots,
//   with an exact 0 for a slot outside the mask, as in sched_weigh_plain.
// - K and D are template parameters (K <= 12, D <= 8; the C entry switches
//   on them), so every loop unrolls and every array is registers.
// - Reductions: warp shuffles (min cost, the OR of feasibility by
//   __any_sync, the min (popcount, mask) key), plus one shared-memory step
//   across the 8 warps of a host above K = 8.  The host's slots are copied
//   into shared memory by its own threads (invalid slots masked there), and
//   a warp-per-host block needs no block barrier at all.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPosInf = 1e30f;

template <int K>
struct Geometry {
    //: threads scoring one host: a warp up to K = 8, 8 warps above
    static constexpr int kHostThreads = K <= 8 ? 32 : 256;
    //: mask bits taken from the thread index
    static constexpr int kLowBits = K <= 8 ? (K < 5 ? K : 5) : 8;
    static constexpr int kMasksPerThread = 1 << (K - kLowBits);
    static constexpr int kHostsPerBlock = K <= 8 ? 4 : 1;
    static constexpr int kThreads = kHostThreads * kHostsPerBlock;
};

struct Args {
    const float* free_f;      // (N, D)
    const float* inst_res;    // (N, K, D)
    const float* inst_cost;   // (N, K)
    const uint8_t* inst_valid;  // (N, K) 0/1
    const float* req;         // (D,)
    int n;
    float tie_eps;
    float* best_cost;         // (N,)
    int32_t* best_mask;       // (N,)
    uint8_t* feasible;        // (N,) 0/1
};

__device__ __forceinline__ float warp_min_f(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ unsigned warp_min_u(unsigned v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Four blocks an SM is all a kernel of 128 or 256 threads needs; left to
// itself ptxas aims the 128-thread blocks at full occupancy (32 registers)
// and spills at K=8, D=4.
template <int K, int D>
__global__ void __launch_bounds__(Geometry<K>::kThreads, 4)
sched_weigh_kernel(const Args a) {
    using G = Geometry<K>;
    constexpr int kLow = G::kLowBits, kP = G::kMasksPerThread;
    constexpr int kWarps = G::kHostThreads / 32;   // warps of one host
    __shared__ float s_res[G::kHostsPerBlock][K * D];
    __shared__ float s_cost[G::kHostsPerBlock][K];
    __shared__ float s_free[G::kHostsPerBlock][D];
    __shared__ float s_red_f[kWarps];
    __shared__ int s_red_i[kWarps];
    __shared__ unsigned s_red_u[kWarps];

    const int g = threadIdx.x / G::kHostThreads;   // host within the block
    const int t = threadIdx.x % G::kHostThreads;   // thread within the host
    const int host = blockIdx.x * G::kHostsPerBlock + g;
    // a whole warp (or the whole block above K = 8) shares the host
    if (host >= a.n) return;
    const size_t h = static_cast<size_t>(host);

    // Invalid slots free nothing and poison any subset they join.
    for (int e = t; e < K * D; e += G::kHostThreads) {
        const bool v = a.inst_valid[h * K + e / D] != 0;
        s_res[g][e] = v ? a.inst_res[h * K * D + e] : 0.0f;
    }
    for (int s = t; s < K; s += G::kHostThreads)
        s_cost[g][s] = a.inst_valid[h * K + s] != 0 ? a.inst_cost[h * K + s] : kPosInf;
    for (int j = t; j < D; j += G::kHostThreads) s_free[g][j] = a.free_f[h * D + j];
    if (kWarps == 1) __syncwarp(); else __syncthreads();

    // this thread's row of the low-slot table: slot sums over the low bits of
    // t, in ascending slot order (tab[D] is the cost); at K = 4 and 5 on two
    // or more hosts, XLA's trees over every slot (kLow = K there)
    const int lo = t & ((1 << kLow) - 1);
    float tab[D + 1];
    bool xla_tree = false;
    if constexpr (K == 4 || K == 5) {
        xla_tree = a.n >= 2;
        if (xla_tree) {
#pragma unroll
            for (int j = 0; j <= D; ++j) {
                float c[K];
#pragma unroll
                for (int s = 0; s < K; ++s)
                    c[s] = (lo >> s) & 1 ? (j < D ? s_res[g][s * D + j] : s_cost[g][s]) : 0.0f;
                tab[j] = K == 4 ? (c[0] + c[1]) + (c[2] + c[3])
                                : ((c[0] + c[2]) + (c[1] + c[3])) + c[K - 1];
            }
        }
    }
    if (!xla_tree) {
#pragma unroll
        for (int j = 0; j <= D; ++j) tab[j] = 0.0f;
#pragma unroll
        for (int s = 0; s < kLow; ++s) {
            if ((lo >> s) & 1) {
#pragma unroll
                for (int j = 0; j < D; ++j) tab[j] = tab[j] + s_res[g][s * D + j];
                tab[D] = tab[D] + s_cost[g][s];
            }
        }
    }
    float free_j[D], need[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        free_j[j] = s_free[g][j];
        need[j] = a.req[j] - 1e-6f;
    }

    // every mask (i << kLow) | lo: the high slots of i added in ascending order
    float sub[kP];
    float t_best = kPosInf;
    bool t_ok = false;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
        float f[D + 1];
#pragma unroll
        for (int j = 0; j <= D; ++j) f[j] = tab[j];
#pragma unroll
        for (int s = kLow; s < K; ++s) {
            if ((i >> (s - kLow)) & 1) {
#pragma unroll
                for (int j = 0; j < D; ++j) f[j] = f[j] + s_res[g][s * D + j];
                f[D] = f[D] + s_cost[g][s];
            }
        }
        bool ok = true;
#pragma unroll
        for (int j = 0; j < D; ++j) ok &= free_j[j] + f[j] >= need[j];
        sub[i] = ok ? f[D] : kPosInf;
        t_best = fminf(t_best, sub[i]);
        t_ok |= ok;
    }

    float best = warp_min_f(t_best);
    int feas = __any_sync(0xffffffffu, t_ok);
    const int warp = t >> 5, lane = t & 31;
    if (kWarps > 1) {
        if (lane == 0) { s_red_f[warp] = best; s_red_i[warp] = feas; }
        __syncthreads();
        best = s_red_f[0];
        feas = s_red_i[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) { best = fminf(best, s_red_f[w]); feas |= s_red_i[w]; }
    }

    // Tie-break among masks within tie_eps of the best: fewest instances,
    // then lowest mask index (the plain version's argmin first hit).
    const float bound = best + a.tie_eps;
    const unsigned lo_pop = static_cast<unsigned>(__popc(lo));
    unsigned key = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
        const unsigned m = (static_cast<unsigned>(i) << kLow) | static_cast<unsigned>(lo);
        const unsigned k_i = ((lo_pop + static_cast<unsigned>(__popc(i))) << 16) | m;
        if (sub[i] <= bound) key = min(key, k_i);
    }
    key = warp_min_u(key);
    if (kWarps > 1) {
        if (lane == 0) s_red_u[warp] = key;
        __syncthreads();
        key = s_red_u[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) key = min(key, s_red_u[w]);
    }
    if (t == 0) {
        a.best_cost[h] = best;
        a.best_mask[h] = static_cast<int32_t>(key & 0xffffu);
        a.feasible[h] = feas ? 1 : 0;
    }
}

using LaunchFn = void (*)(const Args&, cudaStream_t);

template <int K, int D>
void launch(const Args& a, cudaStream_t stream) {
    using G = Geometry<K>;
    const int blocks = (a.n + G::kHostsPerBlock - 1) / G::kHostsPerBlock;
    sched_weigh_kernel<K, D><<<blocks, G::kThreads, 0, stream>>>(a);
}

template <int K>
LaunchFn pick_d(int d) {
    switch (d) {
    case 1: return &launch<K, 1>;
    case 2: return &launch<K, 2>;
    case 3: return &launch<K, 3>;
    case 4: return &launch<K, 4>;
    case 5: return &launch<K, 5>;
    case 6: return &launch<K, 6>;
    case 7: return &launch<K, 7>;
    case 8: return &launch<K, 8>;
    default: return nullptr;
    }
}

//: the instantiation for (K, D), K = 1..12 and D = 1..8
LaunchFn pick(int k, int d) {
    switch (k) {
    case 1: return pick_d<1>(d);
    case 2: return pick_d<2>(d);
    case 3: return pick_d<3>(d);
    case 4: return pick_d<4>(d);
    case 5: return pick_d<5>(d);
    case 6: return pick_d<6>(d);
    case 7: return pick_d<7>(d);
    case 8: return pick_d<8>(d);
    case 9: return pick_d<9>(d);
    case 10: return pick_d<10>(d);
    case 11: return pick_d<11>(d);
    case 12: return pick_d<12>(d);
    default: return nullptr;
    }
}

}  // namespace

extern "C" int sched_weigh_launch(const void* free_f, const void* inst_res,
                                  const void* inst_cost, const void* inst_valid,
                                  const void* req, int n, int k, int d,
                                  float tie_eps, void* best_cost, void* best_mask,
                                  void* feasible, void* stream) {
    if (n <= 0) return 0;
    const LaunchFn fn = pick(k, d);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const float*>(free_f), static_cast<const float*>(inst_res),
                 static_cast<const float*>(inst_cost), static_cast<const uint8_t*>(inst_valid),
                 static_cast<const float*>(req), n, tie_eps, static_cast<float*>(best_cost),
                 static_cast<int32_t*>(best_mask), static_cast<uint8_t*>(feasible)};
    fn(a, static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
}
