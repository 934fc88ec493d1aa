// Stage-1 screen (bounds, normalization constants, top-(M+1) shortlist), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/sched_screen.py:
//   _consts_kernel  (phase 0: fold the 10 ScreenConsts)  -> screen_consts_*
//   _topm_kernel    (phase 1: omega_ub + running top-M)  -> screen_topm_*
//   _kernel         (both phases on one sequential grid) -> the two in a row
// The per-host terms are _tile_stage1's: dual-view fit, domain, zone
// exclusion, churn gate, free slot, exact feasibility from the descending
// per-dim resource prefix (Batcher network), the cost lower bound from the
// ascending cost prefix, and the raw weigher terms.
//
// What bounds it on this card: bytes.  Each pass reads every host's state
// once, about 169 bytes a host at K=8, D=3 (free_f, free_n, inst_res,
// inst_cost, inst_valid, schedulable, domain, slow), and does a few hundred
// flops on it, far below the card's flops-per-byte balance.  The two passes
// read the fleet twice (65,536 hosts: 2 x 11 MB), and a decision waits on
// both, so the floor is two HBM sweeps plus the launch gaps.
//
// What the design does about it: one thread per host recomputes the terms in
// registers in both passes (no intermediate array goes to HBM, as on the
// TPU).  The TPU folded the constants and the running top-M across a
// sequential grid; Hopper's blocks run in parallel and in no order, so:
//   * the constants fold with a block reduction and then atomicMin/atomicMax
//     on an order-preserving integer encoding of the float (min/max do not
//     depend on order, so this is deterministic; -0 is first canonicalised
//     to +0);
//   * the top-(M+1) is a bitonic sort of each block's 64-bit keys (encoded
//     score high, 0xFFFFFFFF - host index low, so ties go to the lowest
//     index, lax.top_k's rule) and a one-block merge of the per-block tops.
// The host-major layout is read as the state keeps it (strided per thread);
// a slot-major copy or TMA staging is later work.
//
// Floating point: compiled with --fmad=false; the multiply-adds that jitted
// XLA contracts (see core/screen_math.py) are explicit __fmaf_rn calls, so
// every output equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define SCREEN_MAX_K 12
#define SCREEN_MAX_D 8
#define CONSTS_THREADS 256
#define TOPM_BLOCK 1024
#define MERGE_THREADS 1024

struct ScreenArgs {
    const float* free_f;       // (N, D)
    const float* free_n;       // (N, D)
    const uint8_t* sched;      // (N,) 0/1
    const int32_t* domain;     // (N,)
    const float* slow;         // (N,)
    const float* inst_res;     // (N, K, D)
    const float* inst_cost;    // (N, K)
    const uint8_t* inst_valid; // (N, K) 0/1
    const float* req;          // (D,)
    const float* churn;        // (N,) or null
    const int32_t* host_zone;  // (N,) or null
    int n, k, d;
    int pre, rdom, excl, require_free_slot, has_thr;
    float thr;
    float m_over, m_term, m_pack, m_strag, m_churn;
};

struct HostTerms {
    bool valid;
    float cost_lb, cost_ub, over_raw, pack_raw, strag_raw, churn_raw;
};

static __device__ __forceinline__ unsigned enc_f(float x) {
    const unsigned b = __float_as_uint(x + 0.0f);   // -0 -> +0
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

static __device__ __forceinline__ float dec_f(unsigned e) {
    const unsigned b = (e & 0x80000000u) ? (e & 0x7fffffffu) : ~e;
    return __uint_as_float(b);
}

// Batcher's odd-even mergesort network (the compare-exchange pairs of
// screen_math.oem_pairs, in the same order).
template <bool DESC>
static __device__ __forceinline__ void oem_sort(float* v, int n) {
    for (int p = 1; p < n; p <<= 1) {
        for (int k = p; k >= 1; k >>= 1) {
            for (int j = k % p; j < n - k; j += 2 * k) {
                const int lim = min(k, n - j - k);
                for (int i = 0; i < lim; ++i) {
                    if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
                        const float a = v[i + j], b = v[i + j + k];
                        const float lo = fminf(a, b), hi = fmaxf(a, b);
                        v[i + j] = DESC ? hi : lo;
                        v[i + j + k] = DESC ? lo : hi;
                    }
                }
            }
        }
    }
}

static __device__ HostTerms host_terms(const ScreenArgs& a, int i) {
    const int k = a.k, d = a.d;
    float need[SCREEN_MAX_D], req_m[SCREEN_MAX_D];
    float free_sum = 0.0f;
    bool over = false, fits = true;
    for (int j = 0; j < d; ++j) {
        const float ff = a.free_f[(size_t)i * d + j];
        need[j] = a.req[j] - ff;
        req_m[j] = a.req[j] - 1e-6f;
        over = over || (need[j] > 1e-6f);
        const float view = a.pre ? ff : a.free_n[(size_t)i * d + j];
        fits = fits && (view >= req_m[j]);
        free_sum = (j == 0) ? ff : free_sum + ff;
    }
    fits = fits && (a.sched[i] != 0);
    fits = fits && (a.rdom < 0 || a.domain[i] == a.rdom);
    if (a.host_zone) fits = fits && (a.excl < 0 || a.host_zone[i] != a.excl);
    if (a.has_thr && a.churn && a.pre) fits = fits && (a.churn[i] <= a.thr);

    float cost[SCREEN_MAX_K];
    float total = 0.0f;
    bool has_free = false;
    for (int s = 0; s < k; ++s) {
        const bool v = a.inst_valid[(size_t)i * k + s] != 0;
        has_free = has_free || !v;
        const float c = a.inst_cost[(size_t)i * k + s];
        cost[s] = v ? c : 1e30f;
        const float c0 = v ? c : 0.0f;
        total = (s == 0) ? c0 : total + c0;
    }
    if (a.require_free_slot && a.pre) fits = fits && has_free;

    // Fewest slots that could cover each dim: descending per-dim prefix.
    int m_star = 0;
    bool feasible = true;
    for (int j = 0; j < d; ++j) {
        float col[SCREEN_MAX_K];
        for (int s = 0; s < k; ++s) {
            const bool v = a.inst_valid[(size_t)i * k + s] != 0;
            col[s] = v ? a.inst_res[((size_t)i * k + s) * d + j] : 0.0f;
        }
        oem_sort<true>(col, k);
        float prefix = 0.0f;
        int lacking = 0;
        const float need_m = need[j] - 1e-6f;
        for (int s = 0; s < k; ++s) {
            prefix = prefix + col[s];
            lacking += (prefix < need_m) ? 1 : 0;
        }
        feasible = feasible && (prefix >= need_m);
        const int m_d = (need[j] > 1e-6f) ? lacking + 1 : 0;
        m_star = max(m_star, m_d);
    }
    m_star = min(m_star, k);
    oem_sort<false>(cost, k);
    float lb = 0.0f;
    for (int s = 0; s < k; ++s) lb = lb + ((s < m_star) ? cost[s] : 0.0f);

    HostTerms t;
    t.cost_lb = (over && !a.pre) ? lb : 0.0f;
    t.cost_ub = (over && !a.pre) ? total : 0.0f;
    t.valid = fits && (a.pre ? fits : feasible);
    t.over_raw = over ? -1.0f : 0.0f;
    t.pack_raw = -free_sum;
    t.strag_raw = -a.slow[i];
    t.churn_raw = a.churn ? -a.churn[i] : 0.0f;
    return t;
}

// ---- phase 0: the 10 normalization constants ------------------------------

static __device__ __forceinline__ float block_min(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fminf(r, red[w]);
    return r;
}

__global__ void __launch_bounds__(CONSTS_THREADS)
screen_consts_fold(ScreenArgs a, unsigned* __restrict__ enc) {
    __shared__ float red[CONSTS_THREADS / 32];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float lo[5], hi[5];
    for (int q = 0; q < 5; ++q) { lo[q] = 1e30f; hi[q] = -1e30f; }
    if (i < a.n) {
        const HostTerms t = host_terms(a, i);
        if (t.valid) {
            lo[0] = t.cost_lb;  hi[0] = t.cost_ub;
            lo[1] = hi[1] = t.over_raw;
            lo[2] = hi[2] = t.pack_raw;
            lo[3] = hi[3] = t.strag_raw;
            lo[4] = hi[4] = t.churn_raw;
        }
    }
    const bool on[5] = {true, a.m_over != 0.0f, a.m_pack != 0.0f,
                        a.m_strag != 0.0f, a.m_churn != 0.0f && a.churn != nullptr};
    for (int q = 0; q < 5; ++q) {
        if (!on[q]) continue;
        const float bl = block_min(lo[q], red);
        const float bh = -block_min(-hi[q], red);
        if (threadIdx.x == 0) {
            atomicMin(&enc[2 * q], enc_f(bl));
            atomicMax(&enc[2 * q + 1], enc_f(bh));
        }
    }
}

__global__ void screen_consts_decode(const unsigned* __restrict__ enc,
                                     float* __restrict__ consts) {
    const int j = threadIdx.x;
    if (j < 10) consts[j] = dec_f(enc[j]);
}

extern "C" int sched_screen_consts_launch(ScreenArgs a, void* enc, void* consts,
                                          void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (a.n + CONSTS_THREADS - 1) / CONSTS_THREADS;
    screen_consts_fold<<<blocks, CONSTS_THREADS, 0, s>>>(a, (unsigned*)enc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    screen_consts_decode<<<1, 32, 0, s>>>((const unsigned*)enc, (float*)consts);
    return (int)cudaGetLastError();
}

// ---- phase 1: omega_ub and the top-(M+1) -----------------------------------

static __device__ __forceinline__ float norm01(float w, float lo, float hi) {
    const float span = hi - lo;
    return (span > 1e-12f) ? (w - lo) / span : 0.0f;
}

static __device__ __forceinline__ bool is_prod(float m) {
    return m != 1.0f && m != -1.0f;
}

// a positive power of two other than 1
static __device__ __forceinline__ bool is_pow2(float m) {
    int e;
    return m > 0.0f && m != 1.0f && frexpf(m, &e) == 0.5f;
}

static __device__ __forceinline__ float scaled(float m, float x) {
    return (m == 1.0f) ? x : ((m == -1.0f) ? -x : m * x);
}

// omega_ub with the weigher sum rounded where jitted XLA rounds; the same
// rules as core/screen_math.py (_base_chain, omega_of).
static __device__ __forceinline__ float omega_ub(const ScreenArgs& a,
                                                 const HostTerms& t,
                                                 const float* c) {
    const float ms[4] = {a.m_over, a.m_pack, a.m_strag,
                         a.churn ? a.m_churn : 0.0f};
    const float raws[4] = {t.over_raw, t.pack_raw, t.strag_raw, t.churn_raw};
    int idx[4];
    int cnt = 0;
    for (int q = 0; q < 4; ++q)
        if (ms[q] != 0.0f) idx[cnt++] = q;
    float xs[4];
    for (int j = 0; j < cnt; ++j) {
        const int q = idx[j];
        xs[j] = norm01(raws[q], c[2 + 2 * q], c[3 + 2 * q]);
    }
    float base = 0.0f;
    bool pending = false;
    float pm = 0.0f, px = 0.0f;
    if (cnt == 1) {
        base = scaled(ms[idx[0]], xs[0]);
        if (is_prod(ms[idx[0]])) { pending = true; pm = ms[idx[0]]; px = xs[0]; }
    } else if (cnt >= 2) {
        const float m0 = ms[idx[0]], m1 = ms[idx[1]];
        const bool p0 = is_prod(m0) && idx[0] != 0, p1 = is_prod(m1);
        if (p0) base = __fmaf_rn(m0, xs[0], scaled(m1, xs[1]));
        else if (p1 && (cnt == 2 || (cnt == 3 && (m0 == 1.0f || ms[idx[2]] == 1.0f))))
            base = __fmaf_rn(m1, xs[1], scaled(m0, xs[0]));
        else base = scaled(m0, xs[0]) + scaled(m1, xs[1]);
        bool shared = true;
        for (int j = 2; j < cnt; ++j) {
            base = base + scaled(ms[idx[j]], xs[j]);
            shared = shared && ms[idx[j]] == m0;
        }
        // one shared power-of-two multiplier: XLA factors it out of the sum
        // and the termination add fuses that (exact) product instead
        // (screen_math._base_chain lists when)
        const float mt = a.m_term;
        if (shared && m1 == m0 &&
            ((is_pow2(m0) && !(mt == -1.0f || (cnt == 2 && mt > 0.0f && mt != 1.0f))) ||
             (is_pow2(-m0) && cnt == 3 && mt < 0.0f && mt != -1.0f))) {
            pending = true; pm = 1.0f; px = base;
        }
    }
    float w = base;
    if (a.m_term != 0.0f) {
        const float span = c[1] - c[0];
        const float ispan = (span > 1e-12f) ? 1.0f / span : 0.0f;
        const float opt = (a.m_term >= 0.0f) ? t.cost_lb : t.cost_ub;
        const float x = c[1] - fminf(opt, 1e30f);
        if (pending) w = __fmaf_rn(pm, px, scaled(a.m_term, x * ispan));
        else if (a.m_term == 1.0f) w = __fmaf_rn(x, ispan, base);
        else if (a.m_term == -1.0f) w = __fmaf_rn(-x, ispan, base);
        else w = __fmaf_rn(a.m_term, x * ispan, base);
    }
    return t.valid ? w : -1e30f;
}

static __device__ __forceinline__ void bitonic_desc(unsigned long long* s, int n) {
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const int p = i ^ j;
                if (p > i) {
                    const unsigned long long x = s[i], y = s[p];
                    const bool desc = (i & k) == 0;
                    if (desc ? (x < y) : (x > y)) { s[i] = y; s[p] = x; }
                }
            }
            __syncthreads();
        }
    }
}

__global__ void __launch_bounds__(TOPM_BLOCK)
screen_topm_block(ScreenArgs a, const float* __restrict__ consts, int m_keep,
                  unsigned long long* __restrict__ scratch) {
    __shared__ unsigned long long keys[TOPM_BLOCK];
    __shared__ float c[10];
    if (threadIdx.x < 10) c[threadIdx.x] = consts[threadIdx.x];
    __syncthreads();
    const int i = blockIdx.x * TOPM_BLOCK + threadIdx.x;
    unsigned long long key = 0ull;   // below every real host
    if (i < a.n) {
        const HostTerms t = host_terms(a, i);
        const float score = omega_ub(a, t, c);
        key = ((unsigned long long)enc_f(score) << 32)
              | (unsigned long long)(0xffffffffu - (unsigned)i);
    }
    keys[threadIdx.x] = key;
    __syncthreads();
    bitonic_desc(keys, TOPM_BLOCK);
    for (int j = threadIdx.x; j < m_keep; j += blockDim.x)
        scratch[(size_t)blockIdx.x * m_keep + j] = keys[j];
}

__global__ void __launch_bounds__(MERGE_THREADS)
screen_topm_merge(const unsigned long long* __restrict__ scratch, int n_cand,
                  int n_pad, int m_keep, float* __restrict__ top_scores,
                  int32_t* __restrict__ top_idx) {
    extern __shared__ unsigned long long mkeys[];
    for (int j = threadIdx.x; j < n_pad; j += blockDim.x)
        mkeys[j] = (j < n_cand) ? scratch[j] : 0ull;
    __syncthreads();
    bitonic_desc(mkeys, n_pad);
    for (int j = threadIdx.x; j < m_keep; j += blockDim.x) {
        const unsigned long long key = mkeys[j];
        top_scores[j] = dec_f((unsigned)(key >> 32));
        top_idx[j] = (int32_t)(0xffffffffu - (unsigned)(key & 0xffffffffull));
    }
}

extern "C" int sched_screen_topm_launch(ScreenArgs a, const void* consts,
                                        int m_keep, void* scratch, int n_pad,
                                        void* top_scores, void* top_idx,
                                        void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (a.n + TOPM_BLOCK - 1) / TOPM_BLOCK;
    screen_topm_block<<<blocks, TOPM_BLOCK, 0, s>>>(
        a, (const float*)consts, m_keep, (unsigned long long*)scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)n_pad * sizeof(unsigned long long);
    err = cudaFuncSetAttribute(screen_topm_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    screen_topm_merge<<<1, MERGE_THREADS, smem, s>>>(
        (const unsigned long long*)scratch, blocks * m_keep, n_pad, m_keep,
        (float*)top_scores, (int32_t*)top_idx);
    return (int)cudaGetLastError();
}
