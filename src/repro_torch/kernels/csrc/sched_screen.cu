// Stage-1 screen (bounds, normalization constants, top-(M+1) shortlist), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/sched_screen.py:
//   _consts_kernel  (phase 0: fold the 10 ScreenConsts)  -> screen_consts_kernel
//   _topm_kernel    (phase 1: omega_ub + running top-M)  -> screen_topm_kernel
//   _kernel         (both phases on one sequential grid) -> the two in a row
// The per-host terms are _tile_stage1's: dual-view fit, domain, zone
// exclusion, churn gate, free slot, exact feasibility from the descending
// per-dim resource prefix (Batcher network), the cost lower bound from the
// ascending cost prefix, and the raw weigher terms.
//
// What bounds it on this card: bytes.  Each pass reads every host's state
// once, 169 bytes a host at K=8, D=3 (free_f, free_n, inst_res, inst_cost,
// inst_valid, schedulable, domain, slow), and does a few hundred flops on it,
// far below the card's flops-per-byte balance: 11.1 MB, 3.31 us at 3.35 TB/s
// for 65,536 hosts; 177 MB, 52.9 us for 2^20 hosts.
//
// What the design does about it:
//   * The whole card scores: one persistent block an SM walks tiles of up to
//     512 hosts, one host a thread (the wrapper's _geometry).
//   * Coalesced reads: a tile's host-major rows (inst_res, inst_cost,
//     inst_valid, free_f, free_n) are copied into shared memory by cp.async,
//     neighbouring threads on neighbouring words, into rows of odd stride so
//     that the per-host reads that follow are free of bank conflicts.  A
//     block copies its next tile while it scores the current one.
//   * The terms in registers: K is a template parameter (a switch over the
//     K <= 12 the wrapper takes), so the Batcher networks and the slot arrays
//     unroll; the weigher plan (which multipliers are on) is worked out once
//     on the host, so omega_ub indexes no array at run time.
//   * One launch a pass, no fills: each block folds its own constants or
//     keeps its own top-P (P = m_keep rounded up to a power of two) and
//     writes them out; the last block to finish (found by a counter, which
//     it resets to 0) folds the partials.  min/max do not depend on order
//     (-0 is first canonicalised to +0), and the 64-bit keys (encoded score
//     high, 0xFFFFFFFF - host index low: lax.top_k's tie order) are unique,
//     so every call gives the same bits whichever block finishes last.
//   * No full re-sort of the candidates: a block keeps its top-P sorted and
//     merges a tile into it only with the tile's keys above its m_keep-th
//     (a bitonic sort of those few, then the bitonic merge of two sorted
//     lists, which keeps the top P).  The last block of each group of 16
//     merges the group's lists, the groups in parallel, and the last group's
//     merges the groups' lists; each merge keeps only the lists whose first
//     key reaches tau, the largest of their m_keep-th keys (every key of the
//     answer is >= tau), and merges them pairwise in a tree.  Compare-
//     exchanges of span < 32 run on warp shuffles, the others through shared
//     memory, one barrier each.  No merge holds more than 16 lists, so the
//     fleet size has no ceiling.
//
// Floating point: compiled with --fmad=false; the multiply-adds that jitted
// XLA contracts (see core/screen_math.py) are explicit __fmaf_rn calls, so
// every output equals the plain PyTorch version bit for bit.
//
// Two programs, as in the JAX package: the static one, whose multipliers are
// constants (a product by 1 is none, a shared power of two is factored out),
// and the traced one of its ensemble (`traced`), whose multipliers are the
// row's values while `gates` (a bit a weigher, from the policy's own
// multipliers) says which terms exist and `term_ub` the bound's side.  The
// wrapper sets `gates` and `term_ub` from the values in the static program.
#include <cuda_runtime.h>
#include <stdint.h>

#define SCREEN_MAX_D 8
#define SCREEN_MAX_TPB 512
#define SCREEN_GROUP 16          // lists a merge takes: blocks <= SCREEN_GROUP^2

typedef unsigned long long u64;

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
    int gates;     // bits: over, term, pack, straggler, churn (on when set)
    int term_ub;   // score the termination term from cost_ub (its gate < 0)
    int traced;    // 1: the traced-multiplier program
};

#define GATE_OVER 1
#define GATE_TERM 2
#define GATE_PACK 4
#define GATE_STRAG 8
#define GATE_CHURN 16

// The launch parameters: the arguments and the weigher plan, the weighers
// whose gate is on in the order over, pack, strag, churn.
struct Screen {
    ScreenArgs a;
    int cnt;
    int q[4];
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

// ---- the tile in shared memory ----------------------------------------------

static __host__ __device__ __forceinline__ int odd(int x) { return x | 1; }

static __host__ __device__ __forceinline__ size_t align16(size_t x) {
    return (x + 15) & ~(size_t)15;
}

// bytes of a tile of `tpb` hosts (the wrapper's _stage_bytes says the same)
static __host__ __device__ __forceinline__ size_t stage_bytes(int tpb, int k, int d) {
    return align16((size_t)tpb * 4 * (odd(k * d) + odd(k) + 2 * odd(d)))
           + align16((size_t)tpb * k);
}

struct Tile {
    float* res;       // host h's slot s, dim j at res[h * rs + s * D + j]
    float* cost;      // cost[h * cs + s]
    float* ff;        // ff[h * fs + j]
    float* fn;
    uint8_t* valid;   // valid[h * K + s]
    int rs, cs, fs;
};

static __device__ __forceinline__ Tile tile_at(unsigned char* smem, int tpb, int k, int d) {
    Tile s;
    s.rs = odd(k * d);
    s.cs = odd(k);
    s.fs = odd(d);
    s.res = (float*)smem;
    s.cost = s.res + (size_t)tpb * s.rs;
    s.ff = s.cost + (size_t)tpb * s.cs;
    s.fn = s.ff + (size_t)tpb * s.fs;
    s.valid = smem + align16((size_t)tpb * 4 * (s.rs + s.cs + 2 * s.fs));
    return s;
}

static __device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}

// `rows` contiguous rows of `w` floats into rows of stride `stride`: thread
// t copies words t, t + blockDim, ... (coalesced), tracking its (row, col).
static __device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                                  int w, int stride) {
    const int total = rows * w, step = blockDim.x;
    const int dq = step / w, dr = step - dq * w;
    int h = threadIdx.x / w, r = threadIdx.x - h * w;
    for (int e = threadIdx.x; e < total; e += step) {
        cp_async4(dst + h * stride + r, src + e);
        h += dq;
        r += dr;
        if (r >= w) { r -= w; ++h; }
    }
}

// start copying hosts h0 .. h0 + cnt - 1 into the tile (one cp.async group;
// stage_wait ends it)
template <int K>
static __device__ __forceinline__ void stage_issue(const ScreenArgs& a, const Tile& s,
                                                   int h0, int cnt) {
    const int d = a.d;
    stage_rows(s.res, a.inst_res + (size_t)h0 * K * d, cnt, K * d, s.rs);
    stage_rows(s.cost, a.inst_cost + (size_t)h0 * K, cnt, K, s.cs);
    stage_rows(s.ff, a.free_f + (size_t)h0 * d, cnt, d, s.fs);
    if (!a.pre) stage_rows(s.fn, a.free_n + (size_t)h0 * d, cnt, d, s.fs);
    const uint8_t* v = a.inst_valid + (size_t)h0 * K;
    const int bytes = cnt * K;
    int e0 = 0;
    if (((uintptr_t)v & 3) == 0) {            // whole words by cp.async
        e0 = bytes & ~3;
        for (int e = 4 * threadIdx.x; e < e0; e += 4 * blockDim.x) cp_async4(s.valid + e, v + e);
    }
    for (int e = e0 + threadIdx.x; e < bytes; e += blockDim.x) s.valid[e] = v[e];
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy issued has landed, and every thread is past the previous tile
static __device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
}

// ---- the per-host terms -------------------------------------------------------

// Batcher's odd-even mergesort network (the compare-exchange pairs of
// screen_math.oem_pairs, in the same order), unrolled for N slots.
template <bool DESC, int N>
static __device__ __forceinline__ void oem_sort(float (&v)[N]) {
#pragma unroll
    for (int lp = 0; (1 << lp) < N; ++lp) {
        const int p = 1 << lp;
#pragma unroll
        for (int lk = lp; lk >= 0; --lk) {
            const int k = 1 << lk;
#pragma unroll
            for (int j = k % p; j < N - k; j += 2 * k) {
#pragma unroll
                for (int i = 0; i < k; ++i) {
                    if (i < N - j - k && (i + j) / (2 * p) == (i + j + k) / (2 * p)) {
                        const float x = v[i + j], y = v[i + j + k];
                        const float lo = fminf(x, y), hi = fmaxf(x, y);
                        v[i + j] = DESC ? hi : lo;
                        v[i + j + k] = DESC ? lo : hi;
                    }
                }
            }
        }
    }
}

// host h of the tile, host i of the fleet
template <int K>
static __device__ __forceinline__ HostTerms host_terms(const ScreenArgs& a, const Tile& s,
                                                       int h, int i, const float* req) {
    const int d = a.d;
    const float* ff = s.ff + h * s.fs;
    const float* fn = s.fn + h * s.fs;
    const float* res = s.res + h * s.rs;
    const float* cst = s.cost + h * s.cs;
    const uint8_t* vl = s.valid + h * K;
    float free_sum = 0.0f;
    bool over = false, fits = true;
    for (int j = 0; j < d; ++j) {
        const float f = ff[j];
        over = over || (req[j] - f > 1e-6f);
        const float view = a.pre ? f : fn[j];
        fits = fits && (view >= req[j] - 1e-6f);
        free_sum = (j == 0) ? f : free_sum + f;
    }
    fits = fits && (a.sched[i] != 0);
    fits = fits && (a.rdom < 0 || a.domain[i] == a.rdom);
    if (a.host_zone) fits = fits && (a.excl < 0 || a.host_zone[i] != a.excl);
    if (a.has_thr && a.churn && a.pre) fits = fits && (a.churn[i] <= a.thr);

    bool v[K];
    float cost[K];
    float total = 0.0f;
    bool has_free = false;
#pragma unroll
    for (int t = 0; t < K; ++t) {
        v[t] = vl[t] != 0;
        has_free = has_free || !v[t];
        const float c = cst[t];
        cost[t] = v[t] ? c : 1e30f;
        const float c0 = v[t] ? c : 0.0f;
        total = (t == 0) ? c0 : total + c0;
    }
    if (a.require_free_slot && a.pre) fits = fits && has_free;

    // Fewest slots that could cover each dim: descending per-dim prefix.
    int m_star = 0;
    bool feasible = true;
    for (int j = 0; j < d; ++j) {
        float col[K];
#pragma unroll
        for (int t = 0; t < K; ++t) col[t] = v[t] ? res[t * d + j] : 0.0f;
        oem_sort<true>(col);
        const float need = req[j] - ff[j];
        const float need_m = need - 1e-6f;
        float prefix = 0.0f;
        int lacking = 0;
#pragma unroll
        for (int t = 0; t < K; ++t) {
            prefix = prefix + col[t];
            lacking += (prefix < need_m) ? 1 : 0;
        }
        feasible = feasible && (prefix >= need_m);
        const int m_d = (need > 1e-6f) ? lacking + 1 : 0;
        m_star = max(m_star, m_d);
    }
    m_star = min(m_star, K);
    oem_sort<false>(cost);
    float lb = 0.0f;
#pragma unroll
    for (int t = 0; t < K; ++t) lb = lb + ((t < m_star) ? cost[t] : 0.0f);

    HostTerms r;
    r.cost_lb = (over && !a.pre) ? lb : 0.0f;
    r.cost_ub = (over && !a.pre) ? total : 0.0f;
    r.valid = fits && (a.pre ? fits : feasible);
    r.over_raw = over ? -1.0f : 0.0f;
    r.pack_raw = -free_sum;
    r.strag_raw = -a.slow[i];
    r.churn_raw = a.churn ? -a.churn[i] : 0.0f;
    return r;
}

// ---- the tile loop ----------------------------------------------------------

// Block b scores tiles b, b + gridDim.x, ... from two stages of shared
// memory: tile_first starts copying the first, and each tile_next starts
// copying the block's following tile into the other stage.
template <int K>
static __device__ __forceinline__ void tile_first(const ScreenArgs& a, unsigned char* smem) {
    const int tpb = blockDim.x, h0 = blockIdx.x * tpb;
    stage_issue<K>(a, tile_at(smem, tpb, K, a.d), h0, min(tpb, a.n - h0));
}

// tile t (the block's i-th) in shared memory, every thread past the last one
template <int K>
static __device__ __forceinline__ Tile tile_next(const ScreenArgs& a, unsigned char* smem,
                                                 int t, int i) {
    const int tpb = blockDim.x, next = (t + gridDim.x) * tpb;
    const size_t sb = stage_bytes(tpb, K, a.d);
    stage_wait();
    if (next < a.n)
        stage_issue<K>(a, tile_at(smem + ((i & 1) ^ 1) * sb, tpb, K, a.d), next,
                       min(tpb, a.n - next));
    return tile_at(smem + (i & 1) * sb, tpb, K, a.d);
}

// ---- phase 0: the 10 normalization constants ----------------------------------

template <int K>
__global__ void __launch_bounds__(SCREEN_MAX_TPB, 1)
screen_consts_kernel(Screen p, float* __restrict__ partial, unsigned* __restrict__ counter,
                     float* __restrict__ consts) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float req[SCREEN_MAX_D];
    __shared__ float red[SCREEN_MAX_TPB / 32][10];
    __shared__ int last;
    const ScreenArgs& a = p.a;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5, tpb = blockDim.x;
    if (tid < a.d) req[tid] = a.req[tid];
    // even entries fold with min, odd with max; a weigher that is off keeps
    // (1e30, -1e30), as consts_of does
    const bool on[5] = {true, (a.gates & GATE_OVER) != 0, (a.gates & GATE_PACK) != 0,
                        (a.gates & GATE_STRAG) != 0,
                        (a.gates & GATE_CHURN) != 0 && a.churn != nullptr};
    float v[10];
#pragma unroll
    for (int q = 0; q < 5; ++q) { v[2 * q] = 1e30f; v[2 * q + 1] = -1e30f; }
    const int tiles = (a.n + tpb - 1) / tpb, nb = gridDim.x;
    tile_first<K>(a, smem);
    for (int t = blockIdx.x, i = 0; t < tiles; t += nb, ++i) {
        const int h0 = t * tpb, cnt = min(tpb, a.n - h0);
        const Tile s = tile_next<K>(a, smem, t, i);
        if (tid < cnt) {
            const HostTerms ht = host_terms<K>(a, s, tid, h0 + tid, req);
            if (ht.valid) {
                const float w[5] = {0.0f, ht.over_raw, ht.pack_raw, ht.strag_raw, ht.churn_raw};
                v[0] = fminf(v[0], ht.cost_lb + 0.0f);
                v[1] = fmaxf(v[1], ht.cost_ub + 0.0f);
#pragma unroll
                for (int q = 1; q < 5; ++q) {
                    if (on[q]) {
                        v[2 * q] = fminf(v[2 * q], w[q] + 0.0f);
                        v[2 * q + 1] = fmaxf(v[2 * q + 1], w[q] + 0.0f);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int q = 0; q < 10; ++q) {
        float x = v[q];
        for (int o = 16; o > 0; o >>= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, x, o);
            x = (q & 1) ? fmaxf(x, y) : fminf(x, y);
        }
        if (lane == 0) red[warp][q] = x;
    }
    __syncthreads();
    if (tid < 10) {
        float x = red[0][tid];
        for (int w = 1; w < nw; ++w) x = (tid & 1) ? fmaxf(x, red[w][tid]) : fminf(x, red[w][tid]);
        partial[(size_t)blockIdx.x * 10 + tid] = x;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(counter, 1u) == (unsigned)nb - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int q = warp; q < 10; q += nw) {
        float x = (q & 1) ? -1e30f : 1e30f;
#pragma unroll 8
        for (int b = lane; b < nb; b += 32) {
            const float y = __ldcg(&partial[(size_t)b * 10 + q]);
            x = (q & 1) ? fmaxf(x, y) : fminf(x, y);
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, x, o);
            x = (q & 1) ? fmaxf(x, y) : fminf(x, y);
        }
        if (lane == 0) consts[q] = x;
    }
    if (tid == 0) *counter = 0u;
}

// ---- phase 1: omega_ub and the top-(M+1) --------------------------------------

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

static __device__ __forceinline__ float mult_of(const ScreenArgs& a, int q) {
    return q == 0 ? a.m_over : (q == 1 ? a.m_pack : (q == 2 ? a.m_strag : a.m_churn));
}

static __device__ __forceinline__ float raw_of(const HostTerms& t, int q) {
    return q == 0 ? t.over_raw : (q == 1 ? t.pack_raw : (q == 2 ? t.strag_raw : t.churn_raw));
}

// the traced program's omega_ub: every multiplier a real product, rounded as
// core/screen_math.py's _traced_chain and omega_of(gate=...) say
static __device__ __forceinline__ float omega_traced(const Screen& p, const HostTerms& t,
                                                     const float* c, const float (&ms)[4],
                                                     const float (&xs)[4]) {
    const ScreenArgs& a = p.a;
    const int cnt = p.cnt;
    float base = 0.0f;
    if (cnt == 1) base = ms[0] * xs[0];
    else if (cnt >= 2) {
        base = (p.q[0] == 0) ? __fmaf_rn(ms[1], xs[1], ms[0] * xs[0])
                             : __fmaf_rn(ms[0], xs[0], ms[1] * xs[1]);
#pragma unroll
        for (int j = 2; j < 4; ++j)
            if (j < cnt) base = __fmaf_rn(ms[j], xs[j], base);
    }
    float w = base;
    if (a.gates & GATE_TERM) {
        const float span = c[1] - c[0];
        const float ispan = (span > 1e-12f) ? 1.0f / span : 0.0f;
        const float opt = a.term_ub ? t.cost_ub : t.cost_lb;
        const float term = (c[1] - fminf(opt, 1e30f)) * ispan;
        w = (cnt == 1) ? __fmaf_rn(ms[0], xs[0], a.m_term * term)
                       : __fmaf_rn(a.m_term, term, base);
    }
    return t.valid ? w : -1e30f;
}

// omega_ub with the weigher sum rounded where jitted XLA rounds; the same
// rules as core/screen_math.py (_base_chain, omega_of).
static __device__ __forceinline__ float omega_ub(const Screen& p, const HostTerms& t,
                                                 const float* c) {
    const ScreenArgs& a = p.a;
    const int cnt = p.cnt;
    float ms[4], xs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int q = p.q[j];
        ms[j] = mult_of(a, q);
        xs[j] = norm01(raw_of(t, q), c[2 + 2 * q], c[3 + 2 * q]);
    }
    if (a.traced) return omega_traced(p, t, c, ms, xs);
    float base = 0.0f;
    bool pending = false;
    float pm = 0.0f, px = 0.0f;
    if (cnt == 1) {
        base = scaled(ms[0], xs[0]);
        if (is_prod(ms[0])) { pending = true; pm = ms[0]; px = xs[0]; }
    } else if (cnt >= 2) {
        const float m0 = ms[0], m1 = ms[1];
        const bool p0 = is_prod(m0) && p.q[0] != 0, p1 = is_prod(m1);
        if (p0) base = __fmaf_rn(m0, xs[0], scaled(m1, xs[1]));
        else if (p1 && (cnt == 2 || (cnt == 3 && (m0 == 1.0f || ms[2] == 1.0f))))
            base = __fmaf_rn(m1, xs[1], scaled(m0, xs[0]));
        else base = scaled(m0, xs[0]) + scaled(m1, xs[1]);
        bool shared = true;
#pragma unroll
        for (int j = 2; j < 4; ++j) {
            if (j < cnt) {
                base = base + scaled(ms[j], xs[j]);
                shared = shared && ms[j] == m0;
            }
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
    if (a.gates & GATE_TERM) {
        const float span = c[1] - c[0];
        const float ispan = (span > 1e-12f) ? 1.0f / span : 0.0f;
        const float opt = a.term_ub ? t.cost_ub : t.cost_lb;
        const float x = c[1] - fminf(opt, 1e30f);
        if (pending) w = __fmaf_rn(pm, px, scaled(a.m_term, x * ispan));
        else if (a.m_term == 1.0f) w = __fmaf_rn(x, ispan, base);
        else if (a.m_term == -1.0f) w = __fmaf_rn(-x, ispan, base);
        else w = __fmaf_rn(a.m_term, x * ispan, base);
    }
    return t.valid ? w : -1e30f;
}

// The bitonic networks below run the compare-exchanges of span >= 32 through
// shared memory, one __syncthreads each, and those of span < 32, which stay
// inside a warp, by shuffles on keys held in registers.

// the index of compare-exchange g (g < n/2) of a half-cleaner of span j
static __device__ __forceinline__ int ce_index(int g, int j) {
    return ((g & ~(j - 1)) << 1) | (g & (j - 1));
}

// element e's side of the compare-exchange (e, e ^ j): the larger key goes
// to the lower index where `desc`
static __device__ __forceinline__ u64 cx_shfl(u64 x, int e, int j, bool desc) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, j);
    const bool keep_max = desc == ((e & j) == 0);
    return keep_max ? (x > y ? x : y) : (x < y ? x : y);
}

// s[0 .. q) into descending order (q a power of two, q <= blockDim.x):
// bitonic sort, thread t holding element t in its shuffle phases
static __device__ void sort_desc(u64* s, int q) {
    const int t = threadIdx.x;
    const bool mine = (t & ~31) < q;          // the warp holds elements
    if (mine) {                               // every k <= 32: one warp's work
        u64 x = t < q ? s[t] : 0ull;
        for (int k = 2; k <= q && k <= 32; k <<= 1)
            for (int j = k >> 1; j > 0; j >>= 1) x = cx_shfl(x, t, j, (t & k) == 0);
        if (t < q) s[t] = x;
    }
    __syncthreads();
    for (int k = 64; k <= q; k <<= 1) {
        for (int j = k >> 1; j >= 32; j >>= 1) {
            for (int g = t; g < (q >> 1); g += blockDim.x) {
                const int i = ce_index(g, j), l = i + j;
                const u64 x = s[i], y = s[l];
                if ((i & k) == 0 ? (x < y) : (x > y)) { s[i] = y; s[l] = x; }
            }
            __syncthreads();
        }
        if (mine) {
            u64 x = s[t];
            for (int j = 16; j > 0; j >>= 1) x = cx_shfl(x, t, j, (t & k) == 0);
            s[t] = x;
        }
        __syncthreads();
    }
}

// `lists` lists of p keys (p a power of two), each bitonic, from `base` on,
// `stride` lists apart: each into descending order (its half-cleaners)
static __device__ void merge_desc(u64* base, int lists, int stride, int p, int lp) {
    const int n = lists * p;
    int j = p >> 1;
    for (; j >= 32; j >>= 1) {
        for (int g = threadIdx.x; g < (n >> 1); g += blockDim.x) {
            u64* s = base + (size_t)(g >> (lp - 1)) * stride * p;
            const int i = ce_index(g & ((p >> 1) - 1), j), l = i + j;
            const u64 x = s[i], y = s[l];
            if (x < y) { s[i] = y; s[l] = x; }
        }
        __syncthreads();
    }
    if (j == 0) return;
    // spans < 32: 32 consecutive elements of one list (or whole lists when
    // p < 32) a warp; every lane of a warp that has any takes part
    for (int g0 = threadIdx.x & ~31; g0 < n; g0 += blockDim.x) {
        const int g = g0 + (threadIdx.x & 31), e = g & (p - 1);
        u64* at = base + (size_t)(g >> lp) * stride * p + e;
        u64 x = g < n ? *at : 0ull;
        for (int jj = j; jj > 0; jj >>= 1) x = cx_shfl(x, e, jj, true);
        if (g < n) *at = x;
    }
    __syncthreads();
}

// The top pk keys (descending) of `nl_in` <= SCREEN_GROUP lists of pk keys
// at `in`, into region[0 .. pk).  tau, the largest m_keep-th key, bounds the
// answer from below, so only the lists whose first key reaches it take part
// (in any order: the keys are unique); they merge pairwise in a tree.
struct MergeScratch {
    int src[SCREEN_GROUP];
    int n_lists;
    u64 red[SCREEN_MAX_TPB / 32];
};

static __device__ void merge_lists(const u64* in, int nl_in, int m_keep, int pk, int lp,
                                   u64* region, MergeScratch& ms) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
    if (tid == 0) ms.n_lists = 0;
    u64 first = 0ull, tau = 0ull;
    if (tid < nl_in) {
        first = __ldcg(in + (size_t)tid * pk);
        tau = __ldcg(in + (size_t)tid * pk + m_keep - 1);
    }
    for (int o = 16; o > 0; o >>= 1) {
        const u64 y = __shfl_xor_sync(0xffffffffu, tau, o);
        tau = y > tau ? y : tau;
    }
    if (lane == 0) ms.red[warp] = tau;
    __syncthreads();
    tau = ms.red[0];
    for (int w = 1; w < nw; ++w) tau = ms.red[w] > tau ? ms.red[w] : tau;
    if (tid < nl_in && first >= tau) ms.src[atomicAdd(&ms.n_lists, 1)] = tid;
    __syncthreads();
    const int nl = ms.n_lists;
    for (int g = tid; g < nl * pk; g += blockDim.x) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(region + g);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(d), "l"(in + (size_t)ms.src[g >> lp] * pk + (g & (pk - 1))) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stage_wait();
    // lists 2*st*m and 2*st*m + st merge into the first
    for (int st = 1; st < nl; st <<= 1) {
        const int pairs = (nl - st + 2 * st - 1) / (2 * st);
        for (int g = tid; g < pairs * pk; g += blockDim.x) {
            u64* x = region + (size_t)(g >> lp) * 2 * st * pk;
            const int e = g & (pk - 1);
            const u64 y = x[(size_t)st * pk + pk - 1 - e];
            if (y > x[e]) x[e] = y;
        }
        __syncthreads();
        merge_desc(region, pairs, 2 * st, pk, lp);
    }
}

template <int K>
__global__ void __launch_bounds__(SCREEN_MAX_TPB, 1)
screen_topm_kernel(Screen p, const float* __restrict__ consts, int m_keep, int pk,
                   u64* __restrict__ lists, u64* __restrict__ group_lists,
                   unsigned* __restrict__ counter, unsigned* __restrict__ group_counter,
                   float* __restrict__ top_scores, int32_t* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float c[10];
    __shared__ float req[SCREEN_MAX_D];
    __shared__ int wc[SCREEN_MAX_TPB / 32];
    __shared__ MergeScratch ms;
    __shared__ int last;
    const ScreenArgs& a = p.a;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5, tpb = blockDim.x, nb = gridDim.x;
    const int lp = __ffs(pk) - 1;
    const size_t stage = 2 * stage_bytes(tpb, K, a.d), mb = (size_t)SCREEN_GROUP * pk * 8;
    u64* list = (u64*)(smem + (stage > mb ? stage : mb));   // this block's top-P, descending
    u64* buf = list + pk;                             // a tile's keys above its m_keep-th
    if (tid < 10) c[tid] = consts[tid];
    if (tid < a.d) req[tid] = a.req[tid];
    for (int g = tid; g < pk; g += tpb) list[g] = 0ull;   // below every real host
    const int tiles = (a.n + tpb - 1) / tpb;
    tile_first<K>(a, smem);
    for (int t = blockIdx.x, i = 0; t < tiles; t += nb, ++i) {
        const int h0 = t * tpb, cnt = min(tpb, a.n - h0);
        const Tile s = tile_next<K>(a, smem, t, i);
        u64 key = 0ull;
        if (tid < cnt) {
            const HostTerms ht = host_terms<K>(a, s, tid, h0 + tid, req);
            key = ((u64)enc_f(omega_ub(p, ht, c)) << 32)
                  | (u64)(0xffffffffu - (unsigned)(h0 + tid));
        }
        const bool pass = key > list[m_keep - 1];
        const unsigned bal = __ballot_sync(0xffffffffu, pass);
        if (lane == 0) wc[warp] = __popc(bal);
        __syncthreads();
        int off = 0, total = 0;
        for (int w = 0; w < nw; ++w) {
            const int x = wc[w];
            off += (w < warp) ? x : 0;
            total += x;
        }
        if (total == 0) continue;
        if (pass) buf[off + __popc(bal & ((1u << lane) - 1u))] = key;
        int q = 1;
        while (q < total) q <<= 1;
        for (int g = total + tid; g < q; g += tpb) buf[g] = 0ull;
        __syncthreads();
        sort_desc(buf, q);
        // max(list, reversed buf) is bitonic and holds the top P of both
        for (int g = tid; g < pk; g += tpb) {
            const int b = pk - 1 - g;
            const u64 y = (b < q) ? buf[b] : 0ull;
            if (y > list[g]) list[g] = y;
        }
        __syncthreads();
        merge_desc(list, 1, 1, pk, lp);
    }
    // two levels of merges: the last block of each group of SCREEN_GROUP
    // blocks merges the group's lists, the last group's the groups' lists
    for (int g = tid; g < pk; g += tpb) lists[(size_t)blockIdx.x * pk + g] = list[g];
    __threadfence();
    __syncthreads();
    const int groups = (nb + SCREEN_GROUP - 1) / SCREEN_GROUP, grp = blockIdx.x / SCREEN_GROUP;
    const int in_group = min(SCREEN_GROUP, nb - grp * SCREEN_GROUP);
    if (tid == 0) last = atomicAdd(&group_counter[grp], 1u) == (unsigned)in_group - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    u64* region = (u64*)smem;
    merge_lists(lists + (size_t)grp * SCREEN_GROUP * pk, in_group, m_keep, pk, lp, region, ms);
    if (tid == 0) group_counter[grp] = 0u;
    if (groups > 1) {
        for (int g = tid; g < pk; g += tpb) group_lists[(size_t)grp * pk + g] = region[g];
        __threadfence();
        __syncthreads();
        if (tid == 0) last = atomicAdd(counter, 1u) == (unsigned)groups - 1;
        __syncthreads();
        if (!last) return;
        __threadfence();
        merge_lists(group_lists, groups, m_keep, pk, lp, region, ms);
        if (tid == 0) *counter = 0u;
    }
    for (int g = tid; g < m_keep; g += tpb) {
        const u64 key = region[g];
        top_scores[g] = dec_f((unsigned)(key >> 32));
        top_idx[g] = (int32_t)(0xffffffffu - (unsigned)(key & 0xffffffffull));
    }
}

// ---- launches -----------------------------------------------------------------

static Screen plan_of(const ScreenArgs& a) {
    Screen p;
    p.a = a;
    const bool on[4] = {(a.gates & GATE_OVER) != 0, (a.gates & GATE_PACK) != 0,
                        (a.gates & GATE_STRAG) != 0, a.churn && (a.gates & GATE_CHURN) != 0};
    p.cnt = 0;
    for (int q = 0; q < 4; ++q)
        if (on[q]) p.q[p.cnt++] = q;
    for (int j = p.cnt; j < 4; ++j) p.q[j] = 0;
    return p;
}

template <int K>
static int consts_k(const Screen& p, int tpb, int blocks, void* partial, void* counter,
                    void* consts, cudaStream_t s) {
    const size_t smem = 2 * stage_bytes(tpb, K, p.a.d);
    cudaError_t err = cudaFuncSetAttribute(screen_consts_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    screen_consts_kernel<K><<<blocks, tpb, smem, s>>>(p, (float*)partial, (unsigned*)counter,
                                                      (float*)consts);
    return (int)cudaGetLastError();
}

template <int K>
static int topm_k(const Screen& p, const void* consts, int m_keep, int pk, int tpb, int blocks,
                  void* lists, void* group_lists, void* counter, void* group_counter,
                  void* top_scores, void* top_idx, cudaStream_t s) {
    const size_t sb = 2 * stage_bytes(tpb, K, p.a.d), mb = (size_t)SCREEN_GROUP * pk * 8;
    const size_t smem = (sb > mb ? sb : mb) + (size_t)(pk + tpb) * 8;
    cudaError_t err = cudaFuncSetAttribute(screen_topm_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    screen_topm_kernel<K><<<blocks, tpb, smem, s>>>(
        p, (const float*)consts, m_keep, pk, (u64*)lists, (u64*)group_lists, (unsigned*)counter,
        (unsigned*)group_counter, (float*)top_scores, (int32_t*)top_idx);
    return (int)cudaGetLastError();
}

#define SCREEN_SWITCH_K(k, CALL)                                                   \
    switch (k) {                                                                   \
        case 1: return CALL(1);  case 2: return CALL(2);   case 3: return CALL(3);   \
        case 4: return CALL(4);  case 5: return CALL(5);   case 6: return CALL(6);   \
        case 7: return CALL(7);  case 8: return CALL(8);   case 9: return CALL(9);   \
        case 10: return CALL(10); case 11: return CALL(11); case 12: return CALL(12); \
        default: return (int)cudaErrorInvalidValue;                                \
    }

// the geometry (threads a block, blocks) comes from the wrapper's _geometry;
// `counter` is a word that is 0 between launches (the last block resets it)
extern "C" int sched_screen_consts_launch(ScreenArgs a, int tpb, int blocks, void* partial,
                                          void* counter, void* consts, void* stream) {
    if (tpb > SCREEN_MAX_TPB || (tpb & 31) || a.d > SCREEN_MAX_D)
        return (int)cudaErrorInvalidValue;
    const Screen p = plan_of(a);
    const cudaStream_t s = (cudaStream_t)stream;
#define SCREEN_CONSTS(K) consts_k<K>(p, tpb, blocks, partial, counter, consts, s)
    SCREEN_SWITCH_K(a.k, SCREEN_CONSTS)
#undef SCREEN_CONSTS
}

// `pk`: m_keep rounded up to a power of two; `lists`: blocks x pk keys,
// `group_lists`: ceil(blocks / SCREEN_GROUP) x pk; `group_counter`: as many
// words as groups, 0 between launches as `counter` is
extern "C" int sched_screen_topm_launch(ScreenArgs a, const void* consts, int m_keep, int pk,
                                        int tpb, int blocks, void* lists, void* group_lists,
                                        void* counter, void* group_counter, void* top_scores,
                                        void* top_idx, void* stream) {
    if (tpb > SCREEN_MAX_TPB || (tpb & 31) || a.d > SCREEN_MAX_D
        || blocks > SCREEN_GROUP * SCREEN_GROUP || m_keep < 1 || m_keep > pk || (pk & (pk - 1)))
        return (int)cudaErrorInvalidValue;
    const Screen p = plan_of(a);
    const cudaStream_t s = (cudaStream_t)stream;
#define SCREEN_TOPM(K) topm_k<K>(p, consts, m_keep, pk, tpb, blocks, lists, group_lists, \
                                 counter, group_counter, top_scores, top_idx, s)
    SCREEN_SWITCH_K(a.k, SCREEN_TOPM)
#undef SCREEN_TOPM
}
