// Flash-attention forward (causal or full, grouped-query) for NVIDIA Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fwd_kernel (via _flash_fwd).
//
//   q (B*H, Sq, hd), k/v (B*G, Skv, hd); o (B*H, Sq, hd) in q's type,
//   lse (B*H, Sq) f32.  Row b*H + h of q reads KV row (b*H + h) / (H/G).
//
// Two routes, picked by the inputs' type before launch (neither falls back
// to the other):
//
// bf16: flash_fwd_wgmma_kernel.  Bound on this card: operations, 4*hd flops
// per (query, key) pair that the mask keeps, on the bf16 tensor cores
// (989 TFLOP/s), against about 4*hd bytes per query row moved.  So both
// products run on wgmma and every tile arrives by TMA:
//   * one block owns 128 query rows of one head: two consumer warpgroups of
//     64 rows each and a producer warpgroup, one thread of which issues the
//     copies (registers moved to the consumers by setmaxnreg; one block an
//     SM);
//   * the producer loads the Q tile once and keeps a ring of 2 K/V stages in
//     flight (TMA, 128-byte swizzle; 64-byte for hd 32), BN = 128 keys a
//     tile (64 for hd 256), so Q and two stages fit: 32 + 128 KB at hd 128,
//     64 + 128 KB at hd 256;
//   * a consumer computes S = Q.K^T by wgmma (bf16 operands, f32
//     accumulators in registers), runs the online softmax on the
//     accumulator fragment in base 2 (scores pre-scaled by scale*log2(e)),
//     rounds P to bf16 in registers and feeds it as wgmma's A operand of
//     O += P.V, V read MN-major from shared memory; then frees the stage;
//   * with causal, key tiles past a block's last row are never loaded, a
//     warpgroup skips tiles wholly above its rows, only tiles that cross the
//     diagonal or the ragged Skv are masked, and the grid issues the last
//     (heaviest) query tiles first.
// f32: flash_fwd_kernel, on the CUDA cores: f32 on wgmma would be TF32, and
// the f32 checks (the card against the CPU at 1e-4, the bitwise resume)
// need full f32.  A block owns 32 query rows and loops over 32-key tiles
// staged in shared memory; a lane scores one key.
//
// Semantics of the TPU kernel, both routes: masked scores are -1e30 (not
// -inf); keys past a ragged Skv weigh exactly 0; o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)) in f32; causal masking compares absolute
// positions counted from 0 for q and k.  The TPU kernel halves its block
// sizes until they divide S; these kernels mask the ragged tails instead.
//
// C interface (loaded with ctypes); returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 32;        // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;
constexpr float kNegInf = -1e30f;

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

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int rep, int sq, int skv, int causal, float scale) {
    constexpr int C = HD / 32;  // acc values per lane
    extern __shared__ float smem[];
    float* qs = smem;                         // [kBQ][HD]
    float* ks = qs + kBQ * HD;                // [kBK][HD + 1]
    float* vs = ks + kBK * (HD + 1);          // [kBK][HD]

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * kBQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* qh = q + static_cast<size_t>(bh) * sq * HD;
    const float* kh = k + static_cast<size_t>(bh / rep) * skv * HD;
    const float* vh = v + static_cast<size_t>(bh / rep) * skv * HD;

    for (int i = threadIdx.x; i < kBQ * HD; i += blockDim.x) {
        const int r = i / HD;
        qs[i] = (q0 + r < sq) ? qh[static_cast<size_t>(q0) * HD + i] : 0.0f;
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
            ks[j * (HD + 1) + d] = in ? kh[g] : 0.0f;
            vs[i] = in ? vh[g] : 0.0f;
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
        float* orow = o + (static_cast<size_t>(bh) * sq + row) * HD;
#pragma unroll
        for (int c = 0; c < C; ++c) orow[lane + 32 * c] = acc[i][c] / lc;
        if (lane == 0) lse[static_cast<size_t>(bh) * sq + row] = m[i] + logf(lc);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int rep, int sq, int skv, int causal, float scale, cudaStream_t stream) {
    constexpr size_t bytes = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kBQ - 1) / kBQ, bh);
    flash_fwd_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, rep, sq, skv, causal, scale);
    return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
             int rep, int sq, int skv, int hd, int causal, float scale, cudaStream_t s) {
    switch (hd) {
        case 32: return launch<32>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        case 64: return launch<64>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        case 128: return launch<128>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        case 256: return launch<256>(q, k, v, o, lse, bh, rep, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2

template <int HD>
struct Cfg {
    static constexpr int SW = HD == 32 ? 32 : 64;  // columns of a swizzled slab row
    static constexpr int SWB = 2 * SW;             // its bytes: the swizzle span
    static constexpr int NSLAB = HD / SW;
    static constexpr int BM = 128;                 // query rows a block
    static constexpr int BN = HD == 256 ? 64 : 128;  // keys a tile
    static constexpr int STAGES = 2;
    static constexpr int Q_SLAB = BM * SWB;
    static constexpr int KV_SLAB = BN * SWB;
    static constexpr int Q_BYTES = BM * HD * 2;
    static constexpr int KV_BYTES = BN * HD * 2;   // K, or V, of one stage
    static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 64 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int rep, int sq, int skv, int causal,
                       float scale_log2) {
    using C = Cfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* qs = align_1024(smem_raw);
    uint8_t* kvs = qs + C::Q_BYTES;  // stage st: K at kvs + 2*st*KV_BYTES, V after it
    uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + 2 * C::STAGES * C::KV_BYTES);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + C::STAGES;

    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // the last query tiles first
    const int kv_end = causal ? min(skv, q0 + C::BM) : skv;  // keys the block's rows see
    const int n_kt = (kv_end + C::BN - 1) / C::BN;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int st = 0; st < C::STAGES; ++st) {
            mbar_init(&full[st], 1);
            mbar_init(&empty[st], 256);  // every consumer thread frees the stage
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wgi = threadIdx.x / 128;
    if (wgi == 2) {  // the producer warpgroup: one thread issues every copy
        producer_registers();
        if (threadIdx.x == 256) {
            mbar_expect_tx(q_full, C::Q_BYTES);
            for (int s = 0; s < C::NSLAB; ++s)
                tma_load_3d(qs + s * C::Q_SLAB, &tq, q_full, s * C::SW, q0, bh);
            for (int it = 0; it < n_kt; ++it) {
                const int st = it % C::STAGES;
                if (it >= C::STAGES) mbar_wait(&empty[st], (it / C::STAGES - 1) & 1);
                uint8_t* ks = kvs + 2 * st * C::KV_BYTES;
                mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
                for (int s = 0; s < C::NSLAB; ++s) {
                    tma_load_3d(ks + s * C::KV_SLAB, &tk, &full[st], s * C::SW, it * C::BN, bh / rep);
                    tma_load_3d(ks + C::KV_BYTES + s * C::KV_SLAB, &tv, &full[st], s * C::SW,
                                it * C::BN, bh / rep);
                }
            }
        }
        return;
    }
    consumer_registers();

    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + wgi * 64;                // this warpgroup's first query row
    const int r_lo = warp * 16 + lane / 4;         // fragment rows r_lo, r_lo + 8
    const int c_lo = 2 * (lane % 4);               // fragment columns 8j + c_lo, + 1
    const int wg_kv_end = causal ? min(skv, row0 + 64) : skv;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kt; ++it) {
        const int st = it % C::STAGES;
        const int kv0 = it * C::BN;
        mbar_wait(&full[st], (it / C::STAGES) & 1);
        if (kv0 < wg_kv_end) {  // else every key of the tile lies above these rows
            const uint8_t* ks = kvs + 2 * st * C::KV_BYTES;
            const uint8_t* vs = ks + C::KV_BYTES;
            float s[C::BN / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const int slab = kk / (C::SW / 16), in_row = 32 * (kk % (C::SW / 16));
                const uint64_t da = desc<C::SWB>(qs + slab * C::Q_SLAB + wgi * 64 * C::SWB + in_row,
                                                 16, 8 * C::SWB);
                const uint64_t db = desc<C::SWB>(ks + slab * C::KV_SLAB + in_row, 16, 8 * C::SWB);
                wgmma_ss<C::BN>(s, da, db, kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(s);

            const bool masked = (causal && kv0 + C::BN - 1 > row0) || kv0 + C::BN > skv;
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int i = 0; i < C::BN / 2; ++i) {
                float x = s[i] * scale_log2;
                if (masked) {
                    const int key = kv0 + 8 * (i / 4) + c_lo + (i & 1);
                    const int row = row0 + r_lo + 8 * ((i >> 1) & 1);
                    if (key >= skv) x = -INFINITY;                 // ragged tail: weight 0
                    else if (causal && key > row) x = kNegInf;     // the TPU kernel's mask
                }
                s[i] = x;
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
            }
            float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                alpha[h] = exp2f(m[h] - mx[h]);
                m[h] = mx[h];
            }
#pragma unroll
            for (int i = 0; i < C::BN / 2; ++i) {
                const float p = exp2f(s[i] - m[(i >> 1) & 1]);
                s[i] = p;
                sum[(i >> 1) & 1] += p;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];  // this lane's share
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

            uint32_t pa[C::BN / 16][4];  // P in bf16, the A operand (written before the fence)
#pragma unroll
            for (int kk = 0; kk < C::BN / 16; ++kk) acc_to_a(s, kk, pa[kk]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::BN / 16; ++kk)
                wgmma_rs<HD>(acc, pa[kk], desc<C::SWB>(vs + kk * 16 * C::SWB, C::KV_SLAB, 8 * C::SWB));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
        }
        mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int row = row0 + r_lo + 8 * h;
        if (row >= sq) continue;
        const float lc = fmaxf(l[h], 1e-30f);
        __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * sq + row) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c_lo) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] / lc, acc[4 * j + 2 * h + 1] / lc);
        if (lane % 4 == 0) lse[static_cast<size_t>(bh) * sq + row] = m[h] * kLn2 + logf(lc);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, __nv_bfloat16* o, float* lse, int bh,
           int bg, int sq, int skv, int causal, float scale, cudaStream_t stream) {
    using C = Cfg<HD>;
    CUtensorMap tq, tk, tv;
    if (!encode_3d(&tq, q, HD, sq, bh, C::SW, C::BM) || !encode_3d(&tk, k, HD, skv, bg, C::SW, C::BN) ||
        !encode_3d(&tv, v, HD, skv, bg, C::SW, C::BN))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(bh, (sq + C::BM - 1) / C::BM);
    flash_fwd_wgmma_kernel<HD><<<grid, kThreads, C::SMEM, stream>>>(
        tq, tk, tv, o, lse, bh / bg, sq, skv, causal, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

extern "C" int flash_attention_fwd_f32_launch(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int bh, int bg, int sq,
                                              int skv, int hd, int causal, float scale,
                                              void* stream) {
    return dispatch(q, k, v, o, static_cast<float*>(lse), bh, bh / bg, sq, skv, hd,
                           causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int bh, int bg, int sq,
                                               int skv, int hd, int causal, float scale,
                                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* lsep = static_cast<float*>(lse);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
    switch (hd) {
        case 32: return wg::launch<32>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        case 64: return wg::launch<64>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        case 128: return wg::launch<128>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        case 256: return wg::launch<256>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
