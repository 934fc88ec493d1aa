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
// f32: flash_fwd_f32_kernel, on the CUDA cores: f32 on wgmma would be TF32,
// and the f32 checks (the card against the CPU at 1e-4, the bitwise resume)
// need full f32.  Bound on this card: operations, 4*hd flops a kept pair at
// the f32 rate (67 TFLOP/s).  The f32 backward's tiling (f32_tiles.cuh):
//   * one block of 256 threads per (tile of B = 64 query rows, 32 at hd
//     256; q head), the heaviest causal tiles issued first; the Q tile stays
//     in shared memory and B-key tiles of K and V stream through a 2-stage
//     cp.async ring (zero fill past the ragged Skv), never past the block's
//     last row when causal; only diagonal and ragged tiles mask.  Shared
//     memory at hd 128: Q 32 KB, 2 stages of K and V 128 KB, P 16 KB;
//   * S = Q.K^T as a 4 x 4 register micro-tile a thread (2 x 2 at hd 256)
//     from float4 fragments of the swizzled tiles, 16 FFMA a fragment;
//   * online softmax per query row: the tile's row max over the 16 threads
//     that share the row (8 lanes by shuffles, then the two warps through
//     shared memory), p = expf(s - m_new), alpha = expf(m_old - m_new) in
//     full precision; each thread keeps its share of the row sum l, and the
//     shares meet once, at the end;
//   * P goes to shared memory once (by key row), then O += P.V as a
//     register-tiled outer product, a thread owning 4 x 8 of the 64 x 128
//     accumulator at hd 128, rescaled by alpha once a tile, summed over the
//     tile's keys in order.  No atomics: two calls give the same bits.
//
// Head dims 32, 64, 112, 128 and 256.  hd 112 (zamba2-7b) runs the hd-128
// tiling of either route over rows of 112 values: the bf16 route's tensor
// maps are 112 columns wide, so TMA fills the second slab's columns 112-127
// with zeros; the f32 route's cp.async loads zero-fill them; both products
// add exact zeros there, and only 112 columns are stored.
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

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: register-tiled FFMA on the CUDA cores, a cp.async ring
// ---------------------------------------------------------------------------
namespace f32 {

using namespace f32tile;

// Q [B][HD]; per stage K, V [B][HD]; P^T by key row [B][B]; per query row
// the two warps' shares of the tile's max (and, at the end, of l), and the
// tile's alpha
template <int HD>
constexpr int fwd_smem_bytes() {
    using C = Cfg<HD>;
    return static_cast<int>(sizeof(float)) * (5 * C::T + C::B * C::B + 3 * C::B);
}

template <int HD, int GHD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int rep, int sq, int skv, int causal, float scale) {
    using C = Cfg<HD>;
    constexpr int B = C::B, T = C::T, TS = C::TS;
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);
    float* kvs = qs + T;              // stage st: K at kvs + 2*st*T, V after it
    float* ps = kvs + 4 * T;          // P^T, [key][query]
    float* red = ps + B * B;          // [2][B]: a row's share from each of its two warps
    float* alph = red + 2 * B;        // [B]

    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * B;  // the last (heaviest, when causal) tiles first
    const int kv_end = causal ? min(skv, q0 + B) : skv;  // keys the block's rows see
    const int n_kt = (kv_end + B - 1) / B;
    const size_t qoff = (static_cast<size_t>(bh) * sq + q0) * GHD;
    const float* kh = k + static_cast<size_t>(bh / rep) * skv * GHD;
    const float* vh = v + static_cast<size_t>(bh / rep) * skv * GHD;

    load_tile<HD, GHD>(qs, q + qoff, sq - q0);
    auto load_kv = [&](int it) {
        const int st = it & 1, kv0 = it * B;
        load_tile<HD, GHD>(kvs + 2 * st * T, kh + static_cast<size_t>(kv0) * GHD, skv - kv0);
        load_tile<HD, GHD>(kvs + (2 * st + 1) * T, vh + static_cast<size_t>(kv0) * GHD, skv - kv0);
    };
    if (n_kt > 0) load_kv(0);
    cp_async_commit();
    if (n_kt > 1) load_kv(1);
    cp_async_commit();

    // score rows qg + 16i and keys kg + 16j; the 16 threads of a row are the
    // 8 lanes of equal lane >> 3 in each warp of a pair (warp ^ 1)
    const Place<HD> pl;
    const int qg = pl.own, kg = pl.str, r0 = pl.r0, cg = pl.cg;
    const int lane = threadIdx.x & 31, pair = (threadIdx.x >> 5) & 1;
    float m[TS], l[TS];               // the score rows' running max, this thread's share of l
#pragma unroll
    for (int i = 0; i < TS; ++i) {
        m[i] = kNegInf;
        l[i] = 0.0f;
    }
    float acc[C::TR][C::TC];
#pragma unroll
    for (int r = 0; r < C::TR; ++r)
#pragma unroll
        for (int c = 0; c < C::TC; ++c) acc[r][c] = 0.0f;

    for (int it = 0; it < n_kt; ++it) {
        const int st = it & 1, kv0 = it * B;
        cp_async_wait<1>();
        __syncthreads();
        const float* ks = kvs + 2 * st * T;
        const float* vs = ks + T;
        float s[TS][TS];
        scores<HD, TS, false>(qs, ks, nullptr, nullptr, qg, kg, s, s);  // S = Q.K^T
        const bool masked = (causal && kv0 + B - 1 > q0) || kv0 + B > skv;
#pragma unroll
        for (int i = 0; i < TS; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < TS; ++j) {
                float x = s[i][j] * scale;
                if (masked) {
                    const int key = kv0 + kg + 16 * j;
                    if (key >= skv) x = -INFINITY;                                // ragged tail: weight 0
                    else if (causal && key > q0 + qg + 16 * i) x = kNegInf;      // the TPU kernel's mask
                }
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            if ((lane & 7) == 0) red[pair * B + qg + 16 * i] = mx;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < TS; ++i) {
            const int row = qg + 16 * i;
            const float m_new = fmaxf(m[i], fmaxf(red[row], red[B + row]));
            const float alpha = expf(m[i] - m_new);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < TS; ++j) {
                const float p = expf(s[i][j] - m_new);
                ps[swz<B>(kg + 16 * j, row)] = p;
                sum += p;
            }
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
            if (kg == 0) alph[row] = alpha;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < C::TR; ++r) {
            const float alpha = alph[r0 + r];
#pragma unroll
            for (int c = 0; c < C::TC; ++c) acc[r][c] *= alpha;
        }
        accumulate<HD, false>(ps, vs, nullptr, nullptr, r0, cg, acc, acc);  // O += P.V
        __syncthreads();              // the stage, P and alpha are consumed
        if (it + 2 < n_kt) load_kv(it + 2);
        cp_async_commit();
    }
    cp_async_wait<0>();

    // a row's l: its 16 shares, by shuffles and then the pair of warps
#pragma unroll
    for (int i = 0; i < TS; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
        if ((lane & 7) == 0) red[pair * B + qg + 16 * i] = l[i];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < C::TR; ++r) {
        const float lc = fmaxf(red[r0 + r] + red[B + r0 + r], 1e-30f);
#pragma unroll
        for (int c = 0; c < C::TC; ++c) acc[r][c] /= lc;
    }
    store_rows<HD, GHD>(o + qoff, acc, r0, cg, sq - q0);
    if (kg == 0) {
#pragma unroll
        for (int i = 0; i < TS; ++i) {
            const int row = qg + 16 * i;
            if (q0 + row < sq)
                lse[static_cast<size_t>(bh) * sq + q0 + row] =
                    m[i] + logf(fmaxf(red[row] + red[B + row], 1e-30f));
        }
    }
}

// HD the tile's columns, GHD a row's in global memory (GHD < HD: zero padded)
template <int HD, int GHD = HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int bg,
           int sq, int skv, int causal, float scale, cudaStream_t stream) {
    constexpr int bytes = fwd_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<HD, GHD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(bh, (sq + Cfg<HD>::B - 1) / Cfg<HD>::B);
    flash_fwd_f32_kernel<HD, GHD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, bh / bg, sq, skv, causal, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

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

template <int HD, int GHD>
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
        __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * sq + row) * GHD;
#pragma unroll
        for (int j = 0; j < GHD / 8; ++j)  // columns past GHD hold the tile's zero padding
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c_lo) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] / lc, acc[4 * j + 2 * h + 1] / lc);
        if (lane % 4 == 0) lse[static_cast<size_t>(bh) * sq + row] = m[h] * kLn2 + logf(lc);
    }
}

// HD the tile's columns, GHD a row's in global memory: with GHD < HD the
// tensor maps have GHD columns, so TMA fills the tile's columns past GHD
// with zeros (the box still counts its full bytes), and only GHD are stored
template <int HD, int GHD = HD>
int launch(const void* q, const void* k, const void* v, __nv_bfloat16* o, float* lse, int bh,
           int bg, int sq, int skv, int causal, float scale, cudaStream_t stream) {
    using C = Cfg<HD>;
    static_assert(GHD <= HD && GHD % 8 == 0, "a row of GHD bf16 values, 16-byte strides");
    CUtensorMap tq, tk, tv;
    if (!encode_3d(&tq, q, GHD, sq, bh, C::SW, C::BM) || !encode_3d(&tk, k, GHD, skv, bg, C::SW, C::BN) ||
        !encode_3d(&tv, v, GHD, skv, bg, C::SW, C::BN))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD, GHD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(bh, (sq + C::BM - 1) / C::BM);
    flash_fwd_wgmma_kernel<HD, GHD><<<grid, kThreads, C::SMEM, stream>>>(
        tq, tk, tv, o, lse, bh / bg, sq, skv, causal, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

extern "C" int flash_attention_fwd_f32_launch(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int bh, int bg, int sq,
                                              int skv, int hd, int causal, float scale,
                                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* lsep = static_cast<float*>(lse);
    switch (hd) {
        case 32: return f32::launch<32>(q, k, v, o, lsep, bh, bg, sq, skv, causal, scale, s);
        case 64: return f32::launch<64>(q, k, v, o, lsep, bh, bg, sq, skv, causal, scale, s);
        case 112: return f32::launch<128, 112>(q, k, v, o, lsep, bh, bg, sq, skv, causal, scale, s);
        case 128: return f32::launch<128>(q, k, v, o, lsep, bh, bg, sq, skv, causal, scale, s);
        case 256: return f32::launch<256>(q, k, v, o, lsep, bh, bg, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
        case 112: return wg::launch<128, 112>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        case 128: return wg::launch<128>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        case 256: return wg::launch<256>(q, k, v, op, lsep, bh, bg, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
