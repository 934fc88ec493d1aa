// Flash-attention backward (causal or full, grouped-query) for NVIDIA Hopper
// (sm_90a).  Replaces the two Pallas TPU kernels of
// src/repro/kernels/flash_attention.py::_flash_bwd:
//   * _dq_kernel  -> flash_bwd_dq_wgmma_kernel (bf16), flash_bwd_dq_kernel
//                    (f32): dq = sum over KV tiles of ds.k
//   * _dkv_kernel -> flash_bwd_dkv_wgmma_kernel + flash_bwd_dkv_reduce_kernel
//                    (bf16), flash_bwd_dkv_kernel (f32): dv = sum p^T.do,
//                    dk = sum ds^T.q over the rep grouped heads and every q
//                    tile
//
//   q, do (B*H, Sq, hd), k/v (B*G, Skv, hd); lse, delta (B*H, Sq) f32
//   (delta = rowsum(do*o), formed by the caller); dq in q's type, dk/dv
//   (B*G, Skv, hd) in k's type.  Row b*H + h of q reads KV row
//   (b*H + h) / rep, rep = H/G.
//
// Every kernel recomputes p = exp(s*scale - lse) from the saved lse, as the
// TPU kernels do, and forms ds = p * (do.v^T - delta) * scale.  Masked
// pairs (causal, or past a ragged Sq) get p = 0 exactly, as the TPU
// kernel's -1e30 scores do after exp.
//
// The TPU grid runs in order and carries dq (or dk, dv) in VMEM scratch
// along its innermost axis.  Hopper blocks run in any order, so each block
// owns its output tile and loops over the other axis itself, and no block
// writes another's rows: no atomics, so the gradients are the same bits on
// every run (a preempted training run resumes bit-exactly).
//
// Bound on this card: operations.  dq does 3 products of 2*hd flops per
// kept (query, key) pair (s, dp, ds.k), dk/dv 4 (s, dp, p^T.do, ds^T.q), on
// the bf16 tensor cores (989 TFLOP/s).  The bf16 kernels run every product
// on wgmma and stream their tiles by TMA; the f32 kernels stay on the CUDA
// cores, since f32 on wgmma would be TF32 and the f32 checks (the card
// against the CPU, the bitwise resume) need full f32.
//
// dq, bf16 (flash_bwd_dq_wgmma_kernel): the forward kernel's shape with a
// second score product and no online softmax.
//   * One block per (128-query tile, q head): at qwen2's training shape 768
//     blocks, the last (heaviest, when causal) query tiles issued first.
//     Two consumer warpgroups own 64 query rows each, with their dQ in f32
//     registers; a producer warpgroup, one thread of which loads (registers
//     moved to the consumers by setmaxnreg).
//   * The producer loads the block's Q and dO once and streams 64-key tiles
//     of K and V through a ring of 2 stages (TMA, 128-byte swizzle; 64-byte
//     at hd 32), stopping at the diagonal when causal.  Each consumer
//     thread holds lse*log2 e and delta of its two fragment rows in
//     registers.
//   * A consumer computes S = Q.K^T and dP = dO.V^T (wgmma, A and B from
//     shared memory, K-major), P = exp2(S*scale*log2 e - lse*log2 e) and
//     dS = P * (dP - delta) * scale on the accumulator fragments (masking
//     only diagonal or ragged tiles), then dQ += dS.K with dS rounded to
//     bf16 as the register A operand, K read MN-major; dQ is cast to bf16
//     once, at the end.  Tiles wholly above a warpgroup's rows are skipped.
//   * Registers at hd <= 128: dQ (hd/2) + S and dP (32 each) + dS (16) f32
//     or packed values a thread.  hd 256: dQ of 64 rows would be 128 values,
//     so the block takes 64 query rows and its two warpgroups split the head
//     dim: each computes S and dP for all 64 rows (the two score products
//     repeated, paid only at hd 256) and accumulates its 128 columns of dQ.
//   * Each block owns its rows of dq: no atomics, no partials.
//
// dk/dv, bf16 (flash_bwd_dkv_wgmma_kernel): all four products on wgmma, the
// streamed tiles by TMA.
//   * One block per (128-key tile, q head): at qwen2's training shape 768
//     blocks, the heaviest (key tile 0, causal) walking 4,096 queries of one
//     head, 1/6 of what the f32 kernel's heaviest walks over the 6 grouped
//     heads; the grid issues the low (heaviest) key tiles first.  Two
//     consumer warpgroups own 64 keys each, with their dK and dV in f32
//     registers; a producer warpgroup, one warp of which loads (registers
//     moved to the consumers by setmaxnreg).
//   * The producer loads the block's K and V once and streams 64-row tiles
//     of Q and dO (TMA, 128-byte swizzle; 64-byte at hd 32), with their lse
//     (times log2 e) and delta, through a ring of 2 stages, from the
//     diagonal on when causal.
//   * A consumer computes S^T = K.Q^T and dP^T = V.dO^T (wgmma, A and B from
//     shared memory), P^T = exp2(S^T*scale*log2 e - lse*log2 e) and
//     dS^T = P^T * (dP^T - delta) * scale on the accumulator fragments,
//     then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T rounded to bf16
//     as register A operands, dO and Q read MN-major.
//   * hd 256: dK and dV of 64 keys would need 256 f32 registers a thread.
//     The block takes 64 keys instead, and its two warpgroups split the head
//     dim: each computes S^T and dP^T for all 64 keys and accumulates its
//     128 columns of dK and dV.  That repeats the two score products (6
//     products for 4), paid only at hd 256, and keeps the registers of hd
//     128 with no shared-memory accumulator.
//   * Each block writes f32 partials of its q head; the reduce kernel sums
//     the rep heads of a group in head order and casts to k's type.
//
// f32 dk/dv (flash_bwd_dkv_kernel): one block per (32-key tile, KV head);
// eight warps own 4 keys each; the block walks the rep grouped heads and,
// for each, the q tiles that can see its keys, staging q, do, lse and
// delta; a lane scores one query row against the warp's key.
// f32 dq (flash_bwd_dq_kernel): one block per (32-query tile, head).  Four
// warps own 8 query rows each, with the rows' dq in registers (hd/32
// values a lane).  The block stages each tile of 32 keys and values in
// shared memory (row stride hd+1: 32 lanes reading 32 keys hit 32 banks);
// a lane scores one key, and ds.k broadcasts each lane's ds over the warp.
// Causal tiles wholly above the block's last row are never loaded.
//
// C interface (loaded with ctypes); each entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 32;       // queries per dq tile, keys per dk/dv tile
constexpr int kDqWarps = 4;
constexpr int kDqRows = kTile / kDqWarps;
constexpr int kDkvWarps = 8;
constexpr int kDkvKeys = kTile / kDkvWarps;

// dq, f32: q, do [kTile][HD] (broadcast reads); k, v [kTile][HD + 1]
template <int HD>
constexpr size_t dq_smem_bytes() {
    return sizeof(float) * (2 * kTile * HD + 2 * kTile * (HD + 1));
}

template <int HD>
__global__ void __launch_bounds__(kDqWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int rep, int sq, int skv, int causal, float scale) {
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
        qs[i] = in ? q[g] : 0.0f;
        dos[i] = in ? dout[g] : 0.0f;
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
            ks[j * (HD + 1) + d] = in ? k[g] : 0.0f;
            vs[j * (HD + 1) + d] = in ? v[g] : 0.0f;
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
        float* out = dq + qoff + static_cast<size_t>(row) * HD;
#pragma unroll
        for (int c = 0; c < C; ++c) out[lane + 32 * c] = acc[i][c];
    }
}

// dk/dv: k, v [kTile][HD] (broadcast reads); q, do [kTile][HD + 1]; lse, delta [kTile]
template <int HD>
constexpr size_t dkv_smem_bytes() {
    return sizeof(float) * (2 * kTile * HD + 2 * kTile * (HD + 1) + 2 * kTile);
}

template <int HD>
__global__ void __launch_bounds__(kDkvWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int rep, int sq, int skv,
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
        ks[i] = in ? k[g] : 0.0f;
        vs[i] = in ? v[g] : 0.0f;
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
                qs[rr * (HD + 1) + d] = in ? q[g] : 0.0f;
                dos[rr * (HD + 1) + d] = in ? dout[g] : 0.0f;
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
            dk[at + lane + 32 * c] = dk_acc[jj][c];
            dv[at + lane + 32 * c] = dv_acc[jj][c];
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

template <int HD>
int launch_dq(const Args& a, void* dq, int bh) {
    constexpr size_t bytes = dq_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + kTile - 1) / kTile, bh);
    flash_bwd_dq_kernel<HD><<<grid, kDqWarps * 32, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dq), a.rep, a.sq, a.skv, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const Args& a, void* dk, void* dv, int bg) {
    constexpr size_t bytes = dkv_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.skv + kTile - 1) / kTile, bg);
    flash_bwd_dkv_kernel<HD><<<grid, kDkvWarps * 32, bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dk), static_cast<float*>(dv), a.rep, a.sq, a.skv, a.causal,
        a.scale);
    return static_cast<int>(cudaGetLastError());
}

int dispatch_dq(const Args& a, void* dq, int bh, int hd) {
    switch (hd) {
        case 32: return launch_dq<32>(a, dq, bh);
        case 64: return launch_dq<64>(a, dq, bh);
        case 128: return launch_dq<128>(a, dq, bh);
        case 256: return launch_dq<256>(a, dq, bh);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int dispatch_dkv(const Args& a, void* dk, void* dv, int bg, int hd) {
    switch (hd) {
        case 32: return launch_dkv<32>(a, dk, dv, bg);
        case 64: return launch_dkv<64>(a, dk, dv, bg);
        case 128: return launch_dkv<128>(a, dk, dv, bg);
        case 256: return launch_dkv<256>(a, dk, dv, bg);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// dk/dv, bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2

template <int HD>
struct Cfg {
    static constexpr int SW = HD == 32 ? 32 : 64;  // columns of a swizzled slab row
    static constexpr int SWB = 2 * SW;
    static constexpr int NSLAB = HD / SW;
    static constexpr int SPLIT = HD == 256 ? 2 : 1;  // warpgroups sharing one set of keys
    static constexpr int BN = 128 / SPLIT;           // keys a block
    static constexpr int NC = HD / SPLIT;            // dK, dV columns a warpgroup
    static constexpr int BM = 64;                    // query rows a streamed tile
    static constexpr int STAGES = 2;
    static constexpr int KV_SLAB = BN * SWB;
    static constexpr int Q_SLAB = BM * SWB;
    static constexpr int KV_BYTES = BN * HD * 2;     // K, or V
    static constexpr int Q_BYTES = BM * HD * 2;      // Q, or dO, of one stage
    // K, V, then per stage Q and dO, then per stage lse and delta (f32)
    static constexpr int ROWS_OFF = 2 * KV_BYTES + 2 * STAGES * Q_BYTES;
    static constexpr int SMEM = ROWS_OFF + 2 * STAGES * BM * 4 + 64 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk_part, float* __restrict__ dv_part, int rep,
                           int sq, int skv, int causal, float scale) {
    using C = Cfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ks = align_1024(smem_raw);
    uint8_t* vs = ks + C::KV_BYTES;
    uint8_t* qdo = vs + C::KV_BYTES;  // stage st: Q at qdo + 2*st*Q_BYTES, dO after it
    float* rows = reinterpret_cast<float*>(ks + C::ROWS_OFF);  // stage st: lse2, delta
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows + 2 * C::STAGES * C::BM);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + C::STAGES;

    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * C::BN;  // the low (heaviest, when causal) key tiles first
    // with the causal mask, query rows before k0 see none of these keys
    // (k0 is a multiple of the q tile's height)
    const int q_begin = causal ? k0 : 0;
    const int n_qt = q_begin < sq ? (sq - q_begin + C::BM - 1) / C::BM : 0;

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int st = 0; st < C::STAGES; ++st) {
            mbar_init(&full[st], 1);
            mbar_init(&empty[st], 256);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wgi = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    if (wgi == 2) {  // the producer warpgroup: its first warp loads
        producer_registers();
        if (threadIdx.x >= 288) return;
        if (lane == 0) {
            mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
            for (int s = 0; s < C::NSLAB; ++s) {
                tma_load_3d(ks + s * C::KV_SLAB, &tk, kv_full, s * C::SW, k0, bh / rep);
                tma_load_3d(vs + s * C::KV_SLAB, &tv, kv_full, s * C::SW, k0, bh / rep);
            }
        }
        for (int it = 0; it < n_qt; ++it) {
            const int st = it % C::STAGES, q0 = q_begin + it * C::BM;
            if (it >= C::STAGES) mbar_wait(&empty[st], (it / C::STAGES - 1) & 1);
            float* lse2 = rows + 2 * st * C::BM;
            for (int i = lane; i < C::BM; i += 32) {  // rows past Sq are masked: any value
                const size_t at = static_cast<size_t>(bh) * sq + q0 + i;
                lse2[i] = q0 + i < sq ? lse[at] * kLog2e : 0.0f;
                lse2[C::BM + i] = q0 + i < sq ? delta[at] : 0.0f;
            }
            __threadfence_block();
            __syncwarp();
            if (lane == 0) {
                uint8_t* qs = qdo + 2 * st * C::Q_BYTES;
                mbar_expect_tx(&full[st], 2 * C::Q_BYTES);
                for (int s = 0; s < C::NSLAB; ++s) {
                    tma_load_3d(qs + s * C::Q_SLAB, &tq, &full[st], s * C::SW, q0, bh);
                    tma_load_3d(qs + C::Q_BYTES + s * C::Q_SLAB, &tdo, &full[st], s * C::SW, q0, bh);
                }
            }
        }
        return;
    }
    consumer_registers();

    const int t = threadIdx.x % 128, warp = t / 32;
    const int koff = C::SPLIT == 1 ? wgi * 64 : 0;    // this warpgroup's keys in the block
    const int coff = C::SPLIT == 1 ? 0 : wgi * C::NC;  // and its columns of dK, dV
    const int kfirst = k0 + koff;
    const int r_lo = warp * 16 + lane / 4;  // fragment rows (keys) r_lo, r_lo + 8
    const int c_lo = 2 * (lane % 4);        // fragment columns (queries) 8j + c_lo, + 1
    const float scale_log2 = scale * kLog2e;
    float dk[C::NC / 2], dv[C::NC / 2];
#pragma unroll
    for (int i = 0; i < C::NC / 2; ++i) dk[i] = dv[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_qt; ++it) {
        const int st = it % C::STAGES, q0 = q_begin + it * C::BM;
        mbar_wait(&full[st], (it / C::STAGES) & 1);
        if (!causal || q0 + C::BM - 1 >= kfirst) {  // else every query lies before these keys
            const uint8_t* qs = qdo + 2 * st * C::Q_BYTES;
            const uint8_t* dos = qs + C::Q_BYTES;
            const float* lse2 = rows + 2 * st * C::BM;
            const float* dlt = lse2 + C::BM;
            float s[32], dp[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const int slab = kk / (C::SW / 16), in_row = 32 * (kk % (C::SW / 16));
                const int a_off = slab * C::KV_SLAB + koff * C::SWB + in_row;
                const int b_off = slab * C::Q_SLAB + in_row;
                wgmma_ss<64>(s, desc<C::SWB>(ks + a_off, 16, 8 * C::SWB),
                             desc<C::SWB>(qs + b_off, 16, 8 * C::SWB), kk > 0);
                wgmma_ss<64>(dp, desc<C::SWB>(vs + a_off, 16, 8 * C::SWB),
                             desc<C::SWB>(dos + b_off, 16, 8 * C::SWB), kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(s);
            fence_regs(dp);

            const bool masked = (causal && q0 < kfirst + 63) || q0 + C::BM > sq;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int col = 8 * (i / 4) + c_lo + (i & 1);  // query q0 + col
                float p = exp2f(s[i] * scale_log2 - lse2[col]);
                if (masked) {
                    const int key = kfirst + r_lo + 8 * ((i >> 1) & 1);
                    if (q0 + col >= sq || (causal && key > q0 + col)) p = 0.0f;
                }
                s[i] = p;
                dp[i] = p * (dp[i] - dlt[col]) * scale;
            }

            uint32_t pa[C::BM / 16][4], da[C::BM / 16][4];  // P^T, dS^T in bf16, before the fence
#pragma unroll
            for (int kk = 0; kk < C::BM / 16; ++kk) {
                acc_to_a(s, kk, pa[kk]);
                acc_to_a(dp, kk, da[kk]);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::BM / 16; ++kk) {
                const int b_off = (coff / C::SW) * C::Q_SLAB + kk * 16 * C::SWB;
                wgmma_rs<C::NC>(dv, pa[kk], desc<C::SWB>(dos + b_off, C::Q_SLAB, 8 * C::SWB));
                wgmma_rs<C::NC>(dk, da[kk], desc<C::SWB>(qs + b_off, C::Q_SLAB, 8 * C::SWB));
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(dk);
            fence_regs(dv);
        }
        mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int key = kfirst + r_lo + 8 * h;
        if (key >= skv) continue;
        const size_t at = (static_cast<size_t>(bh) * skv + key) * HD + coff + c_lo;
#pragma unroll
        for (int j = 0; j < C::NC / 8; ++j) {
            *reinterpret_cast<float2*>(dk_part + at + 8 * j) = make_float2(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
            *reinterpret_cast<float2*>(dv_part + at + 8 * j) = make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// dq, bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------
template <int HD>
struct DqCfg {
    static constexpr int SW = HD == 32 ? 32 : 64;  // columns of a swizzled slab row
    static constexpr int SWB = 2 * SW;
    static constexpr int NSLAB = HD / SW;
    static constexpr int SPLIT = HD == 256 ? 2 : 1;  // warpgroups sharing one set of rows
    static constexpr int BM = 128 / SPLIT;           // query rows a block
    static constexpr int NC = HD / SPLIT;            // dQ columns a warpgroup
    static constexpr int BN = 64;                    // keys a streamed tile
    static constexpr int STAGES = 2;
    static constexpr int Q_SLAB = BM * SWB;
    static constexpr int KV_SLAB = BN * SWB;
    static constexpr int Q_BYTES = BM * HD * 2;      // Q, or dO
    static constexpr int KV_BYTES = BN * HD * 2;     // K, or V, of one stage
    static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 64 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int rep, int sq, int skv, int causal,
                          float scale) {
    using C = DqCfg<HD>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* qs = align_1024(smem_raw);
    uint8_t* dos = qs + C::Q_BYTES;
    uint8_t* kvs = dos + C::Q_BYTES;  // stage st: K at kvs + 2*st*KV_BYTES, V after it
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
            mbar_expect_tx(q_full, 2 * C::Q_BYTES);
            for (int s = 0; s < C::NSLAB; ++s) {
                tma_load_3d(qs + s * C::Q_SLAB, &tq, q_full, s * C::SW, q0, bh);
                tma_load_3d(dos + s * C::Q_SLAB, &tdo, q_full, s * C::SW, q0, bh);
            }
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
    const int roff = C::SPLIT == 1 ? wgi * 64 : 0;    // this warpgroup's rows in the block
    const int coff = C::SPLIT == 1 ? 0 : wgi * C::NC;  // and its columns of dQ
    const int row0 = q0 + roff;
    const int r_lo = warp * 16 + lane / 4;  // fragment rows r_lo, r_lo + 8
    const int c_lo = 2 * (lane % 4);        // fragment columns (keys) 8j + c_lo, + 1
    const int wg_kv_end = causal ? min(skv, row0 + 64) : skv;
    const float scale_log2 = scale * kLog2e;
    // lse (times log2 e) and delta of the two fragment rows; rows past Sq
    // read zeros and are never stored
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_lo + 8 * h;
        const size_t at = static_cast<size_t>(bh) * sq + row;
        lse2[h] = row < sq ? lse[at] * kLog2e : 0.0f;
        dlt[h] = row < sq ? delta[at] : 0.0f;
    }
    float acc[C::NC / 2];
#pragma unroll
    for (int i = 0; i < C::NC / 2; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kt; ++it) {
        const int st = it % C::STAGES;
        const int kv0 = it * C::BN;
        mbar_wait(&full[st], (it / C::STAGES) & 1);
        if (kv0 < wg_kv_end) {  // else every key of the tile lies above these rows
            const uint8_t* ks = kvs + 2 * st * C::KV_BYTES;
            const uint8_t* vs = ks + C::KV_BYTES;
            float s[C::BN / 2], dp[C::BN / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const int slab = kk / (C::SW / 16), in_row = 32 * (kk % (C::SW / 16));
                const int a_off = slab * C::Q_SLAB + roff * C::SWB + in_row;
                const int b_off = slab * C::KV_SLAB + in_row;
                wgmma_ss<C::BN>(s, desc<C::SWB>(qs + a_off, 16, 8 * C::SWB),
                                desc<C::SWB>(ks + b_off, 16, 8 * C::SWB), kk > 0);
                wgmma_ss<C::BN>(dp, desc<C::SWB>(dos + a_off, 16, 8 * C::SWB),
                                desc<C::SWB>(vs + b_off, 16, 8 * C::SWB), kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(s);
            fence_regs(dp);

            const bool masked = (causal && kv0 + C::BN - 1 > row0) || kv0 + C::BN > skv;
#pragma unroll
            for (int i = 0; i < C::BN / 2; ++i) {
                const int h = (i >> 1) & 1;
                float p = exp2f(s[i] * scale_log2 - lse2[h]);
                if (masked) {
                    const int key = kv0 + 8 * (i / 4) + c_lo + (i & 1);
                    if (key >= skv || (causal && key > row0 + r_lo + 8 * h)) p = 0.0f;
                }
                dp[i] = p * (dp[i] - dlt[h]) * scale;
            }

            uint32_t da[C::BN / 16][4];  // dS in bf16, the A operand (written before the fence)
#pragma unroll
            for (int kk = 0; kk < C::BN / 16; ++kk) acc_to_a(dp, kk, da[kk]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::BN / 16; ++kk) {
                const int b_off = (coff / C::SW) * C::KV_SLAB + kk * 16 * C::SWB;
                wgmma_rs<C::NC>(acc, da[kk], desc<C::SWB>(ks + b_off, C::KV_SLAB, 8 * C::SWB));
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
        }
        mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_lo + 8 * h;
        if (row >= sq) continue;
        __nv_bfloat16* out = dq + (static_cast<size_t>(bh) * sq + row) * HD + coff;
#pragma unroll
        for (int j = 0; j < C::NC / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c_lo) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, __nv_bfloat16* dq, int bh, int bg, int sq, int skv, int causal,
              float scale, cudaStream_t stream) {
    using C = DqCfg<HD>;
    CUtensorMap tq, tk, tv, tdo;
    if (!encode_3d(&tq, q, HD, sq, bh, C::SW, C::BM) || !encode_3d(&tdo, dout, HD, sq, bh, C::SW, C::BM) ||
        !encode_3d(&tk, k, HD, skv, bg, C::SW, C::BN) || !encode_3d(&tv, v, HD, skv, bg, C::SW, C::BN))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(bh, (sq + C::BM - 1) / C::BM);
    flash_bwd_dq_wgmma_kernel<HD><<<grid, kThreads, C::SMEM, stream>>>(
        tq, tk, tv, tdo, lse, delta, dq, bh / bg, sq, skv, causal, scale);
    return static_cast<int>(cudaGetLastError());
}

// dk[g] = sum over r < rep of dk_part[g*rep + r], in that order (and dv),
// cast to bf16; four values a thread
__global__ void flash_bwd_dkv_reduce_kernel(const float4* __restrict__ dk_part,
                                            const float4* __restrict__ dv_part,
                                            __nv_bfloat162* __restrict__ dk,
                                            __nv_bfloat162* __restrict__ dv, int rep,
                                            long long per_head, long long n) {
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        const long long g = i / per_head, off = i - g * per_head;
        float4 a = dk_part[g * rep * per_head + off], b = dv_part[g * rep * per_head + off];
        for (int r = 1; r < rep; ++r) {
            const float4 x = dk_part[(g * rep + r) * per_head + off];
            const float4 y = dv_part[(g * rep + r) * per_head + off];
            a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
            b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
        }
        dk[2 * i] = __floats2bfloat162_rn(a.x, a.y);
        dk[2 * i + 1] = __floats2bfloat162_rn(a.z, a.w);
        dv[2 * i] = __floats2bfloat162_rn(b.x, b.y);
        dv[2 * i + 1] = __floats2bfloat162_rn(b.z, b.w);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dk_part, float* dv_part, int bh, int bg, int sq, int skv,
           int causal, float scale, cudaStream_t stream) {
    using C = Cfg<HD>;
    CUtensorMap tq, tk, tv, tdo;
    if (!encode_3d(&tq, q, HD, sq, bh, C::SW, C::BM) || !encode_3d(&tdo, dout, HD, sq, bh, C::SW, C::BM) ||
        !encode_3d(&tk, k, HD, skv, bg, C::SW, C::BN) || !encode_3d(&tv, v, HD, skv, bg, C::SW, C::BN))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(bh, (skv + C::BN - 1) / C::BN);
    flash_bwd_dkv_wgmma_kernel<HD><<<grid, kThreads, C::SMEM, stream>>>(
        tq, tk, tv, tdo, lse, delta, dk_part, dv_part, bh / bg, sq, skv, causal, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

extern "C" int flash_attention_dq_f32_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int bh, int bg,
                                             int sq, int skv, int hd, int causal, float scale,
                                             void* stream) {
    const Args a{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), bh / bg, sq, skv, causal, scale,
                 static_cast<cudaStream_t>(stream)};
    return dispatch_dq(a, dq, bh, hd);
}

extern "C" int flash_attention_dq_bf16_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dq, int bh, int bg,
                                              int sq, int skv, int hd, int causal, float scale,
                                              void* stream) {
    const float* l = static_cast<const float*>(lse);
    const float* d = static_cast<const float*>(delta);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(dq);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return wg::launch_dq<32>(q, k, v, dout, l, d, o, bh, bg, sq, skv, causal, scale, s);
        case 64: return wg::launch_dq<64>(q, k, v, dout, l, d, o, bh, bg, sq, skv, causal, scale, s);
        case 128: return wg::launch_dq<128>(q, k, v, dout, l, d, o, bh, bg, sq, skv, causal, scale, s);
        case 256: return wg::launch_dq<256>(q, k, v, dout, l, d, o, bh, bg, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int flash_attention_dkv_f32_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int bh,
                                              int bg, int sq, int skv, int hd, int causal,
                                              float scale, void* stream) {
    const Args a{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), bh / bg, sq, skv, causal, scale,
                 static_cast<cudaStream_t>(stream)};
    return dispatch_dkv(a, dk, dv, bg, hd);
}

extern "C" int flash_attention_dkv_bf16_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk_part, void* dv_part,
                                               int bh, int bg, int sq, int skv, int hd,
                                               int causal, float scale, void* stream) {
    const float* l = static_cast<const float*>(lse);
    const float* d = static_cast<const float*>(delta);
    float* pk = static_cast<float*>(dk_part);
    float* pv = static_cast<float*>(dv_part);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return wg::launch<32>(q, k, v, dout, l, d, pk, pv, bh, bg, sq, skv, causal, scale, s);
        case 64: return wg::launch<64>(q, k, v, dout, l, d, pk, pv, bh, bg, sq, skv, causal, scale, s);
        case 128: return wg::launch<128>(q, k, v, dout, l, d, pk, pv, bh, bg, sq, skv, causal, scale, s);
        case 256: return wg::launch<256>(q, k, v, dout, l, d, pk, pv, bh, bg, sq, skv, causal, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int flash_attention_dkv_reduce_launch(const void* dk_part, const void* dv_part,
                                                 void* dk, void* dv, int bh, int bg, int skv,
                                                 int hd, void* stream) {
    const long long per_head = static_cast<long long>(skv) * hd / 4;
    const long long n = per_head * bg;
    // 16 blocks an SM at most: the kernel strides over the rest
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = 16LL * sms;
    const int blocks = static_cast<int>(n / 256 + 1 < cap ? n / 256 + 1 : cap);
    wg::flash_bwd_dkv_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(dk_part), static_cast<const float4*>(dv_part),
        static_cast<__nv_bfloat162*>(dk), static_cast<__nv_bfloat162*>(dv), bh / bg, per_head, n);
    return static_cast<int>(cudaGetLastError());
}
