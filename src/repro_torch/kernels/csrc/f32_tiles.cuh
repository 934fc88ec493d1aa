// Full-f32 tiles on the CUDA cores, shared by the f32 flash-attention
// kernels (the forward in flash_attention.cu; dq and dk/dv in
// flash_attention_bwd.cu).  A block of 256 threads owns a tile of B rows
// (B = 64, 32 at hd 256) and streams tiles of B rows of the other side
// through shared memory:
//   * every shared [rows][HD] or [B][B] f32 tile is XOR-swizzled by 16-byte
//     chunk (chunk ^ row & 7), so 8 consecutive rows at one column, or 8
//     chunks of one row, are conflict-free without padding;
//   * tiles arrive by cp.async (16 bytes a thread, zero fill past the ragged
//     edge), committed in groups so the next tile is in flight during the
//     math;
//   * scores: a thread owns a TS x TS micro-tile (rows 16 apart) and sums it
//     over the head dim in order from float4 fragments, 16 FFMA a fragment;
//   * products with a [B][B] tile (P, dS) run as register-tiled outer
//     products, a thread owning TR consecutive rows by TC columns, summed
//     over the tile's rows in order.
// Every sum has one order, fixed by the tiling: the same inputs give the
// same bits.
#pragma once
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace f32tile {

constexpr int kThreads = 256;

template <int HD>
struct Cfg {
    static constexpr int B = HD == 256 ? 32 : 64;  // rows of the block's tile and of a streamed tile
    static constexpr int T = B * HD;               // floats of one such tile
    // scores: a 16 x 16 grid of threads, each TS x TS outputs (rows 16 apart)
    static constexpr int TS = B / 16;
    // accumulation: out[B][HD] over (B / TR) x NCG threads, each TR
    // consecutive rows by TC columns (TC / 4 chunks of 4, NCG chunks apart)
    static constexpr int TC = HD >= 128 ? 8 : 4;
    static constexpr int NCG = HD / TC;
    static constexpr int TR = B * NCG / kThreads;
    static_assert(TS * 16 == B && TR * kThreads == B * NCG && (TR == 2 || TR == 4) &&
                  NCG % 8 == 0 && NCG / 8 * B / TR / 4 == kThreads / 32, "tiling");
};

// element (row, col) of a [rows][W] f32 tile in shared memory: 16-byte
// chunks XOR-swizzled by the row's low 3 bits, so 8 consecutive rows at one
// column, or one row at 8 consecutive chunks, hit 8 distinct bank groups
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
    return row * W + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// start copying rows 0 .. B-1 of a [rows][GHD] tile in global memory (rows
// past `valid` read as zeros) into its swizzled [B][HD] place; GHD < HD
// pads each row with zeros past column GHD (the forward at hd 112 runs the
// hd-128 tiling)
template <int HD, int GHD = HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int valid) {
    static_assert(GHD <= HD && GHD % 4 == 0, "a row of GHD floats in HD columns");
    constexpr int CH = HD / 4, B = Cfg<HD>::B;
#pragma unroll
    for (int idx = threadIdx.x; idx < B * CH; idx += kThreads) {
        const int row = idx / CH, c = idx % CH;
        const bool in = row < valid && 4 * c < GHD;
        cp_async16(dst + swz<HD>(row, 4 * c), in ? src + static_cast<size_t>(row) * GHD + 4 * c : src, in);
    }
}

// s1[i][j] = A1[a0 + 16i] . B1[b0 + 16j] and, when TWO, s2 likewise from
// A2, B2 (rows of swizzled [B][HD] tiles), each summed over the head dim in
// order
template <int HD, int TS, bool TWO = true>
__device__ __forceinline__ void scores(const float* A1, const float* B1, const float* A2,
                                       const float* B2, int a0, int b0, float (&s1)[TS][TS],
                                       float (&s2)[TS][TS]) {
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) {
            s1[i][j] = 0.0f;
            if constexpr (TWO) s2[i][j] = 0.0f;
        }
    // rows 16 apart share their low 3 bits, so one swizzle serves a thread's rows
    const int sa = a0 & 7, sb = b0 & 7;
#pragma unroll 4
    for (int c = 0; c < HD / 4; ++c) {
        float4 a[TS], b[TS];
#pragma unroll
        for (int i = 0; i < TS; ++i) {
            a[i] = *reinterpret_cast<const float4*>(A1 + (a0 + 16 * i) * HD + ((c ^ sa) << 2));
            b[i] = *reinterpret_cast<const float4*>(B1 + (b0 + 16 * i) * HD + ((c ^ sb) << 2));
        }
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
            for (int j = 0; j < TS; ++j) {
                s1[i][j] = fmaf(a[i].x, b[j].x, s1[i][j]);
                s1[i][j] = fmaf(a[i].y, b[j].y, s1[i][j]);
                s1[i][j] = fmaf(a[i].z, b[j].z, s1[i][j]);
                s1[i][j] = fmaf(a[i].w, b[j].w, s1[i][j]);
            }
        if constexpr (!TWO) continue;
#pragma unroll
        for (int i = 0; i < TS; ++i) {
            a[i] = *reinterpret_cast<const float4*>(A2 + (a0 + 16 * i) * HD + ((c ^ sa) << 2));
            b[i] = *reinterpret_cast<const float4*>(B2 + (b0 + 16 * i) * HD + ((c ^ sb) << 2));
        }
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
            for (int j = 0; j < TS; ++j) {
                s2[i][j] = fmaf(a[i].x, b[j].x, s2[i][j]);
                s2[i][j] = fmaf(a[i].y, b[j].y, s2[i][j]);
                s2[i][j] = fmaf(a[i].z, b[j].z, s2[i][j]);
                s2[i][j] = fmaf(a[i].w, b[j].w, s2[i][j]);
            }
    }
}

// TR consecutive values of row j of a swizzled [B][B] tile, from column r0
template <int B, int TR>
__device__ __forceinline__ void load_row(const float* M, int j, int r0, float (&m)[TR]) {
    const float* at = M + swz<B>(j, r0);
    if constexpr (TR == 4) {
        const float4 x = *reinterpret_cast<const float4*>(at);
        m[0] = x.x; m[1] = x.y; m[2] = x.z; m[3] = x.w;
    } else {
        const float2 x = *reinterpret_cast<const float2*>(at);
        m[0] = x.x; m[1] = x.y;
    }
}

// acc1[r][.] += sum over j of M1[j][r0 + r] * T1[j][the thread's columns],
// j in order, and acc2 likewise from M2, T2 when TWO (M: swizzled [B][B],
// T: swizzled [B][HD]; the thread's columns are the chunks cg + NCG*t)
template <int HD, bool TWO>
__device__ __forceinline__ void accumulate(const float* M1, const float* T1, const float* M2,
                                           const float* T2, int r0, int cg,
                                           float (&acc1)[Cfg<HD>::TR][Cfg<HD>::TC],
                                           float (&acc2)[Cfg<HD>::TR][Cfg<HD>::TC]) {
    using C = Cfg<HD>;
    constexpr int TR = C::TR, NCH = C::TC / 4;
#pragma unroll 8
    for (int j = 0; j < C::B; ++j) {
        float m[TR];
        float4 x[NCH];
        load_row<C::B, TR>(M1, j, r0, m);
#pragma unroll
        for (int t = 0; t < NCH; ++t)
            x[t] = *reinterpret_cast<const float4*>(T1 + j * HD + (((cg + C::NCG * t) ^ (j & 7)) << 2));
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int t = 0; t < NCH; ++t) {
                acc1[r][4 * t] = fmaf(m[r], x[t].x, acc1[r][4 * t]);
                acc1[r][4 * t + 1] = fmaf(m[r], x[t].y, acc1[r][4 * t + 1]);
                acc1[r][4 * t + 2] = fmaf(m[r], x[t].z, acc1[r][4 * t + 2]);
                acc1[r][4 * t + 3] = fmaf(m[r], x[t].w, acc1[r][4 * t + 3]);
            }
        if constexpr (TWO) {
            load_row<C::B, TR>(M2, j, r0, m);
#pragma unroll
            for (int t = 0; t < NCH; ++t)
                x[t] = *reinterpret_cast<const float4*>(T2 + j * HD + (((cg + C::NCG * t) ^ (j & 7)) << 2));
#pragma unroll
            for (int r = 0; r < TR; ++r)
#pragma unroll
                for (int t = 0; t < NCH; ++t) {
                    acc2[r][4 * t] = fmaf(m[r], x[t].x, acc2[r][4 * t]);
                    acc2[r][4 * t + 1] = fmaf(m[r], x[t].y, acc2[r][4 * t + 1]);
                    acc2[r][4 * t + 2] = fmaf(m[r], x[t].z, acc2[r][4 * t + 2]);
                    acc2[r][4 * t + 3] = fmaf(m[r], x[t].w, acc2[r][4 * t + 3]);
                }
        }
    }
}

// A thread's places.  Scores: the 16 x 16 grid, own-tile rows `own` + 16i
// and streamed-tile rows `str` + 16j, a warp holding 4 own by 8 streamed
// (each of its loads reads 4 or 8 rows: one 128-byte wavefront).
// Accumulation: rows r0 .. r0+TR-1 and the column chunks cg + NCG*t, a warp
// holding 4 row groups by 8 consecutive chunks (again one wavefront a load).
template <int HD>
struct Place {
    int own, str, r0, cg;
    __device__ __forceinline__ Place() {
        using C = Cfg<HD>;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        own = 4 * (warp >> 1) + (lane >> 3);
        str = 8 * (warp & 1) + (lane & 7);
        cg = 8 * (warp % (C::NCG / 8)) + (lane & 7);
        r0 = (4 * (warp / (C::NCG / 8)) + (lane >> 3)) * C::TR;
    }
};

// rows r0 .. r0+TR-1 of out[rows][GHD] from acc (rows at or past `valid`,
// and columns at or past GHD, are not stored)
template <int HD, int GHD = HD>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[Cfg<HD>::TR][Cfg<HD>::TC],
                                           int r0, int cg, int valid) {
    using C = Cfg<HD>;
#pragma unroll
    for (int r = 0; r < C::TR; ++r) {
        if (r0 + r >= valid) continue;
#pragma unroll
        for (int t = 0; t < C::TC / 4; ++t) {
            const int col = 4 * (cg + C::NCG * t);
            if (GHD < HD && col >= GHD) continue;
            *reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * GHD + col) =
                make_float4(acc[r][4 * t], acc[r][4 * t + 1], acc[r][4 * t + 2], acc[r][4 * t + 3]);
        }
    }
}

}  // namespace f32tile
