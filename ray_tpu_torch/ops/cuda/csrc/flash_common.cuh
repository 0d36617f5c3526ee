// Helpers shared by the fp32 flash-attention kernels (forward, dq, dk/dv),
// which run on CUDA cores; the bf16 kernels are built from sm90.cuh.
//
// Every fp32 kernel stages 64-row tiles of [*, D] operands in shared memory
// with a row stride of D + 1 (odd, so a column walk across rows hits
// distinct banks), and gives thread (ty, tx) = (tid / 16, tid % 16) of a
// 256-thread block the 4 x 4 tile entries (ty + 16 i, tx + 16 j) of a
// 64 x 64 product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int TILE = 64;         // rows of every staged tile
constexpr int THREADS = 256;     // threads of every block
constexpr int PS = TILE + 16;    // row stride of a 64 x 64 score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Copy a 64 x D tile, contiguous along D with rows row_stride apart, into
// shared memory as fp32 with row stride D + 1.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int64_t row_stride) {
    constexpr int CPR = D / 4;  // 4-element chunks per row
    for (int c = threadIdx.x; c < TILE * CPR; c += THREADS) {
        const int r = c / CPR;
        const int col = (c % CPR) * 4;
        float v[4];
        load4(src + r * row_stride + col, v);
        float* d = dst + r * (D + 1) + col;
        d[0] = v[0]; d[1] = v[1]; d[2] = v[2]; d[3] = v[3];
    }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
}

// acc[i][j] += sum_kk p[ty + 16 i][kk] * m[kk][tx + 16 j]: a 64 x 64 score
// tile (row stride PS) times a staged 64 x D tile.
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][D / 16],
                                                const float* p,
                                                const float* m, int ty,
                                                int tx) {
#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
        float pv[4], mv[D / 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < D / 16; ++j) mv[j] = m[kk * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < D / 16; ++j)
                acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
    }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

}  // namespace flash
