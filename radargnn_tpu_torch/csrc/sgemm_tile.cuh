// The float32 SIMT GEMM tile that fused_linear.cu and msg_segmax.cu share:
// one block of 256 threads forms a 128-row x 64-column tile of A @ B, in
// full float32 on the CUDA cores (no tensor cores, no TF32), as the TPU
// kernels' float32 contract asks.
//
//   acc[i][j] = sum over k of A[row0 + ty*8 + i][k] * B[k][col0 + tx*4 + j]
//
// (tx = threadIdx.x % 16, ty = threadIdx.x / 16: a thread owns an 8 x 4
// micro-tile in registers). A is [rows, K] and B [K, n], both row-major and
// contiguous; rows at or past rows_end, columns at or past n and depth past
// K read as zero. The depth comes in chunks of 16: A's chunk is stored
// k-major (transposed) and B's as it lies, double-buffered in shared memory,
// the next chunk's global loads issued before the current chunk's products.
// Each output is one fma chain in ascending k, so a run gives the same bits
// every time.
//
// Per depth step a thread reads two float4 of A and one of B from shared
// memory for 32 fma: enough reuse for a simple kernel; wgmma with 3xTF32 is
// the faster design (a later PR).
#pragma once

#include <stdint.h>

namespace radargnn {

constexpr int kGemmRows = 128;           // rows of a tile
constexpr int kGemmCols = 64;            // columns of a tile
constexpr int kGemmDepth = 16;           // depth chunk
constexpr int kGemmThreads = 256;
constexpr int kGemmTM = 8;               // rows per thread
constexpr int kGemmTN = 4;               // columns per thread
constexpr int kGemmALd = kGemmRows + 4;  // A chunk row stride (floats)

struct GemmSmem {
    float a[2][kGemmDepth][kGemmALd];    // A chunk, k-major
    float b[2][kGemmDepth][kGemmCols];   // B chunk
};

// The 8 A and 4 B values a thread moves from global to shared memory per
// depth chunk (2048 and 1024 values over 256 threads).
struct GemmStage {
    float a[8];
    float b[4];
};

__device__ __forceinline__ void gemm_load(GemmStage& r,
                                          const float* __restrict__ A,
                                          int64_t row0, int64_t rows_end,
                                          int K, const float* __restrict__ B,
                                          int n, int col0, int k0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        // element tid + 256 q of the [128 x 16] chunk: row / 16, k % 16
        const int i = tid + q * kGemmThreads;
        const int64_t row = row0 + i / kGemmDepth;
        const int k = k0 + i % kGemmDepth;
        r.a[q] = row < rows_end && k < K ? __ldg(A + row * K + k) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int i = tid + q * kGemmThreads;
        const int k = k0 + i / kGemmCols;
        const int col = col0 + i % kGemmCols;
        r.b[q] = k < K && col < n
                     ? __ldg(B + static_cast<int64_t>(k) * n + col)
                     : 0.0f;
    }
}

__device__ __forceinline__ void gemm_store(GemmSmem& S, int buf,
                                           const GemmStage& r) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const int i = tid + q * kGemmThreads;
        S.a[buf][i % kGemmDepth][i / kGemmDepth] = r.a[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int i = tid + q * kGemmThreads;
        S.b[buf][i / kGemmCols][i % kGemmCols] = r.b[q];
    }
}

// acc = the thread's micro-tile of A[row0 : row0 + 128] @ B[:, col0 : col0
// + 64] (header comment). All 256 threads must call it; it ends with a
// barrier, so the caller may call it again at once.
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          int64_t row0, int64_t rows_end,
                                          int K, const float* __restrict__ B,
                                          int n, int col0, GemmSmem& S,
                                          float (&acc)[kGemmTM][kGemmTN]) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
        for (int j = 0; j < kGemmTN; ++j) acc[i][j] = 0.0f;
    const int chunks = (K + kGemmDepth - 1) / kGemmDepth;
    GemmStage r;
    gemm_load(r, A, row0, rows_end, K, B, n, col0, 0);
    gemm_store(S, 0, r);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
        const int buf = c & 1;
        const bool more = c + 1 < chunks;
        if (more) {
            gemm_load(r, A, row0, rows_end, K, B, n, col0,
                      (c + 1) * kGemmDepth);
        }
#pragma unroll
        for (int k = 0; k < kGemmDepth; ++k) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(&S.a[buf][k][ty * 8]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&S.a[buf][k][ty * 8 + 4]);
            const float4 bv =
                *reinterpret_cast<const float4*>(&S.b[buf][k][tx * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
                for (int j = 0; j < kGemmTN; ++j)
                    acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
        }
        if (more) gemm_store(S, buf ^ 1, r);
        __syncthreads();
    }
}

}  // namespace radargnn
