// Fused linear: y = x @ W + b, with an optional ReLU, in float32.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py: _linear_kernel
// (reached through fused_linear) on Hopper (sm_90a).
//
// What it computes: x [m, k] float32, W [k, n] float32, b [n] float32,
//   y[r][c] = max(0, sum over j of x[r][j] W[j][c] + b[c])   (ReLU)
//   y[r][c] =         sum over j of x[r][j] W[j][c] + b[c]    (without)
// The TPU kernel tiles the rows (a `tile` of 512 in VMEM) and runs one
// Mosaic dot per row tile, whose float32 default is a single bf16 pass on
// the MXU; the port keeps float32 products and sums throughout.
//
// Design. One block of 256 threads per 128-row x 64-column output tile
// (grid rows x column slices), the float32 SIMT tile of sgemm_tile.cuh
// (8 x 4 outputs per thread in registers, 16-deep double-buffered chunks
// in shared memory), then the epilogue: bias, ReLU, store. Registers are
// capped at 128 a thread so that two blocks share an SM (uncapped, ptxas
// takes 163 and one block fits).
//
// What bounds it on the card: 2 m k n float32 operations at 67 TFLOP/s
// outside the tensor cores against (m k + k n + n + m n) 4 bytes at
// 3.35 TB/s: at 14,080 x 224 -> 464, 2.93 GFLOP (44 us) against 39 MB
// (12 us), so the operations. The SIMT tile reaches a fraction of that
// peak; the times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_tile.cuh"

namespace {

using namespace radargnn;

__global__ void __launch_bounds__(kGemmThreads, 2) fused_linear_kernel(
    const float* __restrict__ x,    // [m, k]
    const float* __restrict__ w,    // [k, n]
    const float* __restrict__ b,    // [n]
    float* __restrict__ y,          // [m, n]
    int m, int k, int n, int relu) {
    __shared__ __align__(16) GemmSmem S;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kGemmRows;
    const int col0 = blockIdx.y * kGemmCols;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[kGemmTM][kGemmTN];
    gemm_tile(x, row0, m, k, w, n, col0, S, acc);
#pragma unroll
    for (int i = 0; i < kGemmTM; ++i) {
        const int64_t row = row0 + ty * 8 + i;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < kGemmTN; ++j) {
            const int col = col0 + tx * 4 + j;
            if (col >= n) continue;
            float v = acc[i][j] + b[col];
            if (relu) v = fmaxf(v, 0.0f);
            y[row * n + col] = v;
        }
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and contiguity.
int fused_linear(const void* x, const void* w, const void* b, void* y, int m,
                 int k, int n, int relu, void* stream) {
    const dim3 grid((m + kGemmRows - 1) / kGemmRows,
                    (n + kGemmCols - 1) / kGemmCols);
    fused_linear_kernel<<<grid, kGemmThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), m, k, n, relu);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
