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
// the MXU; the port keeps float32 accuracy throughout.
//
// Design. One block of 256 threads per 128-row x 128-column output tile
// (grid rows x column slices), one block an SM. The product runs on the
// tensor cores in 3xTF32 (tf32x3.cuh, shared with the message segment-max):
// each operand split into a TF32 part hi (x truncated) and its rest lo =
// x - hi (split_tf32_rz), lo hi + hi lo + hi hi formed from zero for each
// 8-deep step by mma.sync m16n8k8 and added to a float32 accumulator
// rounded to nearest. The depth comes in chunks of 32, staged as they lie
// by cp.async (16-byte copies, 4-byte where a row is not 16-byte aligned),
// double-buffered; 8 warps of 64 rows x 32 columns (4 x 4 m16n8 tiles, the
// segment-max's), 212 registers a thread, no spill. Two blocks an SM (32 x
// 64 warps within 128 registers, spilling) and the split rounded to
// nearest each measured slower. The epilogue adds the bias, then
// applies the ReLU, then stores. Ragged m, k and n read zeros past the
// ends and store nothing there. Each output's sum runs in ascending k, so
// a run gives the same bits every time.
//
// What bounds it on the card: 2 m k n product operations, as three TF32
// products at the 495 TFLOP/s dense TF32 peak, against (m k + k n + n +
// m n) 4 bytes at 3.35 TB/s: at 14,080 x 224 -> 464, 8.8 GFLOP of TF32
// products (18 us) against 39 MB (12 us), so the operations (the float32
// floor outside the tensor cores, 44 us, beside it in PERF.md). The times
// are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace radargnn;

constexpr int kWarpRows = 64;            // a warp's rows
constexpr int kWarpCols = 32;            // a warp's columns
constexpr int kMt = kWarpRows / 16;      // m16 tiles a warp
constexpr int kNt = kWarpCols / 8;       // n8 tiles a warp

__global__ void __launch_bounds__(kTf32Threads, 1) fused_linear_kernel(
    const float* __restrict__ x,    // [m, k]
    const float* __restrict__ w,    // [k, n]
    const float* __restrict__ b,    // [n]
    float* __restrict__ y,          // [m, n]
    int m, int k, int n, int relu, int vec_x, int vec_w) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Tf32Stage& S = *reinterpret_cast<Tf32Stage*>(smem_raw);
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTf32Rows;
    const int col0 = blockIdx.y * kTf32Cols;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int wm = (warp >> 2) * kWarpRows;    // the warp's rows
    const int wn = (warp & 3) * kWarpCols;     // the warp's columns

    float acc[kMt][kNt][4];
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNt; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
    const int chunks = (k + kTf32Depth - 1) / kTf32Depth;
    if (chunks > 0) {
        tf32_load_chunk(S, 0, x, row0, m, k, w, n, col0, 0, vec_x, vec_w);
    }
    for (int c = 0; c < chunks; ++c) {
        const int buf = c & 1;
        if (c + 1 < chunks) {
            tf32_load_chunk(S, buf ^ 1, x, row0, m, k, w, n, col0,
                            (c + 1) * kTf32Depth, vec_x, vec_w);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
#pragma unroll 1
        for (int ks = 0; ks < kTf32Depth; ks += 8) {
            uint32_t ah[kMt][4], al[kMt][4];
#pragma unroll
            for (int mi = 0; mi < kMt; ++mi) {
                const float* a0 = &S.a[buf][wm + mi * 16 + g][ks + tq];
                const float* a8 = a0 + 8 * kTf32ALd;
                split_tf32_rz(a0[0], ah[mi][0], al[mi][0]);
                split_tf32_rz(a8[0], ah[mi][1], al[mi][1]);
                split_tf32_rz(a0[4], ah[mi][2], al[mi][2]);
                split_tf32_rz(a8[4], ah[mi][3], al[mi][3]);
            }
#pragma unroll
            for (int ni = 0; ni < kNt; ++ni) {
                const int cc = wn + ni * 8 + g;
                uint32_t bh[2], bl[2];
                split_tf32_rz(S.b[buf][ks + tq][cc], bh[0], bl[0]);
                split_tf32_rz(S.b[buf][ks + tq + 4][cc], bh[1], bl[1]);
#pragma unroll
                for (int mi = 0; mi < kMt; ++mi) {
                    mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh, bl);
                }
            }
        }
        __syncthreads();   // the buffer is refilled next
    }

    // epilogue: bias, then ReLU, then the store (a column pair as one
    // 8-byte store where n is even)
#pragma unroll
    for (int ni = 0; ni < kNt; ++ni) {
        const int col = col0 + wn + ni * 8 + tq * 2;
        const float b0 = col < n ? __ldg(b + col) : 0.0f;
        const float b1 = col + 1 < n ? __ldg(b + col + 1) : 0.0f;
#pragma unroll
        for (int mi = 0; mi < kMt; ++mi) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int64_t row = row0 + wm + mi * 16 + g + half * 8;
                if (row >= m || col >= n) continue;
                float v0 = acc[mi][ni][half * 2] + b0;
                float v1 = acc[mi][ni][half * 2 + 1] + b1;
                if (relu) {
                    v0 = fmaxf(v0, 0.0f);
                    v1 = fmaxf(v1, 0.0f);
                }
                float* dst = y + row * n + col;
                if (col + 1 < n && (n & 1) == 0) {
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                } else {
                    dst[0] = v0;
                    if (col + 1 < n) dst[1] = v1;
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and contiguity; vec_x (vec_w) says that
// x's (W's) rows may be copied 16 bytes at a time: k (n) a multiple of 4
// and the data 16-byte aligned.
int fused_linear(const void* x, const void* w, const void* b, void* y, int m,
                 int k, int n, int relu, int vec_x, int vec_w,
                 void* stream) {
    const size_t smem = sizeof(Tf32Stage);
    cudaError_t err = cudaFuncSetAttribute(
        fused_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((m + kTf32Rows - 1) / kTf32Rows,
                    (n + kTf32Cols - 1) / kTf32Cols);
    if (grid.x == 0 || grid.y == 0) return static_cast<int>(cudaSuccess);
    fused_linear_kernel<<<grid, kTf32Threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), m, k, n, relu,
        vec_x, vec_w);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
