// Fused message matmul + segment max, in float32.
//
// Replaces the TPU kernels radargnn_tpu/ops/pallas_kernels.py:
// _msg_segmax_scan_kernel and _msg_segmax_kernel (the two bodies of
// fused_message_segment_max, selected by its `variant`) on Hopper (sm_90a).
//
// What it computes (receiver-CSR tiles of ops/windowed_tiles.py:
// prepare_csr_tiles): slot s of tile t has the global receiver recv[s] (-1:
// empty) and the pre-permuted message input m_in[s]; tile t belongs to node
// block tile_blocks[t] (non-decreasing over t: a block's tiles are
// consecutive), and a slot counts only if its receiver lies in that block.
//   m[s]   = m_in[s] @ W + b                       (float32)
//   out[n] = max over the slots s with recv[s] = n of m[s], 0 if none
// A negative maximum stays negative; only a receiver without a slot gives 0.
// The TPU kernels land the maxima in their resident output block, one by a
// segmented log-roll max and a one-hot mean landing, one by a chunked
// one-hot max; both are ways to land rows on the MXU and compute this same
// function, so the port has one kernel for both.
//
// Design. One block of 256 threads = one node block (blockIdx.x) x one
// 64-column slice (blockIdx.y). It finds its tiles by binary search in
// tile_blocks (tile_walk.cuh); since they are consecutive, their slots are
// one contiguous range, which it walks in 128-slot rows with the float32
// SIMT tile of sgemm_tile.cuh (m never reaches device memory). Each value
// m[s][c] lands in a [node_block x 64] float32 accumulator in shared
// memory by an exact float atomic max, so the result does not depend on the
// order of the atomics and two runs give the same bits. The epilogue writes
// the block's rows, 0 where no slot landed. Registers are capped at 128 a
// thread so that two blocks share an SM (uncapped, ptxas takes 143).
//
// What bounds it on the card: 2 E d_in H float32 operations over the valid
// slots at 67 TFLOP/s outside the tensor cores, against m_in, W, b, the
// receivers and the output once (bytes at 3.35 TB/s): at 281,600 valid
// slots and d_in = H = 464, 121 GFLOP (1.81 ms) against 0.6 GB (0.18 ms),
// so the operations. The times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_tile.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kAccLd = kGemmCols + 1;    // accumulator row stride (floats)

__global__ void __launch_bounds__(kGemmThreads, 2) msg_segmax_kernel(
    const float* __restrict__ m_in,            // [T*TE, d_in]
    const float* __restrict__ w,               // [d_in, h]
    const float* __restrict__ b,               // [h]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    float* __restrict__ out,                   // [num_nodes, h]
    int d_in, int h, int num_tiles, int num_nodes, int node_block,
    int edge_tile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    GemmSmem& S = *reinterpret_cast<GemmSmem*>(smem_raw);
    float* acc_s = reinterpret_cast<float*>(smem_raw + sizeof(GemmSmem));
    const int blk = blockIdx.x;
    const int col0 = blockIdx.y * kGemmCols;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int base = blk * node_block;

    for (int i = tid; i < node_block * kAccLd; i += blockDim.x) {
        acc_s[i] = kNeg;
    }
    const int64_t lo = static_cast<int64_t>(
                           lower_bound(tile_blocks, num_tiles, blk)) *
                       edge_tile;
    const int64_t hi = static_cast<int64_t>(
                           lower_bound(tile_blocks, num_tiles, blk + 1)) *
                       edge_tile;
    float bias[kGemmTN];
#pragma unroll
    for (int j = 0; j < kGemmTN; ++j) {
        const int col = col0 + tx * 4 + j;
        bias[j] = col < h ? b[col] : 0.0f;
    }
    __syncthreads();

    for (int64_t row0 = lo; row0 < hi; row0 += kGemmRows) {
        float acc[kGemmTM][kGemmTN];
        gemm_tile(m_in, row0, hi, d_in, w, h, col0, S, acc);
#pragma unroll
        for (int i = 0; i < kGemmTM; ++i) {
            const int64_t slot = row0 + ty * 8 + i;
            if (slot >= hi) continue;
            const int rc = __ldg(recv + slot);
            if (!receiver_in_block(rc, base, node_block, num_nodes)) continue;
            float* row = acc_s + (rc - base) * kAccLd + tx * 4;
#pragma unroll
            for (int j = 0; j < kGemmTN; ++j) {
                atomic_max_f32(row + j, acc[i][j] + bias[j]);
            }
        }
    }
    __syncthreads();

    // epilogue: receivers no slot reached -> 0
    for (int i = tid; i < node_block * kGemmCols; i += blockDim.x) {
        const int r = i / kGemmCols, c = i % kGemmCols;
        const int n = base + r, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const float v = acc_s[r * kAccLd + c];
        out[static_cast<size_t>(n) * h + col] = v > kNeg / 2 ? v : 0.0f;
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, in bytes: the GEMM tile's chunks and the
// [node_block x 64] accumulator.
size_t msg_segmax_smem_bytes(int node_block) {
    return sizeof(GemmSmem) +
           sizeof(float) * static_cast<size_t>(node_block) * kAccLd;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and contiguity, and that tile_blocks is
// non-decreasing (the tiler's order).
int msg_segmax(const void* m_in, const void* w, const void* b,
               const void* recv, const void* tile_blocks, void* out,
               int d_in, int h, int num_tiles, int num_nodes, int node_block,
               int edge_tile, void* stream) {
    const size_t smem = msg_segmax_smem_bytes(node_block);
    cudaError_t err = cudaFuncSetAttribute(
        msg_segmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    (h + kGemmCols - 1) / kGemmCols);
    msg_segmax_kernel<<<grid, kGemmThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(m_in), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks), static_cast<float*>(out),
        d_in, h, num_tiles, num_nodes, node_block, edge_tile);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
