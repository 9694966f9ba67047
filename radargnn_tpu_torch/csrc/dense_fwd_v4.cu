// Dense fixed-degree hoisted max aggregation, forward kernel.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v4 (reached through _fused_fwd_call_v4 and
// make_fused_dense_aggregate) on Hopper (sm_90a).
//
// What it computes (slot layout in dense_tile.cuh):
//   op[slot]  = x[sender] @ W_s + e_t[slot] @ W_e      (bf16 in, f32 acc)
//             = -3e38 for empty slots
//   inner[n]  = max(max_j op[t*TE + j*R + r], inner_o[n])
//   out[n]    = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`, the TPU kernel's emit_inner) the
// kernel also writes inner[n], the maxima the backward routes against;
// serving passes null and skips that [N, H] write.
//
// Design. The TPU kernel gathers the sender rows with a one-hot [TE, W]
// matmul over a Morton window of x; here a gather is an indexed load, so
// each block loads the R sender rows of one slot row j straight from x,
// and the window only serves to form the global sender index
// (dense_tile_rows). The running max over the K slot rows lives in
// registers. The overflow maxima, the offset and the empty-receiver rule
// are the epilogue, as on the TPU.
//
// What bounds it on the card. At the flagship shapes (N=14,080, R=64,
// K=24, d_in up to 224, H up to 464) the function needs x @ W_s once per
// node (x[s] @ W_s = (x @ W_s)[s]) and e @ W_e once per valid slot: ~7
// GFLOP of bf16 products per wide layer against ~97 MB of compulsory
// traffic, so the floor is the HBM rate (~29 us per wide layer). This
// design, like the TPU kernel, multiplies x[s] @ W_s once per slot
// (~60 GFLOP per wide layer, ~8x the function's work), re-gathers each
// sender row once per 64-column slice (x is small enough to stay in L2)
// and feeds mma.sync from shared memory rather than wgmma, so it is held
// by its own tensor-core work, far above the floor. The node-level
// projection computed inside the kernel (ROADMAP.md B1) removes the
// per-slot product; the times are recorded in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in

__global__ void __launch_bounds__(256) dense_fwd_v4_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    const float* __restrict__ inner_o,         // [T*R, h]
    const float* __restrict__ offset,          // [T*R, h]
    float* __restrict__ out,                   // [T*R, h]
    float* __restrict__ inner_out,             // [T*R, h] or null
    int n_x, int d, int de, int h, int r_tile, int k, int node_block) {
    float mx[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[nt][q] = kNeg;

    dense_tile_rows(x, w_s, e_t, w_e, sloc, tile_win, n_x, d, de, h, r_tile,
                    k, node_block,
                    [&](int, float (*acc)[4], bool v0, bool v1,
                        const __nv_bfloat16*) {
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
            if (v0) {
                mx[nt][0] = fmaxf(mx[nt][0], acc[nt][0]);
                mx[nt][1] = fmaxf(mx[nt][1], acc[nt][1]);
            }
            if (v1) {
                mx[nt][2] = fmaxf(mx[nt][2], acc[nt][2]);
                mx[nt][3] = fmaxf(mx[nt][3], acc[nt][3]);
            }
        }
    });

    // epilogue: overflow maxima, hoisted offset, empty receivers -> 0
    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int lane = threadIdx.x & 31;
    const int m0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int row = m0 + g + (q >> 1) * 8;
            const int col = col0 + nt * 8 + tq * 2 + (q & 1);
            if (col >= h) continue;
            const size_t idx =
                (static_cast<size_t>(t) * r_tile + row) * h + col;
            const float inner = fmaxf(mx[nt][q], inner_o[idx]);
            if (inner_out != nullptr) inner_out[idx] = inner;
            out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
        }
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes.
size_t dense_fwd_v4_smem_bytes(int d, int de, int r_tile) {
    return slot_rows_smem_bytes<EdgeBf16>(d, de, r_tile);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: d and de multiples of 8,
// r_tile a multiple of 16 and at most 128, 16-byte aligned x and e_t.
// `inner` may be null (serving); otherwise it receives the maxima.
int dense_fwd_v4(const void* x, const void* w_s, const void* e_t,
                 const void* w_e, const void* sloc, const void* tile_win,
                 const void* inner_o, const void* offset, void* out,
                 void* inner, int n_x, int d, int de, int h, int num_tiles,
                 int r_tile, int k, int node_block, void* stream) {
    const size_t smem = slot_rows_smem_bytes<EdgeBf16>(d, de, r_tile);
    cudaError_t err = cudaFuncSetAttribute(
        dense_fwd_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(num_tiles, (h + kBlockCols - 1) / kBlockCols);
    const dim3 block((r_tile / 16) * 32);
    dense_fwd_v4_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w_s),
        static_cast<const __nv_bfloat16*>(e_t),
        static_cast<const __nv_bfloat16*>(w_e),
        static_cast<const int32_t*>(sloc),
        static_cast<const int32_t*>(tile_win),
        static_cast<const float*>(inner_o),
        static_cast<const float*>(offset), static_cast<float*>(out),
        static_cast<float*>(inner), n_x, d, de, h, r_tile, k, node_block);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
