// Hoisted max aggregation (v1), forward kernel, in float32.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _hoisted_scan_kernel (reached through _hoisted_pallas_call,
// make_fused_hoisted_aggregate and make_fused_hoisted_aggregate_pallas_bwd)
// on Hopper (sm_90a).
//
// What it computes (receiver-CSR tiles of ops/windowed_tiles.py:
// prepare_csr_tiles): slot s of tile t has the global sender senders_t[s]
// and receiver recv[s] (-1: empty); tile t belongs to node block
// tile_blocks[t] (non-decreasing: a block's tiles are consecutive), and a
// slot counts only if its receiver lies in that block and its sender is a
// row of y_s. With the node-level projection y_s = x @ W_s computed once
// per node outside the kernel,
//   op[s]    = (y_s[senders_t[s]] + e_t[s] @ W_e) + b      (hoisted_v1.cuh)
//   inner[n] = max over the slots s with recv[s] = n of op[s] (-3e38 if none)
//   out[n]   = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`) it also writes inner, the maxima the
// backward (hoisted_bwd_v1.cu) routes against; it rebuilds op by the same
// chain (v1_op), so it sees this op bit for bit. Unlike the TPU kernel,
// which takes the rows y_s[senders_t] gathered by XLA outside it, this
// kernel gathers them by indexed load; and where the TPU kernel lands a
// mean of equal maxima (a one-hot matmul of the segmented roll-max, about
// 1e-7 relative from the max), it lands the exact max.
//
// Design: the gather-max walk of the CSR forward (csr_walk.cuh: one block
// per node block x 64-column slice, 16 warps each on its own 16-slot
// groups with the next group's indices in flight, a lane's two slot rows
// over 16 of the slice's 64 columns in quads, the float32 edge chain on
// the CUDA cores against the W_e slice in shared memory, a 16-byte quad of
// W_e feeding 8 fma, the half-group of one receiver folded by shuffles and
// landed by an ordered-key atomic max in shared memory) with v1's operand
// (V1Operand: the bias from a shared-memory slice, added last; the column
// quads of y_s past h masked). The parent design landed every (slot,
// column) by a float atomic in shared memory, which held it, as it held
// the windowed forward's parent (PERF.md).
//
// What bounds it on the card: the edge product, 2 d_e H float32 operations
// per valid slot at 67 TFLOP/s outside the tensor cores (281,600 slots,
// d_e 16, H 464: 4.2 GFLOP, 62 us), against y_s, e_t, the index arrays,
// offset and out once (~0.1 GB, 30 us). The row gathers read E H floats of
// y_s, which at 26 MB stays in the 50 MB L2. The times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "hoisted_v1.cuh"

namespace {

using namespace radargnn;

// B6's operand (hoisted_v1.cuh): a slot counts where its receiver lies in
// its node block and its sender is a row of y_s, and op = (y + ep) + b, as
// the v1 backward (hoisted_bwd_v1.cu) forms it. y_s is [n_y, ld] with the
// column quads past h masked (ld a multiple of 4 and at least h, so a quad
// that starts below h lies in the row), the bias slice in shared memory.
struct V1Operand {
    static constexpr bool kBias = true;
    static constexpr bool kMaskCols = true;

    __device__ __forceinline__ static WalkSlot slot(int rc, int sn, int base,
                                                    int node_block,
                                                    int num_nodes, int n_y) {
        WalkSlot s;
        const bool counts =
            receiver_in_block(rc, base, node_block, num_nodes) && sn >= 0 &&
            sn < n_y;
        s.rc = counts ? rc : -1;
        s.sn = counts ? sn : -1;
        return s;
    }

    __device__ __forceinline__ static void finish(float (&ep)[8],
                                                  const float4 (&y)[2],
                                                  const float* b_s, int c0) {
        const float4 b4 = *reinterpret_cast<const float4*>(b_s + c0);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const float yv[4] = {y[half].x, y[half].y, y[half].z, y[half].w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                ep[half * 4 + c] = v1_op(yv[c], ep[half * 4 + c], b[c]);
            }
        }
    }
};

__global__ void __launch_bounds__(kWalkWarps * 32, 1) hoisted_fwd_v1_kernel(
    const float* __restrict__ y_s,             // [n_y, ys_ld]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const float* __restrict__ b,               // [h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ offset,          // [num_nodes, h]
    float* __restrict__ out,                   // [num_nodes, h]
    float* __restrict__ inner_out,             // [num_nodes, h] or null
    int n_y, int de, int h, int ys_ld, int num_tiles, int num_nodes,
    int node_block, int edge_tile) {
    csr_walk<V1Operand>(y_s, e_t, w_e, b, senders, recv, tile_blocks, offset,
                        out, inner_out, n_y, de, h, ys_ld, num_tiles,
                        num_nodes, node_block, edge_tile);
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, in bytes: the [node_block x 64]
// accumulator, the float32 W_e slice and the bias slice.
size_t hoisted_fwd_v1_smem_bytes(int de, int node_block) {
    return walk_smem_bytes(de, node_block, true);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: de a multiple of 4,
// edge_tile a multiple of 16, y_s [n_y, ys_ld] with ys_ld >= h a multiple
// of 4, 16-byte aligned y_s and e_t, tile_blocks non-decreasing (the
// tiler's order). `inner` may be null (serving); otherwise it receives
// the maxima.
int hoisted_fwd_v1(const void* y_s, const void* e_t, const void* w_e,
                   const void* b, const void* senders, const void* recv,
                   const void* tile_blocks, const void* offset, void* out,
                   void* inner, int n_y, int de, int h, int ys_ld,
                   int num_tiles, int num_nodes, int node_block,
                   int edge_tile, void* stream) {
    return launch_walk(
        hoisted_fwd_v1_kernel, walk_smem_bytes(de, node_block, true),
        num_nodes, node_block, h, stream, static_cast<const float*>(y_s),
        static_cast<const float*>(e_t), static_cast<const float*>(w_e),
        static_cast<const float*>(b), static_cast<const int32_t*>(senders),
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(offset), static_cast<float*>(out),
        static_cast<float*>(inner), n_y, de, h, ys_ld, num_tiles, num_nodes,
        node_block, edge_tile);
}

}  // extern "C"
