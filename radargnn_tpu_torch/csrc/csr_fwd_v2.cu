// CSR-tiled hoisted max aggregation (v2), forward: the gather-max over the
// node projection.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v2 (reached through _fused_fwd_call_v2 and
// make_fused_hoisted_aggregate_v2, the `fused_tiling: "csr"` path) on
// Hopper (sm_90a), together with the node projection dense_proj_v4
// (dense_fwd_v4.cu), which the caller launches first.
//
// What it computes (receiver-CSR tiles, csr_slot.cuh): slot s of tile t has
// the global sender senders[s] and receiver recv[s] (-1: empty); tile t
// belongs to node block tile_blocks[t] (non-decreasing over t), and a slot
// counts only if its receiver lies in that block. With y_s = x @ W_s
// [n_x, hp] f32 (bf16 in, f32 sums; hp = H rounded up to 64, zero past H):
//   op[s]    = y_s[senders[s]] + e_t[s] @ W_e   (the edge product float32
//                                                in and sums: csr_slot.cuh)
//   inner[n] = max over the counting slots s with recv[s] = n of op[s]
//              (-3e38 if none)
//   out[n]   = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`) it also writes inner[n], the maxima
// the backward (csr_bwd_v2.cu) routes against; serving passes null. The
// backward rebuilds op from the same y_s by the same fma chain, so it sees
// this op bit for bit. v2 keeps the edge features and W_e in float32 on the
// card (the TPU kernel's contract), and it has no overflow list: every
// valid edge sits in a tile.
//
// Design: the gather-max walk of csr_walk.cuh (windowed_fwd_v3.cu's walk:
// 16 warps a node block, each on its own 16-slot groups, the float32 edge
// chain on the CUDA cores, ordered-key atomics in shared memory) with B5's
// operand (CsrOperand); the v1 hoisted forward (hoisted_fwd_v1.cu) runs the
// same walk with its own operand. The TPU kernel multiplies x[sender] @
// W_s once per slot; on the card the projection is formed once per node.
//
// What bounds it on the card. Given y_s, the function needs e @ W_e once
// per valid slot in float32 (~4.2 GFLOP at the flagship's wide layer,
// 281,600 valid slots, d_e 16, H 464: 62 us at 67 TFLOP/s outside the
// tensor cores) and a max per element, against y_s, e_t, the index arrays,
// offset and out (~100 MB, ~30 us): the float32 edge chain bounds it. The
// times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_slot.cuh"
#include "csr_walk.cuh"

namespace {

using namespace radargnn;

// B5's operand (csr_slot.cuh): a slot counts where its receiver lies in
// its node block, its x part is 0 where its sender is no row of y_s, and
// op = y + ep. y_s has hp columns (h rounded up to 64, zero past h), so no
// column is masked.
struct CsrOperand {
    static constexpr bool kBias = false;
    static constexpr bool kMaskCols = false;

    __device__ __forceinline__ static WalkSlot slot(int rc, int sn, int base,
                                                    int node_block,
                                                    int num_nodes, int n_y) {
        const CsrSlot s = csr_slot(rc, sn, base, node_block, num_nodes, n_y);
        return WalkSlot{s.rc, s.sn};
    }

    // ep[half * 4 + c] (row g + half * 8, column c0 + c) += y[half]
    __device__ __forceinline__ static void finish(float (&ep)[8],
                                                  const float4 (&y)[2],
                                                  const float*, int) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const float yv[4] = {y[half].x, y[half].y, y[half].z, y[half].w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                ep[half * 4 + c] = csr_op(yv[c], ep[half * 4 + c]);
            }
        }
    }
};

__global__ void __launch_bounds__(kWalkWarps * 32, 1) csr_fwd_v2_kernel(
    const float* __restrict__ y_s,             // [n_x, hp]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ offset,          // [num_nodes, h]
    float* __restrict__ out,                   // [num_nodes, h]
    float* __restrict__ inner_out,             // [num_nodes, h] or null
    int n_x, int de, int h, int hp, int num_tiles, int num_nodes,
    int node_block, int edge_tile) {
    csr_walk<CsrOperand>(y_s, e_t, w_e, nullptr, senders, recv, tile_blocks,
                         offset, out, inner_out, n_x, de, h, hp, num_tiles,
                         num_nodes, node_block, edge_tile);
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes: the
// [node_block x 64] accumulator and the float32 W_e slice.
size_t csr_fwd_v2_smem_bytes(int de, int node_block) {
    return walk_smem_bytes(de, node_block, false);
}

// Launches the gather-max on `stream`; returns the cudaError_t of the
// launch. The caller checks shapes, types and alignment: de a multiple of
// 4, edge_tile a multiple of 16, y_s [n_x, hp] with hp = h rounded up to
// 64, 16-byte aligned y_s and e_t, tile_blocks non-decreasing (the tiler's
// order). `inner` may be null (serving); otherwise it receives the maxima.
int csr_fwd_v2(const void* y_s, const void* e_t, const void* w_e,
               const void* senders, const void* recv,
               const void* tile_blocks, const void* offset, void* out,
               void* inner, int n_x, int de, int h, int hp, int num_tiles,
               int num_nodes, int node_block, int edge_tile, void* stream) {
    return launch_walk(
        csr_fwd_v2_kernel, walk_smem_bytes(de, node_block, false), num_nodes,
        node_block, h, stream, static_cast<const float*>(y_s),
        static_cast<const float*>(e_t), static_cast<const float*>(w_e),
        static_cast<const int32_t*>(senders),
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(offset), static_cast<float*>(out),
        static_cast<float*>(inner), n_x, de, h, hp, num_tiles, num_nodes,
        node_block, edge_tile);
}

}  // extern "C"
