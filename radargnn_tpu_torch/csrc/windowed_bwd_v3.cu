// Windowed hoisted max aggregation, backward kernels.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v3 (reached through _fused_bwd_call_v3 and the custom
// VJP of make_fused_hoisted_aggregate_v3, strict routing) on Hopper
// (sm_90a).
//
// What it computes (windowed tile layout as in windowed_fwd_v3.cu; inner_z
// and g_pass are [num_nodes, h] f32, inner_z = 0 and g_pass = 0 at empty
// receivers; a slot is valid when its receiver lies in its tile's block):
//   op[s]   = x[sender] @ W_s + e_t[s] @ W_e                     (f32)
//   d_op[s] = g_pass[recv[s]] where s is valid and
//             |op - inner_z[recv]| <= 1e-5 |inner_z[recv]| + 1e-5,
//             else 0; rounded to bf16. Every tied slot takes the full g.
//   d_xg[s] = bf16(d_op[s] @ W_s^T),  d_e[s] = bf16(d_op[s] @ W_e^T)
//   dW_s    = sum over slots of x[sender]^T d_op,  dW_e = sum of e_t^T d_op
// d_x, the d_xg rows summed at their senders, is landed by the B3 kernel
// (segment_sum_csr.cu) over the batch's sender-sorted row order, together
// with the overflow rows; the TPU kernel lands it in window parts instead.
//
// Design: four launches on one stream, no atomics and fixed summation
// orders, so two runs on the same inputs are bitwise equal.
//  1. route: one block per (tile, 64-column slice) runs the forward's
//     slot-row loop (dense_tile.cuh, R = 64 slots per row: the same code
//     and mma order as windowed_fwd_v3.cu), so op is bitwise the
//     forward's; each slot reads its receiver's inner_z and g_pass (an
//     indexed load, where the TPU kernel gathers them with exact one-hot
//     selection matmuls) and writes d_op [T*TE, hp] bf16 (hp = h rounded
//     up to 64, zero past h).
//  2.-4. slot products, weight partials and their ordered reduce
//     (slot_grads.cuh, shared with the dense backward).
// The gather is an indexed load of x by global sender, as in the forward;
// the TPU kernel's saved per-slot x_g stream is not needed.
//
// What bounds it on the card. The function needs d_x = (sum over a
// sender's slots of d_op) @ W_s^T and dW_s = x^T @ (the same sums) once
// per node, d_e and dW_e once per valid slot: ~14 GFLOP at the radius
// batch's wide layer (14 us at the bf16 peak) against ~100 MB of
// compulsory bytes (~30 us at 3.35 TB/s), so it is bound by bytes. This
// design multiplies per slot, as the TPU kernel does, on mma.sync from
// shared memory, and writes and reads d_op [E_pad, hp] bf16 twice, so it
// is held by its own tensor-core work and that traffic, far above the
// floor; the times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"
#include "slot_grads.cuh"

namespace {

using namespace radargnn;

__global__ void __launch_bounds__(128) windowed_route_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ inner_z,         // [num_nodes, h]
    const float* __restrict__ g_pass,          // [num_nodes, h]
    __nv_bfloat16* __restrict__ d_op,          // [T*TE, hp]
    int n_x, int d, int de, int h, int hp, int num_nodes, int node_block,
    int edge_tile, int r_chunk) {
    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int lane = threadIdx.x & 31;
    const int m0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int base = tile_blocks[t] * node_block;
    const size_t tile_slot0 = static_cast<size_t>(t) * edge_tile;

    dense_tile_rows(x, w_s, e_t, w_e, sloc, tile_win, n_x, d, de, h, r_chunk,
                    edge_tile / r_chunk, node_block,
                    [&](int j, float (*acc)[4], bool, bool,
                        const __nv_bfloat16*) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const size_t row = tile_slot0 + static_cast<size_t>(j) * r_chunk
                + m0 + g + half * 8;
            const int rc = recv[row];
            const int local = rc - base;
            const bool valid = rc >= 0 && rc < num_nodes && local >= 0 &&
                               local < node_block;
            const size_t node_row = static_cast<size_t>(valid ? rc : 0) * h;
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                const int col = col0 + nt * 8 + tq * 2;
                float o[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    o[c] = 0.0f;
                    if (valid && col + c < h) {
                        const float in = inner_z[node_row + col + c];
                        const float op = acc[nt][half * 2 + c];
                        if (fabsf(op - in) <= 1e-5f * fabsf(in) + 1e-5f) {
                            o[c] = g_pass[node_row + col + c];
                        }
                    }
                }
                *reinterpret_cast<__nv_bfloat162*>(d_op + row * hp + col) =
                    __floats2bfloat162_rn(o[0], o[1]);
            }
        }
    });
}

}  // namespace

extern "C" {

// Shared memory the routing pass needs for these shapes, in bytes.
size_t windowed_bwd_v3_smem_bytes(int d, int de, int r_chunk) {
    return slot_rows_smem_bytes<EdgeBf16>(d, de, r_chunk);
}

// Launches the four passes on `stream`; returns the first cudaError_t.
// Scratch: d_op [T*TE, hp] bf16 and partial [n_part, d+de, hp] f32, with
// hp = h rounded up to 64. The caller checks shapes, types and alignment
// (as for windowed_fwd_v3; h a multiple of 8).
int windowed_bwd_v3(const void* x, const void* w_s, const void* e_t,
                    const void* w_e, const void* recv, const void* sloc,
                    const void* tile_win, const void* tile_blocks,
                    const void* inner_z, const void* g_pass, void* d_op,
                    void* partial, void* d_xg, void* d_e, void* dw_s,
                    void* dw_e, int n_x, int d, int de, int h,
                    int num_tiles, int num_nodes, int node_block,
                    int edge_tile, int r_chunk, int n_part, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int hp = (h + kBlockCols - 1) / kBlockCols * kBlockCols;
    const int n_slots = num_tiles * edge_tile;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wsb = static_cast<const __nv_bfloat16*>(w_s);
    const auto* etb = static_cast<const __nv_bfloat16*>(e_t);
    const auto* web = static_cast<const __nv_bfloat16*>(w_e);
    const auto* sl = static_cast<const int32_t*>(sloc);
    const auto* tw = static_cast<const int32_t*>(tile_win);
    auto* dop = static_cast<__nv_bfloat16*>(d_op);

    const size_t smem = slot_rows_smem_bytes<EdgeBf16>(d, de, r_chunk);
    cudaError_t err = cudaFuncSetAttribute(
        windowed_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    windowed_route_kernel<<<dim3(num_tiles, hp / kBlockCols),
                            (r_chunk / 16) * 32, smem, st>>>(
        xb, wsb, etb, web, static_cast<const int32_t*>(recv), sl, tw,
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(inner_z),
        static_cast<const float*>(g_pass), dop, n_x, d, de, h, hp, num_nodes,
        node_block, edge_tile, r_chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    return static_cast<int>(launch_slot_grads(
        xb, wsb, etb, web, sl, tw, dop, static_cast<float*>(partial),
        static_cast<__nv_bfloat16*>(d_xg), static_cast<__nv_bfloat16*>(d_e),
        static_cast<float*>(dw_s), static_cast<float*>(dw_e), n_x, d, de, h,
        hp, n_slots, edge_tile, node_block, n_part, st));
}

}  // extern "C"
