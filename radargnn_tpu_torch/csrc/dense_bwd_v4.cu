// Dense fixed-degree hoisted max aggregation, backward kernels.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v4 (reached through _fused_bwd_call_v4 and the custom
// VJP of make_fused_dense_aggregate) on Hopper (sm_90a).
//
// What it computes (slot layout in dense_tile.cuh; inner_z and g_pass are
// [T*R, h] f32, inner_z = 0 and g_pass = 0 at empty receivers):
//   op[slot]   = x[sender] @ W_s + e_t[slot] @ W_e                 (f32)
//   d_op[slot] = g_pass[recv] where the slot is valid and
//                |op - inner_z[recv]| <= 1e-5 |inner_z[recv]| + 1e-5,
//                else 0; rounded to bf16. Every tied slot takes the full g.
//   d_xg[slot] = bf16(d_op[slot] @ W_s^T)          [T*TE, d]
//   d_e[slot]  = bf16(d_op[slot] @ W_e^T)          [T*TE, de]
//   dW_s       = sum over slots of x[sender]^T d_op  [d, h]  f32
//   dW_e       = sum over slots of e_t^T d_op        [de, h] f32
// d_x, the d_xg rows summed at their senders, is landed by the B3 kernel
// (segment_sum_csr.cu) over the batch's sender-sorted row order, together
// with the overflow rows; the TPU kernel lands it in window parts instead.
//
// Design: four launches on one stream, no atomics and fixed summation
// orders, so two runs on the same inputs are bitwise equal.
//  1. route: one block per (tile, 64-column slice) runs the forward's
//     slot-row loop (dense_tile_rows, the same code and mma order), so op
//     is bitwise the forward's and the winning slot matches inner exactly;
//     it writes d_op [T*TE, hp] bf16 (hp = h rounded up to 64, zero past h).
//  2.-4. slot products, weight partials and their ordered reduce
//     (slot_grads.cuh, shared with the windowed backward).
// The gather is an indexed load of x by global sender, as in the forward;
// the TPU kernel's saved per-slot x_g stream is not needed.
//
// What bounds it on the card. The function needs d_x = (sum over a
// sender's slots of d_op) @ W_s^T and dW_s = x^T @ (the same sums), so its
// products are 4*N*d*h + 4*valid*de*h flops (~13.8 GFLOP at the flagship's
// wide layer, 14 us at the bf16 peak) against ~94 MB of compulsory bytes
// (x, e_t, sloc, inner, g, d_x, d_e, the weights; ~28 us at 3.35 TB/s): it
// is bound by bytes. This design multiplies per slot, as the TPU kernel
// does (three products of ~75 GFLOP each per wide layer, with the padded
// slots) on mma.sync from shared memory, and writes and reads d_op
// [E_pad, hp] bf16 twice, so it is held by its own tensor-core work and
// that traffic, far above the floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"
#include "slot_grads.cuh"

namespace {

using namespace radargnn;

__global__ void __launch_bounds__(256) route_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    const float* __restrict__ inner_z,         // [T*R, h]
    const float* __restrict__ g_pass,          // [T*R, h]
    __nv_bfloat16* __restrict__ d_op,          // [T*TE, hp]
    int n_x, int d, int de, int h, int hp, int r_tile, int k,
    int node_block) {
    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int lane = threadIdx.x & 31;
    const int m0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;

    // inner_z and g_pass at this thread's receivers and columns
    float inz[kColTiles][4], gp[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int row = m0 + g + (q >> 1) * 8;
            const int col = col0 + nt * 8 + tq * 2 + (q & 1);
            const size_t idx =
                (static_cast<size_t>(t) * r_tile + row) * h + col;
            inz[nt][q] = col < h ? inner_z[idx] : 0.0f;
            gp[nt][q] = col < h ? g_pass[idx] : 0.0f;
        }
    }

    const size_t tile_slot0 = static_cast<size_t>(t) * r_tile * k;
    dense_tile_rows(x, w_s, e_t, w_e, sloc, tile_win, n_x, d, de, h, r_tile,
                    k, node_block,
                    [&](int j, float (*acc)[4], bool v0, bool v1,
                        const __nv_bfloat16*) {
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
            const int col = col0 + nt * 8 + tq * 2;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const bool valid = half ? v1 : v0;
                float o[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int q = half * 2 + c;
                    const float in = inz[nt][q];
                    const bool sel = valid &&
                        fabsf(acc[nt][q] - in) <= 1e-5f * fabsf(in) + 1e-5f;
                    o[c] = sel ? gp[nt][q] : 0.0f;
                }
                const size_t row = slot0 + m0 + g + half * 8;
                *reinterpret_cast<__nv_bfloat162*>(d_op + row * hp + col) =
                    __floats2bfloat162_rn(o[0], o[1]);
            }
        }
    });
}

}  // namespace

extern "C" {

// Shared memory the routing pass needs for these shapes, in bytes.
size_t dense_bwd_v4_smem_bytes(int d, int de, int r_tile) {
    return slot_rows_smem_bytes<EdgeBf16>(d, de, r_tile);
}

// Launches the four passes on `stream`; returns the first cudaError_t.
// Scratch: d_op [T*TE, hp] bf16 and partial [n_part, d+de, hp] f32, with
// hp = h rounded up to 64. The caller checks shapes, types and alignment
// (as for dense_fwd_v4; h a multiple of 8).
int dense_bwd_v4(const void* x, const void* w_s, const void* e_t,
                 const void* w_e, const void* sloc, const void* tile_win,
                 const void* inner_z, const void* g_pass, void* d_op,
                 void* partial, void* d_xg, void* d_e, void* dw_s,
                 void* dw_e, int n_x, int d, int de, int h, int num_tiles,
                 int r_tile, int k, int node_block, int n_part,
                 void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int hp = (h + kBlockCols - 1) / kBlockCols * kBlockCols;
    const int te = r_tile * k;
    const int n_slots = num_tiles * te;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wsb = static_cast<const __nv_bfloat16*>(w_s);
    const auto* etb = static_cast<const __nv_bfloat16*>(e_t);
    const auto* web = static_cast<const __nv_bfloat16*>(w_e);
    const auto* sl = static_cast<const int32_t*>(sloc);
    const auto* tw = static_cast<const int32_t*>(tile_win);
    auto* dop = static_cast<__nv_bfloat16*>(d_op);

    const size_t smem = slot_rows_smem_bytes<EdgeBf16>(d, de, r_tile);
    cudaError_t err = cudaFuncSetAttribute(
        route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    route_kernel<<<dim3(num_tiles, hp / kBlockCols), (r_tile / 16) * 32,
                   smem, st>>>(
        xb, wsb, etb, web, sl, tw, static_cast<const float*>(inner_z),
        static_cast<const float*>(g_pass), dop, n_x, d, de, h, hp, r_tile,
        k, node_block);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    return static_cast<int>(launch_slot_grads(
        xb, wsb, etb, web, sl, tw, dop, static_cast<float*>(partial),
        static_cast<__nv_bfloat16*>(d_xg), static_cast<__nv_bfloat16*>(d_e),
        static_cast<float*>(dw_s), static_cast<float*>(dw_e), n_x, d, de, h,
        hp, n_slots, te, node_block, n_part, st));
}

}  // extern "C"
