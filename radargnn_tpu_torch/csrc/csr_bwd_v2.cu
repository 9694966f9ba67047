// CSR-tiled hoisted max aggregation (v2), backward kernels.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v2 (reached through _fused_bwd_call_v2 and the custom
// VJP of make_fused_hoisted_aggregate_v2) on Hopper (sm_90a).
//
// What it computes (layout as in csr_fwd_v2.cu; inner_z and g_pass are
// [num_nodes, h] f32, 0 at empty receivers; a slot is valid when its
// receiver lies in its tile's block):
//   op[s]      = x[senders[s]] @ W_s + e_t[s] @ W_e       (as the forward)
//   d_op[s]    = g_pass[recv[s]] where s is valid and
//                |op - inner_z[recv]| <= 1e-5 |inner_z[recv]| + 1e-5,
//                else 0, in float32. Every tied slot takes the full g.
//   d_xg[s]    = bf16(bf16(d_op[s]) @ W_s^T)
//   d_e[s]     = d_op[s] @ W_e^T                          (float32)
//   dW_s       = sum over slots of x[sender]^T bf16(d_op)
//   dW_e       = sum over slots of e_t^T d_op             (float32)
// The two forms of d_op are the TPU kernel's: the bf16-rounded one drives
// the sender-side outputs d_xg and dW_s, the float32 one the edge-side d_e
// and dW_e. d_x, the d_xg rows summed at their senders, is landed by the
// B3 kernel (segment_sum_csr.cu) over the batch's sender-sorted tiling,
// as pallas_segment_sum_csr lands it on the TPU.
//
// Design: five launches on one stream, no atomics and fixed summation
// orders, so two runs on the same inputs are bitwise equal:
//  1. route: one block per (tile, 64-column slice) runs the forward's
//     slot-row loop (dense_tile.cuh with csr_tile.cuh: the same code and
//     summation order as csr_fwd_v2.cu), so op is bitwise the forward's;
//     each slot reads its receiver's inner_z and g_pass (an indexed load,
//     where the TPU kernel gathers them with exact one-hot selection
//     matmuls) and writes bf16(d_op) [T*TE, hp] (hp = h rounded up to 64, zero past h). The
//     float32 d_op of the slot row stays in shared memory, where the block
//     forms its edge-side partials: d_e over its 64 columns
//     (de_part [hp/64, T*TE, de]) and e_t^T d_op over its tile
//     (we_part [T, de, hp]), each output owned by one thread.
//  2.-4. slot products, weight partials and their ordered reduce
//     (slot_grads.cuh, shared with the dense and windowed backward) with
//     de = 0: d_xg and dW_s from bf16(d_op).
//  5. edge reduce: d_e = the column-slice partials summed in order, dW_e =
//     the tile partials summed in order.
//
// What bounds it on the card. The function needs d_x = (the sum of d_op
// over a sender's slots) @ W_s^T and dW_s = x^T @ (the same sums) once per
// node in bf16, d_e and dW_e once per valid slot in float32: at the
// flagship's wide layer ~5.9 GFLOP of bf16 products (6 us) and ~8.4 GFLOP
// of float32 products (125 us at 67 TFLOP/s), so the float32 edge
// gradients bound it. This design multiplies per slot, as the TPU kernel
// does, and writes and reads bf16(d_op) [E_pad, hp] twice and the
// float32 partials once, so it is held by its own work and that traffic,
// far above the floor; the times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_tile.cuh"
#include "slot_grads.cuh"

namespace {

using namespace radargnn;

constexpr int kDopLd = kBlockCols + 1;   // float32 d_op tile row stride

__global__ void __launch_bounds__(128) csr_route_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ inner_z,         // [num_nodes, h]
    const float* __restrict__ g_pass,          // [num_nodes, h]
    __nv_bfloat16* __restrict__ d_op,          // [T*TE, hp]
    float* __restrict__ de_part,               // [hp/64, T*TE, de]
    float* __restrict__ we_part,               // [T, de, hp]
    int n_x, int d, int de, int h, int hp, int num_nodes, int node_block,
    int edge_tile, int r_chunk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* dop_s = reinterpret_cast<float*>(           // [r][kDopLd]
        smem_raw + slot_rows_smem_bytes<EdgeF32>(d, de, r_chunk));
    float* we_acc = dop_s + r_chunk * kDopLd;          // [de][64]
    const EdgeF32::Smem E = row_smem<EdgeF32>(d, de, r_chunk).e;
    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid & 31;
    const int m0 = (tid >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int base = tile_blocks[t] * node_block;
    const size_t n_slots = static_cast<size_t>(gridDim.x) * edge_tile;
    const size_t tile_slot0 = static_cast<size_t>(t) * edge_tile;

    for (int i = tid; i < de * kBlockCols; i += nthreads) we_acc[i] = 0.0f;
    stage_weights<EdgeF32>(w_s, w_e, d, de, h, r_chunk, col0);
    slot_rows<EdgeF32>(
        t, x, e_t, CsrSenders{senders, recv, base, node_block, num_nodes, n_x},
        d, de, r_chunk, edge_tile / r_chunk,
        [&](int j, float (*acc)[4], bool, bool, const float* ea) {
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_chunk;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int rr = m0 + g + half * 8;
            const size_t row = slot0 + rr;
            const int rc = recv[row];
            const bool valid = receiver_in_block(rc, base, node_block,
                                                 num_nodes);
            const size_t node_row = static_cast<size_t>(valid ? rc : 0) * h;
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                const int c0 = nt * 8 + tq * 2;
                float o[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    o[c] = 0.0f;
                    const int col = col0 + c0 + c;
                    if (valid && col < h) {
                        const float in = inner_z[node_row + col];
                        const float op = acc[nt][half * 2 + c];
                        if (fabsf(op - in) <= 1e-5f * fabsf(in) + 1e-5f) {
                            o[c] = g_pass[node_row + col];
                        }
                    }
                    dop_s[rr * kDopLd + c0 + c] = o[c];
                }
                *reinterpret_cast<__nv_bfloat162*>(d_op + row * hp + col0 +
                                                   c0) =
                    __floats2bfloat162_rn(o[0], o[1]);
            }
        }
        __syncthreads();       // the slot row's float32 d_op is complete

        // d_e over this block's 64 columns: output (slot rr, feature k)
        for (int p = tid; p < de * r_chunk; p += nthreads) {
            const int k = p / r_chunk, rr = p % r_chunk;
            const float* dr = dop_s + rr * kDopLd;
            const float* wr = E.we_s + k * kWeLd;
            float s = 0.0f;
            for (int c = 0; c < kBlockCols; ++c) s = fmaf(dr[c], wr[c], s);
            de_part[(blockIdx.y * n_slots + slot0 + rr) * de + k] = s;
        }
        // e_t^T d_op over the slot row, added to this tile's partial:
        // output (feature k, column c)
        for (int p = tid; p < de * kBlockCols; p += nthreads) {
            const int k = p / kBlockCols, c = p % kBlockCols;
            float s = 0.0f;
            for (int rr = 0; rr < r_chunk; ++rr) {
                s = fmaf(ea[rr * E.lde + k], dop_s[rr * kDopLd + c], s);
            }
            we_acc[p] += s;
        }
    });

    // slot_rows ends on a barrier: we_acc is complete
    for (int p = tid; p < de * kBlockCols; p += nthreads) {
        const int k = p / kBlockCols, c = p % kBlockCols;
        we_part[(static_cast<size_t>(t) * de + k) * hp + col0 + c] = we_acc[p];
    }
}

// d_e[i] = the column-slice partials of entry i summed in order of the
// slice; dW_e[k][n] = the tile partials summed in order of the tile.
__global__ void csr_edge_reduce_kernel(const float* __restrict__ de_part,
                                       const float* __restrict__ we_part,
                                       int n_slots, int de, int n_cs,
                                       int num_tiles, int h, int hp,
                                       float* __restrict__ d_e,
                                       float* __restrict__ dw_e) {
    const size_t n_de = static_cast<size_t>(n_slots) * de;
    const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
    if (i < n_de) {
        float s = 0.0f;
        for (int cs = 0; cs < n_cs; ++cs) s += de_part[cs * n_de + i];
        d_e[i] = s;
        return;
    }
    const size_t j = i - n_de;
    if (j >= static_cast<size_t>(de) * h) return;
    const int k = static_cast<int>(j / h), n = static_cast<int>(j % h);
    float s = 0.0f;
    for (int t = 0; t < num_tiles; ++t) {
        s += we_part[(static_cast<size_t>(t) * de + k) * hp + n];
    }
    dw_e[j] = s;
}

}  // namespace

extern "C" {

// Shared memory the routing pass needs for these shapes, in bytes: the
// slot-row loop's buffers, the slot row's float32 d_op and the tile's
// e_t^T d_op accumulator.
size_t csr_bwd_v2_smem_bytes(int d, int de, int r_chunk) {
    return slot_rows_smem_bytes<EdgeF32>(d, de, r_chunk) +
           sizeof(float) * (static_cast<size_t>(r_chunk) * kDopLd +
                            static_cast<size_t>(de) * kBlockCols);
}

// Launches the five passes on `stream`; returns the first cudaError_t.
// Scratch: d_op [T*TE, hp] bf16, de_part [hp/64, T*TE, de] f32, we_part
// [T, de, hp] f32 and partial [n_part, d, hp] f32, with hp = h rounded up
// to 64. The caller checks shapes, types and alignment (as for csr_fwd_v2;
// h a multiple of 8).
int csr_bwd_v2(const void* x, const void* w_s, const void* e_t,
               const void* w_e, const void* senders, const void* recv,
               const void* tile_blocks, const void* inner_z,
               const void* g_pass, void* d_op, void* de_part, void* we_part,
               void* partial, void* d_xg, void* d_e, void* dw_s, void* dw_e,
               int n_x, int d, int de, int h, int num_tiles, int num_nodes,
               int node_block, int edge_tile, int r_chunk, int n_part,
               void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int hp = (h + kBlockCols - 1) / kBlockCols * kBlockCols;
    const int n_cs = hp / kBlockCols;
    const int n_slots = num_tiles * edge_tile;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wsb = static_cast<const __nv_bfloat16*>(w_s);
    const auto* snd = static_cast<const int32_t*>(senders);
    auto* dop = static_cast<__nv_bfloat16*>(d_op);
    auto* dep = static_cast<float*>(de_part);
    auto* wep = static_cast<float*>(we_part);

    const size_t smem = csr_bwd_v2_smem_bytes(d, de, r_chunk);
    cudaError_t err = cudaFuncSetAttribute(
        csr_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_route_kernel<<<dim3(num_tiles, n_cs), (r_chunk / 16) * 32, smem,
                       st>>>(
        xb, wsb, static_cast<const float*>(e_t),
        static_cast<const float*>(w_e), snd,
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(inner_z),
        static_cast<const float*>(g_pass), dop, dep, wep, n_x, d, de, h, hp,
        num_nodes, node_block, edge_tile, r_chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    // d_xg and dW_s from bf16(d_op): the slot-gradient passes with de = 0
    // and global senders (a null tile_win)
    err = launch_slot_grads(xb, wsb, nullptr, nullptr, snd, nullptr, dop,
                            static_cast<float*>(partial),
                            static_cast<__nv_bfloat16*>(d_xg), nullptr,
                            static_cast<float*>(dw_s), nullptr, n_x, d, 0, h,
                            hp, n_slots, edge_tile, node_block, n_part, st);
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t n_out = static_cast<size_t>(n_slots) * de +
                         static_cast<size_t>(de) * h;
    csr_edge_reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256,
                             0, st>>>(
        dep, wep, n_slots, de, n_cs, num_tiles, h, hp,
        static_cast<float*>(d_e), static_cast<float*>(dw_e));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
