// Dense fixed-degree hoisted max aggregation, backward: the bits-routed
// sender-sum backward.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v4 (reached through _fused_bwd_call_v4 and the custom
// VJP of make_fused_dense_aggregate) on Hopper (sm_90a), in the form of
// its `sender_dx` variant.
//
// What it computes (slot layout in dense_gather.cuh; g_pass is [T*R, hg]
// f32, 0 at empty receivers, hg = H rounded up to 8; bits come from the
// forward's VJP mode, dense_fwd_v4.cu):
//   d_op[slot] = bf16(g_pass[recv(slot)]) where the slot's bit is set,
//                else 0 (every tied slot takes the full g)
//   d_e[slot]  = bf16(d_op[slot] @ W_e^T)                  [T*TE, de]
//   dW_e       = sum over slots of e_t[slot]^T d_op[slot]  [de, hg] f32
//   d_ys[s]    = sum of d_op over the slots the landing lists for sender s
//                                                          [N, hg] f32
//   d_yo[s]    = sum of its overflow rows d_op_o (f32)     [N, hg] f32
// The caller forms d_x = bf16(d_ys) @ W_s^T + d_yo @ W_s^T and dW_s =
// bf16(x)^T bf16(d_ys) + x^T d_yo as node-wide products: the JAX package's
// sender_dx wrapper rounds the slots' sums to bf16 and keeps the overflow
// part in float32.
//
// Design: the four passes of routed_bwd.cuh (de_pass, dwe_pass,
// send_pass, reduce_pass; no atomics and fixed summation orders, so two
// runs on the same inputs are bitwise equal) with the dense layout's
// receivers (DenseReceivers): a tile's R rows of g, rounded to bf16, are
// staged in shared memory once, and every slot row of the tile reads them.
// d_op [E_pad, H] (~314 MB per wide layer) is never written.
//
// What bounds it on the card. The function needs d_x and dW_s as
// node-wide products (4 N d H flops) and d_e, dW_e once per valid slot
// (4 valid d_e H), ~13.8 GFLOP at the flagship's wide layer (14 us at the
// bf16 peak), against the bits (21.6 MB), e_t, the landing, g, d_e, d_x,
// the weights (~94 MB; ~28 us at 3.35 TB/s): it is bound by bytes. The TPU
// kernel recomputes the forward's op and multiplies per slot (three
// products of ~75 GFLOP per wide layer); here the routing is a bit test
// and the sender sums are adds, so what remains is the passes' L2 traffic
// (g rows re-read per routed byte) and the bit unpacking. The times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "routed_bwd.cuh"

using namespace radargnn;

extern "C" {

// Shared memory the receiver passes need for these shapes, in bytes (the
// larger, d_e's: the tile's g rows over all columns).
size_t dense_bwd_v4_smem_bytes(int hp, int r_tile) {
    return de_pass_smem_bytes<DenseReceivers>(hp, r_tile);
}

// Launches the four passes on `stream`; returns the first cudaError_t.
// Scratch: we_part [T, de16, hp] f32 (de16 = de rounded up to 16). The
// caller checks shapes, types and alignment: de and hg multiples of 8,
// hp = H rounded up to 64, r_tile a multiple of 8 and at most 128.
int dense_bwd_v4(const void* bits, const void* g_pass, const void* e_t,
                 const void* w_e, const void* d_op_o, const void* order,
                 const void* row_ptr, void* d_e, void* we_part, void* dw_e,
                 void* d_ys, void* d_yo, long long n_slots, int num_tiles,
                 int r_tile, int k, int de, int hg, int hp, int n_seg,
                 void* stream) {
    return static_cast<int>(launch_routed_grads(
        DenseReceivers{static_cast<long long>(r_tile) * k, r_tile}, bits,
        g_pass, e_t, w_e, d_op_o, order, row_ptr, d_e, we_part, dw_e, d_ys,
        d_yo, n_slots, num_tiles, r_tile, k, de, hg, hp, n_seg,
        static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
