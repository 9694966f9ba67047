// Windowed hoisted max aggregation, backward: the bits-routed sender-sum
// backward.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v3 (reached through _fused_bwd_call_v3 and the custom
// VJP of make_fused_hoisted_aggregate_v3, strict routing) on Hopper
// (sm_90a), in the form of its `sender_dx` variant.
//
// What it computes (windowed tile layout as in windowed_fwd_v3.cu; g_pass
// is [num_nodes, hg] f32, 0 at empty receivers, hg = H rounded up to 8;
// bits come from the forward's VJP mode, windowed_fwd_v3.cu, and are set
// only where a slot counts):
//   d_op[s] = bf16(g_pass[recv[s]]) where the slot's bit is set, else 0
//             (every tied slot takes the full g)
//   d_e[s]  = bf16(d_op[s] @ W_e^T)                        [T*TE, de]
//   dW_e    = sum over slots of e_t[s]^T d_op[s]           [de, hg] f32
//   d_ys[n] = sum of d_op over the slots the landing lists for sender n
//                                                          [N, hg] f32
//   d_yo[n] = sum of its overflow rows d_op_o (f32)        [N, hg] f32
// The caller forms d_x = (d_ys + d_yo) @ W_s^T and dW_s = x^T (d_ys +
// d_yo) in float32 as node-wide products, as the JAX package's windowed
// sender_dx wrapper does.
//
// Design: the four passes of routed_bwd.cuh (de_pass, dwe_pass,
// send_pass, reduce_pass; no atomics and fixed summation orders, so two
// runs on the same inputs are bitwise equal), shared with the dense
// backward, with the windowed layout's receivers (WindowReceivers: listed
// beside the slot, g read where it lies and only where a bit is set). A
// tile of edge_tile slots is walked as edge_tile / R rows of R slots.
// d_op [E_pad, hp] is never written, and neither the forward's op nor any
// per-slot product with W_s is recomputed: the earlier design reran the
// forward's slot-row loop to route, wrote d_op and multiplied it per slot
// by [W_s | W_e]^T, and landed d_x through the B3 kernel.
//
// What bounds it on the card. The function needs d_e and dW_e once per
// routed element and the sender sums' adds, against the bits, g, e_t, the
// receivers, the landing, d_e and the two sender sums (~90 MB at the
// radius batch's wide layer): it is bound by bytes. The times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "routed_bwd.cuh"

using namespace radargnn;

extern "C" {

// Launches the four passes on `stream`; returns the first cudaError_t.
// The arguments are dense_bwd_v4's, then the slots' receivers recv
// [n_slots] and num_nodes. Scratch: we_part [T, de16, hp] f32 (de16 = de
// rounded up to 16). The caller checks shapes, types and alignment: de
// and hg multiples of 8, hp = H rounded up to 64, r_tile a multiple of 16
// in [16, 64] with n_slots = num_tiles * r_tile * k.
int windowed_bwd_v3(const void* bits, const void* g_pass, const void* e_t,
                    const void* w_e, const void* d_op_o, const void* order,
                    const void* row_ptr, void* d_e, void* we_part,
                    void* dw_e, void* d_ys, void* d_yo, long long n_slots,
                    int num_tiles, int r_tile, int k, int de, int hg, int hp,
                    int n_seg, const void* recv, int num_nodes,
                    void* stream) {
    return static_cast<int>(launch_routed_grads(
        WindowReceivers{static_cast<const int32_t*>(recv), num_nodes}, bits,
        g_pass, e_t, w_e, d_op_o, order, row_ptr, d_e, we_part, dw_e, d_ys,
        d_yo, n_slots, num_tiles, r_tile, k, de, hg, hp, n_seg,
        static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
