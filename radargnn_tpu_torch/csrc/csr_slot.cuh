// What the CSR (v2) kernels share about a slot: whether it counts, its
// sender's row of the node projection, and how its operand is formed, so
// the backward's routing pass (csr_bwd_v2.cu) sees the forward's
// (csr_fwd_v2.cu) operand bit for bit.
//
// Layout (receiver-CSR tiles, ops/windowed_tiles.py: prepare_csr_tiles): a
// slot carries its global sender senders[slot] and its global receiver
// recv[slot] (-1: empty slot); it counts only where its receiver lies in
// its tile's node block tile_blocks[t]. Its x part is 0 where its sender is
// not a row of x (never for the tiler's valid slots).
//
// The operand, with y_s = x @ W_s the node projection (dense_proj_v4 of
// dense_fwd_v4.cu; bf16 in, float32 sums) and the edge side in float32 (v2's
// contract):
//   ep     = 0.0f, then ep = fmaf(e_t[slot][k], W_e[k][c], ep) for
//            k = 0, 1, ..., de - 1 in ascending order (one fma chain)
//   op[c]  = y_s[sender][c] + ep        (csr_op: added last, rounded once)
// Both kernels form ep by that chain in that order, however they lay out
// the loads.
#pragma once

#include "tile_walk.cuh"

namespace radargnn {

// A slot as the kernels see it: its receiver where it counts (-1 where
// not), its sender where it counts and the sender is a row of y_s (-1
// where the x part is 0).
struct CsrSlot {
    int rc, sn;
};

__device__ __forceinline__ CsrSlot csr_slot(int rc, int sn, int base,
                                            int node_block, int num_nodes,
                                            int n_x) {
    CsrSlot s;
    s.rc = receiver_in_block(rc, base, node_block, num_nodes) ? rc : -1;
    s.sn = s.rc >= 0 && sn >= 0 && sn < n_x ? sn : -1;
    return s;
}

// op = y + ep, rounded once: never contracted into the chain's last fma.
__device__ __forceinline__ float csr_op(float y, float ep) {
    return __fadd_rn(y, ep);
}

}  // namespace radargnn
