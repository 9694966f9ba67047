// The v1 hoisted aggregation's operand, shared by its forward
// (hoisted_fwd_v1.cu, on the walk of csr_walk.cuh) and its backward
// (hoisted_bwd_v1.cu), so the backward's routing recomputes the forward's
// operand bit for bit:
//
//   op[s][c] = (y_s[senders_t[s]][c] + sum over k of e_t[s][k] W_e[k][c])
//              + b[c]
//
// in float32: the edge product is one fma chain from 0.0f in ascending k
// (d_e = 16 at the flagship: 16 fma per output), then the gathered row and
// the bias are added in the TPU kernel's order (`add + e @ W_e + b`). Both
// kernels form the chain that way, however they lay out their loads, and
// finish with v1_op.
#pragma once

namespace radargnn {

constexpr int kV1Cols = 64;              // columns of a slice

// The operand from the gathered row, the finished edge chain and the bias,
// in the TPU kernel's order, each add rounded once (never contracted).
__device__ __forceinline__ float v1_op(float add, float ep, float bias) {
    return __fadd_rn(__fadd_rn(add, ep), bias);
}

}  // namespace radargnn
