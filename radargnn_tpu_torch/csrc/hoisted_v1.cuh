// The v1 hoisted aggregation's operand, shared by its forward
// (hoisted_fwd_v1.cu) and its backward (hoisted_bwd_v1.cu), so the
// backward's routing recomputes the forward's operand bit for bit:
//
//   op[s][c] = (y_s[senders_t[s]][c] + sum over k of e_t[s][k] W_e[k][c])
//              + b[c]
//
// in float32: the edge product is one fma chain in ascending k (d_e = 16 at
// the flagship: 16 fma per output), then the gathered row and the bias are
// added in the TPU kernel's order (`add + e @ W_e + b`).
//
// Both kernels form the chain from 0.0f in ascending k and finish with
// v1_op, however they lay out their loads. The forward's v1_operands forms
// the operands of four slots at one column at once: per k it reads one W_e
// value and one float4 of the four slots' edge features, so four fma cost
// two shared-memory loads (one fma per load pair would leave the kernel
// bound by shared-memory loads).
//
// The forward's shared-memory layouts: a 64-column slice of W_e stored
// transposed, we_t[c * (de + 1) + k] (the 64 threads that own the slice's
// columns read 64 different banks); the edge features k-major,
// eT[k * ld + s], with ld a multiple of 4 so the four slots' values are
// one 16-byte load (the same address for every lane of a warp: a
// broadcast).
#pragma once

#include <stdint.h>

namespace radargnn {

constexpr int kV1Cols = 64;              // columns of a slice
constexpr int kV1Slots = 4;              // slots a thread carries at once

// The operand from the gathered row, the finished edge chain and the bias,
// in the TPU kernel's order, each add rounded once (never contracted).
__device__ __forceinline__ float v1_op(float add, float ep, float bias) {
    return __fadd_rn(__fadd_rn(add, ep), bias);
}

// op[j] for the slots s0 + j (j < 4) at one column: eT points at eT[s0]
// (k-major, row stride ld), we_col at the column's W_e values (stride 1).
__device__ __forceinline__ void v1_operands(const float (&add)[kV1Slots],
                                            const float* __restrict__ eT,
                                            int ld,
                                            const float* __restrict__ we_col,
                                            int de, float bias,
                                            float (&op)[kV1Slots]) {
    float ep[kV1Slots] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < de; ++k) {
        const float4 e = *reinterpret_cast<const float4*>(eT + k * ld);
        const float w = we_col[k];
        ep[0] = fmaf(e.x, w, ep[0]);
        ep[1] = fmaf(e.y, w, ep[1]);
        ep[2] = fmaf(e.z, w, ep[2]);
        ep[3] = fmaf(e.w, w, ep[3]);
    }
#pragma unroll
    for (int j = 0; j < kV1Slots; ++j) op[j] = v1_op(add[j], ep[j], bias);
}

// Stages the slice [col0, col0 + 64) of W_e (transposed, zero past h) and
// of b. Every thread of the block calls it; the caller syncs after.
__device__ __forceinline__ void v1_stage_weights(
    const float* __restrict__ w_e, const float* __restrict__ b, int de,
    int h, int col0, float* we_t, float* b_s) {
    for (int i = threadIdx.x; i < de * kV1Cols; i += blockDim.x) {
        const int k = i / kV1Cols, c = i % kV1Cols;
        const int col = col0 + c;
        we_t[c * (de + 1) + k] =
            col < h ? w_e[static_cast<size_t>(k) * h + col] : 0.0f;
    }
    for (int c = threadIdx.x; c < kV1Cols; c += blockDim.x) {
        b_s[c] = col0 + c < h ? b[col0 + c] : 0.0f;
    }
}

// Stages `rows` edge rows from slot s0 k-major into eT (row stride ld),
// zero for the slots past `rows` up to a multiple of 4. Every thread of the
// block calls it; the caller syncs after.
__device__ __forceinline__ void v1_stage_edges(const float* __restrict__ e_t,
                                               int64_t s0, int rows,
                                               int de, float* eT, int ld) {
    const int padded = (rows + kV1Slots - 1) / kV1Slots * kV1Slots;
    for (int i = threadIdx.x; i < padded * de; i += blockDim.x) {
        const int s = i / de, k = i % de;
        eT[k * ld + s] = s < rows ? __ldg(e_t + (s0 + s) * de + k) : 0.0f;
    }
}

}  // namespace radargnn
