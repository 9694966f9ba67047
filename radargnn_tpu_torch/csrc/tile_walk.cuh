// The walk over a node block's tiles that the block-per-node-block forward
// kernels share (windowed_fwd_v3.cu, csr_fwd_v2.cu): the block's tile range
// by binary search over the non-decreasing tile_blocks, and the landing of
// a slot row's op in a shared-memory accumulator by an exact float atomic
// max; and the strict routing test of the backward kernels.
#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace radargnn {

// First index i in [0, n) with a[i] >= v (n if none); a non-decreasing.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ a,
                                           int n, int v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < v) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Whether receiver rc lies in the node block at `base` (rc -1: empty slot).
__device__ __forceinline__ bool receiver_in_block(int rc, int base,
                                                  int node_block,
                                                  int num_nodes) {
    return rc >= 0 && rc < num_nodes && rc >= base && rc < base + node_block;
}

// The strict routing test of the TPU kernel and of ops/dense_aggregate.py
// (_routes): |op - inner| <= 1e-5 |inner| + 1e-5, rounded step by step as
// torch rounds it (no fused multiply-add).
__device__ __forceinline__ bool routes(float op, float inner) {
    return fabsf(__fsub_rn(op, inner)) <=
           __fadd_rn(__fmul_rn(1e-5f, fabsf(inner)), 1e-5f);
}

// *addr = max(*addr, v) for floats, atomically: a float with the sign bit
// clear orders as a signed int, one with it set orders inversely as an
// unsigned int. Exact, so the result is the same in any order.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0) {
        atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
    } else {
        atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
    }
}

// Lands this thread's part of a slot row's op (the slot-row loop's acc:
// the slots at row0 and row0 + 8, columns nt * 8 + tq * 2 + {0, 1}) in the
// block's [node_block x 64] accumulator acc_s (row stride ld) by atomic
// max, where the slot's receiver lies in the block at `base`.
__device__ __forceinline__ void land_max(float* acc_s, int ld,
                                         const float (*acc)[4],
                                         const int32_t* __restrict__ recv,
                                         size_t row0, int base,
                                         int node_block, int num_nodes,
                                         int tq) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int rc = recv[row0 + half * 8];
        if (!receiver_in_block(rc, base, node_block, num_nodes)) continue;
        float* row = acc_s + (rc - base) * ld + tq * 2;
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
            atomic_max_f32(row + nt * 8, acc[nt][half * 2]);
            atomic_max_f32(row + nt * 8 + 1, acc[nt][half * 2 + 1]);
        }
    }
}

}  // namespace radargnn
