// The walk over a node block's tiles that the block-per-node-block forward
// kernels share (windowed_fwd_v3.cu; csr_walk.cuh, the walk of
// csr_fwd_v2.cu and hoisted_fwd_v1.cu): the block's tile range
// by binary search over the non-decreasing tile_blocks, and the landing of
// a warp's group of ops in a shared-memory accumulator by an exact atomic
// max of ordered keys; and the strict routing test and the packing of its
// bits, which the VJP-mode forwards (dense_fwd_v4.cu, windowed_fwd_v3.cu)
// save for their backward.
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

// A float as an int that orders as the float does (-0 below +0): a
// non-negative float keeps its bits, a negative one flips its magnitude
// bits. One signed atomicMax of the keys then lands a float max, with no
// branch on the sign.
__device__ __forceinline__ int ordered_key(float v) {
    const int i = __float_as_int(v);
    return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float ordered_float(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// Lands a warp's 16 rows of op (acc: rows g (half 0) and g + 8 (half 1),
// g = lane / 4, columns nt * 8 + tq * 2 + {0, 1}; receivers rc[half]) in
// the block's [node_block x 64] accumulator of ordered keys (row stride
// ld) by atomic max, where a row's receiver lies in the block at `base`.
// A receiver's slots lie together in the tiler's order, so where all 8
// rows of a half share one receiver, a butterfly over them leaves the
// maxima on every lane and each lane lands 2 of the 64 columns: 2 atomic
// instructions with all 32 lanes active, in place of 16 with the 8 rows'
// lanes on 8 equal addresses, which serialise. Other halves land row by
// row (folding their shorter runs by shuffles measured no faster, and
// slower under the spread tiler; PERF.md). acc is overwritten. Every lane
// must call it (it shuffles across the warp).
__device__ __forceinline__ void land_max_runs(int* keys_s, int ld,
                                              float (*acc)[4], const int* rc,
                                              int base, int node_block,
                                              int num_nodes, int g, int tq) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int key =
            receiver_in_block(rc[half], base, node_block, num_nodes)
                ? rc[half] : -1;
        const int key0 = __shfl_sync(0xffffffffu, key, 0);
        if (__all_sync(0xffffffffu, key == key0)) {
            if (key0 < 0) continue;
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
                for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        float& a = acc[nt][half * 2 + c];
                        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
                    }
                }
            }
            // lane g lands column tile g of its tq
            float v0 = acc[0][half * 2], v1 = acc[0][half * 2 + 1];
#pragma unroll
            for (int nt = 1; nt < kColTiles; ++nt) {
                if (g == nt) {
                    v0 = acc[nt][half * 2];
                    v1 = acc[nt][half * 2 + 1];
                }
            }
            int* at = keys_s + (key0 - base) * ld + g * 8 + tq * 2;
            atomicMax(at, ordered_key(v0));
            atomicMax(at + 1, ordered_key(v1));
        } else if (key >= 0) {
            int* row = keys_s + (key - base) * ld + tq * 2;
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                atomicMax(row + nt * 8, ordered_key(acc[nt][half * 2]));
                atomicMax(row + nt * 8 + 1,
                          ordered_key(acc[nt][half * 2 + 1]));
            }
        }
    }
}

// The warp's routing bits of one slot row over the block's 64 columns:
// sel[nt][q] in the acc layout above. Returns, on the lanes with tq == 0,
// the two 32-bit words (columns col0 .. col0+31, col0+32 .. col0+63) of
// row m0+g (half 0) and of row m0+g+8 (half 1); every lane must call it
// (it shuffles across the four lanes of a row).
__device__ __forceinline__ void pack_row_bits(bool (*sel)[4], int tq,
                                              uint32_t (*words)[2]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                if (sel[nt][half * 2 + c]) {
                    w[nt >> 2] |= 1u << ((nt & 3) * 8 + tq * 2 + c);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            w[i] |= __shfl_xor_sync(0xffffffffu, w[i], 1);
            w[i] |= __shfl_xor_sync(0xffffffffu, w[i], 2);
            words[half][i] = w[i];
        }
    }
}

}  // namespace radargnn
