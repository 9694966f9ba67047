// The passes of the fused backward that follow the routing pass, shared by
// dense_bwd_v4.cu, windowed_bwd_v3.cu and csr_bwd_v2.cu: given the routed
// d_op [n_slots, hp] bf16 (hp = h rounded up to 64, zero past h),
//   [d_xg | d_e][slot] = bf16(d_op[slot] @ [W_s | W_e]^T)
//   dW_s = sum over slots of x[sender]^T d_op,  dW_e = sum of e_t^T d_op
// with a slot's sender tile_win[slot / te] * node_block + sloc[slot] (empty
// slots, sloc < 0, add nothing), or sloc[slot] itself where tile_win is
// null (global senders, the CSR layout). With de = 0 the passes compute
// d_xg and dW_s alone (csr_bwd_v2.cu forms d_e and dW_e in float32). No
// atomics and fixed summation orders, so two runs on the same inputs are
// bitwise equal:
//  - slot_products: one block per 64 slots x 64 output columns, mma.sync
//    over 64-deep chunks of h;
//  - weight_partials: [x_g | e_t]^T @ d_op over P fixed chunks of slots,
//    one f32 partial [d+de, hp] per chunk; the gathered rows and d_op are
//    staged as they lie and ldmatrix.trans transposes the fragments;
//  - reduce_partials: dW = the sum of the P partials, in order of p.
//
// The kernels live in namespace radargnn, not in an anonymous namespace:
// each including .cu file uses `using namespace radargnn` inside its own
// anonymous namespace, and nvcc's host stubs cannot tell two anonymous
// namespaces apart. Each .cu file builds into its own shared library.
#pragma once

#include "mma_bf16.cuh"

namespace radargnn {

constexpr int kDepth = 64;               // depth chunk of slot_products
constexpr int kSlots = 32;               // slot chunk of weight_partials

// [d_xg | d_e][slot] = d_op[slot] @ [W_s | W_e]^T; output column n < d is
// d_xg's, d <= n < d + de is d_e's. Both operands come in 64-deep chunks
// of h by 16-byte cp.async, double-buffered.
__global__ void __launch_bounds__(128) slot_products_kernel(
    const __nv_bfloat16* __restrict__ d_op,    // [n_slots, hp]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    __nv_bfloat16* __restrict__ d_xg,          // [n_slots, d]
    __nv_bfloat16* __restrict__ d_e,           // [n_slots, de]
    int n_slots, int d, int de, int h, int hp) {
    constexpr int ld = kDepth + 8;
    __shared__ __align__(16) __nv_bfloat16 a_s[2][kBlockCols * ld];
    __shared__ __align__(16) __nv_bfloat16 b_s[2][kBlockCols * ld];
    const int row0 = blockIdx.x * kBlockCols;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m0 = (tid >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int nc = d + de;

    // rows r of both tiles: slot row0 + r of d_op, output column col0 + r
    // of [W_s | W_e] (zero past d + de and past h; h is a multiple of 8)
    auto stage = [&](int k0, int buf) {
        for (int i = tid; i < kBlockCols * (kDepth / 8); i += blockDim.x) {
            const int r = i / (kDepth / 8), c = i % (kDepth / 8);
            const int slot = row0 + r;
            const bool ok = slot < n_slots;
            cp_async16(&a_s[buf][r * ld + c * 8],
                       ok ? d_op + static_cast<size_t>(slot) * hp + k0 + c * 8
                          : d_op,
                       ok);
            const int col = col0 + r, hk = k0 + c * 8;
            const __nv_bfloat16* w = nullptr;
            if (hk < h && col < d) {
                w = w_s + static_cast<size_t>(col) * h + hk;
            } else if (hk < h && col < nc) {
                w = w_e + static_cast<size_t>(col - d) * h + hk;
            }
            cp_async16(&b_s[buf][r * ld + c * 8], w ? w : w_s, w != nullptr);
        }
        cp_async_commit();
    };

    float acc[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;

    const int chunks = hp / kDepth;
    stage(0, 0);
    for (int kc = 0; kc < chunks; ++kc) {
        const int buf = kc & 1;
        if (kc + 1 < chunks) {
            stage((kc + 1) * kDepth, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        warp_gemm(acc, &a_s[buf][m0 * ld], ld, b_s[buf], ld, kDepth, g, tq);
        __syncthreads();       // the buffer is refilled two chunks later
    }

#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int slot = row0 + m0 + g + (q >> 1) * 8;
            const int col = col0 + nt * 8 + tq * 2 + (q & 1);
            if (slot >= n_slots) continue;
            const __nv_bfloat16 v = __float2bfloat16_rn(acc[nt][q]);
            if (col < d) {
                d_xg[static_cast<size_t>(slot) * d + col] = v;
            } else if (col < nc) {
                d_e[static_cast<size_t>(slot) * de + col - d] = v;
            }
        }
    }
}

// partial[p][m][n] = sum over the slots of chunk p of A[slot][m] d_op[slot][n]
// with A[slot] = [x[sender(slot)] | e_t[slot]], zero for empty slots. The
// rows are staged as they lie in memory ([slot][feature], 16-byte cp.async,
// double-buffered) and ldmatrix.trans hands the mma their transposes.
__global__ void __launch_bounds__(128) weight_partials_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ e_t,     // [n_slots, de]
    const int32_t* __restrict__ sloc,          // [n_slots]
    const int32_t* __restrict__ tile_win,      // [T] or null
    const __nv_bfloat16* __restrict__ d_op,    // [n_slots, hp]
    float* __restrict__ partial,               // [P, d + de, hp]
    int n_x, int d, int de, int hp, int te, int node_block, int n_slots,
    int chunk) {
    constexpr int ld = kBlockCols + 8;
    __shared__ __align__(16) __nv_bfloat16 a_s[2][kSlots * ld];  // [s][m]
    __shared__ __align__(16) __nv_bfloat16 b_s[2][kSlots * ld];  // [s][n]
    const int m_blk = blockIdx.x * kBlockCols;
    const int n_blk = blockIdx.y * kBlockCols;
    const int p = blockIdx.z;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m0 = (tid >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int mc = d + de;
    const int s_begin = p * chunk;
    const int s_end = min(s_begin + chunk, n_slots);

    auto stage = [&](int s0, int buf) {
        for (int i = tid; i < kSlots * (kBlockCols / 8); i += blockDim.x) {
            const int s = i / (kBlockCols / 8), c = i % (kBlockCols / 8);
            const int slot = s0 + s;
            const __nv_bfloat16* src_a = nullptr;
            const __nv_bfloat16* src_b = nullptr;
            if (slot < s_end) {
                const int m = m_blk + c * 8;
                const int sl = sloc[slot];
                if (sl >= 0 && m < d) {
                    const int snd = tile_win == nullptr
                        ? sl : tile_win[slot / te] * node_block + sl;
                    if (snd < n_x) src_a = x + static_cast<size_t>(snd) * d + m;
                } else if (sl >= 0 && m < mc) {
                    src_a = e_t + static_cast<size_t>(slot) * de + (m - d);
                }
                src_b = d_op + static_cast<size_t>(slot) * hp + n_blk + c * 8;
            }
            cp_async16(&a_s[buf][s * ld + c * 8], src_a ? src_a : x,
                       src_a != nullptr);
            cp_async16(&b_s[buf][s * ld + c * 8], src_b ? src_b : d_op,
                       src_b != nullptr);
        }
        cp_async_commit();
    };

    float acc[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;

    // lane t addresses row t % 8 of 8x8 matrix t / 8
    const int mrow = lane & 7, mat = lane >> 3;
    if (s_begin < s_end) stage(s_begin, 0);
    for (int s0 = s_begin, it = 0; s0 < s_end; s0 += kSlots, ++it) {
        const int buf = it & 1;
        if (s0 + kSlots < s_end) {
            stage(s0 + kSlots, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
#pragma unroll
        for (int k0 = 0; k0 < kSlots; k0 += 16) {
            // A (16 features x 16 slots) = the transpose of rows
            // k0..k0+15 of a_s: matrices (k+0, m+0) (k+0, m+8) (k+8, m+0)
            // (k+8, m+8) are the fragment's a0..a3
            uint32_t a[4];
            ldmatrix_x4_trans(a, &a_s[buf][(k0 + mrow + (mat >> 1) * 8) * ld
                                           + m0 + (mat & 1) * 8]);
#pragma unroll
            for (int nt = 0; nt < kColTiles; nt += 2) {
                // B (16 slots x 8 columns) for tiles nt and nt+1: matrices
                // (k+0, nt) (k+8, nt) (k+0, nt+1) (k+8, nt+1)
                uint32_t b[4];
                ldmatrix_x4_trans(b, &b_s[buf][(k0 + mrow + (mat & 1) * 8) * ld
                                               + nt * 8 + (mat >> 1) * 8]);
                mma_bf16_16816(acc[nt], a, b);
                mma_bf16_16816(acc[nt + 1], a, b + 2);
            }
        }
        __syncthreads();       // the buffer is refilled two steps later
    }

#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int m = m_blk + m0 + g + (q >> 1) * 8;
            const int n = n_blk + nt * 8 + tq * 2 + (q & 1);
            if (m < mc) {
                partial[(static_cast<size_t>(p) * mc + m) * hp + n] =
                    acc[nt][q];
            }
        }
    }
}

// dW_s / dW_e = the sum of the partials, in order of p
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       int n_part, int d, int de, int h,
                                       int hp, float* __restrict__ dw_s,
                                       float* __restrict__ dw_e) {
    const int mc = d + de;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= mc * h) return;
    const int m = i / h, n = i % h;
    float s = 0.0f;
    for (int p = 0; p < n_part; ++p) {
        s += partial[(static_cast<size_t>(p) * mc + m) * hp + n];
    }
    if (m < d) {
        dw_s[static_cast<size_t>(m) * h + n] = s;
    } else {
        dw_e[static_cast<size_t>(m - d) * h + n] = s;
    }
}

// Slots each weight partial covers (a multiple of the 32-slot step).
inline int slot_grads_chunk(int n_slots, int n_part) {
    const int per = (n_slots + n_part - 1) / n_part;
    return (per + kSlots - 1) / kSlots * kSlots;
}

// Launches slot_products, weight_partials and reduce_partials on `st`;
// returns the first launch error. Scratch: partial [n_part, d+de, hp] f32.
inline cudaError_t launch_slot_grads(
    const __nv_bfloat16* x, const __nv_bfloat16* w_s,
    const __nv_bfloat16* e_t, const __nv_bfloat16* w_e, const int32_t* sloc,
    const int32_t* tile_win, const __nv_bfloat16* d_op, float* partial,
    __nv_bfloat16* d_xg, __nv_bfloat16* d_e, float* dw_s, float* dw_e,
    int n_x, int d, int de, int h, int hp, int n_slots, int te,
    int node_block, int n_part, cudaStream_t st) {
    const int nc = d + de;
    slot_products_kernel<<<dim3((n_slots + kBlockCols - 1) / kBlockCols,
                                (nc + kBlockCols - 1) / kBlockCols),
                           128, 0, st>>>(d_op, w_s, w_e, d_xg, d_e, n_slots,
                                         d, de, h, hp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    weight_partials_kernel<<<dim3((nc + kBlockCols - 1) / kBlockCols,
                                  hp / kBlockCols, n_part),
                             128, 0, st>>>(
        x, e_t, sloc, tile_win, d_op, partial, n_x, d, de, hp, te,
        node_block, n_slots, slot_grads_chunk(n_slots, n_part));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    reduce_partials_kernel<<<(nc * h + 255) / 256, 256, 0, st>>>(
        partial, n_part, d, de, h, hp, dw_s, dw_e);
    return cudaGetLastError();
}

}  // namespace radargnn
