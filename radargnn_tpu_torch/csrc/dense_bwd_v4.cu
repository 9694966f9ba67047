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
//  2. slot_products: [d_xg | d_e] = d_op @ [W_s | W_e]^T, one block per 64
//     slots x 64 output columns, mma.sync over 64-deep chunks of h.
//  3. weight_partials: [x_g | e_t]^T @ d_op over P fixed chunks of slots,
//     one f32 partial [d+de, hp] per chunk; the gathered rows and d_op are
//     staged as they lie and ldmatrix.trans transposes the fragments.
//  4. reduce_partials: dW = sum of the P partials, in order of p.
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

namespace {

using namespace radargnn;

constexpr int kDepth = 64;               // depth chunk of slot_products
constexpr int kSlots = 32;               // slot chunk of weight_partials

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
                    [&](int j, float (*acc)[4], bool v0, bool v1) {
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
    const int32_t* __restrict__ tile_win,      // [T]
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
                    const int snd = tile_win[slot / te] * node_block + sl;
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

}  // namespace

extern "C" {

// Shared memory the routing pass needs for these shapes, in bytes.
size_t dense_bwd_v4_smem_bytes(int d, int de, int r_tile) {
    return dense_tile_smem_bytes(d, de, r_tile);
}

// Slots each weight partial covers (a multiple of the 32-slot step).
int dense_bwd_v4_chunk(int n_slots, int n_part) {
    const int per = (n_slots + n_part - 1) / n_part;
    return (per + kSlots - 1) / kSlots * kSlots;
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

    const size_t smem = dense_tile_smem_bytes(d, de, r_tile);
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

    const int nc = d + de;
    slot_products_kernel<<<dim3((n_slots + kBlockCols - 1) / kBlockCols,
                                (nc + kBlockCols - 1) / kBlockCols),
                           128, 0, st>>>(
        dop, wsb, web, static_cast<__nv_bfloat16*>(d_xg),
        static_cast<__nv_bfloat16*>(d_e), n_slots, d, de, h, hp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    weight_partials_kernel<<<dim3((nc + kBlockCols - 1) / kBlockCols,
                                  hp / kBlockCols, n_part),
                             128, 0, st>>>(
        xb, etb, sl, tw, dop, static_cast<float*>(partial), n_x, d, de, hp,
        te, node_block, n_slots, dense_bwd_v4_chunk(n_slots, n_part));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    reduce_partials_kernel<<<(nc * h + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), n_part, d, de, h, hp,
        static_cast<float*>(dw_s), static_cast<float*>(dw_e));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
