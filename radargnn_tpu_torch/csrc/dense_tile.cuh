// The slot-row loop shared by the forward kernels (dense_fwd_v4.cu,
// windowed_fwd_v3.cu) and the backward's routing passes (dense_bwd_v4.cu,
// windowed_bwd_v3.cu). A forward and its backward run this one code path,
// so the backward recomputes the forward's op bitwise: same shared-memory
// layout, same mma order.
//
// Layout. Tile t holds TE = R*K slots; slot t*TE + j*R + r sits in slot row
// j, row r, and its sender is tile_win[t]*node_block + senders_local[slot]
// (-1: empty slot). In the dense layout row r of tile t is receiver t*R+r
// in every slot row; in the windowed layout a slot's receiver is listed
// beside it (R*K = edge_tile, K slot rows of R slots each).
//
// One block = one tile x one 64-column slice of H (blockIdx.y), (R/16)
// warps, each owning 16 rows. The W_s and W_e column slices stay in shared
// memory (transposed, k contiguous) for the whole block. For each slot row
// j the block loads the R sender rows of x and the R edge-feature rows
// (cp.async, zero-filled for empty slots, double-buffered so row j+1 loads
// while j multiplies) and each warp forms
//   acc[16 x 64] = x[sender] @ W_s[:, cols] + e_t[slot] @ W_e[:, cols]
// with mma.sync m16n8k16 bf16 -> f32, then hands it to `visit`.
#pragma once

#include "mma_bf16.cuh"

namespace radargnn {

// Shared memory the slot-row loop needs for these shapes, in bytes (a
// multiple of 16: a caller may place its own buffers after it).
__host__ __device__ inline size_t dense_tile_smem_bytes(int d, int de,
                                                       int r_tile) {
    const int lda = ((d + 15) & ~15) + 8;
    const int lde = ((de + 15) & ~15) + 8;
    return sizeof(__nv_bfloat16) *
           (static_cast<size_t>(kBlockCols) * (lda + lde) +
            2 * static_cast<size_t>(r_tile) * (lda + lde));
}

// The loop's buffers in dynamic shared memory: the W_s / W_e column slices
// and the double-buffered x / e_t row tiles; depths padded to the mma k.
struct TileLayout {
    int kp, kpe, lda, lde;     // +8 on the strides: conflict-free fragments
    __nv_bfloat16* ws_s;
    __nv_bfloat16* we_s;
    __nv_bfloat16* xa_s;       // 2 x [r_tile][lda]
    __nv_bfloat16* ea_s;       // 2 x [r_tile][lde]
};

__device__ __forceinline__ TileLayout tile_layout(int d, int de,
                                                  int r_tile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    TileLayout L;
    L.kp = (d + 15) & ~15;
    L.kpe = (de + 15) & ~15;
    L.lda = L.kp + 8;
    L.lde = L.kpe + 8;
    L.ws_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    L.we_s = L.ws_s + kBlockCols * L.lda;
    L.xa_s = L.we_s + kBlockCols * L.lde;
    L.ea_s = L.xa_s + 2 * r_tile * L.lda;
    return L;
}

// Stages this block's W_s / W_e column slice (blockIdx.y), transposed,
// zero past h and past d / de, and zeroes the depth padding [d, kp) of the
// row buffers, which the mma reads and the gathers never write. The first
// barrier of tile_slot_rows publishes it; stage once per block.
__device__ __forceinline__ void tile_stage_weights(
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    int d, int de, int h, int r_tile) {
    const TileLayout L = tile_layout(d, de, r_tile);
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < L.kp * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        L.ws_s[n * L.lda + kk] = (kk < d && col < h)
            ? w_s[static_cast<size_t>(kk) * h + col] : zero;
    }
    for (int i = tid; i < L.kpe * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        L.we_s[n * L.lde + kk] = (kk < de && col < h)
            ? w_e[static_cast<size_t>(kk) * h + col] : zero;
    }
    for (int i = tid; i < 2 * r_tile * (L.kp - d); i += nthreads) {
        const int r = i / (L.kp - d), c = i % (L.kp - d);
        L.xa_s[r * L.lda + d + c] = zero;
    }
    for (int i = tid; i < 2 * r_tile * (L.kpe - de); i += nthreads) {
        const int r = i / (L.kpe - de), c = i % (L.kpe - de);
        L.ea_s[r * L.lde + de + c] = zero;
    }
}

// Calls visit(j, acc, v0, v1) for each slot row j = 0..k-1 of tile t:
// acc[nt][q] is the product at row m0 + g + (q >> 1) * 8 and column
// col0 + nt * 8 + tq * 2 + (q & 1) (m0 = 16 * warp, g = lane / 4,
// tq = lane % 4); v0 / v1 say whether rows m0+g / m0+g+8 hold a sender.
// Every thread of the block calls it with the same t; the weights must be
// staged (tile_stage_weights). Needs dense_tile_smem_bytes(d, de, r_tile)
// bytes of dynamic shared memory.
template <class Visit>
__device__ __forceinline__ void tile_slot_rows(
    int t,
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    int n_x, int d, int de, int r_tile, int k, int node_block,
    Visit&& visit) {
    const TileLayout L = tile_layout(d, de, r_tile);
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = warp * 16;                  // this warp's rows

    const int te = r_tile * k;
    const size_t tile_slot0 = static_cast<size_t>(t) * te;
    const int win0 = tile_win[t] * node_block;
    const int xchunks = d / 8, echunks = de / 8;   // 16-byte chunks per row

    auto issue = [&](int j, int buf) {
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
        __nv_bfloat16* xa = L.xa_s + buf * r_tile * L.lda;
        __nv_bfloat16* ea = L.ea_s + buf * r_tile * L.lde;
        for (int i = tid; i < r_tile * xchunks; i += nthreads) {
            const int r = i / xchunks, c = i % xchunks;
            const int sl = sloc[slot0 + r];
            const int s = win0 + sl;
            const bool ok = sl >= 0 && s < n_x;
            const __nv_bfloat16* src =
                ok ? x + static_cast<size_t>(s) * d + c * 8 : x;
            cp_async16(xa + r * L.lda + c * 8, src, ok);
        }
        for (int i = tid; i < r_tile * echunks; i += nthreads) {
            const int r = i / echunks, c = i % echunks;
            cp_async16(ea + r * L.lde + c * 8,
                       e_t + (slot0 + r) * static_cast<size_t>(de) + c * 8,
                       true);
        }
        cp_async_commit();
    };

    issue(0, 0);
    for (int j = 0; j < k; ++j) {
        const int buf = j & 1;
        if (j + 1 < k) {
            issue(j + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float acc[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
        warp_gemm(acc, L.xa_s + buf * r_tile * L.lda + m0 * L.lda, L.lda,
                  L.ws_s, L.lda, L.kp, g, tq);
        warp_gemm(acc, L.ea_s + buf * r_tile * L.lde + m0 * L.lde, L.lde,
                  L.we_s, L.lde, L.kpe, g, tq);

        // this thread's rows are m0+g and m0+g+8 of the slot row
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
        const int sl0 = sloc[slot0 + m0 + g];
        const int sl1 = sloc[slot0 + m0 + g + 8];
        visit(j, acc, sl0 >= 0 && win0 + sl0 < n_x,
              sl1 >= 0 && win0 + sl1 < n_x);
        __syncthreads();       // the buffer is refilled two steps later
    }
}

// The slot-row loop of the block's own tile (blockIdx.x), weights staged.
template <class Visit>
__device__ __forceinline__ void dense_tile_rows(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    int n_x, int d, int de, int h, int r_tile, int k, int node_block,
    Visit&& visit) {
    tile_stage_weights(w_s, w_e, d, de, h, r_tile);
    tile_slot_rows(blockIdx.x, x, e_t, sloc, tile_win, n_x, d, de, r_tile,
                   k, node_block, visit);
}

}  // namespace radargnn
