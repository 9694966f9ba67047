// The slot-row loop of the dense fixed-degree layout, shared by the forward
// kernel (dense_fwd_v4.cu) and the backward's routing pass
// (dense_bwd_v4.cu). Both run this one code path, so the backward recomputes
// the forward's op bitwise: same shared-memory layout, same mma order.
//
// Layout. Tile t covers receivers [t*R, (t+1)*R); slot t*TE + j*R + r
// (TE = R*K) holds receiver t*R+r's j-th in-edge, whose sender is
// tile_win[t]*node_block + senders_local[slot] (-1: empty slot).
//
// One block = one tile (blockIdx.x) x one 64-column slice of H
// (blockIdx.y), (R/16) warps, each owning 16 receivers. The W_s and W_e
// column slices stay in shared memory (transposed, k contiguous) for the
// whole block. For each slot row j the block loads the R sender rows of x
// and the R edge-feature rows (cp.async, zero-filled for empty slots,
// double-buffered so row j+1 loads while j multiplies) and each warp forms
//   acc[16 x 64] = x[sender] @ W_s[:, cols] + e_t[slot] @ W_e[:, cols]
// with mma.sync m16n8k16 bf16 -> f32, then hands it to `visit`.
#pragma once

#include "mma_bf16.cuh"

namespace radargnn {

// Shared memory the slot-row loop needs for these shapes, in bytes.
inline size_t dense_tile_smem_bytes(int d, int de, int r_tile) {
    const int lda = ((d + 15) & ~15) + 8;
    const int lde = ((de + 15) & ~15) + 8;
    return sizeof(__nv_bfloat16) *
           (static_cast<size_t>(kBlockCols) * (lda + lde) +
            2 * static_cast<size_t>(r_tile) * (lda + lde));
}

// Calls visit(j, acc, v0, v1) for each slot row j = 0..k-1 of this block's
// tile: acc[nt][q] is the product at receiver row m0 + g + (q >> 1) * 8 and
// column col0 + nt * 8 + tq * 2 + (q & 1) (m0 = 16 * warp, g = lane / 4,
// tq = lane % 4); v0 / v1 say whether rows m0+g / m0+g+8 hold valid slots.
// Needs dense_tile_smem_bytes(d, de, r_tile) bytes of dynamic shared memory.
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
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int kp = (d + 15) & ~15;             // depths padded to the mma k
    const int kpe = (de + 15) & ~15;
    const int lda = kp + 8;                    // +8: conflict-free fragments
    const int lde = kpe + 8;
    __nv_bfloat16* ws_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* we_s = ws_s + kBlockCols * lda;
    __nv_bfloat16* xa_s = we_s + kBlockCols * lde;   // 2 x [r_tile][lda]
    __nv_bfloat16* ea_s = xa_s + 2 * r_tile * lda;   // 2 x [r_tile][lde]

    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = warp * 16;                  // this warp's receiver rows
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);

    // W_s / W_e column slices, transposed; zero past h and past d / de
    for (int i = tid; i < kp * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        ws_s[n * lda + kk] = (kk < d && col < h)
            ? w_s[static_cast<size_t>(kk) * h + col] : zero;
    }
    for (int i = tid; i < kpe * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        we_s[n * lde + kk] = (kk < de && col < h)
            ? w_e[static_cast<size_t>(kk) * h + col] : zero;
    }
    // the depth padding [d, kp) of the row buffers is read by the mma and
    // never written by the gathers: zero it once
    for (int i = tid; i < 2 * r_tile * (kp - d); i += nthreads) {
        const int r = i / (kp - d), c = i % (kp - d);
        xa_s[r * lda + d + c] = zero;
    }
    for (int i = tid; i < 2 * r_tile * (kpe - de); i += nthreads) {
        const int r = i / (kpe - de), c = i % (kpe - de);
        ea_s[r * lde + de + c] = zero;
    }

    const int te = r_tile * k;
    const size_t tile_slot0 = static_cast<size_t>(t) * te;
    const int win0 = tile_win[t] * node_block;
    const int xchunks = d / 8, echunks = de / 8;   // 16-byte chunks per row

    auto issue = [&](int j, int buf) {
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
        __nv_bfloat16* xa = xa_s + buf * r_tile * lda;
        __nv_bfloat16* ea = ea_s + buf * r_tile * lde;
        for (int i = tid; i < r_tile * xchunks; i += nthreads) {
            const int r = i / xchunks, c = i % xchunks;
            const int sl = sloc[slot0 + r];
            const int s = win0 + sl;
            const bool ok = sl >= 0 && s < n_x;
            const __nv_bfloat16* src =
                ok ? x + static_cast<size_t>(s) * d + c * 8 : x;
            cp_async16(xa + r * lda + c * 8, src, ok);
        }
        for (int i = tid; i < r_tile * echunks; i += nthreads) {
            const int r = i / echunks, c = i % echunks;
            cp_async16(ea + r * lde + c * 8,
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
        warp_gemm(acc, xa_s + buf * r_tile * lda + m0 * lda, lda, ws_s, lda,
                  kp, g, tq);
        warp_gemm(acc, ea_s + buf * r_tile * lde + m0 * lde, lde, we_s, lde,
                  kpe, g, tq);

        // this thread's rows are m0+g and m0+g+8 of the slot row
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
        const int sl0 = sloc[slot0 + m0 + g];
        const int sl1 = sloc[slot0 + m0 + g + 8];
        visit(j, acc, sl0 >= 0 && win0 + sl0 < n_x,
              sl1 >= 0 && win0 + sl1 < n_x);
        __syncthreads();       // the buffer is refilled two steps later
    }
}

}  // namespace radargnn
