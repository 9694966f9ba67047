// The slot-row loop shared by every fused kernel of the port: the forward
// kernels (dense_fwd_v4.cu, windowed_fwd_v3.cu, csr_fwd_v2.cu) and the
// backward's routing passes (dense_bwd_v4.cu, windowed_bwd_v3.cu,
// csr_bwd_v2.cu). A forward and its backward run this one code path, so the
// backward recomputes the forward's op bitwise: same shared-memory layout,
// same mma order, same float32 summation order.
//
// Layout. Tile t holds TE = R*K slots; slot t*TE + j*R + r sits in slot row
// j, row r. A `senders` functor gives a slot's global sender, or -1 where
// the slot does not count: in the dense and windowed layouts
// (WindowSenders) it is tile_win[t]*node_block + senders_local[slot] (-1:
// empty slot); in the CSR layout (csr_tile.cuh) it is listed beside the
// slot, which counts where its receiver lies in the tile's node block. In
// the dense layout row r of tile t is receiver t*R+r in every slot row; in
// the windowed and CSR layouts a slot's receiver is listed beside it.
//
// One block = one 64-column slice of H (col0), (R/16) warps, each owning 16
// rows. The W_s column slice (transposed, k contiguous) and the edge
// policy's W_e slice stay in shared memory for the whole block. For each
// slot row j the block loads the R sender rows of x (zero-filled where a
// slot does not count) and the R edge-feature rows (cp.async,
// double-buffered so row j+1 loads while j multiplies) and each warp forms
//   acc[16 x 64] = x[sender] @ W_s[:, cols]      (mma.sync bf16 -> f32)
//                + e_t[slot] @ W_e[:, cols]      (the edge policy)
// then hands it to `visit`. The edge policy is EdgeBf16 (below: e_t and W_e
// in bf16, mma.sync into the same accumulators; the dense and windowed
// kernels) or EdgeF32 (csr_tile.cuh: float32, an fma chain added to the x
// part; v2's contract).
#pragma once

#include "mma_bf16.cuh"

namespace radargnn {

// The edge side in bf16: W_e transposed like W_s, the edge rows padded to
// the mma k, the product accumulated by mma.sync after the x part.
struct EdgeBf16 {
    using T = __nv_bfloat16;
    struct Smem {
        int kpe, lde;          // depth padded to the mma k; row stride (+8:
                               // conflict-free fragments)
        T* we_s;               // [64][lde]     W_e slice, transposed
        T* ea_s;               // 2 x [r][lde]  edge-feature rows
    };
    __host__ __device__ static size_t smem_bytes(int de, int r) {
        const int lde = ((de + 15) & ~15) + 8;
        return sizeof(T) * static_cast<size_t>(kBlockCols + 2 * r) * lde;
    }
    __device__ static Smem layout(unsigned char* base, int de, int r) {
        Smem S;
        S.kpe = (de + 15) & ~15;
        S.lde = S.kpe + 8;
        S.we_s = reinterpret_cast<T*>(base);
        S.ea_s = S.we_s + kBlockCols * S.lde;
        return S;
    }
    // The W_e slice, zero past de and h; zeroes the depth padding
    // [de, kpe) of the row buffers, which the mma reads and the gathers
    // never write.
    __device__ static void stage(const Smem& S, const T* __restrict__ w_e,
                                 int de, int h, int r, int col0) {
        const T zero = __float2bfloat16(0.0f);
        for (int i = threadIdx.x; i < S.kpe * kBlockCols; i += blockDim.x) {
            const int kk = i / kBlockCols, n = i % kBlockCols;
            const int col = col0 + n;
            S.we_s[n * S.lde + kk] = (kk < de && col < h)
                ? w_e[static_cast<size_t>(kk) * h + col] : zero;
        }
        for (int i = threadIdx.x; i < 2 * r * (S.kpe - de); i += blockDim.x) {
            const int rr = i / (S.kpe - de), c = i % (S.kpe - de);
            S.ea_s[rr * S.lde + de + c] = zero;
        }
    }
    __device__ static T* rows(const Smem& S, int buf, int r) {
        return S.ea_s + buf * r * S.lde;
    }
    // Starts the copy of the R edge rows from slot slot0 into buffer buf.
    __device__ static void issue(const Smem& S, int buf,
                                 const T* __restrict__ e_t, size_t slot0,
                                 int de, int r) {
        T* ea = rows(S, buf, r);
        const int chunks = de / 8;              // 16-byte chunks per row
        for (int i = threadIdx.x; i < r * chunks; i += blockDim.x) {
            const int rr = i / chunks, c = i % chunks;
            cp_async16(ea + rr * S.lde + c * 8,
                       e_t + (slot0 + rr) * static_cast<size_t>(de) + c * 8,
                       true);
        }
    }
    // acc += the warp's 16 edge rows (ea: the slot row's buffer) @ W_e.
    __device__ static void product(const Smem& S, const T* ea,
                                   float (*acc)[4], int m0, int g, int tq,
                                   int) {
        warp_gemm(acc, ea + m0 * S.lde, S.lde, S.we_s, S.lde, S.kpe, g, tq);
    }
};

// Senders of the dense and windowed layouts: tile t's window starts at node
// tile_win[t] * node_block; -1 for an empty slot or one past n_x. The
// index arrays are read-only for a kernel's life: read through the
// non-coherent cache (__ldg), as the kernels' __restrict__ parameters are.
struct WindowSenders {
    const int32_t* sloc;       // [T*TE]
    int win0, n_x;
    __device__ WindowSenders(const int32_t* sloc_, const int32_t* tile_win,
                             int t, int node_block, int n_x_)
        : sloc(sloc_), win0(__ldg(tile_win + t) * node_block), n_x(n_x_) {}
    __device__ int operator()(size_t slot) const {
        const int sl = __ldg(sloc + slot);
        return sl >= 0 && win0 + sl < n_x ? win0 + sl : -1;
    }
};

// The loop's buffers in dynamic shared memory: the W_s slice and the
// double-buffered sender rows, then the edge policy's.
template <class Edge>
struct RowSmem {
    int kp, lda;               // depth padded to the mma k; stride (+8)
    __nv_bfloat16* ws_s;       // [64][lda]    W_s slice, transposed
    __nv_bfloat16* xa_s;       // 2 x [r][lda] sender rows
    typename Edge::Smem e;
};

// Shared memory the slot-row loop needs for these shapes, in bytes (a
// multiple of 16: a caller may place its own buffers after it).
template <class Edge>
__host__ __device__ inline size_t slot_rows_smem_bytes(int d, int de,
                                                       int r) {
    const int lda = ((d + 15) & ~15) + 8;
    return sizeof(__nv_bfloat16) * static_cast<size_t>(kBlockCols + 2 * r) *
               lda +
           Edge::smem_bytes(de, r);
}

template <class Edge>
__device__ __forceinline__ RowSmem<Edge> row_smem(int d, int de, int r) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    RowSmem<Edge> L;
    L.kp = (d + 15) & ~15;
    L.lda = L.kp + 8;
    L.ws_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    L.xa_s = L.ws_s + kBlockCols * L.lda;
    L.e = Edge::layout(
        reinterpret_cast<unsigned char*>(L.xa_s + 2 * r * L.lda), de, r);
    return L;
}

// Stages the W_s / W_e column slice [col0, col0 + 64), zero past h and
// past d, and zeroes the depth padding [d, kp) of the sender-row buffers.
// The first barrier of slot_rows publishes it; stage once per block.
template <class Edge>
__device__ __forceinline__ void stage_weights(
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const typename Edge::T* __restrict__ w_e,  // [de, h]
    int d, int de, int h, int r, int col0) {
    const RowSmem<Edge> L = row_smem<Edge>(d, de, r);
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < L.kp * kBlockCols; i += blockDim.x) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        L.ws_s[n * L.lda + kk] = (kk < d && col < h)
            ? w_s[static_cast<size_t>(kk) * h + col] : zero;
    }
    for (int i = threadIdx.x; i < 2 * r * (L.kp - d); i += blockDim.x) {
        const int rr = i / (L.kp - d), c = i % (L.kp - d);
        L.xa_s[rr * L.lda + d + c] = zero;
    }
    Edge::stage(L.e, w_e, de, h, r, col0);
}

// Calls visit(j, acc, v0, v1, e_rows) for each slot row j = 0..k-1 of tile
// t: acc[nt][q] is op at row m0 + g + (q >> 1) * 8 and column
// col0 + nt * 8 + tq * 2 + (q & 1) (m0 = 16 * warp, g = lane / 4,
// tq = lane % 4); v0 / v1 say whether rows m0+g / m0+g+8 count (a sender);
// e_rows is the slot row's edge features in shared memory (the policy's
// rows). Every thread of the block calls it with the same t; the weights
// must be staged (stage_weights). Needs slot_rows_smem_bytes<Edge>(d, de,
// r) bytes of dynamic shared memory.
template <class Edge, class Senders, class Visit>
__device__ __forceinline__ void slot_rows(
    int t,
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const typename Edge::T* __restrict__ e_t,  // [T*TE, de]
    const Senders& senders, int d, int de, int r, int k, Visit&& visit) {
    const RowSmem<Edge> L = row_smem<Edge>(d, de, r);
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = warp * 16;                  // this warp's rows

    const size_t tile_slot0 = static_cast<size_t>(t) * r * k;
    const int xchunks = d / 8;                 // 16-byte chunks per row

    auto issue = [&](int j, int buf) {
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r;
        __nv_bfloat16* xa = L.xa_s + buf * r * L.lda;
        for (int i = tid; i < r * xchunks; i += nthreads) {
            const int rr = i / xchunks, c = i % xchunks;
            const int s = senders(slot0 + rr);
            const __nv_bfloat16* src =
                s >= 0 ? x + static_cast<size_t>(s) * d + c * 8 : x;
            cp_async16(xa + rr * L.lda + c * 8, src, s >= 0);
        }
        Edge::issue(L.e, buf, e_t, slot0, de, r);
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
        warp_gemm(acc, L.xa_s + buf * r * L.lda + m0 * L.lda, L.lda,
                  L.ws_s, L.lda, L.kp, g, tq);
        const typename Edge::T* ea = Edge::rows(L.e, buf, r);
        Edge::product(L.e, ea, acc, m0, g, tq, de);

        // this thread's rows are m0+g and m0+g+8 of the slot row
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r;
        visit(j, acc, senders(slot0 + m0 + g) >= 0,
              senders(slot0 + m0 + g + 8) >= 0, ea);
        __syncthreads();       // the buffer is refilled two steps later
    }
}

// The slot-row loop of the block's own tile (blockIdx.x) and column slice
// (blockIdx.y) in the dense or windowed layout, weights staged.
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
    stage_weights<EdgeBf16>(w_s, w_e, d, de, h, r_tile,
                            blockIdx.y * kBlockCols);
    slot_rows<EdgeBf16>(blockIdx.x, x, e_t,
                        WindowSenders(sloc, tile_win, blockIdx.x, node_block,
                                      n_x),
                        d, de, r_tile, k, visit);
}

}  // namespace radargnn
