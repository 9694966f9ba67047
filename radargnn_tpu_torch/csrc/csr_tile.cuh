// The CSR (v2) layout's part of the shared slot-row loop (dense_tile.cuh):
// its senders and its float32 edge policy, for the forward kernel
// (csr_fwd_v2.cu). The backward (csr_bwd_v2.cu) rebuilds the same op from
// the node projection and this policy's fma chain, in its own code.
//
// Layout (receiver-CSR tiles, ops/windowed_tiles.py: prepare_csr_tiles): a
// slot carries its global sender senders[slot] and its global receiver
// recv[slot] (-1: empty slot); it counts only where its receiver lies in
// the tile's node block tile_blocks[t] (receiver_in_block).
//
// The v2 contract keeps the two products in different types:
//   op[slot] = x[sender] @ W_s          bf16 in, mma.sync, float32 sums
//            + e_t[slot] @ W_e          float32 in, float32 fma chain
// so the edge features and W_e stay float32 on the card, as on the TPU.
#pragma once

#include "dense_tile.cuh"
#include "tile_walk.cuh"

namespace radargnn {

constexpr int kWeLd = kBlockCols + 4;    // float32 W_e slice row stride

// Senders of the CSR layout in a tile of the block at `base`: -1 where the
// slot does not count or its sender lies past n_x.
struct CsrSenders {
    const int32_t* senders;    // [T*TE]
    const int32_t* recv;       // [T*TE]
    int base, node_block, num_nodes, n_x;
    __device__ int operator()(size_t slot) const {
        const int s = __ldg(senders + slot);
        return receiver_in_block(__ldg(recv + slot), base, node_block,
                                 num_nodes) &&
                       s >= 0 && s < n_x
                   ? s
                   : -1;
    }
};

// The edge side in float32: W_e k-major, the edge rows unpadded (de a
// multiple of 4: 16-byte rows), e @ W_e as one fma chain per output, k
// ascending, added to the x part (the TPU kernel's two dots summed).
struct EdgeF32 {
    using T = float;
    struct Smem {
        int lde;               // row stride (+4 floats: the 8 rows of a
                               // fragment hit 8 different banks)
        T* we_s;               // [de][kWeLd]  W_e slice
        T* ea_s;               // 2 x [r][lde] edge-feature rows
    };
    __host__ __device__ static size_t smem_bytes(int de, int r) {
        return sizeof(T) * (static_cast<size_t>(de) * kWeLd +
                            2 * static_cast<size_t>(r) * (de + 4));
    }
    __device__ static Smem layout(unsigned char* base, int de, int) {
        Smem S;
        S.lde = de + 4;
        S.we_s = reinterpret_cast<T*>(base);
        S.ea_s = S.we_s + de * kWeLd;
        return S;
    }
    // The W_e slice, zero past h.
    __device__ static void stage(const Smem& S, const T* __restrict__ w_e,
                                 int de, int h, int, int col0) {
        for (int i = threadIdx.x; i < de * kBlockCols; i += blockDim.x) {
            const int kk = i / kBlockCols, n = i % kBlockCols;
            const int col = col0 + n;
            S.we_s[kk * kWeLd + n] =
                col < h ? w_e[static_cast<size_t>(kk) * h + col] : 0.0f;
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
        const int chunks = de / 4;              // 16-byte chunks per row
        for (int i = threadIdx.x; i < r * chunks; i += blockDim.x) {
            const int rr = i / chunks, c = i % chunks;
            cp_async16(ea + rr * S.lde + c * 4,
                       e_t + (slot0 + rr) * static_cast<size_t>(de) + c * 4,
                       true);
        }
    }
    // acc += the warp's 16 edge rows (ea: the slot row's buffer) @ W_e.
    __device__ static void product(const Smem& S, const T* ea,
                                   float (*acc)[4], int m0, int g, int tq,
                                   int de) {
        const float* e0 = ea + (m0 + g) * S.lde;
        const float* e1 = e0 + 8 * S.lde;
        float ep[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) ep[nt][q] = 0.0f;
        for (int kk = 0; kk < de; ++kk) {
            const float a0 = e0[kk], a1 = e1[kk];
            const float* wr = S.we_s + kk * kWeLd + tq * 2;
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                const float2 w = *reinterpret_cast<const float2*>(wr + nt * 8);
                ep[nt][0] = fmaf(a0, w.x, ep[nt][0]);
                ep[nt][1] = fmaf(a0, w.y, ep[nt][1]);
                ep[nt][2] = fmaf(a1, w.x, ep[nt][2]);
                ep[nt][3] = fmaf(a1, w.y, ep[nt][3]);
            }
        }
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[nt][q] += ep[nt][q];
    }
};

}  // namespace radargnn
