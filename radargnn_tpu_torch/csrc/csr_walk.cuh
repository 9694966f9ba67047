// The gather-max walk over receiver-CSR tiles that the CSR forward
// (csr_fwd_v2.cu, B5) and the v1 hoisted forward (hoisted_fwd_v1.cu, B6)
// share. Both compute, with y_s = x @ W_s the node projection formed once
// per node outside the kernel,
//   op[s]    = y_s[senders[s]] + e_t[s] @ W_e   (+ b[c] for v1)
//   inner[n] = max over the counting slots s with recv[s] = n of op[s]
//              (-3e38 if none)
//   out[n]   = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// and, in VJP mode (a non-null `inner_out`), write inner. What differs is
// an operand policy, which each kernel defines (csr_fwd_v2.cu: CsrOperand,
// hoisted_fwd_v1.cu: V1Operand) and passes as the template argument Op:
//   Op::kBias      whether b is read (its 64-column slice staged in shared
//                  memory)
//   Op::kMaskCols  whether the column quads of y_s past h read as 0
//   Op::slot(rc, sn, base, node_block, num_nodes, n_y) -> WalkSlot
//                  which slots count, and whose x part is read
//   Op::finish(ep, y, b_s, c0)
//                  the operand of a lane's quad from its finished edge
//                  chains ep, the gathered y_s quads y and the bias slice
//
// Layout (ops/windowed_tiles.py: prepare_csr_tiles): slot s of tile t has
// the global sender senders[s] and receiver recv[s] (-1: empty); tile t
// belongs to node block tile_blocks[t] (non-decreasing over t), and a
// slot counts only if its receiver lies in that block.
//
// The walk. One block = one node block (blockIdx.x) x one 64-column slice
// (blockIdx.y), 16 warps (one block an SM). It finds its tiles by binary
// search in tile_blocks and splits their slots into groups of 16 (the
// block's tiles one after the other); warp w walks groups w, w + 16, ... on
// its own, with no barrier between groups, so a node block with many tiles
// (a hub, or a dense region of a radius graph) keeps every warp busy. For a
// group, each lane holds rows g and g + 8 (g = lane / 4) over the columns
// j * 16 + tq * 4 + {0, 1, 2, 3} (tq = lane % 4, j < 4), with the next
// group's indices already in flight; a group of padding slots is skipped.
// The lane loads its slots' quads of y_s[sender] (y_s stays in L2), reads
// its two edge rows where they lie, and forms the float32 edge chain on the
// CUDA cores against the W_e slice in shared memory (float32, k-major; a
// 16-byte quad of W_e feeds 8 fma, two rows by four columns):
// ep = 0.0f, then ep = fmaf(e[k], W_e[k][c], ep) for k = 0, 1,
// ..., de - 1, the order both backwards (csr_bwd_v2.cu, hoisted_bwd_v1.cu)
// rebuild bit for bit; then finishes the operand with the policy. Each op
// lands in a [node_block x 64] accumulator in shared memory by an exact
// atomic max of ordered keys, a half-group of one receiver folded by
// shuffles first (land_walk_runs); so one block combines a
// receiver's slots across tiles, and the result does not depend on the
// atomics' order. The epilogue applies the hoisted offset and the
// empty-receiver rule, and covers receivers no slot reaches.
//
// The TPU kernels multiply a tile's rows on the MXU and land the maxima
// with a segmented log-roll max and a one-hot selection matmul; on the card
// the projection is formed once per node and the landing is a
// shared-memory max.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tile_walk.cuh"

namespace radargnn {

constexpr float kWalkNeg = -3.0e38f;       // finite -inf stand-in
constexpr int kWalkAccLd = kBlockCols + 1; // accumulator row stride
constexpr int kWalkWeLd = kBlockCols + 4;  // float32 W_e slice row stride
constexpr int kWalkWarps = 16;             // warps of a block
constexpr int kWalkGroup = 16;             // slots of a warp's group

__host__ __device__ inline size_t walk_acc_bytes(int node_block) {
    return (sizeof(int) * static_cast<size_t>(node_block) * kWalkAccLd +
            15) & ~static_cast<size_t>(15);
}

// Shared memory of the walk, in bytes: the [node_block x 64] accumulator
// of ordered keys, the float32 W_e slice [de x 68] and, with a bias, its
// 64-column slice.
__host__ __device__ inline size_t walk_smem_bytes(int de, int node_block,
                                                  bool bias) {
    return walk_acc_bytes(node_block) +
           sizeof(float) * (static_cast<size_t>(de) * kWalkWeLd +
                            (bias ? kBlockCols : 0));
}

// A slot as an operand policy's slot() returns it: its receiver where it
// counts (-1 where not) and its sender where its x part is read (-1 where
// that part is 0). A slot that does not count is never landed.
struct WalkSlot {
    int rc, sn;
};

// The columns of the 64-column slice a lane (g = lane / 4, tq = lane % 4)
// holds: j * 16 + tq * 4 + c for j < kWalkQuads and c < 4, so that each
// load of W_e from shared memory is one 16-byte quad.
constexpr int kWalkQuads = kBlockCols / 16;

// Lands a warp's 16 rows of ops (ep[j][half * 4 + c]: row g + half * 8,
// column j * 16 + tq * 4 + c; receivers rc[half]) in the block's
// [node_block x 64] accumulator of ordered keys by atomic max, where a
// row's receiver lies in the block at `base`. A receiver's slots lie
// together in the tiler's order, so where all 8 rows of a half share one
// receiver, a butterfly over them leaves the maxima on every lane and each
// lane lands 2 of the 64 columns: 2 atomic instructions with all 32 lanes
// active, in place of 16 with the 8 rows' lanes on 8 equal addresses,
// which serialise (tile_walk.cuh: land_max_runs, in the mma fragment's
// layout). Other halves land row by row. ep is overwritten. Every lane
// must call it (it shuffles across the warp).
__device__ __forceinline__ void land_walk_runs(int* keys_s,
                                               float (*ep)[8], const int* rc,
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
                for (int j = 0; j < kWalkQuads; ++j) {
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        float& a = ep[j][half * 4 + c];
                        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
                    }
                }
            }
            // lane g lands two columns: (g / 2) * 16 + tq * 4 + (g % 2) * 2
            // and the next
            float v0 = ep[0][half * 4], v1 = ep[0][half * 4 + 1];
#pragma unroll
            for (int j = 0; j < kWalkQuads; ++j) {
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    if (g == j * 2 + p) {
                        v0 = ep[j][half * 4 + p * 2];
                        v1 = ep[j][half * 4 + p * 2 + 1];
                    }
                }
            }
            int* at = keys_s + (key0 - base) * kWalkAccLd + (g >> 1) * 16 +
                      tq * 4 + (g & 1) * 2;
            atomicMax(at, ordered_key(v0));
            atomicMax(at + 1, ordered_key(v1));
        } else if (key >= 0) {
            int* row = keys_s + (key - base) * kWalkAccLd + tq * 4;
#pragma unroll
            for (int j = 0; j < kWalkQuads; ++j) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    atomicMax(row + j * 16 + c,
                              ordered_key(ep[j][half * 4 + c]));
                }
            }
        }
    }
}

// A group's slots as one lane sees them: its rows g and g + 8.
struct GroupSlots {
    int sn[2];                 // senders (raw)
    int rc[2];                 // receivers (raw; -1: empty)
};

__device__ __forceinline__ GroupSlots load_group(
    const int32_t* __restrict__ senders, const int32_t* __restrict__ recv,
    size_t slot0, int g) {
    GroupSlots G;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        G.sn[half] = __ldg(senders + slot0 + g + half * 8);
        G.rc[half] = __ldg(recv + slot0 + g + half * 8);
    }
    return G;
}

// The walk (header comment), the body of a kernel launched with
// kWalkWarps * 32 threads on a grid of (node blocks, 64-column slices) and
// walk_smem_bytes(de, node_block, Op::kBias) of dynamic shared memory.
// y_s is [n_y, ys_ld] (ys_ld a multiple of 4, 16-byte aligned), e_t
// [T*TE, de] with de a multiple of 4 (16-byte aligned), w_e [de, h], b [h]
// (read only with a bias), offset, out and inner_out [num_nodes, h];
// edge_tile a multiple of 16.
template <class Op>
__device__ __forceinline__ void csr_walk(
    const float* __restrict__ y_s, const float* __restrict__ e_t,
    const float* __restrict__ w_e, const float* __restrict__ b,
    const int32_t* __restrict__ senders, const int32_t* __restrict__ recv,
    const int32_t* __restrict__ tile_blocks,
    const float* __restrict__ offset, float* __restrict__ out,
    float* __restrict__ inner_out, int n_y, int de, int h, int ys_ld,
    int num_tiles, int num_nodes, int node_block, int edge_tile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* keys = reinterpret_cast<int*>(smem_raw);   // ordered keys
    float* we_s =
        reinterpret_cast<float*>(smem_raw + walk_acc_bytes(node_block));
    float* b_s = we_s + de * kWalkWeLd;             // bias slice (v1)
    const int blk = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int base = blk * node_block;

    for (int i = tid; i < node_block * kWalkAccLd; i += nthreads) {
        keys[i] = ordered_key(kWalkNeg);
    }
    // the W_e slice [col0, col0 + 64), k-major, zero past h; the bias's
    for (int i = tid; i < de * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        we_s[kk * kWalkWeLd + n] =
            col < h ? w_e[static_cast<size_t>(kk) * h + col] : 0.0f;
    }
    if constexpr (Op::kBias) {
        for (int n = tid; n < kBlockCols; n += nthreads) {
            b_s[n] = col0 + n < h ? b[col0 + n] : 0.0f;
        }
    }
    const int lo = lower_bound(tile_blocks, num_tiles, blk);
    const int hi = lower_bound(tile_blocks, num_tiles, blk + 1);
    const int groups = (hi - lo) * (edge_tile / kWalkGroup);
    const size_t slot_lo = static_cast<size_t>(lo) * edge_tile;
    __syncthreads();

    GroupSlots next{};
    if (warp < groups) {
        next = load_group(senders, recv,
                          slot_lo + static_cast<size_t>(warp) * kWalkGroup,
                          g);
    }
    for (int q = warp; q < groups; q += kWalkWarps) {
        const size_t slot0 = slot_lo + static_cast<size_t>(q) * kWalkGroup;
        const GroupSlots G = next;
        if (q + kWalkWarps < groups) {
            next = load_group(
                senders, recv,
                slot0 + kWalkWarps * static_cast<size_t>(kWalkGroup), g);
        }
        WalkSlot S[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            S[half] = Op::slot(G.rc[half], G.sn[half], base, node_block,
                               num_nodes, n_y);
        }
        // a group of padding slots lands nothing
        if (!__any_sync(0xffffffffu, S[0].rc >= 0 || S[1].rc >= 0)) continue;
        // the senders' y_s slices (0 where the x part is 0 or, masked,
        // past h; a slot that does not count is never landed)
        float4 y[kWalkQuads][2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int s = S[half].sn;
            const float* yr = y_s + static_cast<size_t>(s >= 0 ? s : 0) *
                ys_ld + col0 + tq * 4;
#pragma unroll
            for (int j = 0; j < kWalkQuads; ++j) {
                const bool in = s >= 0 &&
                    (!Op::kMaskCols || col0 + j * 16 + tq * 4 < h);
                y[j][half] = in
                    ? __ldg(reinterpret_cast<const float4*>(yr + j * 16))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
        }
        // the edge chain: ep[j][half * 4 + c] at row g + half * 8 and
        // column col0 + j * 16 + tq * 4 + c, k ascending from 0; each W_e
        // quad loaded from shared memory feeds 8 fma
        float ep[kWalkQuads][8];
#pragma unroll
        for (int j = 0; j < kWalkQuads; ++j)
#pragma unroll
            for (int q = 0; q < 8; ++q) ep[j][q] = 0.0f;
        const float* e0 = e_t + (slot0 + g) * de;
        const float* e8 = e0 + 8 * de;
        for (int k0 = 0; k0 < de; k0 += 4) {
            const float4 a4 = __ldg(reinterpret_cast<const float4*>(e0 + k0));
            const float4 b4 = __ldg(reinterpret_cast<const float4*>(e8 + k0));
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float* wr = we_s + (k0 + kk) * kWalkWeLd + tq * 4;
#pragma unroll
                for (int j = 0; j < kWalkQuads; ++j) {
                    const float4 w4 =
                        *reinterpret_cast<const float4*>(wr + j * 16);
                    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        ep[j][c] = fmaf(av[kk], w[c], ep[j][c]);
                        ep[j][4 + c] = fmaf(bv[kk], w[c], ep[j][4 + c]);
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kWalkQuads; ++j) {
            Op::finish(ep[j], y[j], b_s, j * 16 + tq * 4);
        }
        const int counted[2] = {S[0].rc, S[1].rc};
        land_walk_runs(keys, ep, counted, base, node_block, num_nodes, g,
                       tq);
    }
    __syncthreads();

    // epilogue: hoisted offset, empty receivers -> 0
    for (int i = tid; i < node_block * kBlockCols; i += nthreads) {
        const int rr = i / kBlockCols, c = i % kBlockCols;
        const int n = base + rr, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const size_t idx = static_cast<size_t>(n) * h + col;
        const float inner = ordered_float(keys[rr * kWalkAccLd + c]);
        if (inner_out != nullptr) inner_out[idx] = inner;
        out[idx] = inner > kWalkNeg / 2 ? offset[idx] + inner : 0.0f;
    }
}

// Sets the kernel's dynamic shared memory and launches it on a grid of
// (node blocks, ceil(h / 64)) blocks of kWalkWarps * 32 threads; returns
// the cudaError_t of the launch.
template <class Kernel, class... Args>
inline int launch_walk(Kernel kernel, size_t smem, int num_nodes,
                       int node_block, int h, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    (h + kBlockCols - 1) / kBlockCols);
    if (grid.x > 0) {
        kernel<<<grid, kWalkWarps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(args...);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace radargnn
