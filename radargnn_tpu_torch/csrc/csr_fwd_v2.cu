// CSR-tiled hoisted max aggregation (v2), forward: the gather-max over the
// node projection.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v2 (reached through _fused_fwd_call_v2 and
// make_fused_hoisted_aggregate_v2, the `fused_tiling: "csr"` path) on
// Hopper (sm_90a), together with the node projection dense_proj_v4
// (dense_fwd_v4.cu), which the caller launches first.
//
// What it computes (receiver-CSR tiles, csr_slot.cuh): slot s of tile t has
// the global sender senders[s] and receiver recv[s] (-1: empty); tile t
// belongs to node block tile_blocks[t] (non-decreasing over t), and a slot
// counts only if its receiver lies in that block. With y_s = x @ W_s
// [n_x, hp] f32 (bf16 in, f32 sums; hp = H rounded up to 64, zero past H):
//   op[s]    = y_s[senders[s]] + e_t[s] @ W_e   (the edge product float32
//                                                in and sums: csr_slot.cuh)
//   inner[n] = max over the counting slots s with recv[s] = n of op[s]
//              (-3e38 if none)
//   out[n]   = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`) it also writes inner[n], the maxima
// the backward (csr_bwd_v2.cu) routes against; serving passes null. The
// backward rebuilds op from the same y_s by the same fma chain, so it sees
// this op bit for bit. v2 keeps the edge features and W_e in float32 on the
// card (the TPU kernel's contract), and it has no overflow list: every
// valid edge sits in a tile.
//
// Design (windowed_fwd_v3.cu's walk). One block = one node block
// (blockIdx.x) x one 64-column slice (blockIdx.y), 16 warps (one block an
// SM). It finds its tiles by binary search in tile_blocks and splits their
// slots into groups of 16 (the block's tiles one after the other); warp w
// walks groups w, w + 16, ... on its own, with no barrier between groups,
// so a node block with many tiles (a hub, or a dense region of a radius
// graph under this tiling) keeps every warp busy. For a group, each lane
// holds fragment rows g and g + 8 (g = lane / 4) over columns
// nt * 8 + tq * 2 + {0, 1} (tq = lane % 4), with the next group's indices
// already in flight; a group of padding slots is skipped. The lane loads
// its slots' 64-column slices of y_s[sender] (y_s stays in L2), reads its
// two edge rows where they lie, and forms the float32 edge chain on the
// CUDA cores against the W_e slice in shared memory (float32, k-major);
// then adds the y_s slices. Each op lands in a [node_block x 64]
// accumulator in shared memory by an exact atomic max of ordered keys, a
// half-group of one receiver folded by shuffles first (tile_walk.cuh:
// land_max_runs; a kNN receiver's slots are consecutive, so most halves
// fold); so one block combines a receiver's slots across tiles, and the
// result does not depend on the atomics' order. The epilogue applies the
// hoisted offset and the empty-receiver rule, and covers receivers no slot
// reaches (dummy tiles, the static budget's tiles of recv -1). The TPU
// kernel multiplies x[sender] @ W_s once per slot and lands the maxima with
// a segmented log-roll max and an exact one-hot selection matmul; on the
// card the projection is formed once per node and the landing is a
// shared-memory max.
//
// What bounds it on the card. Given y_s, the function needs e @ W_e once
// per valid slot in float32 (~4.2 GFLOP at the flagship's wide layer,
// 281,600 valid slots, d_e 16, H 464: 62 us at 67 TFLOP/s outside the
// tensor cores) and a max per element, against y_s, e_t, the index arrays,
// offset and out (~100 MB, ~30 us): the float32 edge chain bounds it. The
// times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_slot.cuh"
#include "mma_bf16.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kAccLd = kBlockCols + 1;   // accumulator row stride
constexpr int kWeLd = kBlockCols + 4;    // float32 W_e slice row stride
constexpr int kWarps = 16;               // warps of a block
constexpr int kGroup = 16;               // slots of a warp's group

__host__ __device__ inline size_t acc_bytes(int node_block) {
    return (sizeof(int) * static_cast<size_t>(node_block) * kAccLd + 15) &
           ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t fwd_smem_bytes(int de, int node_block) {
    return acc_bytes(node_block) +
           sizeof(float) * static_cast<size_t>(de) * kWeLd;
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

__global__ void __launch_bounds__(kWarps * 32, 1) csr_fwd_v2_kernel(
    const float* __restrict__ y_s,             // [n_x, hp]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ offset,          // [num_nodes, h]
    float* __restrict__ out,                   // [num_nodes, h]
    float* __restrict__ inner_out,             // [num_nodes, h] or null
    int n_x, int de, int h, int hp, int num_tiles, int num_nodes,
    int node_block, int edge_tile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* keys = reinterpret_cast<int*>(smem_raw);   // ordered keys
    float* we_s = reinterpret_cast<float*>(smem_raw + acc_bytes(node_block));
    const int blk = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int base = blk * node_block;

    for (int i = tid; i < node_block * kAccLd; i += nthreads) {
        keys[i] = ordered_key(kNeg);
    }
    // the W_e slice [col0, col0 + 64), k-major, zero past h
    for (int i = tid; i < de * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        we_s[kk * kWeLd + n] =
            col < h ? w_e[static_cast<size_t>(kk) * h + col] : 0.0f;
    }
    const int lo = lower_bound(tile_blocks, num_tiles, blk);
    const int hi = lower_bound(tile_blocks, num_tiles, blk + 1);
    const int groups = (hi - lo) * (edge_tile / kGroup);
    const size_t slot_lo = static_cast<size_t>(lo) * edge_tile;
    __syncthreads();

    GroupSlots next{};
    if (warp < groups) {
        next = load_group(senders, recv,
                          slot_lo + static_cast<size_t>(warp) * kGroup, g);
    }
    for (int q = warp; q < groups; q += kWarps) {
        const size_t slot0 = slot_lo + static_cast<size_t>(q) * kGroup;
        const GroupSlots G = next;
        if (q + kWarps < groups) {
            next = load_group(senders, recv,
                              slot0 + kWarps * static_cast<size_t>(kGroup),
                              g);
        }
        CsrSlot S[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            S[half] = csr_slot(G.rc[half], G.sn[half], base, node_block,
                               num_nodes, n_x);
        }
        // a group of padding slots lands nothing
        if (!__any_sync(0xffffffffu, S[0].rc >= 0 || S[1].rc >= 0)) continue;
        // the senders' y_s slices (0 where the x part is 0; a slot that
        // does not count is never landed)
        float2 y[2][kColTiles];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int s = S[half].sn;
            const float* yr = y_s + static_cast<size_t>(s >= 0 ? s : 0) * hp
                + col0 + tq * 2;
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                y[half][nt] = s >= 0
                    ? __ldg(reinterpret_cast<const float2*>(yr + nt * 8))
                    : make_float2(0.0f, 0.0f);
            }
        }
        // the edge chain (csr_slot.cuh): ep[nt][q] at row g + (q >> 1) * 8
        // and column col0 + nt * 8 + tq * 2 + (q & 1), k ascending from 0
        float ep[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) ep[nt][k] = 0.0f;
        const float* e0 = e_t + (slot0 + g) * de;
        const float* e8 = e0 + 8 * de;
        for (int k0 = 0; k0 < de; k0 += 4) {
            const float4 a4 = __ldg(reinterpret_cast<const float4*>(e0 + k0));
            const float4 b4 = __ldg(reinterpret_cast<const float4*>(e8 + k0));
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float* wr = we_s + (k0 + kk) * kWeLd + tq * 2;
#pragma unroll
                for (int nt = 0; nt < kColTiles; ++nt) {
                    const float2 w =
                        *reinterpret_cast<const float2*>(wr + nt * 8);
                    ep[nt][0] = fmaf(av[kk], w.x, ep[nt][0]);
                    ep[nt][1] = fmaf(av[kk], w.y, ep[nt][1]);
                    ep[nt][2] = fmaf(bv[kk], w.x, ep[nt][2]);
                    ep[nt][3] = fmaf(bv[kk], w.y, ep[nt][3]);
                }
            }
        }
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                ep[nt][half * 2] = csr_op(y[half][nt].x, ep[nt][half * 2]);
                ep[nt][half * 2 + 1] =
                    csr_op(y[half][nt].y, ep[nt][half * 2 + 1]);
            }
        }
        land_max_runs(keys, kAccLd, ep, G.rc, base, node_block, num_nodes,
                      g, tq);
    }
    __syncthreads();

    // epilogue: hoisted offset, empty receivers -> 0
    for (int i = tid; i < node_block * kBlockCols; i += nthreads) {
        const int rr = i / kBlockCols, c = i % kBlockCols;
        const int n = base + rr, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const size_t idx = static_cast<size_t>(n) * h + col;
        const float inner = ordered_float(keys[rr * kAccLd + c]);
        if (inner_out != nullptr) inner_out[idx] = inner;
        out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes: the
// [node_block x 64] accumulator and the float32 W_e slice.
size_t csr_fwd_v2_smem_bytes(int de, int node_block) {
    return fwd_smem_bytes(de, node_block);
}

// Launches the gather-max on `stream`; returns the cudaError_t of the
// launch. The caller checks shapes, types and alignment: de a multiple of
// 4, edge_tile a multiple of 16, y_s [n_x, hp] with hp = h rounded up to
// 64, 16-byte aligned y_s and e_t, tile_blocks non-decreasing (the tiler's
// order). `inner` may be null (serving); otherwise it receives the maxima.
int csr_fwd_v2(const void* y_s, const void* e_t, const void* w_e,
               const void* senders, const void* recv,
               const void* tile_blocks, const void* offset, void* out,
               void* inner, int n_x, int de, int h, int hp, int num_tiles,
               int num_nodes, int node_block, int edge_tile, void* stream) {
    const size_t smem = fwd_smem_bytes(de, node_block);
    cudaError_t err = cudaFuncSetAttribute(
        csr_fwd_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    hp / kBlockCols);
    if (grid.x > 0) {
        csr_fwd_v2_kernel<<<grid, kWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(y_s), static_cast<const float*>(e_t),
            static_cast<const float*>(w_e),
            static_cast<const int32_t*>(senders),
            static_cast<const int32_t*>(recv),
            static_cast<const int32_t*>(tile_blocks),
            static_cast<const float*>(offset), static_cast<float*>(out),
            static_cast<float*>(inner), n_x, de, h, hp, num_tiles, num_nodes,
            node_block, edge_tile);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
