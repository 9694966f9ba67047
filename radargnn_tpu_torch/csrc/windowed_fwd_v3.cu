// Windowed hoisted max aggregation, forward: the gather-max over the node
// projection.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v3 (reached through _fused_fwd_call_v3 and
// make_fused_hoisted_aggregate_v3) on Hopper (sm_90a), together with the
// node projection dense_proj_v4 (dense_fwd_v4.cu), which the caller
// launches first.
//
// What it computes (windowed tile layout, ops/windowed_tiles.py): slot s
// of tile t has receiver recv[s] (-1: empty) and sender
// tile_win[t]*node_block + sloc[s] (sloc -1: no sender, a zero row);
// tile t belongs to node block tile_blocks[t] (non-decreasing over t), and
// a slot counts only if its receiver lies in that block. With y_s = x @ W_s
// [n_x, hp] f32 (hp = H rounded up to 64, zero past H):
//   op[s]     = y_s[sender] + e_t[s] @ W_e          (the edge product bf16
//                                                    in, f32 sums)
//   inner[n]  = max(max over the counting slots s with recv[s] = n of
//                   op[s], inner_o[n])              (-3e38 if none)
//   out[n]    = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// With `bf16_landing` (the TPU kernel's bf16 landing, its bf16_landing
// branch) the slots' maximum is rounded to bf16, to nearest even, before
// inner_o is merged: the overflow maxima stay float32, as the TPU wrapper
// merges them after its kernel. Rounding is monotone, so rounding the
// maximum is rounding each run's maximum and landing those.
// In VJP mode (non-null `inner_out` and `bits`, the TPU kernel's
// emit_inner) it also writes inner[n] and one routing bit per (slot,
// column), set where the slot counts and |op - inner[recv]| <= 1e-5
// |inner| + 1e-5 (the strict routing of the TPU kernel's backward, under
// which every tied slot takes the full g; with `bf16_max`, where
// bf16(op) == bf16(inner), the TPU kernel's bf16_cmp branch): bits[slot][w]
// holds columns 32w .. 32w+31, as dense_fwd_v4.cu writes them. The backward
// (windowed_bwd_v3.cu) routes on these bits, so it sees this op bit for
// bit without recomputing it. Serving passes null and skips both writes.
//
// Design. One block = one node block (blockIdx.x) x one 64-column slice
// (blockIdx.y), 16 warps (one block an SM). It finds its tiles by binary
// search in tile_blocks and splits their slots into groups of 16 (the
// block's tiles one after the other); warp w walks groups w, w + 16, ...
// on its own, with no barrier between groups, so a node block with many
// tiles (a dense region of the cloud; 3.2 times the mean on the radius
// batch) keeps every warp busy, and its walk is not held to one slot row
// at a time. For a group, each lane loads its mma fragments of the 16 edge
// rows (e_t is read where it lies) and its slots' 64-column slices of
// y_s[sender] (a 768-node window of y_s stays in L2), with the next
// group's indices already in flight; a group of padding slots is skipped.
// The warp forms e_rows @ W_e on mma.sync from a zero accumulator (the
// W_e slice in shared memory; dense_fwd_v4.cu's edge product) and adds
// the y_s slices. Each op lands in a [node_block x 64] accumulator in
// shared memory by an exact atomic max of ordered keys, a half-group of
// one receiver folded by shuffles first (tile_walk.cuh: land_max_runs);
// so one block combines a receiver's slots across tiles (hubs, or runs
// spread by the spread tiler), and the result does not depend on the
// atomics' order. The epilogue applies the overflow maxima, the hoisted
// offset and the empty-receiver rule, and covers receivers no slot
// reaches. The VJP mode keeps inner in the accumulator and walks the
// groups again (the same code, so the same op bit for bit), each op
// against its receiver's inner. The TPU kernel gathers with one-hot
// matmuls, multiplies x[sender] @ W_s per slot, and lands the maxima with
// an exact 3-pass bf16 selection after a log-roll segmented max; none of
// that is needed on the card.
//
// What bounds it on the card. Given y_s, the function needs e @ W_e once
// per valid slot (~2.3 GFLOP at the radius batch's wide layer) and a max
// per element, against y_s, e_t, the index arrays, inner_o, offset and
// out (~100 MB; in VJP mode also inner and the bits): the HBM rate bounds
// it. The landing's atomics and shuffles take more than half of the
// serving time and the y_s reads from L2 most of the rest (PERF.md, with
// the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kAccLd = kBlockCols + 1;   // accumulator row stride (floats)
constexpr int kWarps = 16;               // warps of a block
constexpr int kGroup = 16;               // slots of a warp's mma tile

struct FwdSmem {
    int kpe, lde;              // edge depth padded to the mma k; stride (+8)
    float* acc;                // [node_block][kAccLd] maxima (ordered
                               // keys), then inner
    __nv_bfloat16* we_s;       // [64][lde] W_e slice, transposed
};

__host__ __device__ inline size_t acc_bytes(int node_block) {
    return (sizeof(float) * static_cast<size_t>(node_block) * kAccLd + 15) &
           ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t fwd_smem_bytes(int de, int node_block) {
    const int lde = ((de + 15) & ~15) + 8;
    return acc_bytes(node_block) +
           sizeof(__nv_bfloat16) * static_cast<size_t>(kBlockCols) * lde;
}

__device__ __forceinline__ FwdSmem fwd_smem(int de, int node_block) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    FwdSmem S;
    S.kpe = (de + 15) & ~15;
    S.lde = S.kpe + 8;
    S.acc = reinterpret_cast<float*>(smem_raw);
    S.we_s = reinterpret_cast<__nv_bfloat16*>(smem_raw +
                                              acc_bytes(node_block));
    return S;
}

// A group's slots as one lane sees them: its rows g and g + 8.
struct GroupSlots {
    int sl[2];                 // senders_local (-1: no sender)
    int rc[2];                 // receivers (-1: empty)
    int win0;                  // the tile's window start (node)
};

__device__ __forceinline__ GroupSlots load_group(
    const int32_t* __restrict__ recv, const int32_t* __restrict__ sloc,
    const int32_t* __restrict__ tile_win, size_t slot0, int g,
    int edge_tile, int node_block) {
    GroupSlots G;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        G.sl[half] = __ldg(sloc + slot0 + g + half * 8);
        G.rc[half] = __ldg(recv + slot0 + g + half * 8);
    }
    G.win0 = __ldg(tile_win + slot0 / edge_tile) * node_block;
    return G;
}

__global__ void __launch_bounds__(kWarps * 32, 1) windowed_fwd_v3_kernel(
    const float* __restrict__ y_s,             // [n_x, hp]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ inner_o,         // [num_nodes, h]
    const float* __restrict__ offset,          // [num_nodes, h]
    float* __restrict__ out,                   // [num_nodes, h]
    float* __restrict__ inner_out,             // [num_nodes, h] or null
    uint32_t* __restrict__ bits,               // [T*TE, hp/32] or null
    int n_x, int de, int h, int hp, int num_tiles, int num_nodes,
    int node_block, int edge_tile, bool bf16_max, bool bf16_landing) {
    const FwdSmem S = fwd_smem(de, node_block);
    const int blk = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int base = blk * node_block;

    // the maxima as ordered keys (tile_walk.cuh), then inner as floats
    int* keys = reinterpret_cast<int*>(S.acc);
    for (int i = tid; i < node_block * kAccLd; i += nthreads) {
        keys[i] = ordered_key(kNeg);
    }
    // the W_e slice [col0, col0 + 64), zero past de and h
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < S.kpe * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        S.we_s[n * S.lde + kk] = (kk < de && col < h)
            ? w_e[static_cast<size_t>(kk) * h + col] : zero;
    }
    const int lo = lower_bound(tile_blocks, num_tiles, blk);
    const int hi = lower_bound(tile_blocks, num_tiles, blk + 1);
    const int groups = (hi - lo) * (edge_tile / kGroup);
    const size_t slot_lo = static_cast<size_t>(lo) * edge_tile;
    __syncthreads();

    // Calls visit(slot0, acc, rc) for each group of this warp: slot0 is
    // the group's first slot, acc[nt][q] op at slot slot0 + g + (q >> 1) *
    // 8 and column col0 + nt * 8 + tq * 2 + (q & 1), rc[half] the receiver
    // of slot slot0 + g + half * 8. The same code both times, so the
    // second walk sees the first's op bit for bit.
    auto walk = [&](auto&& visit) {
        GroupSlots next{};
        if (warp < groups) {
            next = load_group(recv, sloc, tile_win,
                              slot_lo + static_cast<size_t>(warp) * kGroup,
                              g, edge_tile, node_block);
        }
        for (int q = warp; q < groups; q += kWarps) {
            const size_t slot0 = slot_lo + static_cast<size_t>(q) * kGroup;
            const GroupSlots G = next;
            if (q + kWarps < groups) {
                next = load_group(recv, sloc, tile_win, slot0 + kWarps *
                                  static_cast<size_t>(kGroup), g, edge_tile,
                                  node_block);
            }
            bool counts[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                counts[half] = receiver_in_block(G.rc[half], base, node_block,
                                                 num_nodes);
            }
            // a group of padding slots lands nothing and routes nothing
            if (!__any_sync(0xffffffffu, counts[0] || counts[1])) continue;
            // the senders' y_s slices (a zero row where a slot has none; a
            // slot that does not count is never landed or routed)
            float2 y[2][kColTiles];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int s = G.win0 + G.sl[half];
                const bool has = counts[half] && G.sl[half] >= 0 && s < n_x;
                const float* yr = y_s + static_cast<size_t>(has ? s : 0) * hp
                    + col0 + tq * 2;
#pragma unroll
                for (int nt = 0; nt < kColTiles; ++nt) {
                    y[half][nt] = has
                        ? __ldg(reinterpret_cast<const float2*>(yr + nt * 8))
                        : make_float2(0.0f, 0.0f);
                }
            }
            // acc = e_rows @ W_e: A fragments (rows g, g + 8; depths
            // k0 + tq*2 (+1), k0 + 8 + tq*2 (+1)) from e_t where it lies
            float acc[kColTiles][4];
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
            const __nv_bfloat16* e0 = e_t + (slot0 + g) * de;
            const __nv_bfloat16* e8 = e0 + 8 * de;
            for (int k0 = 0; k0 < S.kpe; k0 += 16) {
                const int c0 = k0 + tq * 2, c1 = c0 + 8;
                const uint32_t a[4] = {
                    c0 < de ? __ldg(reinterpret_cast<const uint32_t*>(e0 + c0))
                            : 0u,
                    c0 < de ? __ldg(reinterpret_cast<const uint32_t*>(e8 + c0))
                            : 0u,
                    c1 < de ? __ldg(reinterpret_cast<const uint32_t*>(e0 + c1))
                            : 0u,
                    c1 < de ? __ldg(reinterpret_cast<const uint32_t*>(e8 + c1))
                            : 0u};
#pragma unroll
                for (int nt = 0; nt < kColTiles; ++nt) {
                    const __nv_bfloat16* bp =
                        S.we_s + (nt * 8 + g) * S.lde + k0 + tq * 2;
                    const uint32_t b[2] = {ld_pair(bp), ld_pair(bp + 8)};
                    mma_bf16_16816(acc[nt], a, b);
                }
            }
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    acc[nt][half * 2] += y[half][nt].x;
                    acc[nt][half * 2 + 1] += y[half][nt].y;
                }
            }
            visit(slot0, acc, G.rc);
        }
    };

    walk([&](size_t, float (*acc)[4], const int* rc) {
        land_max_runs(keys, kAccLd, acc, rc, base, node_block, num_nodes, g,
                      tq);
    });
    __syncthreads();

    // epilogue: the landing's bf16 rounding, overflow maxima, hoisted
    // offset, empty receivers -> 0; in VJP mode the accumulator keeps inner
    // for the bits
    for (int i = tid; i < node_block * kBlockCols; i += nthreads) {
        const int rr = i / kBlockCols, c = i % kBlockCols;
        const int n = base + rr, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const size_t idx = static_cast<size_t>(n) * h + col;
        float landed = ordered_float(keys[rr * kAccLd + c]);
        if (bf16_landing && landed > kNeg / 2) {
            landed = __bfloat162float(__float2bfloat16_rn(landed));
        }
        const float inner = fmaxf(landed, inner_o[idx]);
        if (bits != nullptr) {
            S.acc[rr * kAccLd + c] = inner;
            inner_out[idx] = inner;
        }
        out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
    }
    if (bits == nullptr) return;
    __syncthreads();

    const int words = hp / 32;
    walk([&](size_t slot0, float (*acc)[4], const int* rc) {
        bool in[2];
        const float* at[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            in[half] = receiver_in_block(rc[half], base, node_block,
                                         num_nodes);
            at[half] = S.acc + (in[half] ? rc[half] - base : 0) * kAccLd +
                       tq * 2;
        }
        bool sel[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int half = k >> 1;
                const int col = col0 + nt * 8 + tq * 2 + (k & 1);
                sel[nt][k] = in[half] && col < h &&
                             routes(acc[nt][k], at[half][nt * 8 + (k & 1)],
                                    bf16_max);
            }
        }
        uint32_t w[2][2];
        pack_row_bits(sel, tq, w);
        // the words of slots that do not count stay as the caller zeroed
        // them
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            if (tq == 0 && in[half]) {
                const size_t slot = slot0 + g + half * 8;
                *reinterpret_cast<uint2*>(bits + slot * words + col0 / 32) =
                    make_uint2(w[half][0], w[half][1]);
            }
        }
    });
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes: the
// [node_block x 64] accumulator and the W_e slice.
size_t windowed_fwd_v3_smem_bytes(int de, int node_block) {
    return fwd_smem_bytes(de, node_block);
}

// Launches the gather-max on `stream`; returns the cudaError_t of the
// launch. The caller checks shapes, types and alignment: de a multiple of
// 8, edge_tile a multiple of 16, y_s [n_x, hp] with hp = h rounded up to
// 64, 16-byte aligned y_s and e_t, tile_blocks non-decreasing (the tiler's
// order). `inner` and `bits` are both null (serving) or both set (VJP
// mode; bits zeroed by the caller); `bf16_max` non-zero sets the bits by
// the bf16 test (tile_walk.cuh, routes_bf16); `bf16_landing` non-zero
// rounds the slots' maxima to bf16 before inner_o is merged.
int windowed_fwd_v3(const void* y_s, const void* e_t, const void* w_e,
                    const void* recv, const void* sloc, const void* tile_win,
                    const void* tile_blocks, const void* inner_o,
                    const void* offset, void* out, void* inner, void* bits,
                    int n_x, int de, int h, int hp, int num_tiles,
                    int num_nodes, int node_block, int edge_tile,
                    int bf16_max, int bf16_landing, void* stream) {
    const size_t smem = fwd_smem_bytes(de, node_block);
    cudaError_t err = cudaFuncSetAttribute(
        windowed_fwd_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    hp / kBlockCols);
    if (grid.x > 0) {
        windowed_fwd_v3_kernel<<<grid, kWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(y_s),
            static_cast<const __nv_bfloat16*>(e_t),
            static_cast<const __nv_bfloat16*>(w_e),
            static_cast<const int32_t*>(recv),
            static_cast<const int32_t*>(sloc),
            static_cast<const int32_t*>(tile_win),
            static_cast<const int32_t*>(tile_blocks),
            static_cast<const float*>(inner_o),
            static_cast<const float*>(offset), static_cast<float*>(out),
            static_cast<float*>(inner), static_cast<uint32_t*>(bits), n_x,
            de, h, hp, num_tiles, num_nodes, node_block, edge_tile,
            bf16_max != 0, bf16_landing != 0);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
