// Windowed hoisted max aggregation, forward kernel.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v3 (reached through _fused_fwd_call_v3 and
// make_fused_hoisted_aggregate_v3) on Hopper (sm_90a).
//
// What it computes (windowed tile layout, ops/windowed_tiles.py): slot s
// of tile t has receiver recv[s] (-1: empty) and sender
// tile_win[t]*node_block + sloc[s] (sloc -1: no sender, zero x row);
// tile t belongs to node block tile_blocks[t] (non-decreasing over t), and
// a slot counts only if its receiver lies in that block.
//   op[s]     = x[sender] @ W_s + e_t[s] @ W_e          (bf16 in, f32 acc)
//   inner[n]  = max(max over the slots s with recv[s] = n of op[s],
//                   inner_o[n])                         (-3e38 if none)
//   out[n]    = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`) it also writes inner[n], the maxima
// the backward routes against; serving passes null.
//
// Design. One block = one node block (blockIdx.x) x one 64-column slice
// (blockIdx.y). It finds its tiles by binary search in tile_blocks, stages
// the weight slice once and runs the slot-row loop of dense_tile.cuh over
// each tile (R = 64 slots per row, edge_tile / 64 rows per tile; the same
// code and mma order as the backward's routing pass, so the backward sees
// these op bits). Each op lands in a [node_block x 64] f32 accumulator in
// shared memory by a float atomic max; max is exact and order-independent,
// so the result does not depend on the order of the atomics and two runs
// give the same bits. (Folding each receiver's run within a warp by
// shuffles first, so that one atomic per run lands, measured 25 % slower
// at the radius batch's wide layer: the atomics are not what holds this
// kernel; PERF.md.) A receiver whose slots span several tiles (hubs, or
// runs spread on purpose by the spread tiler) is combined in the same
// accumulator. The epilogue applies the overflow maxima, the hoisted offset
// and the empty-receiver rule, and covers receivers no slot reaches (dummy
// tiles, padding tiles of recv -1, blocks without tiles).
// The TPU kernel gathers sender rows with a one-hot [TE, W] matmul over the
// window parts and lands the per-receiver maxima with an exact 3-pass bf16
// selection matmul after a log-roll segmented max; on the card a gather is
// an indexed load and a landing is a shared-memory max, so none of those
// (nor the window parts or part_mask) is needed.
//
// What bounds it on the card. The function needs x @ W_s once per node
// (x[s] @ W_s = (x @ W_s)[s]) and e @ W_e once per valid slot: ~7 GFLOP of
// bf16 products per wide layer of the radius batch against ~100 MB of
// compulsory traffic, so the floor is the HBM rate (~30 us per wide layer).
// This design multiplies x[s] @ W_s once per slot, as the TPU kernel does,
// from shared memory with mma.sync, one block of 4 warps per SM (the
// accumulator takes 65 KB beside the loop's 96 KB), so it is held by its
// own tensor-core work, far above the floor; the times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kAccLd = kBlockCols + 1;   // accumulator row stride (floats)

__global__ void __launch_bounds__(128) windowed_fwd_v3_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
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
    int n_x, int d, int de, int h, int num_tiles, int num_nodes,
    int node_block, int edge_tile, int r_chunk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* acc_s = reinterpret_cast<float*>(
        smem_raw + slot_rows_smem_bytes<EdgeBf16>(d, de, r_chunk));
    const int blk = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m0 = (tid >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int base = blk * node_block;

    for (int i = tid; i < node_block * kAccLd; i += blockDim.x) {
        acc_s[i] = kNeg;
    }
    const int lo = lower_bound(tile_blocks, num_tiles, blk);
    const int hi = lower_bound(tile_blocks, num_tiles, blk + 1);
    stage_weights<EdgeBf16>(w_s, w_e, d, de, h, r_chunk, col0);

    for (int t = lo; t < hi; ++t) {
        const size_t tile_slot0 = static_cast<size_t>(t) * edge_tile;
        slot_rows<EdgeBf16>(
            t, x, e_t, WindowSenders(sloc, tile_win, t, node_block, n_x), d,
            de, r_chunk, edge_tile / r_chunk,
            [&](int j, float (*acc)[4], bool, bool, const __nv_bfloat16*) {
            land_max(acc_s, kAccLd, acc, recv,
                     tile_slot0 + static_cast<size_t>(j) * r_chunk + m0 + g,
                     base, node_block, num_nodes, tq);
        });
    }
    __syncthreads();

    // epilogue: overflow maxima, hoisted offset, empty receivers -> 0
    for (int i = tid; i < node_block * kBlockCols; i += blockDim.x) {
        const int r = i / kBlockCols, c = i % kBlockCols;
        const int n = base + r, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const size_t idx = static_cast<size_t>(n) * h + col;
        const float inner = fmaxf(acc_s[r * kAccLd + c], inner_o[idx]);
        if (inner_out != nullptr) inner_out[idx] = inner;
        out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes: the slot-row
// loop's buffers and the [node_block x 64] accumulator.
size_t windowed_fwd_v3_smem_bytes(int d, int de, int r_chunk,
                                  int node_block) {
    return slot_rows_smem_bytes<EdgeBf16>(d, de, r_chunk) +
           sizeof(float) * static_cast<size_t>(node_block) * kAccLd;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: d and de multiples of 8,
// r_chunk a multiple of 16 in [16, 64] that divides edge_tile, 16-byte
// aligned x and e_t, tile_blocks non-decreasing (the tiler's order).
// `inner` may be null (serving); otherwise it receives the maxima.
int windowed_fwd_v3(const void* x, const void* w_s, const void* e_t,
                    const void* w_e, const void* recv, const void* sloc,
                    const void* tile_win, const void* tile_blocks,
                    const void* inner_o, const void* offset, void* out,
                    void* inner, int n_x, int d, int de, int h,
                    int num_tiles, int num_nodes, int node_block,
                    int edge_tile, int r_chunk, void* stream) {
    const size_t smem =
        windowed_fwd_v3_smem_bytes(d, de, r_chunk, node_block);
    cudaError_t err = cudaFuncSetAttribute(
        windowed_fwd_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    (h + kBlockCols - 1) / kBlockCols);
    const dim3 block((r_chunk / 16) * 32);
    windowed_fwd_v3_kernel<<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w_s),
        static_cast<const __nv_bfloat16*>(e_t),
        static_cast<const __nv_bfloat16*>(w_e),
        static_cast<const int32_t*>(recv), static_cast<const int32_t*>(sloc),
        static_cast<const int32_t*>(tile_win),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(inner_o),
        static_cast<const float*>(offset), static_cast<float*>(out),
        static_cast<float*>(inner), n_x, d, de, h, num_tiles, num_nodes,
        node_block, edge_tile, r_chunk);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
