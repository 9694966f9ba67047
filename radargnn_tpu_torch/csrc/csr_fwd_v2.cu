// CSR-tiled hoisted max aggregation (v2), forward kernel.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v2 (reached through _fused_fwd_call_v2 and
// make_fused_hoisted_aggregate_v2, the `fused_tiling: "csr"` path) on
// Hopper (sm_90a).
//
// What it computes (receiver-CSR tiles, csr_tile.cuh): slot s of tile t has
// the global sender senders[s] and receiver recv[s] (-1: empty); tile t
// belongs to node block tile_blocks[t] (non-decreasing over t: a block's
// tiles are consecutive, every block has at least one), and a slot counts
// only if its receiver lies in that block.
//   op[s]    = x[senders[s]] @ W_s          (bf16 in, float32 sums)
//            + e_t[s] @ W_e                 (float32 in and sums)
//   inner[n] = max over the slots s with recv[s] = n of op[s] (-3e38 if none)
//   out[n]   = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`) it also writes inner[n], the maxima
// the backward routes against; serving passes null. Unlike the dense and
// windowed kernels, v2 keeps the edge features and W_e in float32 on the
// card (the TPU kernel's contract), and it has no overflow list: every
// valid edge sits in a tile.
//
// Design. One block = one node block (blockIdx.x) x one 64-column slice
// (blockIdx.y). It finds its tiles by binary search in tile_blocks
// (tile_walk.cuh), stages the weight slice once and runs the slot-row loop
// of dense_tile.cuh with the CSR senders and float32 edge policy of
// csr_tile.cuh over each tile (R = 64 slots per row where the tile allows;
// the same code and summation order as the backward's routing pass, so the
// backward sees these op bits). Each op lands in a [node_block x 64]
// f32 accumulator in shared memory by an exact float atomic max, so the
// result does not depend on the order of the atomics and two runs give the
// same bits; a receiver whose slots span several tiles is combined there
// too (the combine across tiles that the TPU kernel does in its resident
// output block). The epilogue applies the hoisted offset and the
// empty-receiver rule and covers receivers no slot reaches (dummy tiles,
// the static budget's no-op tiles of recv -1).
// The TPU kernel lands the per-receiver maxima with a one-directional
// segmented log-roll max and an exact one-hot selection matmul; on the
// card a landing is a shared-memory max, so neither is needed.
//
// What bounds it on the card. The function needs x @ W_s once per node
// (x[s] @ W_s = (x @ W_s)[s]) and e @ W_e once per valid slot in float32:
// at the flagship's wide layer (14,080 nodes, 281,600 valid slots, d 224,
// d_e 16, H 464) ~2.9 GFLOP of bf16 products (3 us at the tensor-core peak)
// and ~4.2 GFLOP of float32 products (62 us at 67 TFLOP/s outside the
// tensor cores) against ~110 MB of compulsory traffic (~33 us), so the
// float32 edge product bounds it. This design multiplies x[s] @ W_s once
// per slot, as the TPU kernel does, from shared memory with mma.sync, one
// block of 4 warps per SM (the accumulator takes 65 KB beside the loop's
// 104 KB); the times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_tile.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kAccLd = kBlockCols + 1;   // accumulator row stride (floats)

__global__ void __launch_bounds__(128) csr_fwd_v2_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ offset,          // [num_nodes, h]
    float* __restrict__ out,                   // [num_nodes, h]
    float* __restrict__ inner_out,             // [num_nodes, h] or null
    int n_x, int d, int de, int h, int num_tiles, int num_nodes,
    int node_block, int edge_tile, int r_chunk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* acc_s = reinterpret_cast<float*>(
        smem_raw + slot_rows_smem_bytes<EdgeF32>(d, de, r_chunk));
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
    stage_weights<EdgeF32>(w_s, w_e, d, de, h, r_chunk, col0);
    const CsrSenders snd{senders, recv, base, node_block, num_nodes, n_x};

    for (int t = lo; t < hi; ++t) {
        const size_t tile_slot0 = static_cast<size_t>(t) * edge_tile;
        slot_rows<EdgeF32>(
            t, x, e_t, snd, d, de, r_chunk, edge_tile / r_chunk,
            [&](int j, float (*acc)[4], bool, bool, const float*) {
            land_max(acc_s, kAccLd, acc, recv,
                     tile_slot0 + static_cast<size_t>(j) * r_chunk + m0 + g,
                     base, node_block, num_nodes, tq);
        });
    }
    __syncthreads();

    // epilogue: hoisted offset, empty receivers -> 0
    for (int i = tid; i < node_block * kBlockCols; i += blockDim.x) {
        const int r = i / kBlockCols, c = i % kBlockCols;
        const int n = base + r, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const size_t idx = static_cast<size_t>(n) * h + col;
        const float inner = acc_s[r * kAccLd + c];
        if (inner_out != nullptr) inner_out[idx] = inner;
        out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes: the slot-row
// loop's buffers and the [node_block x 64] accumulator.
size_t csr_fwd_v2_smem_bytes(int d, int de, int r_chunk, int node_block) {
    return slot_rows_smem_bytes<EdgeF32>(d, de, r_chunk) +
           sizeof(float) * static_cast<size_t>(node_block) * kAccLd;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: d a multiple of 8, de a
// multiple of 4, r_chunk a multiple of 16 in [16, 64] that divides
// edge_tile, 16-byte aligned x and e_t, tile_blocks non-decreasing (the
// tiler's order). `inner` may be null (serving); otherwise it receives the
// maxima.
int csr_fwd_v2(const void* x, const void* w_s, const void* e_t,
               const void* w_e, const void* senders, const void* recv,
               const void* tile_blocks, const void* offset, void* out,
               void* inner, int n_x, int d, int de, int h, int num_tiles,
               int num_nodes, int node_block, int edge_tile, int r_chunk,
               void* stream) {
    const size_t smem = csr_fwd_v2_smem_bytes(d, de, r_chunk, node_block);
    cudaError_t err = cudaFuncSetAttribute(
        csr_fwd_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    (h + kBlockCols - 1) / kBlockCols);
    const dim3 block((r_chunk / 16) * 32);
    csr_fwd_v2_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w_s),
        static_cast<const float*>(e_t), static_cast<const float*>(w_e),
        static_cast<const int32_t*>(senders),
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(offset), static_cast<float*>(out),
        static_cast<float*>(inner), n_x, d, de, h, num_tiles, num_nodes,
        node_block, edge_tile, r_chunk);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
