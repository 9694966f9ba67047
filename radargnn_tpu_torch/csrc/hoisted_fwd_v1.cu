// Hoisted max aggregation (v1), forward kernel, in float32.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _hoisted_scan_kernel (reached through _hoisted_pallas_call,
// make_fused_hoisted_aggregate and make_fused_hoisted_aggregate_pallas_bwd)
// on Hopper (sm_90a).
//
// What it computes (receiver-CSR tiles of ops/windowed_tiles.py:
// prepare_csr_tiles): slot s of tile t has the global sender senders_t[s]
// and receiver recv[s] (-1: empty); tile t belongs to node block
// tile_blocks[t] (non-decreasing: a block's tiles are consecutive), and a
// slot counts only if its receiver lies in that block. With the node-level
// projection y_s = x @ W_s computed once per node outside the kernel,
//   op[s]    = y_s[senders_t[s]] + e_t[s] @ W_e + b        (hoisted_v1.cuh)
//   inner[n] = max over the slots s with recv[s] = n of op[s] (-3e38 if none)
//   out[n]   = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (a non-null `inner_out`) it also writes inner, the maxima the
// backward routes against. Unlike the TPU kernel, which takes the rows
// y_s[senders_t] gathered by XLA outside it, this kernel gathers them by
// indexed load; and where the TPU kernel lands a mean of equal maxima (a
// one-hot matmul of the segmented roll-max, about 1e-7 relative from the
// max), it lands the exact max.
//
// Design. One block of 256 threads = one node block (blockIdx.x) x one
// 64-column slice (blockIdx.y). It stages the slice of W_e (transposed) and
// b once, finds its tiles by binary search (tile_walk.cuh) and walks their
// slots, which are one contiguous range, 64 at a time: the slots' edge rows
// (k-major), senders and receivers go to shared memory, then each thread
// owns one column and every fourth group of four slots. For a group it
// issues the four reads y_s[sender][column] together (a warp reads 32
// consecutive floats of each row), forms the four operands
// (hoisted_v1.cuh: two shared-memory loads per four fma) and lands each in
// a [node_block x 64] float32 accumulator in shared memory by an exact
// float atomic max, so the result does not depend on the atomics' order.
// The epilogue applies the offset and the empty-receiver rule.
//
// What bounds it on the card: the edge product, 2 d_e H float32 operations
// per valid slot at 67 TFLOP/s outside the tensor cores (281,600 slots,
// d_e 16, H 464: 4.2 GFLOP, 62 us), against y_s, e_t, the index arrays,
// offset and out once (~0.1 GB, 30 us). The row gathers read E H floats of
// y_s, which at 26 MB stays in the 50 MB L2. The times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hoisted_v1.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kAccLd = kV1Cols + 1;      // accumulator row stride (floats)
constexpr int kSlotChunk = 64;           // slots staged at a time
constexpr int kEdgeLd = kSlotChunk + 4;  // k-major edge rows' stride
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) hoisted_fwd_v1_kernel(
    const float* __restrict__ y_s,             // [n_y, h]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const float* __restrict__ b,               // [h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ offset,          // [num_nodes, h]
    float* __restrict__ out,                   // [num_nodes, h]
    float* __restrict__ inner_out,             // [num_nodes, h] or null
    int n_y, int de, int h, int num_tiles, int num_nodes, int node_block,
    int edge_tile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* eT = reinterpret_cast<float*>(smem_raw);     // [de][kEdgeLd]
    float* acc_s = eT + de * kEdgeLd;                   // [node_block][65]
    float* we_t = acc_s + node_block * kAccLd;          // [64][de + 1]
    float* b_s = we_t + kV1Cols * (de + 1);             // [64]
    int* rc_s = reinterpret_cast<int*>(b_s + kV1Cols); // [64] local or -1
    int* snd_s = rc_s + kSlotChunk;                     // [64]
    const int blk = blockIdx.x;
    const int col0 = blockIdx.y * kV1Cols;
    const int tid = threadIdx.x;
    const int tx = tid % kV1Cols, ty = tid / kV1Cols;
    const int col = col0 + tx;
    const int base = blk * node_block;

    for (int i = tid; i < node_block * kAccLd; i += blockDim.x) {
        acc_s[i] = kNeg;
    }
    v1_stage_weights(w_e, b, de, h, col0, we_t, b_s);
    const int64_t lo = static_cast<int64_t>(
                           lower_bound(tile_blocks, num_tiles, blk)) *
                       edge_tile;
    const int64_t hi = static_cast<int64_t>(
                           lower_bound(tile_blocks, num_tiles, blk + 1)) *
                       edge_tile;

    for (int64_t s0 = lo; s0 < hi; s0 += kSlotChunk) {
        __syncthreads();    // the previous chunk's reads are done
        const int rows = static_cast<int>(
            hi - s0 < kSlotChunk ? hi - s0 : kSlotChunk);
        v1_stage_edges(e_t, s0, rows, de, eT, kEdgeLd);
        for (int s = tid; s < kSlotChunk; s += blockDim.x) {
            int rc = -1, snd = 0;
            if (s < rows) {
                rc = __ldg(recv + s0 + s);
                snd = __ldg(senders + s0 + s);
                if (!receiver_in_block(rc, base, node_block, num_nodes) ||
                    snd < 0 || snd >= n_y) {
                    rc = -1;
                    snd = 0;
                }
            }
            rc_s[s] = rc < 0 ? -1 : rc - base;
            snd_s[s] = snd;
        }
        __syncthreads();
        if (col >= h) continue;
        // groups of four slots; a warp's threads share ty, so the branch on
        // the group's receivers is uniform across the warp
        for (int s = ty * kV1Slots; s < rows;
             s += (kThreads / kV1Cols) * kV1Slots) {
            int r[kV1Slots];
            float add[kV1Slots];
            bool any = false;
#pragma unroll
            for (int j = 0; j < kV1Slots; ++j) {
                r[j] = rc_s[s + j];
                any |= r[j] >= 0;
                const size_t row = static_cast<size_t>(snd_s[s + j]) * h;
                add[j] = r[j] >= 0 ? __ldg(y_s + row + col) : 0.0f;
            }
            if (!any) continue;
            float op[kV1Slots];
            v1_operands(add, eT + s, kEdgeLd, we_t + tx * (de + 1), de,
                        b_s[tx], op);
#pragma unroll
            for (int j = 0; j < kV1Slots; ++j) {
                if (r[j] >= 0) {
                    atomic_max_f32(acc_s + r[j] * kAccLd + tx, op[j]);
                }
            }
        }
    }
    __syncthreads();

    // epilogue: hoisted offset, empty receivers -> 0
    for (int i = tid; i < node_block * kV1Cols; i += blockDim.x) {
        const int r = i / kV1Cols, c = i % kV1Cols;
        const int n = base + r, cc = col0 + c;
        if (n >= num_nodes || cc >= h) continue;
        const size_t idx = static_cast<size_t>(n) * h + cc;
        const float inner = acc_s[r * kAccLd + c];
        if (inner_out != nullptr) inner_out[idx] = inner;
        out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, in bytes: a chunk of edge rows
// (k-major), the [node_block x 64] accumulator, the W_e and bias slices and
// the chunk's receivers and senders.
size_t hoisted_fwd_v1_smem_bytes(int de, int node_block) {
    return sizeof(float) * (static_cast<size_t>(de) * kEdgeLd +
                            static_cast<size_t>(node_block) * kAccLd +
                            static_cast<size_t>(kV1Cols) * (de + 1) +
                            kV1Cols) +
           sizeof(int) * 2 * kSlotChunk;
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and contiguity, and that tile_blocks is
// non-decreasing (the tiler's order). `inner` may be null (serving);
// otherwise it receives the maxima.
int hoisted_fwd_v1(const void* y_s, const void* e_t, const void* w_e,
                   const void* b, const void* senders, const void* recv,
                   const void* tile_blocks, const void* offset, void* out,
                   void* inner, int n_y, int de, int h, int num_tiles,
                   int num_nodes, int node_block, int edge_tile,
                   void* stream) {
    const size_t smem = hoisted_fwd_v1_smem_bytes(de, node_block);
    cudaError_t err = cudaFuncSetAttribute(
        hoisted_fwd_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((num_nodes + node_block - 1) / node_block,
                    (h + kV1Cols - 1) / kV1Cols);
    hoisted_fwd_v1_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(y_s), static_cast<const float*>(e_t),
        static_cast<const float*>(w_e), static_cast<const float*>(b),
        static_cast<const int32_t*>(senders),
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(offset), static_cast<float*>(out),
        static_cast<float*>(inner), n_y, de, h, num_tiles, num_nodes,
        node_block, edge_tile);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
