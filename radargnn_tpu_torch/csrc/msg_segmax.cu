// Fused message matmul + segment max, in float32.
//
// Replaces the TPU kernels radargnn_tpu/ops/pallas_kernels.py:
// _msg_segmax_scan_kernel and _msg_segmax_kernel (the two bodies of
// fused_message_segment_max, selected by its `variant`) on Hopper (sm_90a).
//
// What it computes (receiver-CSR tiles of ops/windowed_tiles.py:
// prepare_csr_tiles): slot s of tile t has the global receiver recv[s] (-1:
// empty) and the pre-permuted message input m_in[s]; tile t belongs to node
// block tile_blocks[t] (non-decreasing over t: a block's tiles are
// consecutive), and a slot counts only if its receiver lies in that block.
//   m[s]   = m_in[s] @ W + b                       (float32)
//   out[n] = max over the slots s with recv[s] = n of m[s], 0 if none
// A negative maximum stays negative; only a receiver without a slot gives 0.
// The TPU kernels multiply a tile's rows on the MXU at HIGHEST precision
// and land the maxima in their resident output block, one by a segmented
// log-roll max and a one-hot mean landing, one by a chunked one-hot max;
// both are ways to land rows on the MXU and compute this same function, so
// the port has one kernel for both.
//
// What bounds it on the card: 2 E d_in H float32 operations over the valid
// slots, at 281,600 valid slots and d_in = H = 464 121 GFLOP, as the three
// TF32 products below at the 495 TFLOP/s dense TF32 peak: 0.74 ms (1.81 ms
// at 67 TFLOP/s outside the tensor cores), against 0.6 GB of m_in, W, b,
// the receivers and the output read or written once (0.18 ms at 3.35
// TB/s): the operations.
//
// Design. One block of 256 threads = one 128-column slice x one node block.
// It finds its tiles by binary search in tile_blocks (tile_walk.cuh);
// their slots are one contiguous range, which it walks in 128-slot rows:
//  - the grid's fast axis is the column slice (blockIdx.x), so the slices
//    of one node block run side by side and read that block's rows of m_in
//    from device memory once (the others hit L2); with the node block fast
//    a block's slices ran ~110 blocks apart and each read m_in again (that
//    order measured <= 2 % slower: PERF.md);
//  - the product runs on the tensor cores in 3xTF32: each float32 operand
//    x is split into a TF32 part hi = tf32(x) and a TF32 rest lo =
//    tf32(x - hi), and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b, three
//    mma.sync m16n8k8 (the dropped lo_a lo_b is ~2^-22 of a product) from
//    zero for each 8-deep step, added to a float32 accumulator rounded to
//    nearest: float32 accuracy, where one TF32 product keeps ~3 digits.
//    8 warps of 64 rows x 32 columns; depth chunks of 32 staged as they
//    lie by 16-byte cp.async (4-byte where a row is not 16-byte aligned),
//    double-buffered (tf32x3.cuh, which the fused linear shares). A
//    float32 SIMT tile (128 x 128, 8 x 8 a thread) measured 4.23 ms at
//    the shape above (PERF.md), above the 2.8 ms this design was to reach
//    without the tensor cores;
//  - the row chunk's products m_in @ W go through shared memory (over the
//    product's buffers), and each thread walks one column over 64
//    receiver-sorted rows, keeping the max of each run of one receiver in
//    a register and landing it in a [node_block x 128] float32
//    accumulator by one exact float atomic max per run, where the earlier
//    kernel landed every (slot, column) by an atomic. The max is exact, so
//    the result does not depend on the order of the landing and two runs
//    give the same bits;
//  - a row chunk that holds no counted slot (a block's padding) is skipped.
// The epilogue adds b to the maxima (max(m + b) = max(m) + b exactly, the
// rounding of x + b being monotone) and writes the block's rows, 0 where
// no slot landed. The times and the build's registers are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kRows = kTf32Rows;         // slots per row chunk
constexpr int kCols = kTf32Cols;         // columns per block
constexpr int kDepth = kTf32Depth;       // depth chunk
constexpr int kThreads = kTf32Threads;   // 8 warps of 64 x 32
constexpr int kMt = 4;                   // m16 tiles a warp
constexpr int kRun = kRows * kCols / kThreads;   // landing rows a thread
constexpr int kCLd = kCols + 4;          // staged product row stride
constexpr int kAccLd = kCols + 1;        // accumulator row stride

struct Smem {
    union {
        Tf32Stage g;                     // m_in and W chunks as they lie
        float c[kRows][kCLd];            // the row chunk's products
    };
    int recv[kRows];                     // the row chunk's receivers
};

__global__ void __launch_bounds__(kThreads, 1) msg_segmax_kernel(
    const float* __restrict__ m_in,            // [T*TE, d_in]
    const float* __restrict__ w,               // [d_in, h]
    const float* __restrict__ b,               // [h]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    float* __restrict__ out,                   // [num_nodes, h]
    int d_in, int h, int num_tiles, int num_nodes, int node_block,
    int edge_tile, int vec_a, int vec_w) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& S = *reinterpret_cast<Smem*>(smem_raw);
    float* acc_s = reinterpret_cast<float*>(smem_raw + sizeof(Smem));
    const int col0 = blockIdx.x * kCols;
    const int blk = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int wm = (warp >> 2) * 64;           // the warp's rows
    const int wn = (warp & 3) * 32;            // the warp's columns
    const int base = blk * node_block;

    for (int i = tid; i < node_block * kAccLd; i += kThreads) {
        acc_s[i] = kNeg;
    }
    const int64_t lo = static_cast<int64_t>(
                           lower_bound(tile_blocks, num_tiles, blk)) *
                       edge_tile;
    const int64_t hi = static_cast<int64_t>(
                           lower_bound(tile_blocks, num_tiles, blk + 1)) *
                       edge_tile;
    const int chunks = (d_in + kDepth - 1) / kDepth;

    for (int64_t row0 = lo; row0 < hi; row0 += kRows) {
        __syncthreads();       // the previous chunk's landing is done
        bool any = false;
        if (tid < kRows) {
            int rc = row0 + tid < hi ? __ldg(recv + row0 + tid) : -1;
            if (!receiver_in_block(rc, base, node_block, num_nodes)) rc = -1;
            S.recv[tid] = rc;
            any = rc >= 0;
        }
        if (!__syncthreads_or(any)) continue;

        float acc[kMt][4][4];
#pragma unroll
        for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
        tf32_load_chunk(S.g, 0, m_in, row0, hi, d_in, w, h, col0, 0, vec_a,
                        vec_w);
        for (int c = 0; c < chunks; ++c) {
            const int buf = c & 1;
            if (c + 1 < chunks) {
                tf32_load_chunk(S.g, buf ^ 1, m_in, row0, hi, d_in, w, h,
                                col0, (c + 1) * kDepth, vec_a, vec_w);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            // not unrolled: unrolled, the fragments of all four steps
            // stay live and the build spills
#pragma unroll 1
            for (int ks = 0; ks < kDepth; ks += 8) {
                uint32_t ah[kMt][4], al[kMt][4], bh[4][2], bl[4][2];
#pragma unroll
                for (int mi = 0; mi < kMt; ++mi) {
                    const int r = wm + mi * 16 + g;
                    split_tf32(S.g.a[buf][r][ks + tq], ah[mi][0], al[mi][0]);
                    split_tf32(S.g.a[buf][r + 8][ks + tq], ah[mi][1],
                               al[mi][1]);
                    split_tf32(S.g.a[buf][r][ks + tq + 4], ah[mi][2],
                               al[mi][2]);
                    split_tf32(S.g.a[buf][r + 8][ks + tq + 4], ah[mi][3],
                               al[mi][3]);
                }
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    const int cc = wn + ni * 8 + g;
                    split_tf32(S.g.b[buf][ks + tq][cc], bh[ni][0], bl[ni][0]);
                    split_tf32(S.g.b[buf][ks + tq + 4][cc], bh[ni][1],
                               bl[ni][1]);
                }
#pragma unroll
                for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
                    for (int ni = 0; ni < 4; ++ni) {
                        mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh[ni],
                                   bl[ni]);
                    }
            }
            __syncthreads();   // the buffer is refilled next
        }

        // the products through shared memory, then each column's runs of
        // one receiver: thread t walks column t % 128 over rows
        // 64 (t / 128) .. + 63, one atomic max per run
#pragma unroll
        for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = wm + mi * 16 + g + half * 8;
                    const int cc = wn + ni * 8 + tq * 2;
                    *reinterpret_cast<float2*>(&S.c[r][cc]) = make_float2(
                        acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
                }
        __syncthreads();
        {
            const int cc = tid & (kCols - 1);
            const int r0 = (tid / kCols) * kRun;
            int cur = S.recv[r0];
            float run = S.c[r0][cc];
            for (int r = r0 + 1; r < r0 + kRun; ++r) {
                const int rc = S.recv[r];
                const float v = S.c[r][cc];
                if (rc == cur) {
                    run = fmaxf(run, v);
                } else {
                    if (cur >= 0) {
                        atomic_max_f32(acc_s + (cur - base) * kAccLd + cc,
                                       run);
                    }
                    cur = rc;
                    run = v;
                }
            }
            if (cur >= 0) {
                atomic_max_f32(acc_s + (cur - base) * kAccLd + cc, run);
            }
        }
    }
    __syncthreads();

    // epilogue: the bias (after the max: x -> x + b rounds monotonically,
    // so max(m + b) is max(m) + b bit for bit); receivers no slot reached
    // -> 0
    for (int i = tid; i < node_block * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        const int n = base + r, col = col0 + c;
        if (n >= num_nodes || col >= h) continue;
        const float v = acc_s[r * kAccLd + c];
        out[static_cast<size_t>(n) * h + col] =
            v > kNeg / 2 ? v + __ldg(b + col) : 0.0f;
    }
}

}  // namespace

extern "C" {

size_t msg_segmax_smem_bytes(int node_block) {
    return sizeof(Smem) +
           sizeof(float) * static_cast<size_t>(node_block) * kAccLd;
}

int msg_segmax(const void* m_in, const void* w, const void* b,
               const void* recv, const void* tile_blocks, void* out,
               int d_in, int h, int num_tiles, int num_nodes, int node_block,
               int edge_tile, int vec_a, int vec_w, void* stream) {
    const size_t smem = msg_segmax_smem_bytes(node_block);
    cudaError_t err = cudaFuncSetAttribute(
        msg_segmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int slices = (h + kCols - 1) / kCols;
    const int blocks = (num_nodes + node_block - 1) / node_block;
    if (blocks == 0) return static_cast<int>(cudaSuccess);
    const dim3 grid(slices, blocks);
    msg_segmax_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(m_in), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks), static_cast<float*>(out),
        d_in, h, num_tiles, num_nodes, node_block, edge_tile, vec_a, vec_w);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
