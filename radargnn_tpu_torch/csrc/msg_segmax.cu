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
//    double-buffered. A float32 SIMT tile (128 x 128, 8 x 8 a thread)
//    measured 4.23 ms at the shape above (PERF.md), above the 2.8 ms this
//    design was to reach without the tensor cores;
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

#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kRows = 128;               // slots per row chunk
constexpr int kCols = 128;               // columns per block
constexpr int kDepth = 32;               // depth chunk
constexpr int kThreads = 256;            // 8 warps of 64 x 32
constexpr int kMt = 4;                   // m16 tiles a warp
constexpr int kRun = kRows * kCols / kThreads;   // landing rows a thread
constexpr int kALd = kDepth + 4;         // m_in chunk row stride
constexpr int kBLd = kCols + 8;          // W chunk row stride
constexpr int kCLd = kCols + 4;          // staged product row stride
constexpr int kAccLd = kCols + 1;        // accumulator row stride

struct Smem {
    union {
        struct {
            float a[2][kRows][kALd];     // m_in chunk as it lies
            float b[2][kDepth][kBLd];    // W chunk as it lies
        } g;
        float c[kRows][kCLd];            // the row chunk's products
    };
    int recv[kRows];                     // the row chunk's receivers
};

// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both TF32
// values (x - hi is exact in float32), so that a b ~ lo_a hi_b + hi_a lo_b
// + hi_a hi_b to ~2^-22 of |a b| (the dropped lo_a lo_b and the rounding
// of lo): float32 accuracy from three TF32 products.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a @ b (mma.sync m16n8k8, TF32 in, float32 accumulator). A (16 x 8,
// row): a0 (g, tq), a1 (g+8, tq), a2 (g, tq+4), a3 (g+8, tq+4); B (8 x 8,
// col): b0 (tq, g), b1 (tq+4, g); C: c0 (g, 2tq), c1 (g, 2tq+1), c2 (g+8,
// 2tq), c3 (g+8, 2tq+1), with g = lane / 4, tq = lane % 4.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += the three TF32 products of one 8-deep step (a and b split by
// split_tf32), formed from zero and added rounded to nearest: the tensor
// cores' float32 sums truncate, so an output takes that error once per
// step rather than once per product.
__device__ __forceinline__ void mma_3xtf32(float* acc, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
    float p[4];
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
        : "r"(a_lo[0]), "r"(a_lo[1]), "r"(a_lo[2]), "r"(a_lo[3]),
          "r"(b_hi[0]), "r"(b_hi[1]), "f"(0.0f));
    mma_tf32(p, a_hi, b_lo);
    mma_tf32(p, a_hi, b_hi);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += p[q];
}

// 4-byte async copy global -> shared (a row that is not 16-byte aligned);
// copies zero when !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(pred ? 4 : 0));
}

// Issues the copies of depth chunk k0 of rows row0 .. row0 + 127 of m_in and
// of W's columns col0 .. col0 + 127 into buffer buf; zero past the ends.
__device__ __forceinline__ void issue(Smem& S, int buf,
                                      const float* __restrict__ m_in,
                                      int64_t row0, int64_t rows_end,
                                      int d_in, const float* __restrict__ w,
                                      int h, int col0, int k0, bool vec_a,
                                      bool vec_w) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < kRows * kDepth / 4 / kThreads; ++q) {
        const int i = tid + q * kThreads;
        const int r = i / (kDepth / 4), kc = (i % (kDepth / 4)) * 4;
        const int64_t row = row0 + r;
        const int k = k0 + kc;
        float* dst = &S.g.a[buf][r][kc];
        const float* src = m_in + row * d_in + k;
        if (vec_a) {
            const bool ok = row < rows_end && k < d_in;
            cp_async16(dst, ok ? src : m_in, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = row < rows_end && k + j < d_in;
                cp_async4(dst + j, ok ? src + j : m_in, ok);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < kDepth * kCols / 4 / kThreads; ++q) {
        const int i = tid + q * kThreads;
        const int k = k0 + i / (kCols / 4), c = (i % (kCols / 4)) * 4;
        const int col = col0 + c;
        float* dst = &S.g.b[buf][i / (kCols / 4)][c];
        const float* src = w + static_cast<int64_t>(k) * h + col;
        if (vec_w) {
            const bool ok = k < d_in && col < h;
            cp_async16(dst, ok ? src : w, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = k < d_in && col + j < h;
                cp_async4(dst + j, ok ? src + j : w, ok);
            }
        }
    }
    cp_async_commit();
}

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
        issue(S, 0, m_in, row0, hi, d_in, w, h, col0, 0, vec_a, vec_w);
        for (int c = 0; c < chunks; ++c) {
            const int buf = c & 1;
            if (c + 1 < chunks) {
                issue(S, buf ^ 1, m_in, row0, hi, d_in, w, h, col0,
                      (c + 1) * kDepth, vec_a, vec_w);
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
