// 3xTF32 products on the tensor cores (mma.sync m16n8k8), shared by the
// message segment-max (msg_segmax.cu, B8) and the fused linear
// (fused_linear.cu, B9): float32 accuracy from three TF32 products, and the
// staging of a 128-row x 128-column tile's depth chunks into shared memory
// by cp.async, double-buffered.
//
// Each float32 operand x is split into a TF32 part hi and a TF32 rest lo
// with x - hi exact in float32; then a b ~ lo_a hi_b + hi_a lo_b + hi_a
// hi_b (the dropped lo_a lo_b and the rounding of lo are ~2^-22 of |a b|
// with hi rounded to nearest, ~2^-21 with hi truncated). Two splits:
// split_tf32 rounds hi to nearest (ties away) and rounds lo so (the
// segment-max's), split_tf32_rz truncates hi and leaves lo's low bits for
// the tensor cores to drop (the fused linear's: two integer/float
// instructions per operand in place of two conversions). The
// three products of one 8-deep step are formed from zero and added to a
// float32 accumulator rounded to nearest: the tensor cores' float32 sums
// truncate, so an output takes that error once per step rather than once
// per product. TF32 keeps float32's exponent range, so the split is exact
// in range; with rounding, a |x| within 2^-11 of FLT_MAX rounds hi to
// infinity (no layer's values come near), and a lo below the normal range
// loses bits far under the output's scale.
#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace radargnn {

constexpr int kTf32Rows = 128;             // rows of a staged tile
constexpr int kTf32Cols = 128;             // columns of a staged tile
constexpr int kTf32Depth = 32;             // depth chunk
constexpr int kTf32Threads = 256;          // threads that stage a tile
constexpr int kTf32ALd = kTf32Depth + 4;   // A chunk row stride
constexpr int kTf32BLd = kTf32Cols + 8;    // B chunk row stride

// Two buffers of a depth chunk: A's rows [128 x 32] and B's rows [32 x 128]
// as they lie (the strides keep the fragment loads free of bank conflicts).
struct Tf32Stage {
    float a[2][kTf32Rows][kTf32ALd];
    float b[2][kTf32Depth][kTf32BLd];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// x = hi + lo with hi = x truncated to TF32 (its low 13 mantissa bits
// cleared) and lo = x - hi (exact), whose low mantissa bits the tensor
// cores ignore (a truncation of lo to TF32).
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi,
                                              uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
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
// either split), formed from zero and added rounded to nearest.
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

// Starts the copies of depth chunk k0 of A's rows row0 .. row0 + 127 (A
// [rows_end, depth] row-major) and of B's columns col0 .. col0 + 127 (B
// [depth, n] row-major) into buffer buf, zero past the ends, and commits
// them as one group: 16-byte copies where vec_a / vec_b say the rows are
// 16-byte aligned (depth, n multiples of 4), else 4-byte ones. All
// kTf32Threads threads call it.
__device__ __forceinline__ void tf32_load_chunk(Tf32Stage& S, int buf,
                                                const float* __restrict__ A,
                                                int64_t row0, int64_t rows_end,
                                                int depth,
                                                const float* __restrict__ B,
                                                int n, int col0, int k0,
                                                bool vec_a, bool vec_b) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < kTf32Rows * kTf32Depth / 4 / kTf32Threads; ++q) {
        const int i = tid + q * kTf32Threads;
        const int r = i / (kTf32Depth / 4), kc = (i % (kTf32Depth / 4)) * 4;
        const int64_t row = row0 + r;
        const int k = k0 + kc;
        float* dst = &S.a[buf][r][kc];
        const float* src = A + row * depth + k;
        if (vec_a) {
            const bool ok = row < rows_end && k < depth;
            cp_async16(dst, ok ? src : A, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = row < rows_end && k + j < depth;
                cp_async4(dst + j, ok ? src + j : A, ok);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < kTf32Depth * kTf32Cols / 4 / kTf32Threads; ++q) {
        const int i = tid + q * kTf32Threads;
        const int k = k0 + i / (kTf32Cols / 4), c = (i % (kTf32Cols / 4)) * 4;
        const int col = col0 + c;
        float* dst = &S.b[buf][i / (kTf32Cols / 4)][c];
        const float* src = B + static_cast<int64_t>(k) * n + col;
        if (vec_b) {
            const bool ok = k < depth && col < n;
            cp_async16(dst, ok ? src : B, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = k < depth && col + j < n;
                cp_async4(dst + j, ok ? src + j : B, ok);
            }
        }
    }
    cp_async_commit();
}

}  // namespace radargnn
