// Building blocks shared by the port's hand-written kernels (sm_90a):
// mma.sync m16n8k16 bf16 -> f32, 16-byte cp.async, and a warp-level
// [16 x 64] += [16 x k] @ [k x 64] product fed from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace radargnn {

constexpr int kBlockCols = 64;           // output columns per block
constexpr int kColTiles = kBlockCols / 8;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte async copy global -> shared; copies zeros when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int src_bytes = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// ldmatrix .x4 .trans: four 8x8 b16 matrices from shared memory, each
// delivered transposed; lane t gives the address of row t % 8 of matrix
// t / 8, and r[i] receives matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem_row) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

// acc[16 x 64] += A[16 x kp] (rows of a_s, stride lda) @ B (b_s holds the
// 64 output columns as rows of length kp, stride ldb); kp a multiple of 16.
// The fragment order is fixed, so equal inputs give bitwise-equal sums.
__device__ __forceinline__ void warp_gemm(float (*acc)[4],
                                          const __nv_bfloat16* a_s, int lda,
                                          const __nv_bfloat16* b_s, int ldb,
                                          int kp, int g, int tq) {
    for (int k0 = 0; k0 < kp; k0 += 16) {
        const __nv_bfloat16* ap = a_s + g * lda + k0 + tq * 2;
        uint32_t a[4] = {ld_pair(ap), ld_pair(ap + 8 * lda), ld_pair(ap + 8),
                         ld_pair(ap + 8 * lda + 8)};
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
            const __nv_bfloat16* bp = b_s + (nt * 8 + g) * ldb + k0 + tq * 2;
            uint32_t b[2] = {ld_pair(bp), ld_pair(bp + 8)};
            mma_bf16_16816(acc[nt], a, b);
        }
    }
}

}  // namespace radargnn
