// Dense fixed-degree hoisted max aggregation, forward (serving) kernel.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v4 (reached through _fused_fwd_call_v4 and
// make_fused_dense_aggregate) on Hopper (sm_90a).
//
// What it computes. Tile t covers receivers [t*R, (t+1)*R); slot
// t*TE + j*R + r (TE = R*K) holds receiver t*R+r's j-th in-edge, whose
// sender is tile_win[t]*node_block + senders_local[slot] (-1: empty slot).
//   op[slot]  = x[sender] @ W_s + e_t[slot] @ W_e      (bf16 in, f32 acc)
//             = -3e38 for empty slots
//   inner[n]  = max(max_j op[t*TE + j*R + r], inner_o[n])
//   out[n]    = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
//
// Design. The TPU kernel gathers the sender rows with a one-hot [TE, W]
// matmul over a Morton window of x; here a gather is an indexed load, so
// each block loads the R sender rows of one slot row j straight from x
// (cp.async, zero-filled for empty slots, double-buffered so slot row j+1
// loads while j multiplies), and the window only serves to form the
// global sender index. One block = one tile x one 64-column slice of H,
// (R/16) warps, each owning 16 receivers. The W_s and W_e column slices
// stay in shared memory (transposed, k contiguous) for the whole block;
// the products run on the tensor cores as mma.sync m16n8k16 bf16 with f32
// accumulators, and the running max over the K slot rows lives in
// registers. The overflow maxima, the offset and the empty-receiver rule
// are the epilogue, as on the TPU.
//
// What bounds it on the card. At the flagship shapes (N=14,080, R=64,
// K=24, d_in up to 224, H up to 464) the function needs x @ W_s once per
// node (x[s] @ W_s = (x @ W_s)[s]) and e @ W_e once per valid slot: ~7
// GFLOP of bf16 products per wide layer against ~97 MB of compulsory
// traffic, so the floor is the HBM rate (~29 us per wide layer). This
// design, like the TPU kernel, multiplies x[s] @ W_s once per slot
// (~60 GFLOP per wide layer, ~8x the function's work), re-gathers each
// sender row once per 64-column slice (x is small enough to stay in L2)
// and feeds mma.sync from shared memory rather than wgmma, so it is held
// by its own tensor-core work, far above the floor. The node-level
// projection computed inside the kernel (ROADMAP.md B1) removes the
// per-slot product; the times are recorded in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockCols = 64;           // output columns per block
constexpr int kColTiles = kBlockCols / 8;
constexpr float kNeg = -3.0e38f;         // finite -inf stand-in

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

// acc[16 x 64] += A[16 x kp] (rows of a_s, stride lda) @ B (b_s holds the
// 64 output columns as rows of length kp, stride ldb)
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

__global__ void __launch_bounds__(256) dense_fwd_v4_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    const float* __restrict__ inner_o,         // [T*R, h]
    const float* __restrict__ offset,          // [T*R, h]
    float* __restrict__ out,                   // [T*R, h]
    int n_x, int d, int de, int h, int r_tile, int k, int node_block) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int kp = (d + 15) & ~15;             // depths padded to the mma k
    const int kpe = (de + 15) & ~15;
    const int lda = kp + 8;                    // +8: conflict-free fragments
    const int lde = kpe + 8;
    __nv_bfloat16* ws_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* we_s = ws_s + kBlockCols * lda;
    __nv_bfloat16* xa_s = we_s + kBlockCols * lde;   // 2 x [r_tile][lda]
    __nv_bfloat16* ea_s = xa_s + 2 * r_tile * lda;   // 2 x [r_tile][lde]

    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = warp * 16;                  // this warp's receiver rows
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);

    // W_s / W_e column slices, transposed; zero past h and past d / de
    for (int i = tid; i < kp * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        ws_s[n * lda + kk] = (kk < d && col < h)
            ? w_s[static_cast<size_t>(kk) * h + col] : zero;
    }
    for (int i = tid; i < kpe * kBlockCols; i += nthreads) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        we_s[n * lde + kk] = (kk < de && col < h)
            ? w_e[static_cast<size_t>(kk) * h + col] : zero;
    }
    // the depth padding [d, kp) of the row buffers is read by the mma and
    // never written by the gathers: zero it once
    for (int i = tid; i < 2 * r_tile * (kp - d); i += nthreads) {
        const int r = i / (kp - d), c = i % (kp - d);
        xa_s[r * lda + d + c] = zero;
    }
    for (int i = tid; i < 2 * r_tile * (kpe - de); i += nthreads) {
        const int r = i / (kpe - de), c = i % (kpe - de);
        ea_s[r * lde + de + c] = zero;
    }

    const int te = r_tile * k;
    const size_t tile_slot0 = static_cast<size_t>(t) * te;
    const int win0 = tile_win[t] * node_block;
    const int xchunks = d / 8, echunks = de / 8;   // 16-byte chunks per row

    auto issue = [&](int j, int buf) {
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
        __nv_bfloat16* xa = xa_s + buf * r_tile * lda;
        __nv_bfloat16* ea = ea_s + buf * r_tile * lde;
        for (int i = tid; i < r_tile * xchunks; i += nthreads) {
            const int r = i / xchunks, c = i % xchunks;
            const int sl = sloc[slot0 + r];
            const int s = win0 + sl;
            const bool ok = sl >= 0 && s < n_x;
            const __nv_bfloat16* src = ok ? x + static_cast<size_t>(s) * d + c * 8 : x;
            cp_async16(xa + r * lda + c * 8, src, ok);
        }
        for (int i = tid; i < r_tile * echunks; i += nthreads) {
            const int r = i / echunks, c = i % echunks;
            cp_async16(ea + r * lde + c * 8,
                       e_t + (slot0 + r) * static_cast<size_t>(de) + c * 8,
                       true);
        }
        cp_async_commit();
    };

    float mx[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[nt][q] = kNeg;

    issue(0, 0);
    for (int j = 0; j < k; ++j) {
        const int buf = j & 1;
        if (j + 1 < k) {
            issue(j + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float acc[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
        warp_gemm(acc, xa_s + buf * r_tile * lda + m0 * lda, lda, ws_s, lda,
                  kp, g, tq);
        warp_gemm(acc, ea_s + buf * r_tile * lde + m0 * lde, lde, we_s, lde,
                  kpe, g, tq);

        // this thread's rows are m0+g and m0+g+8 of the slot row
        const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r_tile;
        const int sl0 = sloc[slot0 + m0 + g];
        const int sl1 = sloc[slot0 + m0 + g + 8];
        const bool v0 = sl0 >= 0 && win0 + sl0 < n_x;
        const bool v1 = sl1 >= 0 && win0 + sl1 < n_x;
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
            if (v0) {
                mx[nt][0] = fmaxf(mx[nt][0], acc[nt][0]);
                mx[nt][1] = fmaxf(mx[nt][1], acc[nt][1]);
            }
            if (v1) {
                mx[nt][2] = fmaxf(mx[nt][2], acc[nt][2]);
                mx[nt][3] = fmaxf(mx[nt][3], acc[nt][3]);
            }
        }
        __syncthreads();       // the buffer is refilled two steps later
    }

    // epilogue: overflow maxima, hoisted offset, empty receivers -> 0
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int row = m0 + g + (q >> 1) * 8;
            const int col = col0 + nt * 8 + tq * 2 + (q & 1);
            if (col >= h) continue;
            const size_t idx =
                (static_cast<size_t>(t) * r_tile + row) * h + col;
            const float inner = fmaxf(mx[nt][q], inner_o[idx]);
            out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
        }
    }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these shapes, in bytes.
size_t dense_fwd_v4_smem_bytes(int d, int de, int r_tile) {
    const int lda = ((d + 15) & ~15) + 8;
    const int lde = ((de + 15) & ~15) + 8;
    return sizeof(__nv_bfloat16) *
           (static_cast<size_t>(kBlockCols) * (lda + lde) +
            2 * static_cast<size_t>(r_tile) * (lda + lde));
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: d and de multiples of 8,
// r_tile a multiple of 16 and at most 128, 16-byte aligned x and e_t.
int dense_fwd_v4(const void* x, const void* w_s, const void* e_t,
                 const void* w_e, const void* sloc, const void* tile_win,
                 const void* inner_o, const void* offset, void* out,
                 int n_x, int d, int de, int h, int num_tiles, int r_tile,
                 int k, int node_block, void* stream) {
    const size_t smem = dense_fwd_v4_smem_bytes(d, de, r_tile);
    cudaError_t err = cudaFuncSetAttribute(
        dense_fwd_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(num_tiles, (h + kBlockCols - 1) / kBlockCols);
    const dim3 block((r_tile / 16) * 32);
    dense_fwd_v4_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w_s),
        static_cast<const __nv_bfloat16*>(e_t),
        static_cast<const __nv_bfloat16*>(w_e),
        static_cast<const int32_t*>(sloc),
        static_cast<const int32_t*>(tile_win),
        static_cast<const float*>(inner_o),
        static_cast<const float*>(offset), static_cast<float*>(out),
        n_x, d, de, h, r_tile, k, node_block);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
