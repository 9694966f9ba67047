// Dense fixed-degree hoisted max aggregation, forward: the node projection
// and the gather-max.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_fwd_kernel_v4 (reached through _fused_fwd_call_v4 and
// make_fused_dense_aggregate) on Hopper (sm_90a).
//
// What it computes (slot layout in dense_gather.cuh):
//   y_s       = x @ W_s, [n_x, hp] f32 (bf16 in, f32 accumulation; hp = H
//               rounded up to 64, zero past H)            dense_proj_v4
//   op[slot]  = y_s[sender] + e_t[slot] @ W_e             dense_fwd_v4
//             = -3e38 for empty slots
//   inner[n]  = max(max_j op[t*TE + j*R + r], inner_o[n])
//   out[n]    = offset[n] + inner[n] where inner[n] > -1.5e38, else 0
// In VJP mode (non-null `inner_out` and `bits`, the TPU kernel's
// emit_inner) it also writes inner[n] and one routing bit per (slot,
// column), set where the slot holds an edge and |op - inner| <= 1e-5
// |inner| + 1e-5 (the strict routing of the TPU kernel's backward, under
// which every tied slot takes the full g; with `bf16_max`, where
// bf16(op) == bf16(inner), the TPU kernel's bf16_cmp branch): bits[slot][w]
// holds columns 32w .. 32w+31. The backward (dense_bwd_v4.cu) routes on
// these bits, so it sees this op bit for bit without recomputing it.
// Serving passes null and skips both writes.
//
// What bounds it on the card. The function needs x @ W_s once per node
// (x[s] @ W_s = y_s[s]; 2.9 GFLOP at the flagship's wide layer, N =
// 14,080, d 224, H 464) and e @ W_e once per slot (5 GFLOP at d_e 16),
// against ~97 MB of compulsory traffic (x, e_t, the index arrays, inner_o,
// offset, out): the HBM rate bounds it (~29 us per wide layer; the VJP
// mode adds inner and the bits, ~48 MB). The TPU kernel multiplies
// x[s] @ W_s once per slot, ~60 GFLOP per wide layer; this design projects
// once per node in its own launch (dense_proj_v4: one block per 128 nodes
// x 64 columns on mma.sync, both operands staged in shared memory) and
// gathers y_s rows (26 MB at the wide layer): one block per (tile,
// 64-column slice) stages the slices of the tile's distinct senders in
// shared memory once (dense_gather.cuh), walks the slot rows with the edge
// rows double-buffered, adds the edge product (one m16n8k16 step at d_e
// 16) and keeps the running max in registers; the distinct rows are ~9x
// fewer than the slots' (~630 MB per wide layer read per slot). The VJP
// mode walks the slot rows twice (the max, then the bits against it). It
// runs at ~7x its bound; what holds it is not measured (PERF.md, with the
// times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_gather.cuh"

namespace {

using namespace radargnn;

constexpr float kNeg = -3.0e38f;         // finite -inf stand-in
constexpr int kProjRows = 128;           // nodes per projection block
constexpr int kProjLdw = kBlockCols + 8; // W_s slice row stride (bf16)

// y_s[n][c] = sum_k x[n][k] w_s[k][c] for c < hw, 0 for hw <= c < hp. One
// block = 128 nodes x one 64-column slice, 8 warps of 16 nodes; the x rows
// and the W_s slice as it lies ([k][64], 16-byte cp.async, zero past d
// and hw) in shared memory, the depth padded to the mma k; ldmatrix.trans
// hands the mma the slice's column fragments.
__global__ void __launch_bounds__(256) dense_proj_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n, d]
    const __nv_bfloat16* __restrict__ w_s,     // [d, hw]
    float* __restrict__ y_s,                   // [n, hp]
    int n, int d, int hw, int hp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int kp = (d + 15) & ~15, ldx = kp + 8;
    auto* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [128][ldx]
    __nv_bfloat16* ws = xs + kProjRows * ldx;               // [kp][ldw]
    const int row0 = blockIdx.x * kProjRows;
    const int col0 = blockIdx.y * kBlockCols;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m0 = (tid >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;

    const int chunks = kp / 8;                 // 16-byte chunks per x row
    for (int i = tid; i < kProjRows * chunks; i += blockDim.x) {
        const int r = i / chunks, c = i % chunks;
        const bool ok = row0 + r < n && c * 8 < d;
        cp_async16(xs + r * ldx + c * 8,
                   ok ? x + static_cast<size_t>(row0 + r) * d + c * 8 : x,
                   ok);
    }
    constexpr int kWChunks = kBlockCols / 8;   // 16-byte chunks per W row
    for (int i = tid; i < kp * kWChunks; i += blockDim.x) {
        const int kk = i / kWChunks, c = i % kWChunks;
        const int col = col0 + c * 8;
        const bool ok = kk < d && col < hw;
        cp_async16(ws + kk * kProjLdw + c * 8,
                   ok ? w_s + static_cast<size_t>(kk) * hw + col : w_s, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float acc[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
    // lane t addresses row t % 8 of 8x8 matrix t / 8
    const int mrow = lane & 7, mat = lane >> 3;
    for (int k0 = 0; k0 < kp; k0 += 16) {
        const __nv_bfloat16* ap = xs + (m0 + g) * ldx + k0 + tq * 2;
        const uint32_t a[4] = {ld_pair(ap), ld_pair(ap + 8 * ldx),
                               ld_pair(ap + 8), ld_pair(ap + 8 * ldx + 8)};
#pragma unroll
        for (int nt = 0; nt < kColTiles; nt += 2) {
            // B (16 depths x 8 columns) for tiles nt and nt+1: matrices
            // (k+0, nt) (k+8, nt) (k+0, nt+1) (k+8, nt+1)
            uint32_t b[4];
            ldmatrix_x4_trans(b, ws + (k0 + mrow + (mat & 1) * 8) * kProjLdw
                                 + nt * 8 + (mat >> 1) * 8);
            mma_bf16_16816(acc[nt], a, b);
            mma_bf16_16816(acc[nt + 1], a, b + 2);
        }
    }

#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = row0 + m0 + g + half * 8;
            if (row >= n) continue;
            *reinterpret_cast<float2*>(
                y_s + static_cast<size_t>(row) * hp + col0 + nt * 8 +
                tq * 2) = make_float2(acc[nt][half * 2],
                                      acc[nt][half * 2 + 1]);
        }
    }
}

__global__ void __launch_bounds__(256) dense_fwd_v4_kernel(
    const float* __restrict__ y_s,             // [n_x, hp]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const __nv_bfloat16* __restrict__ w_e,     // [de, h]
    const int32_t* __restrict__ sloc,          // [T*TE]
    const int32_t* __restrict__ tile_win,      // [T]
    const float* __restrict__ inner_o,         // [T*R, h]
    const float* __restrict__ offset,          // [T*R, h]
    float* __restrict__ out,                   // [T*R, h]
    float* __restrict__ inner_out,             // [T*R, h] or null
    uint32_t* __restrict__ bits,               // [T*TE, hp/32] or null
    int n_x, int de, int h, int hp, int r_tile, int k, int node_block,
    bool bf16_max) {
    const int t = blockIdx.x;
    const int col0 = blockIdx.y * kBlockCols;
    const int lane = threadIdx.x & 31;
    const int m0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const DenseSenders senders(sloc, tile_win, t, node_block, n_x);
    stage_edge_weights(gather_smem(de, r_tile, k), w_e, de, h, r_tile,
                       col0);

    float mx[kColTiles][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[nt][q] = kNeg;
    gather_rows(t, y_s, e_t, senders, de, hp, r_tile, k, col0, false,
                [&](int, float (*acc)[4], bool v0, bool v1) {
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
    });

    // epilogue: overflow maxima, hoisted offset, empty receivers -> 0;
    // mx becomes inner (the VJP pass routes against it)
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int row = m0 + g + (q >> 1) * 8;
            const int col = col0 + nt * 8 + tq * 2 + (q & 1);
            if (row >= r_tile || col >= h) continue;
            const size_t idx =
                (static_cast<size_t>(t) * r_tile + row) * h + col;
            const float inner = fmaxf(mx[nt][q], inner_o[idx]);
            mx[nt][q] = inner;
            if (inner_out != nullptr) inner_out[idx] = inner;
            out[idx] = inner > kNeg / 2 ? offset[idx] + inner : 0.0f;
        }
    }
    if (bits == nullptr) return;

    const int words = hp / 32;
    const size_t tile_slot0 = static_cast<size_t>(t) * r_tile * k;
    // VJP mode: the same loop again, each op against its receiver's inner
    // (the staged senders of a one-chunk tile are walked again as they lie)
    gather_rows(t, y_s, e_t, senders, de, hp, r_tile, k, col0, true,
                [&](int j, float (*acc)[4], bool v0, bool v1) {
        bool sel[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = col0 + nt * 8 + tq * 2 + (q & 1);
                sel[nt][q] = ((q >> 1) ? v1 : v0) && col < h &&
                             routes(acc[nt][q], mx[nt][q], bf16_max);
            }
        }
        uint32_t w[2][2];
        pack_row_bits(sel, tq, w);
        // a slot's words are written in the chunk that holds its sender;
        // the words of empty slots stay as the caller zeroed them
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            if (tq == 0 && (half ? v1 : v0)) {
                const size_t slot = tile_slot0 +
                    static_cast<size_t>(j) * r_tile + m0 + g + half * 8;
                *reinterpret_cast<uint2*>(bits + slot * words + col0 / 32) =
                    make_uint2(w[half][0], w[half][1]);
            }
        }
    });
}

}  // namespace

extern "C" {

// Shared memory the projection needs for depth d, in bytes.
size_t dense_proj_v4_smem_bytes(int d) {
    const size_t kp = (d + 15) & ~15;
    return sizeof(__nv_bfloat16) * (kProjRows * (kp + 8) + kp * kProjLdw);
}

// Launches the projection on `stream`; returns the cudaError_t of the
// launch. The caller checks shapes, types and alignment: d and hw (w_s's
// width, H zero-padded to a multiple of 8) multiples of 8, hp = H rounded
// up to 64, 16-byte aligned x and w_s.
int dense_proj_v4(const void* x, const void* w_s, void* y_s, int n, int d,
                  int hw, int hp, void* stream) {
    const size_t smem = dense_proj_v4_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        dense_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kProjRows - 1) / kProjRows, hp / kBlockCols);
    if (grid.x > 0) {
        dense_proj_kernel<<<grid, 256, smem,
                            static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w_s), static_cast<float*>(y_s),
            n, d, hw, hp);
    }
    return static_cast<int>(cudaGetLastError());
}

// Shared memory the gather-max needs for these shapes, in bytes.
size_t dense_fwd_v4_smem_bytes(int de, int r_tile, int k) {
    return gather_smem_bytes(de, r_tile, k);
}

// Launches the gather-max on `stream`; returns the cudaError_t of the
// launch. The caller checks shapes, types and alignment: de a multiple of
// 8, r_tile a multiple of 8 and at most 128, y_s [n_x, hp] with hp = h
// rounded up to 64, 16-byte aligned e_t. `inner` and `bits` are both null
// (serving) or both set (VJP mode; bits zeroed by the caller); `bf16_max`
// non-zero sets the bits by the bf16 test (tile_walk.cuh, routes_bf16).
int dense_fwd_v4(const void* y_s, const void* e_t, const void* w_e,
                 const void* sloc, const void* tile_win, const void* inner_o,
                 const void* offset, void* out, void* inner, void* bits,
                 int n_x, int de, int h, int hp, int num_tiles, int r_tile,
                 int k, int node_block, int bf16_max, void* stream) {
    const size_t smem = gather_smem_bytes(de, r_tile, k);
    cudaError_t err = cudaFuncSetAttribute(
        dense_fwd_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(num_tiles, hp / kBlockCols);
    const dim3 block((r_tile + 15) / 16 * 32);
    if (grid.x > 0) {
        dense_fwd_v4_kernel<<<grid, block, smem,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(y_s),
            static_cast<const __nv_bfloat16*>(e_t),
            static_cast<const __nv_bfloat16*>(w_e),
            static_cast<const int32_t*>(sloc),
            static_cast<const int32_t*>(tile_win),
            static_cast<const float*>(inner_o),
            static_cast<const float*>(offset), static_cast<float*>(out),
            static_cast<float*>(inner), static_cast<uint32_t*>(bits), n_x,
            de, h, hp, r_tile, k, node_block, bf16_max != 0);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
