// CSR-tiled hoisted max aggregation (v2), backward kernels.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v2 (reached through _fused_bwd_call_v2 and the custom
// VJP of make_fused_hoisted_aggregate_v2) on Hopper (sm_90a).
//
// What it computes (layout as in csr_fwd_v2.cu; inner_z and g_pass are
// [num_nodes, h] f32, 0 at empty receivers; a slot is valid when its
// receiver lies in its tile's block):
//   op[s]      = x[senders[s]] @ W_s + e_t[s] @ W_e       (as the forward:
//                y_s[senders[s]] + the edge chain, csr_slot.cuh)
//   d_op[s]    = g_pass[recv[s]] where s is valid and
//                |op - inner_z[recv]| <= 1e-5 |inner_z[recv]| + 1e-5,
//                else 0, in float32. Every tied slot takes the full g.
//   d_xg[s]    = bf16(bf16(d_op[s]) @ W_s^T)
//   d_e[s]     = d_op[s] @ W_e^T                          (float32)
//   dW_s       = sum over slots of x[sender]^T bf16(d_op)
//   dW_e       = sum over slots of e_t^T d_op             (float32)
// The two forms of d_op are the TPU kernel's: the bf16-rounded one drives
// the sender-side outputs d_xg and dW_s, the float32 one the edge-side d_e
// and dW_e. d_x, the d_xg rows summed at their senders, is landed by the
// B3 kernel (segment_sum_csr.cu) over the batch's sender-sorted tiling,
// as pallas_segment_sum_csr lands it on the TPU. The TPU kernel recomputes
// op slot by slot (x[sender] @ W_s and e_t @ W_e on the MXU for every
// slot), gathers inner_z and g_pass by one-hot matmuls and accumulates the
// weight gradients in its resident output blocks.
//
// What bounds it on the card. The function needs d_x = (the sum of d_op
// over a sender's slots) @ W_s^T and dW_s = x^T @ (the same sums) once per
// node in bf16, d_e and dW_e once per valid slot in float32: at the
// flagship's wide layer ~5.9 GFLOP of bf16 products (6 us) and ~8.4 GFLOP
// of float32 products (125 us at 67 TFLOP/s), so the float32 edge
// gradients bound it.
//
// Design: a node projection, the launches below and B3's landing, on one
// stream, no atomics and fixed summation orders, so two runs on the same
// inputs are bitwise equal:
//  0. projection: y_s = x @ W_s, [n_x, hp] f32 (hp = h rounded up to 64),
//     the node projection the forward gathered (dense_proj_v4 of
//     dense_fwd_v4.cu), which the caller (ops/csr_aggregate.py) saved from
//     the forward or, without one, projects anew: the same kernel on the
//     same inputs, the same bits. So the routing pass sees the forward's
//     op bit for bit (csr_slot.cuh), and no slot multiplies x @ W_s.
//  1. route: one block of 256 threads per 256 slots (not per tile x
//     column slice), 2 blocks an SM; W_e and the block's edge rows stay in
//     shared memory. A thread owns one slot and walks all its columns, 8
//     at a time (the next 8's loads of y_s, inner_z and g_pass in flight
//     while these compute): it rebuilds op = y_s[sender] + the float32
//     edge chain (fmaf over the edge features in ascending order from 0,
//     then added to the x part: csr_slot.cuh), routes it against
//     inner_z with the strict test rounded as torch rounds it, and adds
//     d_op @ W_e^T into its slot's d_e in registers, the columns in order
//     (no [hp/64, n_slots, de] partial buffer and no pass to reduce it).
//     Every 32 columns the block's d_op goes through shared memory: written
//     out as bf16(d_op) [n_slots, hp] (zero past h) for the sender side in
//     16-byte stores, and summed into dW_e (each warp's 32 slots in order,
//     then the 8 warps in order) as one partial per block, we_part
//     [blocks, dep, hp]. Edge features come 16 at a time (dep = de rounded
//     up to 16); a wider de runs the columns once per 16. All edge-side
//     products are float32 fma on the CUDA cores (3xTF32 on the tensor
//     cores measured no faster: PERF.md).
//  2. slot products: d_xg from bf16(d_op) per slot, as the TPU kernel
//     forms it (128 slots x 64 outputs a block, mma.sync in ascending
//     depth from a zero accumulator); then dW_e = the
//     routing blocks' partials summed in order (csr_reduce_kernel).
//  3. dW_s (csr_bwd_v2_dws, after the caller's landing): the B3 kernel
//     sums bf16(d_op) at the senders over the batch's sender landing (s
//     [n_x, hp] f32), then x^T s in float32 (128 x 128 SIMT tiles over
//     fixed node chunks, the partials summed in order): the TPU kernel's
//     sum over slots of x[sender]^T bf16(d_op) up to float32 summation
//     order, over n_x nodes instead of the slots (slot-by-slot weight
//     partials took 2.8 ms a step: PERF.md).
// The times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_slot.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr int kRouteSlots = 256;         // slots per routing block
constexpr int kRouteThreads = 256;       // one slot a thread
constexpr int kFeat = 16;                // edge features per pass
constexpr int kChunk = 8;                // columns a thread forms at once
constexpr int kHalf = 32;                // columns per dW_e step
constexpr int kDopLd = kHalf + 4;        // staged d_op row stride
constexpr int kReduceGroups = 8;         // strided groups of the dW_e sum

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// The inputs of a thread's slot at 8 columns: y_s of its sender, inner_z
// and g_pass of its receiver (zero where the slot does not count).
struct ChunkIn {
    float4 y[2], in[2], g[2];
};

__device__ __forceinline__ void load_chunk(
    ChunkIn& r, const float* __restrict__ y_s,
    const float* __restrict__ inner_z, const float* __restrict__ g_pass,
    int sn, int rc, int h, int hp, int col) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        r.y[q] = sn >= 0 ? __ldg(reinterpret_cast<const float4*>(
                               y_s + static_cast<size_t>(sn) * hp + col +
                               q * 4))
                         : zero;
        // h is a multiple of 4: a float4 lies below h or past it
        const bool ok = rc >= 0 && col + q * 4 < h;
        const size_t node =
            static_cast<size_t>(ok ? rc : 0) * h + col + q * 4;
        r.in[q] = ok ? __ldg(reinterpret_cast<const float4*>(inner_z + node))
                     : zero;
        r.g[q] = ok ? __ldg(reinterpret_cast<const float4*>(g_pass + node))
                    : zero;
    }
}

__device__ __forceinline__ float at(const float4 (&v)[2], int j) {
    const float4& u = v[j >> 2];
    const int i = j & 3;
    return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__global__ void __launch_bounds__(kRouteThreads, 2) csr_route_kernel(
    const float* __restrict__ y_s,             // [n_x, hp]
    const float* __restrict__ e_t,             // [n_slots, de]
    const float* __restrict__ w_e,             // [de, h]
    const int32_t* __restrict__ senders,       // [n_slots]
    const int32_t* __restrict__ recv,          // [n_slots]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ inner_z,         // [num_nodes, h]
    const float* __restrict__ g_pass,          // [num_nodes, h]
    __nv_bfloat16* __restrict__ d_op,          // [n_slots, hp]
    float* __restrict__ d_e,                   // [n_slots, de]
    float* __restrict__ we_part,               // [blocks, dep, hp]
    int n_x, int de, int h, int hp, int num_nodes, int node_block,
    int edge_tile, int n_slots) {
    extern __shared__ __align__(16) float smem[];
    const int dep = (de + kFeat - 1) / kFeat * kFeat;
    const int lde = dep + 4;                   // +4: rows 16 bytes apart
    float* we_s = smem;                        // [dep][hp] W_e
    float* e_s = we_s + dep * hp;              // [256][lde] edge rows
    float* dop_s = e_s + kRouteSlots * lde;    // [256][kDopLd] d_op
    float* red = dop_s + kRouteSlots * kDopLd; // [8][kFeat * kHalf] dW_e
    const int t = threadIdx.x;
    const int slot0 = blockIdx.x * kRouteSlots;
    const int slot = slot0 + t;

    for (int i = t; i < dep * hp; i += kRouteThreads) {
        const int k = i / hp, c = i % hp;
        we_s[i] = k < de && c < h
                      ? __ldg(w_e + static_cast<size_t>(k) * h + c) : 0.0f;
    }
    const int q4 = dep / 4;
    for (int i = t; i < kRouteSlots * q4; i += kRouteThreads) {
        const int s = i / q4, c = (i % q4) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (slot0 + s < n_slots && c < de) {
            v = __ldg(reinterpret_cast<const float4*>(
                e_t + static_cast<size_t>(slot0 + s) * de + c));
        }
        *reinterpret_cast<float4*>(e_s + s * lde + c) = v;
    }
    // the thread's slot: its receiver (-1 where it does not count) and its
    // sender (-1 where its x part is 0; csr_slot.cuh)
    int rc = -1, sn = -1;
    if (slot < n_slots) {
        const CsrSlot S = csr_slot(
            __ldg(recv + slot), __ldg(senders + slot),
            __ldg(tile_blocks + slot / edge_tile) * node_block, node_block,
            num_nodes, n_x);
        rc = S.rc;
        sn = S.sn;
    }
    const float* e_row = e_s + t * lde;
    // dW_e: slot group sg (the warp) x feature group kg x column group cg
    const int cg = t & 7, kg = (t >> 3) & 3, sg = t >> 5;

    for (int k0 = 0; k0 < dep; k0 += kFeat) {
        float de_acc[kFeat];
#pragma unroll
        for (int f = 0; f < kFeat; ++f) de_acc[f] = 0.0f;
        ChunkIn cur;
        load_chunk(cur, y_s, inner_z, g_pass, sn, rc, h, hp, 0);
        __syncthreads();   // we_s and e_s are staged (first pass)
        for (int c0 = 0; c0 < hp; c0 += kHalf) {
#pragma unroll 1
            for (int cc = 0; cc < kHalf; cc += kChunk) {
                const int col = c0 + cc;
                // the next chunk's loads are in flight while this one
                // computes
                ChunkIn next;
                const int ncol = col + kChunk;
                if (ncol < hp) {
                    load_chunk(next, y_s, inner_z, g_pass, sn, rc, h, hp,
                               ncol);
                }
                // the edge chain, as the forward forms it
                float ep[kChunk];
#pragma unroll
                for (int j = 0; j < kChunk; ++j) ep[j] = 0.0f;
                for (int k = 0; k < de; k += 4) {
                    const float4 e4 =
                        *reinterpret_cast<const float4*>(e_row + k);
                    const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const float* wr = we_s + (k + kk) * hp + col;
                        const float4 w0 = *reinterpret_cast<const float4*>(wr);
                        const float4 w1 =
                            *reinterpret_cast<const float4*>(wr + 4);
                        const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                             w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                        for (int j = 0; j < kChunk; ++j) {
                            ep[j] = fmaf(ev[kk], wv[j], ep[j]);
                        }
                    }
                }
                float dop[kChunk];
#pragma unroll
                for (int j = 0; j < kChunk; ++j) {
                    const float op = csr_op(at(cur.y, j), ep[j]);
                    dop[j] = rc >= 0 && col + j < h &&
                                     routes(op, at(cur.in, j))
                                 ? at(cur.g, j)
                                 : 0.0f;
                }
                float* ds = dop_s + t * kDopLd + cc;
                *reinterpret_cast<float4*>(ds) =
                    make_float4(dop[0], dop[1], dop[2], dop[3]);
                *reinterpret_cast<float4*>(ds + 4) =
                    make_float4(dop[4], dop[5], dop[6], dop[7]);
                // d_e: feature k0 + f, the columns in order
#pragma unroll
                for (int f = 0; f < kFeat; ++f) {
                    const float* wr = we_s + (k0 + f) * hp + col;
                    const float4 w0 = *reinterpret_cast<const float4*>(wr);
                    const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
                    const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                         w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                    for (int j = 0; j < kChunk; ++j) {
                        de_acc[f] = fmaf(dop[j], wv[j], de_acc[f]);
                    }
                }
                if (ncol < hp) cur = next;
            }
            __syncthreads();   // the 32 columns' d_op are staged

            // bf16(d_op) for the sender side, 16 bytes a store
            if (k0 == 0) {
                for (int i = t; i < kRouteSlots * kHalf / 8;
                     i += kRouteThreads) {
                    const int s = i / (kHalf / 8), q = (i % (kHalf / 8)) * 8;
                    if (slot0 + s >= n_slots) continue;
                    const float* ds = dop_s + s * kDopLd + q;
                    const float4 a = *reinterpret_cast<const float4*>(ds);
                    const float4 b = *reinterpret_cast<const float4*>(ds + 4);
                    *reinterpret_cast<uint4*>(
                        d_op + static_cast<size_t>(slot0 + s) * hp + c0 + q) =
                        make_uint4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w),
                                   bf16_pair(b.x, b.y), bf16_pair(b.z, b.w));
                }
            }
            // dW_e partials: features k0 + 4 kg .. + 3 x columns c0 + 4 cg
            // .. + 3 over the 32 slots of group sg, in slot order
            {
                float acc[4][4];
#pragma unroll
                for (int f = 0; f < 4; ++f)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[f][j] = 0.0f;
                for (int s = sg * 32; s < sg * 32 + 32; ++s) {
                    const float4 e4 = *reinterpret_cast<const float4*>(
                        e_s + s * lde + k0 + kg * 4);
                    const float4 d4 = *reinterpret_cast<const float4*>(
                        dop_s + s * kDopLd + cg * 4);
                    const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
                    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
                    for (int f = 0; f < 4; ++f)
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[f][j] = fmaf(ev[f], dv[j], acc[f][j]);
                }
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    *reinterpret_cast<float4*>(
                        red + sg * kFeat * kHalf + (kg * 4 + f) * kHalf +
                        cg * 4) =
                        make_float4(acc[f][0], acc[f][1], acc[f][2],
                                    acc[f][3]);
                }
            }
            __syncthreads();   // the slot groups' partials are staged
            for (int o = t; o < kFeat * kHalf; o += kRouteThreads) {
                float sum = 0.0f;
#pragma unroll
                for (int g = 0; g < kRouteThreads / 32; ++g) {
                    sum += red[g * kFeat * kHalf + o];
                }
                we_part[(static_cast<size_t>(blockIdx.x) * dep + k0 +
                         o / kHalf) * hp + c0 + o % kHalf] = sum;
            }
            // dop_s and red are rewritten after the next 32 columns' first
            // barrier
        }
        if (slot < n_slots) {
#pragma unroll
            for (int f = 0; f < kFeat; ++f) {
                if (k0 + f < de) {
                    d_e[static_cast<size_t>(slot) * de + k0 + f] = de_acc[f];
                }
            }
        }
    }
}

// ldmatrix .x4 (not transposed): four 8x8 b16 matrices from shared memory;
// lane t gives the address of row t % 8 of matrix t / 8, and r[i] receives
// matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

constexpr int kSpRows = 128;             // slots per slot-products block
constexpr int kSpDepth = 64;             // depth chunk (columns of d_op)
constexpr int kSpStages = 3;             // cp.async ring
constexpr int kSpLd = kSpDepth + 8;      // staged row stride (bf16)
constexpr int kSpThreads = 128;          // 4 warps of 32 slots x 64 outputs

// Shared memory of the slot products, in bytes.
constexpr size_t kSpSmem = sizeof(__nv_bfloat16) * kSpStages *
                           (kSpRows + kBlockCols) * kSpLd;

// d_xg[s][n] = bf16(sum over k of d_op[s][k] W_s[n][k]) for one block of
// 128 slots x 64 outputs: mma.sync m16n8k16 in ascending depth from a zero
// accumulator, fragments by ldmatrix and a three-stage
// cp.async ring. The output tile is the fast grid axis, so the 64-output
// tiles of a slot block run side by side and read its d_op rows from
// device memory once.
__global__ void __launch_bounds__(kSpThreads) csr_slot_products_kernel(
    const __nv_bfloat16* __restrict__ d_op,    // [n_slots, hp]
    const __nv_bfloat16* __restrict__ w_s,     // [d, h]
    __nv_bfloat16* __restrict__ d_xg,          // [n_slots, d]
    int n_slots, int d, int h, int hp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    auto* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* b_s = a_s + kSpStages * kSpRows * kSpLd;
    const int n0 = blockIdx.x * kBlockCols;
    const int slot0 = blockIdx.y * kSpRows;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m0 = (tid >> 5) * 32;
    const int g = lane >> 2, tq = lane & 3;
    const int chunks = hp / kSpDepth;

    auto issue = [&](int c, int buf) {
        const int k0 = c * kSpDepth;
        __nv_bfloat16* as = a_s + buf * kSpRows * kSpLd;
        __nv_bfloat16* bs = b_s + buf * kBlockCols * kSpLd;
        for (int i = tid; i < kSpRows * (kSpDepth / 8); i += kSpThreads) {
            const int r = i / (kSpDepth / 8), q = (i % (kSpDepth / 8)) * 8;
            const bool ok = slot0 + r < n_slots;
            cp_async16(as + r * kSpLd + q,
                       ok ? d_op + static_cast<size_t>(slot0 + r) * hp + k0
                                + q
                          : d_op,
                       ok);
        }
        for (int i = tid; i < kBlockCols * (kSpDepth / 8); i += kSpThreads) {
            const int n = i / (kSpDepth / 8), q = (i % (kSpDepth / 8)) * 8;
            // h is a multiple of 8: an 8-wide run lies below h or past it
            const bool ok = n0 + n < d && k0 + q < h;
            cp_async16(bs + n * kSpLd + q,
                       ok ? w_s + static_cast<size_t>(n0 + n) * h + k0 + q
                          : w_s,
                       ok);
        }
    };

    float acc[2][kColTiles][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][nt][q] = 0.0f;

#pragma unroll
    for (int c = 0; c < kSpStages - 1; ++c) {
        if (c < chunks) issue(c, c);
        cp_async_commit();
    }
    // lane t addresses row t % 8 of 8x8 matrix t / 8
    const int mrow = lane & 7, mat = lane >> 3;
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kSpStages - 2>();
        __syncthreads();       // chunk c is in; chunk c - 1's buffer is free
        if (c + kSpStages - 1 < chunks) {
            issue(c + kSpStages - 1, (c + kSpStages - 1) % kSpStages);
        }
        cp_async_commit();
        const int buf = c % kSpStages;
        const __nv_bfloat16* as = a_s + buf * kSpRows * kSpLd;
        const __nv_bfloat16* bs = b_s + buf * kBlockCols * kSpLd;
#pragma unroll
        for (int k0 = 0; k0 < kSpDepth; k0 += 16) {
            // A (16 slots x 16 depths): matrices (m+0, k+0) (m+8, k+0)
            // (m+0, k+8) (m+8, k+8) are the fragment's a0..a3
            uint32_t a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                ldmatrix_x4(a[mi], as + (m0 + mi * 16 + (mat & 1) * 8 + mrow)
                                        * kSpLd + k0 + (mat >> 1) * 8);
            }
#pragma unroll
            for (int nt = 0; nt < kColTiles; nt += 2) {
                // B for output tiles nt and nt+1 from W_s's rows: matrices
                // (nt, k+0) (nt, k+8) (nt+1, k+0) (nt+1, k+8)
                uint32_t b[4];
                ldmatrix_x4(b, bs + ((nt + (mat >> 1)) * 8 + mrow) * kSpLd
                                   + k0 + (mat & 1) * 8);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    mma_bf16_16816(acc[mi][nt], a[mi], b);
                    mma_bf16_16816(acc[mi][nt + 1], a[mi], b + 2);
                }
            }
        }
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int slot = slot0 + m0 + mi * 16 + g + half * 8;
                const int n = n0 + nt * 8 + tq * 2;
                if (slot < n_slots && n < d) {
                    *reinterpret_cast<__nv_bfloat162*>(
                        d_xg + static_cast<size_t>(slot) * d + n) =
                        __floats2bfloat162_rn(acc[mi][nt][half * 2],
                                              acc[mi][nt][half * 2 + 1]);
                }
            }
}

constexpr int kGemmTile = 128;           // dW_s tile: 128 x 128 outputs
constexpr int kGemmDepth = 8;            // nodes per depth chunk
constexpr int kGemmThreads = 256;        // an 8 x 8 micro-tile a thread
constexpr int kGemmLd = kGemmTile + 4;

// partial[p][m][n] = sum over the nodes of chunk p of x[node][m] s[node][n]
// (x bf16 [n_x, d], s float32 [n_x, hp]: the sender sums of bf16(d_op)),
// in float32 on the CUDA cores: a 128 x 128 tile a block, rows 8 ty .. 8
// ty + 7 and columns 4 tx .. 4 tx + 3, 64 + 4 tx .. 64 + 4 tx + 3 a
// thread, the nodes in ascending depth chunks of 8 (one fma chain an
// output), double-buffered through registers.
__global__ void __launch_bounds__(kGemmThreads) csr_dws_partials_kernel(
    const __nv_bfloat16* __restrict__ x,       // [n_x, d]
    const float* __restrict__ s,               // [n_x, hp]
    float* __restrict__ partial,               // [P, d, hp]
    int n_x, int d, int hp, int chunk) {
    __shared__ __align__(16) float a_s[2][kGemmDepth][kGemmLd];
    __shared__ __align__(16) float b_s[2][kGemmDepth][kGemmLd];
    const int n0 = blockIdx.x * kGemmTile;
    const int m0 = blockIdx.y * kGemmTile;
    const int node0 = blockIdx.z * chunk;
    const int node_end = min(node0 + chunk, n_x);
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    // the thread's share of a chunk: node k, 4 values at column q
    const int k = tid >> 5, q = (tid & 31) * 4;

    auto load = [&](int nd, float4& av, float4& bv) {
        const int node = nd + k;
        av = bv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (node >= node_end) return;
        if (m0 + q < d) {            // d is a multiple of 8
            const uint2 raw = *reinterpret_cast<const uint2*>(
                x + static_cast<size_t>(node) * d + m0 + q);
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
            av = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
        if (n0 + q < hp) {
            bv = __ldg(reinterpret_cast<const float4*>(
                s + static_cast<size_t>(node) * hp + n0 + q));
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    float4 av, bv;
    load(node0, av, bv);
    *reinterpret_cast<float4*>(&a_s[0][k][q]) = av;
    *reinterpret_cast<float4*>(&b_s[0][k][q]) = bv;
    __syncthreads();
    for (int nd = node0, buf = 0; nd < node_end;
         nd += kGemmDepth, buf ^= 1) {
        const bool more = nd + kGemmDepth < node_end;
        if (more) load(nd + kGemmDepth, av, bv);
#pragma unroll
        for (int kk = 0; kk < kGemmDepth; ++kk) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * 8]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * 8 + 4]);
            const float4 b0 =
                *reinterpret_cast<const float4*>(&b_s[buf][kk][tx * 4]);
            const float4 b1 =
                *reinterpret_cast<const float4*>(&b_s[buf][kk][64 + tx * 4]);
            const float am[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bn[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
        }
        if (more) {
            *reinterpret_cast<float4*>(&a_s[buf ^ 1][k][q]) = av;
            *reinterpret_cast<float4*>(&b_s[buf ^ 1][k][q]) = bv;
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + ty * 8 + i;
        if (m >= d) continue;
        float* row = partial + (static_cast<size_t>(blockIdx.z) * d + m) * hp;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int n = n0 + half * 64 + tx * 4;
            if (n < hp) {
                *reinterpret_cast<float4*>(row + n) = make_float4(
                    acc[i][half * 4], acc[i][half * 4 + 1],
                    acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
            }
        }
    }
}

// dW[k][n] = the partials [n_part, rows_p, hp] summed in order of the
// partial, for k < rows and n < h: thread group g of a block sums
// partials g, g + 8, ... of its output, then the groups are summed in
// order. It sums the routing blocks' dW_e partials and the node chunks'
// dW_s partials.
__global__ void __launch_bounds__(256) csr_reduce_kernel(
    const float* __restrict__ part, int n_part, int rows, int rows_p, int h,
    int hp, float* __restrict__ dw) {
    __shared__ float sums[kReduceGroups][32];
    const int c = threadIdx.x & 31, grp = threadIdx.x >> 5;
    const int j = blockIdx.x * 32 + c;         // output k * h + n
    const bool ok = j < rows * h;
    const int k = ok ? j / h : 0, n = ok ? j % h : 0;
    float s = 0.0f;
    if (ok) {
        for (int p = grp; p < n_part; p += kReduceGroups) {
            s += part[(static_cast<size_t>(p) * rows_p + k) * hp + n];
        }
    }
    sums[grp][c] = s;
    __syncthreads();
    if (grp == 0 && ok) {
        float t = 0.0f;
#pragma unroll
        for (int g = 0; g < kReduceGroups; ++g) t += sums[g][c];
        dw[j] = t;
    }
}

}  // namespace

extern "C" {

// Shared memory the routing pass needs for edge width de and width h, in
// bytes.
size_t csr_bwd_v2_smem_bytes(int de, int h) {
    const size_t dep = (de + kFeat - 1) / kFeat * kFeat;
    const size_t hp = (h + kBlockCols - 1) / kBlockCols * kBlockCols;
    return sizeof(float) * (dep * hp + kRouteSlots * (dep + 4) +
                            kRouteSlots * kDopLd +
                            kRouteThreads / 32 * kFeat * kHalf);
}

// Floats of the routing pass's dW_e partials we_part for these shapes.
size_t csr_bwd_v2_we_part_floats(int n_slots, int de, int hp) {
    const size_t blocks = (n_slots + kRouteSlots - 1) / kRouteSlots;
    const size_t dep = (de + kFeat - 1) / kFeat * kFeat;
    return blocks * dep * hp;
}

// Launches the routing pass, the slot products and the dW_e reduce on
// `stream`; returns the first cudaError_t. y_s [n_x, hp] f32 is the
// projection x @ W_s (dense_proj_v4), hp = h rounded up to 64; d_op
// [n_slots, hp] bf16 is written for the caller too (its sender sums make
// dW_s: csr_bwd_v2_dws). Scratch: we_part (csr_bwd_v2_we_part_floats) f32.
// The caller checks shapes, types and alignment (as for csr_fwd_v2; h a
// multiple of 8, de a multiple of 4).
int csr_bwd_v2(const void* y_s, const void* w_s, const void* e_t,
               const void* w_e, const void* senders, const void* recv,
               const void* tile_blocks, const void* inner_z,
               const void* g_pass, void* d_op, void* we_part, void* d_xg,
               void* d_e, void* dw_e, int n_x, int d, int de, int h,
               int num_nodes, int node_block, int edge_tile, int n_slots,
               void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int hp = (h + kBlockCols - 1) / kBlockCols * kBlockCols;
    const int dep = (de + kFeat - 1) / kFeat * kFeat;
    const int blocks = (n_slots + kRouteSlots - 1) / kRouteSlots;
    const auto* snd = static_cast<const int32_t*>(senders);
    auto* dop = static_cast<__nv_bfloat16*>(d_op);
    auto* wep = static_cast<float*>(we_part);

    const size_t smem = csr_bwd_v2_smem_bytes(de, h);
    cudaError_t err = cudaFuncSetAttribute(
        csr_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // all of the SM's shared memory, so that two ~107 KB blocks fit
    err = cudaFuncSetAttribute(csr_route_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0) {
        csr_route_kernel<<<blocks, kRouteThreads, smem, st>>>(
            static_cast<const float*>(y_s), static_cast<const float*>(e_t),
            static_cast<const float*>(w_e), snd,
            static_cast<const int32_t*>(recv),
            static_cast<const int32_t*>(tile_blocks),
            static_cast<const float*>(inner_z),
            static_cast<const float*>(g_pass), dop,
            static_cast<float*>(d_e), wep, n_x, de, h, hp, num_nodes,
            node_block, edge_tile, n_slots);
        if ((err = cudaGetLastError()) != cudaSuccess) {
            return static_cast<int>(err);
        }
    }

    // d_xg from bf16(d_op)
    const auto* wsb = static_cast<const __nv_bfloat16*>(w_s);
    err = cudaFuncSetAttribute(csr_slot_products_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSpSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_slots > 0) {
        csr_slot_products_kernel<<<
            dim3((d + kBlockCols - 1) / kBlockCols,
                 (n_slots + kSpRows - 1) / kSpRows),
            kSpThreads, kSpSmem, st>>>(dop, wsb,
                                       static_cast<__nv_bfloat16*>(d_xg),
                                       n_slots, d, h, hp);
        if ((err = cudaGetLastError()) != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    const int n_out = de * h;
    csr_reduce_kernel<<<(n_out + 31) / 32, 256, 0, st>>>(
        wep, blocks, de, dep, h, hp, static_cast<float*>(dw_e));
    return static_cast<int>(cudaGetLastError());
}

// Chunks of nodes the dW_s partials cover (a multiple of the 8-node step).
int csr_bwd_v2_dws_chunk(int n_x, int n_part) {
    const int per = (n_x + n_part - 1) / n_part;
    return (per + kGemmDepth - 1) / kGemmDepth * kGemmDepth;
}

// dW_s [d, h] = x^T s in float32, from the sender sums s [n_x, hp] of
// bf16(d_op) (the landing of csr_bwd_v2's d_op): n_part partials over
// fixed chunks of nodes (scratch partial [n_part, d, hp]), then their sum
// in order (csr_reduce_kernel). Returns the first
// cudaError_t.
int csr_bwd_v2_dws(const void* x, const void* s, void* partial, void* dw_s,
                   int n_x, int d, int h, int n_part, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int hp = (h + kBlockCols - 1) / kBlockCols * kBlockCols;
    const dim3 grid((hp + kGemmTile - 1) / kGemmTile,
                    (d + kGemmTile - 1) / kGemmTile, n_part);
    csr_dws_partials_kernel<<<grid, kGemmThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(s),
        static_cast<float*>(partial), n_x, d, hp,
        csr_bwd_v2_dws_chunk(n_x, n_part));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_reduce_kernel<<<(d * h + 31) / 32, 256, 0, st>>>(
        static_cast<const float*>(partial), n_part, d, d, h, hp,
        static_cast<float*>(dw_s));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
