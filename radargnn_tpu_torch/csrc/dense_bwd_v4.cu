// Dense fixed-degree hoisted max aggregation, backward: the bits-routed
// sender-sum backward.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _fused_bwd_kernel_v4 (reached through _fused_bwd_call_v4 and the custom
// VJP of make_fused_dense_aggregate) on Hopper (sm_90a), in the form of
// its `sender_dx` variant.
//
// What it computes (slot layout in dense_gather.cuh; g_pass is [T*R, hg]
// f32, 0 at empty receivers, hg = H rounded up to 8; bits come from the
// forward's VJP mode, dense_fwd_v4.cu):
//   d_op[slot] = bf16(g_pass[recv(slot)]) where the slot's bit is set,
//                else 0 (every tied slot takes the full g)
//   d_e[slot]  = bf16(d_op[slot] @ W_e^T)                  [T*TE, de]
//   dW_e       = sum over slots of e_t[slot]^T d_op[slot]  [de, hg] f32
//   d_ys[s]    = sum of d_op over the slots the landing lists for sender s
//                                                          [N, hg] f32
//   d_yo[s]    = sum of its overflow rows d_op_o (f32)     [N, hg] f32
// The caller forms d_x = bf16(d_ys) @ W_s^T + d_yo @ W_s^T and dW_s =
// bf16(x)^T bf16(d_ys) + x^T d_yo as node-wide products: the JAX package's
// sender_dx wrapper rounds the slots' sums to bf16 and keeps the overflow
// part in float32.
//
// Design: four launches on one stream, no atomics and fixed summation
// orders, so two runs on the same inputs are bitwise equal.
//  1. de_pass: one block per tile. The tile's R rows of g, rounded to
//     bf16, sit in shared memory; each warp owns 16 receivers, i.e. 16
//     slots, of every second slot row. d_op fragments are built in
//     registers from those rows and the slots' bits (a masked bf16 pair per
//     register), and d_e = d_op @ W_e^T runs on mma.sync (the W_e
//     fragments read through the read-only cache).
//  1b. dwe_pass: one block per (tile, 64-column chunk), the chunk of the
//     g rows in shared memory: dW_e = e^T @ d_op, summed over the slot rows
//     in registers, then over the warps in order into one partial per tile.
//  2. send_pass: one warp per sender walks the batch's sender-sorted
//     landing order (SenderLanding: order, row_ptr); each lane owns 8
//     columns, rebuilds a slot row's d_op from its byte of bits and
//     g_pass[recv] (loaded only where a bit is set; ~1 column in 20
//     routes), adds an overflow row as it lies to a second sum, and keeps
//     both in registers. d_op [E_pad, H] (~314 MB per wide layer) is never
//     written.
//  3. reduce_pass: dW_e = the per-tile partials summed in tile order.
//
// What bounds it on the card. The function needs d_x and dW_s as
// node-wide products (4 N d H flops) and d_e, dW_e once per valid slot
// (4 valid d_e H), ~13.8 GFLOP at the flagship's wide layer (14 us at the
// bf16 peak), against the bits (21.6 MB), e_t, the landing, g, d_e, d_x,
// the weights (~94 MB; ~28 us at 3.35 TB/s): it is bound by bytes. The TPU
// kernel recomputes the forward's op and multiplies per slot (three
// products of ~75 GFLOP per wide layer); here the routing is a bit test
// and the sender sums are adds, so what remains is the passes' L2 traffic
// (g rows re-read per routed byte) and the bit unpacking. The times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace radargnn;

constexpr int kRedCols = kBlockCols;     // dW_e chunk width (columns)

// Keeps the bf16 of a pair (low half: the even column) whose bit in
// `word` at `bit` / `bit + 1` is set, zeroes the other.
__device__ __forceinline__ uint32_t mask_pair(uint32_t pair, uint32_t word,
                                              int bit) {
    const uint32_t two = (word >> bit) & 3u;
    return pair & (((two & 1u) ? 0x0000FFFFu : 0u) |
                   ((two & 2u) ? 0xFFFF0000u : 0u));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The tile's R rows of g over columns [c0, c0 + width), rounded to bf16
// (d_op's values), zero past hg, into gs (row stride ld).
__device__ __forceinline__ void stage_g_rows(
    const float* __restrict__ g_pass, __nv_bfloat16* gs, int ld, int t,
    int r_tile, int hg, int c0, int width) {
    for (int i = threadIdx.x; i < r_tile * (width / 4); i += blockDim.x) {
        const int r = i / (width / 4), c = (i % (width / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c < hg) {
            v = *reinterpret_cast<const float4*>(
                g_pass + (static_cast<size_t>(t) * r_tile + r) * hg + c0 +
                c);
        }
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(gs + r * ld + c);
        dst[0] = __floats2bfloat162_rn(v.x, v.y);
        dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
}

// d_e of one tile (blockIdx.x). Warp w owns the 16 receivers of row group
// w % (R/16), i.e. 16 slots of each slot row, and every second slot row
// (j = w / (R/16), +2, ...): per slot row and 16-feature chunk, over hp in
// k-steps of 16 columns, A = d_op built from the g rows in shared memory
// and the slots' bits (16 words per slot loaded together ahead of use),
// B = W_e through the read-only cache.
constexpr int kDeWords = 16;             // bit words of a slot in flight

__global__ void __launch_bounds__(512) de_pass_kernel(
    const uint32_t* __restrict__ bits,         // [T*TE, hp/32]
    const float* __restrict__ g_pass,          // [T*R, hg]
    const __nv_bfloat16* __restrict__ w_e,     // [de, hg]
    __nv_bfloat16* __restrict__ d_e,           // [T*TE, de]
    int de, int hg, int hp, int r_tile, int k) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = hp + 8;                     // gs row stride (bf16)
    auto* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [r][ld]
    const int t = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int groups = r_tile / 16;
    const int m0 = (warp % groups) * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int words = hp / 32;
    const size_t tile_slot0 = static_cast<size_t>(t) * r_tile * k;
    stage_g_rows(g_pass, gs, ld, t, r_tile, hg, 0, hp);
    __syncthreads();

    const __nv_bfloat16* g0 = gs + (m0 + g) * ld;
    const __nv_bfloat16* g8 = gs + (m0 + g + 8) * ld;
    for (int j = warp / groups; j < k; j += 2) {
        const size_t slot_a = tile_slot0 + static_cast<size_t>(j) * r_tile +
                              m0 + g;
        const uint32_t* ba = bits + slot_a * words;
        const uint32_t* bb = bits + (slot_a + 8) * words;
        for (int f0 = 0; f0 < de; f0 += 16) {
            float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            for (int w0 = 0; w0 < words; w0 += kDeWords) {
                // words is even: 8-byte loads, all issued before use
                uint2 wa[kDeWords / 2], wb[kDeWords / 2];
#pragma unroll
                for (int i = 0; i < kDeWords / 2; ++i) {
                    const bool ok = w0 + 2 * i < words;
                    wa[i] = ok ? __ldg(reinterpret_cast<const uint2*>(
                                     ba + w0) + i) : make_uint2(0u, 0u);
                    wb[i] = ok ? __ldg(reinterpret_cast<const uint2*>(
                                     bb + w0) + i) : make_uint2(0u, 0u);
                }
#pragma unroll
                for (int wi = 0; wi < kDeWords; ++wi) {
                    if (w0 + wi >= words) break;
                    const uint32_t xa = (wi & 1) ? wa[wi / 2].y : wa[wi / 2].x;
                    const uint32_t xb = (wi & 1) ? wb[wi / 2].y : wb[wi / 2].x;
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int col = (w0 + wi) * 32 + half * 16 + tq * 2;
                        const int bit = half * 16 + tq * 2;
                        uint32_t a[4] = {
                            mask_pair(ld_pair(g0 + col), xa, bit),
                            mask_pair(ld_pair(g8 + col), xb, bit),
                            mask_pair(ld_pair(g0 + col + 8), xa, bit + 8),
                            mask_pair(ld_pair(g8 + col + 8), xb, bit + 8)};
#pragma unroll
                        for (int nn = 0; nn < 2; ++nn) {
                            const int f = f0 + nn * 8 + g;
                            uint32_t b[2] = {0u, 0u};
                            if (f < de) {
                                const uint32_t* wr = reinterpret_cast<
                                    const uint32_t*>(
                                        w_e + static_cast<size_t>(f) * hg);
                                if (col < hg) b[0] = __ldg(wr + col / 2);
                                if (col + 8 < hg) {
                                    b[1] = __ldg(wr + col / 2 + 4);
                                }
                            }
                            mma_bf16_16816(acc[nn], a, b);
                        }
                    }
                }
            }
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int f = f0 + nn * 8 + tq * 2;
                    if (f >= de) continue;
                    const size_t slot = slot_a + half * 8;
                    *reinterpret_cast<__nv_bfloat162*>(
                        d_e + slot * de + f) = __floats2bfloat162_rn(
                            acc[nn][half * 2], acc[nn][half * 2 + 1]);
                }
            }
        }
    }
}

// dW_e's partial of one tile (blockIdx.x) over one 64-column chunk
// (blockIdx.y): per 16-feature chunk, each warp sums e^T (16 features x
// its 16 slots) @ d_op (16 slots x 64 columns) over the slot rows, then
// the warps' sums are added in order.
__global__ void __launch_bounds__(256) dwe_pass_kernel(
    const uint32_t* __restrict__ bits,         // [T*TE, hp/32]
    const float* __restrict__ g_pass,          // [T*R, hg]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    float* __restrict__ we_part,               // [T, de16, hp]
    int de, int hg, int hp, int r_tile, int k) {
    constexpr int ld = kRedCols + 8;           // gs row stride (bf16)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    auto* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [r][ld]
    float* red = reinterpret_cast<float*>(gs + r_tile * ld);
    const int t = blockIdx.x;
    const int c0 = blockIdx.y * kRedCols;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nwarps = blockDim.x >> 5;
    const int m0 = warp * 16;
    const int g = lane >> 2, tq = lane & 3;
    const int words = hp / 32;
    const int de16 = (de + 15) & ~15;
    const size_t tile_slot0 = static_cast<size_t>(t) * r_tile * k;
    stage_g_rows(g_pass, gs, ld, t, r_tile, hg, c0, kRedCols);
    __syncthreads();

    for (int f0 = 0; f0 < de16; f0 += 16) {
        float acc[kColTiles][4];
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
        for (int j = 0; j < k; ++j) {
            const size_t slot0 = tile_slot0 +
                static_cast<size_t>(j) * r_tile + m0;
            // A = e^T: rows features f0+g, f0+g+8; columns slots tq*2,
            // tq*2+1 (a0, a1) and tq*2+8, tq*2+9 (a2, a3)
            __nv_bfloat16 ev[4][2];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                const size_t slot = slot0 + (s >> 1) * 8 + tq * 2 + (s & 1);
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int f = f0 + g + hf * 8;
                    ev[s][hf] = f < de ? e_t[slot * de + f]
                                       : __float2bfloat16(0.0f);
                }
            }
            const uint32_t a[4] = {pack_bf16(ev[0][0], ev[1][0]),
                                   pack_bf16(ev[0][1], ev[1][1]),
                                   pack_bf16(ev[2][0], ev[3][0]),
                                   pack_bf16(ev[2][1], ev[3][1])};
            // the bits of the slots tq*2, tq*2+1, tq*2+8, tq*2+9 over the
            // chunk's 64 columns
            uint2 wv[4];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                const size_t slot = slot0 + (s >> 1) * 8 + tq * 2 + (s & 1);
                wv[s] = __ldg(reinterpret_cast<const uint2*>(
                    bits + slot * words + c0 / 32));
            }
            // B = d_op: rows the slots above, column c0 + nt*8 + g
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                const int col = nt * 8 + g;
                const int bit = (nt & 3) * 8 + g;
                __nv_bfloat16 v[4];
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    const int row = m0 + (s >> 1) * 8 + tq * 2 + (s & 1);
                    const uint32_t w = (nt >> 2) ? wv[s].y : wv[s].x;
                    v[s] = ((w >> bit) & 1u) ? gs[row * ld + col]
                                             : __float2bfloat16(0.0f);
                }
                const uint32_t b[2] = {pack_bf16(v[0], v[1]),
                                       pack_bf16(v[2], v[3])};
                mma_bf16_16816(acc[nt], a, b);
            }
        }
        // acc[nt][q]: feature f0 + g + (q >> 1) * 8, column
        // c0 + nt*8 + tq*2 + (q & 1)
        float* mine = red + warp * 16 * kRedCols;
#pragma unroll
        for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                mine[(g + (q >> 1) * 8) * kRedCols + nt * 8 + tq * 2 +
                     (q & 1)] = acc[nt][q];
            }
        }
        __syncthreads();
        for (int i = tid; i < 16 * kRedCols; i += blockDim.x) {
            float s = 0.0f;
            for (int w = 0; w < nwarps; ++w) {
                s += red[w * 16 * kRedCols + i];
            }
            const int m = i / kRedCols, n = i % kRedCols;
            we_part[(static_cast<size_t>(t) * de16 + f0 + m) * hp + c0 + n] =
                s;
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void add_f32x8(float* acc, const float* src) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    const float4 w = *reinterpret_cast<const float4*>(src + 4);
    acc[0] += u.x; acc[1] += u.y; acc[2] += u.z; acc[3] += u.w;
    acc[4] += w.x; acc[5] += w.y; acc[6] += w.z; acc[7] += w.w;
}

__device__ __forceinline__ void store_f32x8(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[b] += bf16(src[b]) where bit b of `byte` is set (d_op's rounding)
__device__ __forceinline__ void add_routed8(float* acc, const float* src,
                                            uint32_t byte) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    const float4 w = *reinterpret_cast<const float4*>(src + 4);
    const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
#pragma unroll
    for (int b = 0; b < 8; ++b) {
        if ((byte >> b) & 1u) {
            acc[b] += __bfloat162float(__float2bfloat16_rn(v[b]));
        }
    }
}

__global__ void __launch_bounds__(256) send_pass_kernel(
    const uint32_t* __restrict__ bits,         // [n_slots, hp/32]
    const float* __restrict__ g_pass,          // [N, hg]
    const float* __restrict__ d_op_o,          // [Eo, hg]
    const int32_t* __restrict__ order,         // [M]
    const int32_t* __restrict__ row_ptr,       // [N + 1]
    float* __restrict__ d_ys,                  // [N, hg]
    float* __restrict__ d_yo,                  // [N, hg]
    long long n_slots, int n_seg, int hg, int words, int te, int r_tile) {
    const int seg = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (seg >= n_seg) return;
    const int begin = row_ptr[seg], end = row_ptr[seg + 1];
    for (int c = lane; c < hg / 8; c += 32) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float acc_o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int e = begin; e < end; ++e) {
            const long long i = order[e];
            if (i < n_slots) {
                const uint32_t byte =
                    (__ldg(bits + i * words + c / 4) >> ((c & 3) * 8)) & 0xFFu;
                if (byte != 0u) {
                    const long long recv = i / te * r_tile + i % r_tile;
                    add_routed8(acc, g_pass + recv * hg + c * 8, byte);
                }
            } else {
                add_f32x8(acc_o, d_op_o + (i - n_slots) * hg + c * 8);
            }
        }
        const size_t at = static_cast<size_t>(seg) * hg + c * 8;
        store_f32x8(d_ys + at, acc);
        store_f32x8(d_yo + at, acc_o);
    }
}

// dW_e = the per-tile partials summed in order of the tile
__global__ void reduce_pass_kernel(const float* __restrict__ we_part,
                                   int num_tiles, int de, int de16, int hg,
                                   int hp, float* __restrict__ dw_e) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= de * hg) return;
    const int m = i / hg, n = i % hg;
    float s = 0.0f;
    for (int t = 0; t < num_tiles; ++t) {
        s += we_part[(static_cast<size_t>(t) * de16 + m) * hp + n];
    }
    dw_e[i] = s;
}

}  // namespace

extern "C" {

// Shared memory the receiver passes need for these shapes, in bytes (the
// larger, d_e's: the tile's g rows over all columns).
size_t dense_bwd_v4_smem_bytes(int hp, int r_tile) {
    return sizeof(__nv_bfloat16) * static_cast<size_t>(r_tile) * (hp + 8);
}

// Launches the four passes on `stream`; returns the first cudaError_t.
// Scratch: we_part [T, de16, hp] f32 (de16 = de rounded up to 16). The
// caller checks shapes, types and alignment: de and hg multiples of 8,
// hp = H rounded up to 64, r_tile a multiple of 16 and at most 128.
int dense_bwd_v4(const void* bits, const void* g_pass, const void* e_t,
                 const void* w_e, const void* d_op_o, const void* order,
                 const void* row_ptr, void* d_e, void* we_part, void* dw_e,
                 void* d_ys, void* d_yo, long long n_slots, int num_tiles,
                 int r_tile, int k, int de, int hg, int hp, int n_seg,
                 void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* b = static_cast<const uint32_t*>(bits);
    const auto* g = static_cast<const float*>(g_pass);
    const int de16 = (de + 15) & ~15;
    const int threads = (r_tile / 16) * 32;
    const size_t smem_de = dense_bwd_v4_smem_bytes(hp, r_tile);
    const size_t smem_dwe =
        sizeof(__nv_bfloat16) * static_cast<size_t>(r_tile) *
            (kRedCols + 8) +
        sizeof(float) * static_cast<size_t>(r_tile / 16) * 16 * kRedCols;
    cudaError_t err = cudaFuncSetAttribute(
        de_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_de));
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            dwe_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_dwe));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (num_tiles > 0) {
        de_pass_kernel<<<num_tiles, 2 * threads, smem_de, st>>>(
            b, g, static_cast<const __nv_bfloat16*>(w_e),
            static_cast<__nv_bfloat16*>(d_e), de, hg, hp, r_tile, k);
        if ((err = cudaGetLastError()) != cudaSuccess) {
            return static_cast<int>(err);
        }
        dwe_pass_kernel<<<dim3(num_tiles, hp / kRedCols), threads, smem_dwe,
                          st>>>(
            b, g, static_cast<const __nv_bfloat16*>(e_t),
            static_cast<float*>(we_part), de, hg, hp, r_tile, k);
        if ((err = cudaGetLastError()) != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    const int warps_per_block = 8;
    const int blocks = (n_seg + warps_per_block - 1) / warps_per_block;
    if (blocks > 0) {
        send_pass_kernel<<<blocks, warps_per_block * 32, 0, st>>>(
            b, g, static_cast<const float*>(d_op_o),
            static_cast<const int32_t*>(order),
            static_cast<const int32_t*>(row_ptr), static_cast<float*>(d_ys),
            static_cast<float*>(d_yo), n_slots, n_seg, hg, hp / 32,
            r_tile * k, r_tile);
        if ((err = cudaGetLastError()) != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    if (de * hg > 0) {
        reduce_pass_kernel<<<(de * hg + 255) / 256, 256, 0, st>>>(
            static_cast<const float*>(we_part), num_tiles, de, de16, hg, hp,
            static_cast<float*>(dw_e));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
