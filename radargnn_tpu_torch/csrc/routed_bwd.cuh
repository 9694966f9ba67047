// The bits-routed sender-sum backward's passes, shared by the dense
// backward (dense_bwd_v4.cu) and the windowed backward (windowed_bwd_v3.cu):
// given the forward's routing bits (one per (slot, column), set where the
// slot counts and its op routes to its receiver's max) and g_pass [N, hg]
// f32 (0 at empty receivers; hg = H rounded up to 8),
//   d_op[slot] = bf16(g_pass[recv(slot)]) where the slot's bit is set,
//                else 0 (every tied slot takes the full g)
//   d_e[slot]  = bf16(d_op[slot] @ W_e^T)                  [n_slots, de]
//   dW_e       = sum over slots of e_t[slot]^T d_op[slot]  [de, hg] f32
//   d_ys[s]    = sum of d_op over the slots the landing lists for sender s
//                                                          [N, hg] f32
//   d_yo[s]    = sum of its overflow rows d_op_o (f32)     [N, hg] f32
// d_op [n_slots, hp] is never written. The layouts differ only in where a
// slot's receiver is: a `Recv` functor gives it.
//  - DenseReceivers: dense tiles of R receivers x K slot rows; slot t*TE +
//    j*R + r belongs to receiver t*R + r, so a tile's g rows are staged in
//    shared memory once (kStaged).
//  - WindowReceivers: the windowed layout lists the receiver beside the
//    slot; a routed slot reads its g row where it lies (kStaged false), and
//    only where one of its bits is set (about 1 column in 20 routes).
// Both are walked as tiles of R slots x K slot rows (the windowed layout's
// edge_tile slots as edge_tile / R rows of R), R a multiple of 8 (16 or
// more on the windowed layout). The warps take 16 slots of a row each;
// where R % 16 == 8 the last warp's upper 8 lie past the row: they load
// nothing of another row, contribute nothing and store nothing.
//
// Four launches on one stream, no atomics and fixed summation orders, so
// two runs on the same inputs are bitwise equal:
//  1. de_pass: one block per tile; each warp owns 16 slots of every second
//     slot row. d_op fragments are built in registers from the g rows and
//     the slots' bits (a masked bf16 pair per register), and d_e = d_op @
//     W_e^T runs on mma.sync (the W_e fragments through the read-only
//     cache).
//  1b. dwe_pass: one block per (tile, 64-column chunk): dW_e = e^T @ d_op,
//     summed over the slot rows in registers, then over the warps in order
//     into one partial per tile.
//  2. send_pass: one warp per sender walks the batch's sender-sorted
//     landing order (SenderLanding: order, row_ptr); each lane owns 8
//     columns, rebuilds a slot's d_op from its byte of bits and
//     g_pass[recv] (loaded only where a bit is set), adds an overflow row
//     as it lies to a second sum, and keeps both in registers.
//  3. reduce_pass: dW_e = the per-tile partials summed in tile order.
//
// The kernels live in namespace radargnn, not in an anonymous namespace:
// each including .cu file uses `using namespace radargnn` inside its own
// anonymous namespace, and nvcc's host stubs cannot tell two anonymous
// namespaces apart. Each .cu file builds into its own shared library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace radargnn {

constexpr int kRedCols = kBlockCols;     // dW_e chunk width (columns)
constexpr int kDeWords = 16;             // bit words of a slot in flight

// Receivers of the dense layout: row r of tile t is receiver t*R + r in
// every slot row.
struct DenseReceivers {
    static constexpr bool kStaged = true;
    long long te;
    int r_tile;
    __device__ long long operator()(long long slot) const {
        return slot / te * r_tile + slot % r_tile;
    }
};

// Receivers of the windowed layout, listed beside the slots (-1: empty; a
// slot without bits may name any node or none, so the index is clamped).
struct WindowReceivers {
    static constexpr bool kStaged = false;
    const int32_t* recv;
    int num_nodes;
    __device__ long long operator()(long long slot) const {
        const int r = __ldg(recv + slot);
        return r >= 0 && r < num_nodes ? r : 0;
    }
};

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

// A slot's g row, as d_op reads it: a bf16 row staged in shared memory
// (kStaged), or the float32 row of g_pass, rounded to bf16 where it is
// read (only where a bit is set; a set bit lies below h <= hg).
template <bool kStaged>
struct GRow {
    const __nv_bfloat16* s;
    const float* f;
    // d_op's bf16 pair at columns col, col + 1 (bits `bit`, `bit + 1` of
    // `word`)
    __device__ __forceinline__ uint32_t routed(int col, uint32_t word,
                                               int bit) const {
        if constexpr (kStaged) {
            return mask_pair(ld_pair(s + col), word, bit);
        } else {
            if (((word >> bit) & 3u) == 0u) return 0u;
            const float2 v = __ldg(reinterpret_cast<const float2*>(f + col));
            const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
            return mask_pair(*reinterpret_cast<const uint32_t*>(&b), word,
                             bit);
        }
    }
    // d_op's bf16 at column col (bit `bit` of `word`)
    __device__ __forceinline__ __nv_bfloat16 routed1(int col, uint32_t word,
                                                     int bit) const {
        if (((word >> bit) & 1u) == 0u) return __float2bfloat16(0.0f);
        if constexpr (kStaged) {
            return s[col];
        } else {
            return __float2bfloat16_rn(__ldg(f + col));
        }
    }
};

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

// d_e of one tile (blockIdx.x). Warp w owns slots m0 .. m0+15 (m0 = 16 (w %
// G), G = ceil(R/16); those below R) of every second slot row (j = w / G,
// +2, ...): per slot row
// and 16-feature chunk, over hp in k-steps of 16 columns, A = d_op built
// from the slots' g rows and bits (16 words per slot loaded together ahead
// of use), B = W_e through the read-only cache.
template <class Recv>
__global__ void __launch_bounds__(512) de_pass_kernel(
    Recv recvs,
    const uint32_t* __restrict__ bits,         // [n_slots, hp/32]
    const float* __restrict__ g_pass,          // [N, hg]
    const __nv_bfloat16* __restrict__ w_e,     // [de, hg]
    __nv_bfloat16* __restrict__ d_e,           // [n_slots, de]
    int de, int hg, int hp, int r_tile, int k) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = hp + 8;                     // gs row stride (bf16)
    auto* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [r][ld]
    const int t = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int groups = (r_tile + 15) / 16;
    const int m0 = (warp % groups) * 16;
    const int g = lane >> 2, tq = lane & 3;
    // whether row m0 + g + 8 lies in the tile (row m0 + g always does)
    const bool upper = m0 + 16 <= r_tile;
    const int words = hp / 32;
    const size_t tile_slot0 = static_cast<size_t>(t) * r_tile * k;
    if constexpr (Recv::kStaged) {
        stage_g_rows(g_pass, gs, ld, t, r_tile, hg, 0, hp);
        __syncthreads();
    }

    for (int j = warp / groups; j < k; j += 2) {
        const size_t slot_a = tile_slot0 + static_cast<size_t>(j) * r_tile +
                              m0 + g;
        GRow<Recv::kStaged> ra{}, rb{};
        // a row past the tile reads row m0 + g's g under zero bits
        if constexpr (Recv::kStaged) {
            ra.s = gs + (m0 + g) * ld;
            rb.s = upper ? gs + (m0 + g + 8) * ld : ra.s;
        } else {
            ra.f = g_pass + recvs(slot_a) * hg;
            rb.f = upper ? g_pass + recvs(slot_a + 8) * hg : ra.f;
        }
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
                    wb[i] = ok && upper
                        ? __ldg(reinterpret_cast<const uint2*>(bb + w0) + i)
                        : make_uint2(0u, 0u);
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
                        uint32_t a[4] = {ra.routed(col, xa, bit),
                                         rb.routed(col, xb, bit),
                                         ra.routed(col + 8, xa, bit + 8),
                                         rb.routed(col + 8, xb, bit + 8)};
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
                    if (f >= de || (half && !upper)) continue;
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
// its 16 slots, zero past R) @ d_op (16 slots x 64 columns) over the slot
// rows, then the warps' sums are added in order.
template <class Recv>
__global__ void __launch_bounds__(256) dwe_pass_kernel(
    Recv recvs,
    const uint32_t* __restrict__ bits,         // [n_slots, hp/32]
    const float* __restrict__ g_pass,          // [N, hg]
    const __nv_bfloat16* __restrict__ e_t,     // [n_slots, de]
    float* __restrict__ we_part,               // [T, de16, hp]
    int de, int hg, int hp, int r_tile, int k) {
    constexpr int ld = kRedCols + 8;           // gs row stride (bf16)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    auto* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [r][ld]
    float* red = reinterpret_cast<float*>(
        Recv::kStaged ? smem_raw + sizeof(__nv_bfloat16) * r_tile * ld
                      : smem_raw);
    const int t = blockIdx.x;
    const int c0 = blockIdx.y * kRedCols;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nwarps = blockDim.x >> 5;
    const int m0 = warp * 16;
    const int g = lane >> 2, tq = lane & 3;
    // whether the warp's slots m0 + 8 .. m0 + 15 lie in the tile
    const bool upper = m0 + 16 <= r_tile;
    const int words = hp / 32;
    const int de16 = (de + 15) & ~15;
    const size_t tile_slot0 = static_cast<size_t>(t) * r_tile * k;
    if constexpr (Recv::kStaged) {
        stage_g_rows(g_pass, gs, ld, t, r_tile, hg, c0, kRedCols);
        __syncthreads();
    }

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
                const bool in = (s >> 1) == 0 || upper;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int f = f0 + g + hf * 8;
                    ev[s][hf] = in && f < de ? e_t[slot * de + f]
                                             : __float2bfloat16(0.0f);
                }
            }
            const uint32_t a[4] = {pack_bf16(ev[0][0], ev[1][0]),
                                   pack_bf16(ev[0][1], ev[1][1]),
                                   pack_bf16(ev[2][0], ev[3][0]),
                                   pack_bf16(ev[2][1], ev[3][1])};
            // the bits and g rows of the slots tq*2, tq*2+1, tq*2+8,
            // tq*2+9 over the chunk's 64 columns
            uint2 wv[4];
            GRow<Recv::kStaged> rows[4]{};
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                const int r = m0 + (s >> 1) * 8 + tq * 2 + (s & 1);
                const size_t slot = slot0 + (s >> 1) * 8 + tq * 2 + (s & 1);
                // a slot past the tile: no bits, so its g is never read
                const bool in = (s >> 1) == 0 || upper;
                wv[s] = in ? __ldg(reinterpret_cast<const uint2*>(
                                 bits + slot * words + c0 / 32))
                           : make_uint2(0u, 0u);
                if constexpr (Recv::kStaged) {
                    rows[s].s = gs + (in ? r : 0) * ld;
                } else {
                    rows[s].f = g_pass + (in ? recvs(slot) : 0) * hg + c0;
                }
            }
            // B = d_op: rows the slots above, column c0 + nt*8 + g
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt) {
                const int col = nt * 8 + g;
                const int bit = (nt & 3) * 8 + g;
                __nv_bfloat16 v[4];
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    v[s] = rows[s].routed1(col, (nt >> 2) ? wv[s].y
                                                          : wv[s].x, bit);
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

template <class Recv>
__global__ void __launch_bounds__(256) send_pass_kernel(
    Recv recvs,
    const uint32_t* __restrict__ bits,         // [n_slots, hp/32]
    const float* __restrict__ g_pass,          // [N, hg]
    const float* __restrict__ d_op_o,          // [Eo, hg]
    const int32_t* __restrict__ order,         // [M]
    const int32_t* __restrict__ row_ptr,       // [N + 1]
    float* __restrict__ d_ys,                  // [N, hg]
    float* __restrict__ d_yo,                  // [N, hg]
    long long n_slots, int n_seg, int hg, int words) {
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
                    add_routed8(acc, g_pass + recvs(i) * hg + c * 8, byte);
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

// Shared memory of the d_e pass, in bytes: the tile's g rows over all
// columns where they are staged.
template <class Recv>
inline size_t de_pass_smem_bytes(int hp, int r_tile) {
    return Recv::kStaged
        ? sizeof(__nv_bfloat16) * static_cast<size_t>(r_tile) * (hp + 8)
        : 0;
}

// Launches the four passes on `stream`; returns the first cudaError_t.
// Scratch: we_part [T, de16, hp] f32 (de16 = de rounded up to 16). The
// caller checks shapes, types and alignment: de and hg multiples of 8,
// hp = H rounded up to 64, r_tile a multiple of 8 and at most 128, the
// slots n_slots = T * r_tile * k.
template <class Recv>
cudaError_t launch_routed_grads(
    Recv recvs, const void* bits, const void* g_pass, const void* e_t,
    const void* w_e, const void* d_op_o, const void* order,
    const void* row_ptr, void* d_e, void* we_part, void* dw_e, void* d_ys,
    void* d_yo, long long n_slots, int num_tiles, int r_tile, int k, int de,
    int hg, int hp, int n_seg, cudaStream_t st) {
    const auto* b = static_cast<const uint32_t*>(bits);
    const auto* g = static_cast<const float*>(g_pass);
    const int de16 = (de + 15) & ~15;
    const int warps = (r_tile + 15) / 16;
    const int threads = warps * 32;
    const size_t smem_de = de_pass_smem_bytes<Recv>(hp, r_tile);
    const size_t smem_dwe =
        (Recv::kStaged ? sizeof(__nv_bfloat16) *
                             static_cast<size_t>(r_tile) * (kRedCols + 8)
                       : 0) +
        sizeof(float) * static_cast<size_t>(warps) * 16 * kRedCols;
    cudaError_t err = cudaFuncSetAttribute(
        de_pass_kernel<Recv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_de));
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            dwe_pass_kernel<Recv>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_dwe));
    }
    if (err != cudaSuccess) return err;
    if (num_tiles > 0) {
        de_pass_kernel<Recv><<<num_tiles, 2 * threads, smem_de, st>>>(
            recvs, b, g, static_cast<const __nv_bfloat16*>(w_e),
            static_cast<__nv_bfloat16*>(d_e), de, hg, hp, r_tile, k);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        dwe_pass_kernel<Recv><<<dim3(num_tiles, hp / kRedCols), threads,
                                smem_dwe, st>>>(
            recvs, b, g, static_cast<const __nv_bfloat16*>(e_t),
            static_cast<float*>(we_part), de, hg, hp, r_tile, k);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    const int warps_per_block = 8;
    const int blocks = (n_seg + warps_per_block - 1) / warps_per_block;
    if (blocks > 0) {
        send_pass_kernel<Recv><<<blocks, warps_per_block * 32, 0, st>>>(
            recvs, b, g, static_cast<const float*>(d_op_o),
            static_cast<const int32_t*>(order),
            static_cast<const int32_t*>(row_ptr), static_cast<float*>(d_ys),
            static_cast<float*>(d_yo), n_slots, n_seg, hg, hp / 32);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (de * hg > 0) {
        reduce_pass_kernel<<<(de * hg + 255) / 256, 256, 0, st>>>(
            static_cast<const float*>(we_part), num_tiles, de, de16, hg, hp,
            static_cast<float*>(dw_e));
    }
    return cudaGetLastError();
}

}  // namespace radargnn
