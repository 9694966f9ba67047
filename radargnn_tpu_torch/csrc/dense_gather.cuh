// The dense forward's gather loop (dense_fwd_v4.cu): the operand of every
// slot of a dense tile from the node-level projection,
//   op[slot] = y_s[sender] + e_t[slot] @ W_e     (f32; the edge product on
//                                                  the tensor cores)
// over one 64-column slice. Both passes of the VJP-mode forward (the max,
// then the bits) run this one loop, so the second sees the first's op bit
// for bit; the bits are packed by tile_walk.cuh's pack_row_bits.
//
// Layout (ops/dense_tiles.py). Tile t holds TE = R*K slots; slot t*TE + j*R
// + r sits in slot row j, row r, and is an in-edge of receiver t*R + r. Its
// sender is tile_win[t]*node_block + senders_local[slot] (-1: empty slot).
// y_s is [n_x, hp] float32 (hp = H rounded up to 64, zero past H).
//
// One block = one tile x one 64-column slice, ceil(R/16) warps of 16 rows
// each (R a multiple of 8: where R % 16 == 8 the last warp's upper 8 rows
// lie past the tile; they read zero edge rows, load no sender slot and
// hold no edge, so the caller lands and routes nothing for them).
// A tile's ~1,200 slots read only ~140 distinct sender rows at the
// flagship's shapes (benchmarks/dense_variants.py). So the block first
// loads the slots' senders into shared memory, finds the distinct ones (a
// bit per window position, ranked by a prefix count), copies their
// 64-column slices of y_s into shared memory once (16-byte cp.async), and
// then walks the slot rows: the R edge rows of slot row j are copied
// through a ring of kEStages buffers (rows j+1 .. j+stages-1 load while row
// j computes), each warp forms acc[16 x 64] = e_rows @ W_e on mma.sync and
// adds the y_s slice of each slot's sender from shared memory. Senders are
// taken kWinSpan window positions and kGatherRows distinct rows at a time;
// a tile with more runs the slot rows once per such chunk, each slot in
// the chunk that holds its sender. The VJP mode's second pass walks a
// one-chunk tile's staged rows again.
#pragma once

#include "mma_bf16.cuh"
#include "tile_walk.cuh"

namespace radargnn {

constexpr int kYsLd = kBlockCols + 8;    // staged y_s row stride (floats)
// distinct sender rows staged at a time: 192 covers every tile of the
// flagship's batches (their largest has 190) and leaves room for three
// blocks per SM (128 and 256 measured slower; PERF.md)
constexpr int kGatherRows = 192;
// edge-row buffers: the copies of slot rows j+1 .. j+stages-1 are in
// flight while row j computes; deeper rings cost blocks per SM and
// measured slower (PERF.md)
constexpr int kEStages = 2;
constexpr int kWinSpan = 4096;           // window positions per range
constexpr int kWinWords = kWinSpan / 32;

struct GatherSmem {
    int kpe, lde;              // edge depth padded to the mma k; stride (+8)
    int* pos;                  // [r*k]   the slot's sender as a window
                               //         position, or -1
    int* inv;                  // [kGatherRows] window position of each
                               //         staged row of the chunk
    unsigned* mask;            // [kWinWords] senders present in the range
    int* base;                 // [kWinWords] rank of each word's first bit
    int* scalars;              // [4]     the tile's span, the range's
                               //         count, the chunks walked, the
                               //         last chunk's rows
    int16_t* cidx;             // [r*k]   rank of the slot's sender among the
                               //         range's distinct senders, or -1
    __nv_bfloat16* we_s;       // [64][lde]        W_e slice, transposed
    __nv_bfloat16* ea;         // kEStages x [r16][lde] edge rows (r16 = r
                               //         rounded up to 16; rows past r
                               //         stay zero)
    float* ys;                 // [kGatherRows][kYsLd] staged y_s slices
};

// bytes of the index arrays (pos .. cidx), a multiple of 16
__host__ __device__ inline size_t gather_index_bytes(int r, int k) {
    const size_t b = sizeof(int) * static_cast<size_t>(
                         r * k + kGatherRows + 2 * kWinWords + 4) +
                     sizeof(int16_t) * static_cast<size_t>(r * k);
    return (b + 15) & ~static_cast<size_t>(15);
}

// The rows of an edge-row buffer: the tile's r rounded up to the warps'
// 16.
__host__ __device__ inline int gather_buf_rows(int r) {
    return (r + 15) & ~15;
}

// Shared memory the loop needs, in bytes.
__host__ __device__ inline size_t gather_smem_bytes(int de, int r, int k) {
    const int lde = ((de + 15) & ~15) + 8;
    return gather_index_bytes(r, k) +
           sizeof(__nv_bfloat16) *
               static_cast<size_t>(kBlockCols +
                                   kEStages * gather_buf_rows(r)) * lde +
           sizeof(float) * static_cast<size_t>(kGatherRows) * kYsLd;
}

__device__ __forceinline__ GatherSmem gather_smem(int de, int r, int k) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    GatherSmem S;
    S.kpe = (de + 15) & ~15;
    S.lde = S.kpe + 8;
    S.pos = reinterpret_cast<int*>(smem_raw);
    S.inv = S.pos + r * k;
    S.mask = reinterpret_cast<unsigned*>(S.inv + kGatherRows);
    S.base = reinterpret_cast<int*>(S.mask + kWinWords);
    S.scalars = S.base + kWinWords;
    S.cidx = reinterpret_cast<int16_t*>(S.scalars + 4);
    S.we_s = reinterpret_cast<__nv_bfloat16*>(
        smem_raw + gather_index_bytes(r, k));
    S.ea = S.we_s + kBlockCols * S.lde;
    // (64 + stages r16) lde bf16 is a multiple of 16 bytes (lde % 8 == 0)
    S.ys = reinterpret_cast<float*>(S.ea + kEStages * gather_buf_rows(r) *
                                               S.lde);
    return S;
}

// A slot's sender as a window position (the window starts at node win0),
// or -1 for an empty slot or one past n_x. The index arrays are read-only
// for the kernel's life (__ldg).
struct DenseSenders {
    const int32_t* sloc;
    int win0, n_x;
    __device__ DenseSenders(const int32_t* sloc_, const int32_t* tile_win,
                            int t, int node_block, int n_x_)
        : sloc(sloc_), win0(__ldg(tile_win + t) * node_block), n_x(n_x_) {}
    __device__ int operator()(size_t slot) const {
        const int sl = __ldg(sloc + slot);
        return sl >= 0 && win0 + sl < n_x ? sl : -1;
    }
};

// Stages the W_e slice [col0, col0 + 64), zero past de and h, and zeroes
// the depth padding [de, kpe) of every edge-row buffer and its rows past
// r (the mma reads them, the copies never write them). The loop's first
// barrier publishes it.
__device__ __forceinline__ void stage_edge_weights(
    const GatherSmem& S, const __nv_bfloat16* __restrict__ w_e, int de,
    int h, int r, int col0) {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < S.kpe * kBlockCols; i += blockDim.x) {
        const int kk = i / kBlockCols, n = i % kBlockCols;
        const int col = col0 + n;
        S.we_s[n * S.lde + kk] = (kk < de && col < h)
            ? w_e[static_cast<size_t>(kk) * h + col] : zero;
    }
    const int r16 = gather_buf_rows(r);
    for (int i = threadIdx.x; i < kEStages * r16 * (S.kpe - de);
         i += blockDim.x) {
        const int rr = i / (S.kpe - de), c = i % (S.kpe - de);
        S.ea[rr * S.lde + de + c] = zero;
    }
    for (int i = threadIdx.x; i < kEStages * (r16 - r) * de;
         i += blockDim.x) {
        const int rr = i / de, c = i % de;
        const int buf = rr / (r16 - r), row = r + rr % (r16 - r);
        S.ea[(buf * r16 + row) * S.lde + c] = zero;
    }
}

// The distinct senders of the rk slots (S.pos) at window positions
// [p0, p0 + kWinSpan): S.mask, S.base and S.cidx (-1 for a slot whose
// sender lies elsewhere); returns their count. Every thread of the block
// calls it.
__device__ __forceinline__ int rank_senders(const GatherSmem& S, int rk,
                                            int p0) {
    const int tid = threadIdx.x;
    for (int w = tid; w < kWinWords; w += blockDim.x) S.mask[w] = 0u;
    __syncthreads();
    for (int i = tid; i < rk; i += blockDim.x) {
        const int p = S.pos[i] - p0;
        if (p >= 0 && p < kWinSpan) {
            atomicOr(S.mask + (p >> 5), 1u << (p & 31));
        }
    }
    __syncthreads();
    // exclusive prefix count over the words: warp 0, each lane a run of
    // kWinWords / 32 consecutive words
    if (tid < 32) {
        constexpr int kRun = kWinWords / 32;
        int sum = 0;
#pragma unroll
        for (int i = 0; i < kRun; ++i) sum += __popc(S.mask[tid * kRun + i]);
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (tid >= off) incl += v;
        }
        int run = incl - sum;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
            S.base[tid * kRun + i] = run;
            run += __popc(S.mask[tid * kRun + i]);
        }
        if (tid == 31) S.scalars[1] = incl;
    }
    __syncthreads();
    for (int i = tid; i < rk; i += blockDim.x) {
        const int p = S.pos[i] - p0;
        int c = -1;
        if (p >= 0 && p < kWinSpan) {
            const unsigned below = S.mask[p >> 5] & ((1u << (p & 31)) - 1u);
            c = S.base[p >> 5] + __popc(below);
        }
        S.cidx[i] = static_cast<int16_t>(c);
    }
    const int count = S.scalars[1];
    __syncthreads();
    return count;
}

// Copies the 64-column slices of the distinct senders ranked [c0, c0 + n)
// into S.ys (16-byte cp.async, committed; the caller waits and syncs).
__device__ __forceinline__ void stage_sender_rows(
    const GatherSmem& S, const float* __restrict__ y_s, int win0, int p0,
    int hp, int col0, int c0, int n) {
    const int tid = threadIdx.x;
    // the window position of each staged rank, from the bits (a word's bits
    // are ranked in order from its base, so each entry is written once)
    for (int w = tid; w < kWinWords; w += blockDim.x) {
        unsigned bits = S.mask[w];
        int c = S.base[w];
        while (bits != 0u) {
            const int b = __ffs(bits) - 1;
            if (c >= c0 && c < c0 + n) S.inv[c - c0] = w * 32 + b;
            bits &= bits - 1u;
            ++c;
        }
    }
    __syncthreads();
    constexpr int kChunks = kBlockCols / 4;    // 16-byte chunks of a slice
    for (int i = tid; i < n * kChunks; i += blockDim.x) {
        const int rr = i / kChunks, c = i % kChunks;
        const size_t row = static_cast<size_t>(win0 + p0 + S.inv[rr]);
        cp_async16(S.ys + rr * kYsLd + c * 4, y_s + row * hp + col0 + c * 4,
                   true);
    }
    cp_async_commit();
}

// Calls visit(j, acc, v0, v1) for each slot row j = 0..k-1 of tile t and
// each chunk of its distinct senders: acc[nt][q] is op at row
// m0 + g + (q >> 1) * 8 and column col0 + nt * 8 + tq * 2 + (q & 1)
// (m0 = 16 * warp, g = lane / 4, tq = lane % 4); v0 / v1 say whether rows
// m0+g / m0+g+8 hold an edge whose sender is in the chunk (each slot with
// an edge is in exactly one chunk; a row past r holds none). With `reuse`, a tile whose senders the
// previous call staged in one chunk walks its slot rows again without
// ranking or copying anything. Every thread of the block calls it;
// stage_edge_weights first.
template <class Visit>
__device__ __forceinline__ void gather_rows(
    int t, const float* __restrict__ y_s,      // [n_x, hp]
    const __nv_bfloat16* __restrict__ e_t,     // [T*TE, de]
    const DenseSenders& senders, int de, int hp, int r, int k, int col0,
    bool reuse, Visit&& visit) {
    const GatherSmem S = gather_smem(de, r, k);
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = (tid >> 5) * 16;
    const int rk = r * k;
    const int r16 = gather_buf_rows(r);
    const size_t tile_slot0 = static_cast<size_t>(t) * rk;
    const int echunks = de / 8;

    // the edge rows of slot row j into their ring buffer, one commit group
    // per row (an empty group past the last row)
    auto issue = [&](int j) {
        if (j < k) {
            const size_t slot0 = tile_slot0 + static_cast<size_t>(j) * r;
            __nv_bfloat16* ea = S.ea + (j % kEStages) * r16 * S.lde;
            for (int i = tid; i < r * echunks; i += nthreads) {
                const int rr = i / echunks, c = i % echunks;
                cp_async16(ea + rr * S.lde + c * 8,
                           e_t + (slot0 + rr) * static_cast<size_t>(de) +
                               c * 8,
                           true);
            }
        }
        cp_async_commit();
    };

    // the slot rows over the staged chunk of ranks [c0, c0 + n)
    auto walk = [&](int c0, int n) {
        for (int j = 0; j < kEStages - 1; ++j) issue(j);
        for (int j = 0; j < k; ++j) {
            const int buf = j % kEStages;
            issue(j + kEStages - 1);
            cp_async_wait<kEStages - 1>();       // row j (and the y_s rows)
            __syncthreads();

            float acc[kColTiles][4];
#pragma unroll
            for (int nt = 0; nt < kColTiles; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
            warp_gemm(acc, S.ea + buf * r16 * S.lde + m0 * S.lde, S.lde,
                      S.we_s, S.lde, S.kpe, g, tq);
            bool in[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + g + half * 8;
                const int c = row < r ? S.cidx[j * r + row] - c0 : -1;
                in[half] = c >= 0 && c < n;
                const float* ys = S.ys + (in[half] ? c : 0) * kYsLd;
#pragma unroll
                for (int nt = 0; nt < kColTiles; ++nt) {
                    const float2 y = *reinterpret_cast<const float2*>(
                        ys + nt * 8 + tq * 2);
                    acc[nt][half * 2] += y.x;
                    acc[nt][half * 2 + 1] += y.y;
                }
            }
            visit(j, acc, in[0], in[1]);
            __syncthreads();       // the buffers are refilled next
        }
    };

    if (reuse && S.scalars[2] == 1) {
        walk(0, S.scalars[3]);
        return;
    }
    // the slots' senders, four loads in flight per thread, and the tile's
    // window span: one past its largest sender position
    if (tid == 0) S.scalars[0] = 0;
#pragma unroll 4
    for (int i = tid; i < rk; i += nthreads) {
        S.pos[i] = senders(tile_slot0 + i);
    }
    __syncthreads();
    int span = 0;
    for (int i = tid; i < rk; i += nthreads) span = max(span, S.pos[i] + 1);
    atomicMax(S.scalars, span);
    __syncthreads();
    span = S.scalars[0];

    int chunks = 0, last = 0;
    for (int p0 = 0; p0 < span; p0 += kWinSpan) {
        const int count = rank_senders(S, rk, p0);
        for (int c0 = 0; c0 < count; c0 += kGatherRows) {
            last = min(kGatherRows, count - c0);
            stage_sender_rows(S, y_s, senders.win0, p0, hp, col0, c0, last);
            walk(c0, last);
            ++chunks;
        }
    }
    if (tid == 0) {
        S.scalars[2] = chunks;
        S.scalars[3] = last;
    }
    __syncthreads();
}

}  // namespace radargnn
