// Hoisted max aggregation (v1), backward kernel, in float32.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _hoisted_bwd_kernel (reached through _hoisted_bwd_call and
// make_fused_hoisted_aggregate_pallas_bwd) on Hopper (sm_90a).
//
// What it computes, on the forward's tiles (hoisted_fwd_v1.cu), with
// inner_z and g_pass [num_nodes, h] the forward's maxima and the upstream
// gradient, both 0 at receivers without a slot:
//   op[s]      = y_s[senders_t[s]] + e_t[s] @ W_e + b  (hoisted_v1.cuh, the
//                forward's bits)
//   d_op[s][c] = g_pass[recv[s]][c] where slot s counts (its receiver lies
//                in its tile's node block: the TPU kernel's has_recv gate)
//                and |op[s][c] - inner_z[recv[s]][c]|
//                    <= 1e-5 |inner_z[recv[s]][c]| + 1e-5, else 0
//   d_e[s]     = d_op[s] @ W_e^T
//   dW_e       = e_t^T @ d_op,   d_b = the sum of d_op over the slots
// Every slot within the tolerance of its receiver's max takes the full g (a
// tie shares nothing). The gate matters: a padding slot's operand can lie
// within 1e-5 of a zero inner_z. d_y_s, d_op summed at each slot's sender,
// is landed outside the kernel by segment_sum_csr.cu.
//
// Design. Pass 1: one block of 256 threads per tile, two blocks an SM. It
// stages the tile's edge rows once (in k-groups of four: a float4 per slot
// and group) and each slot's receiver and sender, then walks the h columns
// in 64-column slices, each in three register-tiled phases over the
// slice's d_op kept in shared memory:
//  A. d_op: a thread owns 4 slots x 4 contiguous columns. It requests the
//     slots' y_s, inner_z and g_pass rows (16 bytes each; a slot of the
//     last one's receiver reuses its rows, and g is loaded whether or not
//     the slot routes, so no load waits on the test), then forms the 16
//     edge chains from 0.0f in ascending k while they arrive (a W_e float4
//     per 16 fma, the edge values four at a time), adds the gathered y_s
//     and the bias (hoisted_v1.cuh: v1_op, the forward's bits), routes
//     against inner_z with the strict test as torch rounds it, and writes
//     d_op to device memory and to shared memory, 16 bytes at a time.
//     Loads that waited one after another held the parent design
//     (PERF.md).
//  B. d_e: a thread owns 2 slots x 8 features and adds the slice's 64
//     columns in order, 64 fma per two 16-byte loads of d_op and eight of
//     W_e (broadcast); the sums stay in shared memory across slices.
//  C. the tile's partial of [e_t | 1]^T @ d_op: a thread owns 8 features x
//     4 columns over an eighth of the tile's slots, ascending (32 fma per a
//     16-byte load of d_op and two of the edge rows); the threads of the
//     first feature group also sum d_op for d_b. The parts are combined in
//     order and written to device memory.
// Pass 2: dW_e and d_b, the tiles' partials summed in tile order (8 warps
// over contiguous tile ranges, combined in order). No float atomics, so two
// runs on the same inputs give the same bits.
//
// What bounds it on the card: three edge products per valid slot (the
// operand, d_e, dW_e), 6 d_e H float32 operations at 67 TFLOP/s (281,600
// slots, d_e 16, H 464: 12.5 GFLOP, 0.19 ms), close to the d_op write of
// E_pad H floats (0.52 GB, 0.16 ms). The times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hoisted_v1.cuh"
#include "tile_walk.cuh"

namespace {

using namespace radargnn;

constexpr int kThreads = 256;
constexpr int kDopLd = kV1Cols + 4;      // d_op slice row stride (floats)
constexpr int kOpSlots = 4;              // phase A: slots of a thread
constexpr int kOpCols = 4;               // phase A: columns of a thread
constexpr int kColGroups = kV1Cols / kOpCols;
constexpr int kChunk = kThreads / kColGroups * kOpSlots;   // slots a round
constexpr int kReduceWarps = 8;          // pass 2: tile ranges

// Edge features padded to whole groups of eight (phase B's items).
__host__ __device__ inline int v1_kp(int de) { return (de + 7) / 8 * 8; }

// Phase C's items: 8 features x 4 columns of the slice.
__host__ __device__ inline int v1_c_items(int de) {
    return v1_kp(de) / 8 * (kV1Cols / 4);
}

// Parts of the tile's slots in phase C: as many as the threads allow (at
// most 8, dividing te).
__host__ __device__ inline int v1_parts(int de, int te) {
    int p = kThreads / v1_c_items(de);
    p = p >= 8 ? 8 : (p >= 4 ? 4 : (p >= 2 ? 2 : 1));
    while (te % p != 0) p /= 2;
    return p;
}

// Floats of the d_op slice, which phase C's partials reuse.
__host__ __device__ inline size_t v1_dop_floats(int de, int te) {
    const size_t dop = static_cast<size_t>(te) * kDopLd;
    const size_t red = static_cast<size_t>(v1_parts(de, te)) * (de + 1) *
                       kV1Cols;
    return dop > red ? dop : red;
}

// Shared memory of pass 1, in 4-byte words: the edge rows [kp/4][te][4],
// the W_e slice [kp][64] and b [64], d_e's sums [kp/4][te][4],
// the d_op slice, the slots' receivers and senders [te] each.
__host__ __device__ inline size_t v1_bwd_smem_words(int de, int te) {
    const size_t kp = v1_kp(de);
    return 2 * kp * te + kp * kV1Cols + kV1Cols + v1_dop_floats(de, te) +
           2 * static_cast<size_t>(te);
}

// v[i] = row[i] for the first `cols` of a thread's columns (0 past them
// or where !ok): 16-byte loads where rows are 16-byte aligned (kVec: h a
// multiple of 4, so a 4-column group lies below h or past it).
template <bool kVec>
__device__ __forceinline__ void load_row(float (&v)[kOpCols],
                                         const float* __restrict__ row,
                                         bool ok, int cols) {
    if constexpr (kVec) {
#pragma unroll
        for (int c = 0; c < kOpCols; c += 4) {
            const float4 u =
                ok && c < cols
                    ? __ldg(reinterpret_cast<const float4*>(row + c))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            v[c] = u.x;
            v[c + 1] = u.y;
            v[c + 2] = u.z;
            v[c + 3] = u.w;
        }
    } else {
#pragma unroll
        for (int c = 0; c < kOpCols; ++c) {
            v[c] = ok && c < cols ? __ldg(row + c) : 0.0f;
        }
    }
}

// row[i] = v[i] for the first `cols` of a thread's columns.
template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ row,
                                          const float (&v)[kOpCols],
                                          int cols) {
    if constexpr (kVec) {
#pragma unroll
        for (int c = 0; c < kOpCols; c += 4) {
            if (c < cols) {
                *reinterpret_cast<float4*>(row + c) =
                    make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
            }
        }
    } else {
#pragma unroll
        for (int c = 0; c < kOpCols; ++c) {
            if (c < cols) row[c] = v[c];
        }
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) hoisted_bwd_v1_kernel(
    const float* __restrict__ y_s,             // [n_y, h]
    const float* __restrict__ e_t,             // [T*TE, de]
    const float* __restrict__ w_e,             // [de, h]
    const float* __restrict__ b,               // [h]
    const int32_t* __restrict__ senders,       // [T*TE]
    const int32_t* __restrict__ recv,          // [T*TE]
    const int32_t* __restrict__ tile_blocks,   // [T]
    const float* __restrict__ inner_z,         // [num_nodes, h]
    const float* __restrict__ g_pass,          // [num_nodes, h]
    float* __restrict__ d_op,                  // [T*TE, h]
    float* __restrict__ d_e,                   // [T*TE, de]
    float* __restrict__ part,                  // [T, de + 1, h]
    int n_y, int de, int h, int num_nodes, int node_block, int edge_tile) {
    extern __shared__ __align__(16) float smem[];
    const int te = edge_tile;
    const int kp = v1_kp(de);
    float* eR = smem;                              // [kg][te][4] edge rows
    float* we_p = eR + static_cast<size_t>(kp) * te;    // [kp][64] W_e
    float* b_p = we_p + kp * kV1Cols;              // [64] b
    float* dacc = b_p + kV1Cols;                   // [kg][te][4] d_e sums
    float* dop = dacc + static_cast<size_t>(kp) * te;   // [te][kDopLd]
    float* red = dop;                              // phase C's partials
    int* rc_s = reinterpret_cast<int*>(dop + v1_dop_floats(de, te));
    int* sn_s = rc_s + te;       // [te] receiver (-1: no count), sender
    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int64_t slot0 = static_cast<int64_t>(t) * te;
    const int base = tile_blocks[t] * node_block;

    // the tile's edge rows, zero past de; d_e's sums start at 0; each
    // slot's receiver where it counts (-1 where not) and its sender
    for (int i = tid; i < te * kp; i += kThreads) {
        const int s = i / kp, k = i % kp;
        eR[((k >> 2) * te + s) * 4 + (k & 3)] =
            k < de ? __ldg(e_t + (slot0 + s) * de + k) : 0.0f;
        dacc[i] = 0.0f;
    }
    for (int s = tid; s < te; s += kThreads) {
        const int rc = __ldg(recv + slot0 + s);
        const int sn = __ldg(senders + slot0 + s);
        const bool counts =
            receiver_in_block(rc, base, node_block, num_nodes) && sn >= 0 &&
            sn < n_y;
        rc_s[s] = counts ? rc : -1;
        sn_s[s] = counts ? sn : 0;
    }
    // phase A: columns 4 cg .. 4 cg + 3 of the slice, slots of the round
    // 8 warp + q + 2 j: the two lanes of a column group on neighbouring rows
    // (their edge values in different banks), a thread's 4 slots within 8
    // (mostly one receiver's run, whose rows it loads once)
    const int cg = lane % kColGroups, q = lane / kColGroups;
    // phase C: item (8 features from 8 c_kh, 4 columns from 4 c_pq) and
    // part of the slots
    const int parts = v1_parts(de, te);
    const int c_items = v1_c_items(de);
    const int c_item = tid % c_items, c_part = tid / c_items;
    const int c_pq = c_item % (kV1Cols / 4), c_kh = c_item / (kV1Cols / 4);
    const bool c_on = c_part < parts;
    const int c_s0 = c_part * (te / parts);
    const int c_s1 = c_s0 + te / parts;

    for (int col0 = 0; col0 < h; col0 += kV1Cols) {
        __syncthreads();    // the previous slice's reads are done
        for (int i = tid; i < kp * kV1Cols; i += kThreads) {
            const int k = i / kV1Cols, col = col0 + i % kV1Cols;
            we_p[i] = k < de && col < h
                          ? __ldg(w_e + static_cast<size_t>(k) * h + col)
                          : 0.0f;
        }
        for (int p = tid; p < kV1Cols; p += kThreads) {
            const int col = col0 + p;
            b_p[p] = col < h ? __ldg(b + col) : 0.0f;
        }
        __syncthreads();

        // -- A: d_op ----------------------------------------------------
        // the thread's columns below h
        const int cols = min(kOpCols, max(0, h - col0 - cg * kOpCols));
        for (int r0 = 0; r0 < te; r0 += kChunk) {
            // slot j: sbase + 2 j
            const int sbase = r0 + 2 * kOpSlots * warp + q;
            // the round's y_s, inner_z and g_pass rows at the thread's
            // columns (0 where a slot does not count), all requested before
            // the edge chains, whose work covers their wait; a slot of the
            // last one's receiver takes its rows
            int rc[kOpSlots];
            float y[kOpSlots][kOpCols], in[kOpSlots][kOpCols],
                g[kOpSlots][kOpCols];
#pragma unroll
            for (int j = 0; j < kOpSlots; ++j) {
                const int s = sbase + 2 * j;
                rc[j] = s < te ? rc_s[s] : -1;
                const float* yr = y_s + static_cast<size_t>(
                    s < te ? sn_s[s] : 0) * h + col0 + cg * kOpCols;
                load_row<kVec>(y[j], yr, rc[j] >= 0, cols);
                const bool own = j == 0 || rc[j] != rc[j - 1];
                const size_t at = static_cast<size_t>(rc[j] >= 0 ? rc[j] : 0) *
                                  h + col0 + cg * kOpCols;
                load_row<kVec>(in[j], inner_z + at, own && rc[j] >= 0, cols);
                load_row<kVec>(g[j], g_pass + at, own && rc[j] >= 0, cols);
            }
            float acc[kOpSlots][kOpCols];
#pragma unroll
            for (int j = 0; j < kOpSlots; ++j)
#pragma unroll
                for (int i = 0; i < kOpCols; ++i) acc[j][i] = 0.0f;
            for (int k0 = 0; k0 < de; k0 += 4) {
                // the slots' edge values k0 .. k0 + 3, one 16-byte load each
                float ev[kOpSlots][4];
#pragma unroll
                for (int j = 0; j < kOpSlots; ++j) {
                    const int s = sbase + 2 * j;
                    const float4 e4 = s < te
                        ? *reinterpret_cast<const float4*>(
                              eR + ((k0 >> 2) * te + s) * 4)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    ev[j][0] = e4.x;
                    ev[j][1] = e4.y;
                    ev[j][2] = e4.z;
                    ev[j][3] = e4.w;
                }
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    if (k0 + kk >= de) break;   // the chain stops at de
                    const float4 w4 = *reinterpret_cast<const float4*>(
                        we_p + (k0 + kk) * kV1Cols + cg * kOpCols);
                    const float w[kOpCols] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                    for (int j = 0; j < kOpSlots; ++j)
#pragma unroll
                        for (int i = 0; i < kOpCols; ++i)
                            acc[j][i] = fmaf(ev[j][kk], w[i], acc[j][i]);
                }
            }
#pragma unroll
            for (int j = 0; j < kOpSlots; ++j) {
                if (j > 0 && rc[j] == rc[j - 1]) {
#pragma unroll
                    for (int i = 0; i < kOpCols; ++i) {
                        in[j][i] = in[j - 1][i];
                        g[j][i] = g[j - 1][i];
                    }
                }
                const int s = sbase + 2 * j;
                if (s >= te) continue;
                float v[kOpCols];
#pragma unroll
                for (int i = 0; i < kOpCols; ++i) {
                    const float op = v1_op(y[j][i], acc[j][i],
                                           b_p[cg * kOpCols + i]);
                    v[i] = rc[j] >= 0 && i < cols && routes(op, in[j][i])
                               ? g[j][i]
                               : 0.0f;
                }
                store_row<kVec>(d_op + (slot0 + s) * h + col0 + cg * kOpCols,
                                v, cols);
                *reinterpret_cast<float4*>(dop + s * kDopLd + cg * kOpCols) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
        }
        __syncthreads();    // the slice's d_op is staged

        // -- B: d_e[s][k] += d_op[s] . W_e[k] over the slice ---------------
        // item: slots sp and sp + te / 2, features 8 kh .. 8 kh + 7 (the
        // lanes of a warp on neighbouring slot pairs, one W_e broadcast)
        for (int it = tid; it < (te / 2) * (kp / 8); it += kThreads) {
            const int sp = it % (te / 2), kh = it / (te / 2);
            float* da[2][2];
            float a[2][8];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int h4 = 0; h4 < 2; ++h4) {
                    da[jj][h4] = dacc + ((2 * kh + h4) * te + sp +
                                         jj * (te / 2)) * 4;
                    const float4 d4 =
                        *reinterpret_cast<const float4*>(da[jj][h4]);
                    a[jj][h4 * 4] = d4.x;
                    a[jj][h4 * 4 + 1] = d4.y;
                    a[jj][h4 * 4 + 2] = d4.z;
                    a[jj][h4 * 4 + 3] = d4.w;
                }
            const float* wk = we_p + 8 * kh * kV1Cols;
            for (int p0 = 0; p0 < kV1Cols; p0 += 4) {
                float dv[2][4];
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                    const float4 d4 = *reinterpret_cast<const float4*>(
                        dop + (sp + jj * (te / 2)) * kDopLd + p0);
                    dv[jj][0] = d4.x;
                    dv[jj][1] = d4.y;
                    dv[jj][2] = d4.z;
                    dv[jj][3] = d4.w;
                }
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    const float4 w4 = *reinterpret_cast<const float4*>(
                        wk + kk * kV1Cols + p0);
                    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                    for (int pp = 0; pp < 4; ++pp)
#pragma unroll
                        for (int jj = 0; jj < 2; ++jj)
                            a[jj][kk] = fmaf(dv[jj][pp], wv[pp], a[jj][kk]);
                }
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int h4 = 0; h4 < 2; ++h4) {
                    *reinterpret_cast<float4*>(da[jj][h4]) =
                        make_float4(a[jj][h4 * 4], a[jj][h4 * 4 + 1],
                                    a[jj][h4 * 4 + 2], a[jj][h4 * 4 + 3]);
                }
        }

        // -- C: the part's [e_t | 1]^T d_op, slots ascending -------------
        float pa[8][4], pb[4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
            pb[pp] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) pa[kk][pp] = 0.0f;
        }
        if (c_on) {
            for (int s = c_s0; s < c_s1; ++s) {
                const float4 d4 = *reinterpret_cast<const float4*>(
                    dop + s * kDopLd + c_pq * 4);
                const float4 e0 = *reinterpret_cast<const float4*>(
                    eR + (2 * c_kh * te + s) * 4);
                const float4 e1 = *reinterpret_cast<const float4*>(
                    eR + ((2 * c_kh + 1) * te + s) * 4);
                const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
                const float ev[8] = {e0.x, e0.y, e0.z, e0.w,
                                     e1.x, e1.y, e1.z, e1.w};
#pragma unroll
                for (int kk = 0; kk < 8; ++kk)
#pragma unroll
                    for (int pp = 0; pp < 4; ++pp)
                        pa[kk][pp] = fmaf(ev[kk], dv[pp], pa[kk][pp]);
                if (c_kh == 0) {
#pragma unroll
                    for (int pp = 0; pp < 4; ++pp) pb[pp] += dv[pp];
                }
            }
        }
        __syncthreads();    // phases B and C have read the d_op slice
        // red [parts][de + 1][64] over the d_op slice
        if (c_on) {
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                const int k = c_kh * 8 + kk;
                if (k >= de) continue;
                *reinterpret_cast<float4*>(
                    red + (c_part * (de + 1) + k) * kV1Cols + c_pq * 4) =
                    make_float4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
            }
            if (c_kh == 0) {
                *reinterpret_cast<float4*>(
                    red + (c_part * (de + 1) + de) * kV1Cols + c_pq * 4) =
                    make_float4(pb[0], pb[1], pb[2], pb[3]);
            }
        }
        __syncthreads();
        for (int o = tid; o < (de + 1) * kV1Cols; o += kThreads) {
            const int k = o / kV1Cols, p = o % kV1Cols;
            const int col = col0 + p;
            if (col >= h) continue;
            float sum = red[o];
            for (int pt = 1; pt < parts; ++pt) {
                sum += red[pt * (de + 1) * kV1Cols + o];
            }
            part[(static_cast<size_t>(t) * (de + 1) + k) * h + col] = sum;
        }
    }
    __syncthreads();
    for (int i = tid; i < te * de; i += kThreads) {
        const int s = i / de, k = i % de;
        d_e[(slot0 + s) * de + k] = dacc[((k >> 2) * te + s) * 4 + (k & 3)];
    }
}

// dW_e [de, h] and d_b [h]: the sum of the tiles' partials in tile order.
// Block (32 columns, row k = blockIdx.y); warp w sums the w-th contiguous
// range of tiles, then the ranges are added in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
hoisted_bwd_v1_reduce_kernel(const float* __restrict__ part, int num_tiles,
                             int de, int h, float* __restrict__ dw_e,
                             float* __restrict__ d_b) {
    __shared__ float s[kReduceWarps][32];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int c = blockIdx.x * 32 + lane, k = blockIdx.y;
    const int per = (num_tiles + kReduceWarps - 1) / kReduceWarps;
    const int t0 = w * per;
    const int t1 = t0 + per < num_tiles ? t0 + per : num_tiles;
    float acc = 0.0f;
    if (c < h) {
        for (int t = t0; t < t1; ++t) {
            acc += part[(static_cast<size_t>(t) * (de + 1) + k) * h + c];
        }
    }
    s[w][lane] = acc;
    __syncthreads();
    if (w != 0 || c >= h) return;
    float sum = s[0][lane];
#pragma unroll
    for (int i = 1; i < kReduceWarps; ++i) sum += s[i][lane];
    if (k < de) {
        dw_e[static_cast<size_t>(k) * h + c] = sum;
    } else {
        d_b[c] = sum;
    }
}

// Pass 1 on `st` with its attributes set; the cudaError_t of the launch.
template <bool kVec>
cudaError_t launch_pass1(const void* y_s, const void* e_t, const void* w_e,
                         const void* b, const void* senders, const void* recv,
                         const void* tile_blocks, const void* inner_z,
                         const void* g_pass, void* d_op, void* d_e,
                         void* part, int n_y, int de, int h, int num_tiles,
                         int num_nodes, int node_block, int edge_tile,
                         cudaStream_t st) {
    const size_t smem = sizeof(float) * v1_bwd_smem_words(de, edge_tile);
    cudaError_t err = cudaFuncSetAttribute(
        hoisted_bwd_v1_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // all of the SM's shared memory, so that two blocks fit
    err = cudaFuncSetAttribute(hoisted_bwd_v1_kernel<kVec>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    hoisted_bwd_v1_kernel<kVec><<<num_tiles, kThreads, smem, st>>>(
        static_cast<const float*>(y_s), static_cast<const float*>(e_t),
        static_cast<const float*>(w_e), static_cast<const float*>(b),
        static_cast<const int32_t*>(senders),
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(inner_z),
        static_cast<const float*>(g_pass), static_cast<float*>(d_op),
        static_cast<float*>(d_e), static_cast<float*>(part), n_y, de, h,
        num_nodes, node_block, edge_tile);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs, in bytes (see v1_bwd_smem_floats).
size_t hoisted_bwd_v1_smem_bytes(int de, int edge_tile) {
    return sizeof(float) * v1_bwd_smem_words(de, edge_tile);
}

// The largest d_e phase C takes (kp / 8 x 16 items on 256 threads).
int hoisted_bwd_v1_max_de() { return kThreads / (kV1Cols / 4) * 8; }

// Launches both passes on `stream`; returns the first cudaError_t. The
// caller checks shapes, types and contiguity, edge_tile a multiple of 4,
// d_e at most hoisted_bwd_v1_max_de() and the shared memory. Scratch: part
// [num_tiles, de + 1, h] float32.
int hoisted_bwd_v1(const void* y_s, const void* e_t, const void* w_e,
                   const void* b, const void* senders, const void* recv,
                   const void* tile_blocks, const void* inner_z,
                   const void* g_pass, void* d_op, void* d_e, void* part,
                   void* dw_e, void* d_b, int n_y, int de, int h,
                   int num_tiles, int num_nodes, int node_block,
                   int edge_tile, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // 16-byte rows of y_s, inner_z, g_pass and d_op
    const bool vec = h % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(y_s) |
          reinterpret_cast<uintptr_t>(inner_z) |
          reinterpret_cast<uintptr_t>(g_pass) |
          reinterpret_cast<uintptr_t>(d_op)) & 15) == 0;
    cudaError_t err = num_tiles > 0
        ? (vec ? launch_pass1<true> : launch_pass1<false>)(
              y_s, e_t, w_e, b, senders, recv, tile_blocks, inner_z, g_pass,
              d_op, d_e, part, n_y, de, h, num_tiles, num_nodes, node_block,
              edge_tile, st)
        : cudaSuccess;
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((h + 31) / 32, de + 1);
    hoisted_bwd_v1_reduce_kernel<<<grid, 32 * kReduceWarps, 0, st>>>(
        static_cast<const float*>(part), num_tiles, de, h,
        static_cast<float*>(dw_e), static_cast<float*>(d_b));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
