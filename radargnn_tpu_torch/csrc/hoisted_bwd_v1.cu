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
// Design. Pass 1: one block of 256 threads per tile. It stages the tile's
// edge rows twice (k-major for the operands, and row-major with a column of
// ones for the weight partials), its senders and receivers, then walks the
// h columns in 64-column slices:
//  - d_op: a thread owns one column and every fourth group of four slots,
//    forms their operands as the forward does (hoisted_v1.cuh), routes, and
//    writes the slice of d_op to device memory and, transposed, to shared
//    memory (one float4 per group);
//  - d_e: a thread owns fixed (group of four slots, k) entries, held in
//    registers across the slices, and adds the slice's columns in
//    ascending order (a float4 of d_op and one W_e value per four fma);
//  - the tile's partial of [e_t | 1]^T @ d_op: a thread owns a column and
//    four rows of it (rows k < de are dW_e's, row de is d_b's) and sums the
//    tile's slots in ascending order (a float4 of d_op and four of the edge
//    rows per sixteen fma), written to device memory.
// d_e completes in the block, so no buffer spans column slices. Pass 2: dW_e
// and d_b, one thread per output, the sum of the tiles' partials in tile
// order. No float atomics anywhere, so two runs on the same inputs give the
// same bits.
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
constexpr int kMaxItems = 8;   // d_e entries (x4 slots) a thread owns

// Row stride of the k-major buffers (d_op transposed, the edge rows):
// te + 4, a multiple of 4 for float4 access that puts the 8 lanes of a
// quarter-warp on different banks.
__host__ __device__ inline int v1_slot_ld(int te) { return te + 4; }

// Row stride of the row-major edge rows with their column of ones: de + 1
// rounded up to a multiple of 4.
__host__ __device__ inline int v1_edge_ld(int de) {
    return (de + 1 + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kThreads) hoisted_bwd_v1_kernel(
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
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int te = edge_tile;
    const int ldt = v1_slot_ld(te), ldr = v1_edge_ld(de);
    float* dopT = reinterpret_cast<float*>(smem_raw);     // [64][ldt]
    float* eT = dopT + kV1Cols * ldt;                     // [de][ldt]
    float* eR = eT + de * ldt;                            // [te][ldr]
    float* we_t = eR + te * ldr;                          // [64][de + 1]
    float* b_s = we_t + kV1Cols * (de + 1);               // [64]
    int* rc_s = reinterpret_cast<int*>(b_s + kV1Cols);   // [te] global / -1
    int* snd_s = rc_s + te;                               // [te]
    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int tx = tid % kV1Cols, ty = tid / kV1Cols;
    const int groups = te / kV1Slots;
    const int64_t slot0 = static_cast<int64_t>(t) * te;
    const int base = tile_blocks[t] * node_block;

    v1_stage_edges(e_t, slot0, te, de, eT, ldt);
    for (int i = tid; i < te * ldr; i += blockDim.x) {
        const int s = i / ldr, k = i % ldr;
        eR[i] = k < de ? __ldg(e_t + (slot0 + s) * de + k)
                       : (k == de ? 1.0f : 0.0f);
    }
    for (int s = tid; s < te; s += blockDim.x) {
        int rc = __ldg(recv + slot0 + s);
        int snd = __ldg(senders + slot0 + s);
        if (!receiver_in_block(rc, base, node_block, num_nodes) || snd < 0 ||
            snd >= n_y) {
            rc = -1;
            snd = 0;
        }
        rc_s[s] = rc;
        snd_s[s] = snd;
    }
    float4 de_acc[kMaxItems];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
        de_acc[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }

    for (int col0 = 0; col0 < h; col0 += kV1Cols) {
        __syncthreads();    // the previous slice's reads are done
        v1_stage_weights(w_e, b, de, h, col0, we_t, b_s);
        __syncthreads();

        // the slice of d_op: routed g where the slot counts, else 0
        const int col = col0 + tx;
        for (int s = ty * kV1Slots; s < te;
             s += (kThreads / kV1Cols) * kV1Slots) {
            int r[kV1Slots];
            float add[kV1Slots];
            bool any = false;
#pragma unroll
            for (int j = 0; j < kV1Slots; ++j) {
                r[j] = col < h ? rc_s[s + j] : -1;
                any |= r[j] >= 0;
                const size_t row = static_cast<size_t>(snd_s[s + j]) * h;
                add[j] = r[j] >= 0 ? __ldg(y_s + row + col) : 0.0f;
            }
            float v[kV1Slots] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (any) {
                float op[kV1Slots];
                v1_operands(add, eT + s, ldt, we_t + tx * (de + 1), de,
                            b_s[tx], op);
#pragma unroll
                for (int j = 0; j < kV1Slots; ++j) {
                    if (r[j] < 0) continue;
                    const size_t idx = static_cast<size_t>(r[j]) * h + col;
                    const float in = __ldg(inner_z + idx);
                    if (fabsf(op[j] - in) <= 1e-5f * fabsf(in) + 1e-5f) {
                        v[j] = __ldg(g_pass + idx);
                    }
                }
            }
            *reinterpret_cast<float4*>(dopT + tx * ldt + s) =
                make_float4(v[0], v[1], v[2], v[3]);
            if (col < h) {
#pragma unroll
                for (int j = 0; j < kV1Slots; ++j) {
                    d_op[(slot0 + s + j) * h + col] = v[j];
                }
            }
        }
        __syncthreads();

        // d_e[s][k] += the slice's d_op[s] . W_e[k], columns ascending
#pragma unroll
        for (int it = 0; it < kMaxItems; ++it) {
            const int i = tid + it * kThreads;
            if (i < groups * de) {
                const int g = i % groups, k = i / groups;
                float4 a = de_acc[it];
                for (int c = 0; c < kV1Cols; ++c) {
                    const float4 d4 = *reinterpret_cast<const float4*>(
                        dopT + c * ldt + g * 4);
                    const float w = we_t[c * (de + 1) + k];
                    a.x = fmaf(d4.x, w, a.x);
                    a.y = fmaf(d4.y, w, a.y);
                    a.z = fmaf(d4.z, w, a.z);
                    a.w = fmaf(d4.w, w, a.w);
                }
                de_acc[it] = a;
            }
        }
        // the tile's partial of [e_t | 1]^T @ d_op for the slice, slots
        // ascending: rows k < de are dW_e's, row de is d_b's
        for (int i = tid; i < (ldr / 4) * kV1Cols; i += blockDim.x) {
            const int c = i % kV1Cols, k0 = (i / kV1Cols) * 4;
            float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int s = 0; s < te; s += 4) {
                const float4 d4 =
                    *reinterpret_cast<const float4*>(dopT + c * ldt + s);
                const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float4 e4 = *reinterpret_cast<const float4*>(
                        eR + (s + j) * ldr + k0);
                    a[0] = fmaf(e4.x, dv[j], a[0]);
                    a[1] = fmaf(e4.y, dv[j], a[1]);
                    a[2] = fmaf(e4.z, dv[j], a[2]);
                    a[3] = fmaf(e4.w, dv[j], a[3]);
                }
            }
            if (col0 + c >= h) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (k0 + q <= de) {
                    part[(static_cast<size_t>(t) * (de + 1) + k0 + q) * h +
                         col0 + c] = a[q];
                }
            }
        }
    }
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
        const int i = tid + it * kThreads;
        if (i < groups * de) {
            const int g = i % groups, k = i / groups;
            const float dv[4] = {de_acc[it].x, de_acc[it].y, de_acc[it].z,
                                 de_acc[it].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                d_e[(slot0 + g * 4 + j) * de + k] = dv[j];
            }
        }
    }
}

// dW_e [de, h] and d_b [h]: the sum of the tiles' partials in tile order,
// one thread per output.
__global__ void hoisted_bwd_v1_reduce_kernel(const float* __restrict__ part,
                                             int num_tiles, int de, int h,
                                             float* __restrict__ dw_e,
                                             float* __restrict__ d_b) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (de + 1) * h) return;
    const int k = i / h, c = i % h;
    float acc = 0.0f;
    for (int t = 0; t < num_tiles; ++t) {
        acc += part[(static_cast<size_t>(t) * (de + 1) + k) * h + c];
    }
    if (k < de) {
        dw_e[i] = acc;
    } else {
        d_b[c] = acc;
    }
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs, in bytes: d_op's slice transposed, the
// tile's edge rows k-major and row-major, the W_e and b slices, receivers
// and senders.
size_t hoisted_bwd_v1_smem_bytes(int de, int edge_tile) {
    const size_t te = static_cast<size_t>(edge_tile);
    const size_t ldt = v1_slot_ld(edge_tile);
    return sizeof(float) * ((kV1Cols + de) * ldt + te * v1_edge_ld(de) +
                            static_cast<size_t>(kV1Cols) * (de + 1) +
                            kV1Cols) +
           sizeof(int) * 2 * te;
}

// The d_e entries pass 1 can hold in registers: edge_tile / 4 x de of them.
int hoisted_bwd_v1_max_entries() { return kMaxItems * kThreads; }

// Launches both passes on `stream`; returns the first cudaError_t. The
// caller checks shapes, types and contiguity, edge_tile a multiple of 4
// and edge_tile / 4 x de at most hoisted_bwd_v1_max_entries(). Scratch: part
// [num_tiles, de + 1, h] float32.
int hoisted_bwd_v1(const void* y_s, const void* e_t, const void* w_e,
                   const void* b, const void* senders, const void* recv,
                   const void* tile_blocks, const void* inner_z,
                   const void* g_pass, void* d_op, void* d_e, void* part,
                   void* dw_e, void* d_b, int n_y, int de, int h,
                   int num_tiles, int num_nodes, int node_block,
                   int edge_tile, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = hoisted_bwd_v1_smem_bytes(de, edge_tile);
    cudaError_t err = cudaFuncSetAttribute(
        hoisted_bwd_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    hoisted_bwd_v1_kernel<<<num_tiles, kThreads, smem, st>>>(
        static_cast<const float*>(y_s), static_cast<const float*>(e_t),
        static_cast<const float*>(w_e), static_cast<const float*>(b),
        static_cast<const int32_t*>(senders),
        static_cast<const int32_t*>(recv),
        static_cast<const int32_t*>(tile_blocks),
        static_cast<const float*>(inner_z),
        static_cast<const float*>(g_pass), static_cast<float*>(d_op),
        static_cast<float*>(d_e), static_cast<float*>(part), n_y, de, h,
        num_nodes, node_block, edge_tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int outputs = (de + 1) * h;
    hoisted_bwd_v1_reduce_kernel<<<(outputs + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(part), num_tiles, de, h,
        static_cast<float*>(dw_e), static_cast<float*>(d_b));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
