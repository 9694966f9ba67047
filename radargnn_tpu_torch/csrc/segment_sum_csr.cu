// Segment sum over segment-sorted rows: the deterministic landing of the
// dense backward's d_x.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _segsum_kernel (reached through pallas_segment_sum_csr) on Hopper
// (sm_90a).
//
// What it computes. Rows are numbered across two sources: row i is a[i]
// (bf16 or f32) for i < n_a, else b[i - n_a] (f32). `order` lists the rows
// to sum, grouped by segment, and segment n owns
// order[row_ptr[n] .. row_ptr[n+1]):
//   out[n] = sum over those rows, in f32, in the order listed
//   (0 for an empty segment).
// The dense backward lands its per-slot d_xg (bf16, source a) and the
// overflow rows' d_op_o @ W_s^T (f32, source b) at their senders in one
// launch; the batch builds the sender-sorted order once (graph/batch.py).
//
// Design. The TPU kernel lands a segment-sorted tile into its node block
// with a one-hot matmul and carries the block's sum across grid steps.
// Here one warp owns one segment: each lane owns 8 columns (16-byte bf16
// or 2 x 16-byte f32 loads), walks the segment's rows in order and keeps
// the sums in registers. No atomics, so the result is bitwise the same on
// every run.
//
// What bounds it on the card: bytes. It reads each listed row once and
// writes N x d f32; it does one add per element read. At the flagship's
// wide layer (~281,600 rows of 224 bf16, N = 14,080) that is ~139 MB,
// ~41 us at 3.35 TB/s. The rows of a segment are scattered, so each warp
// reads whole rows (448 bytes) at random addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void add_bf16x8(float* acc, const uint4& v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        acc[2 * e] += f.x;
        acc[2 * e + 1] += f.y;
    }
}

__device__ __forceinline__ void add_f32x8(float* acc, const float* src) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    const float4 w = *reinterpret_cast<const float4*>(src + 4);
    acc[0] += u.x; acc[1] += u.y; acc[2] += u.z; acc[3] += u.w;
    acc[4] += w.x; acc[5] += w.y; acc[6] += w.z; acc[7] += w.w;
}

__global__ void __launch_bounds__(256) segment_sum_csr_kernel(
    const void* __restrict__ a, int a_bf16, long long n_a,
    const float* __restrict__ b, const int32_t* __restrict__ order,
    const int32_t* __restrict__ row_ptr, float* __restrict__ out,
    int n_seg, int d) {
    const int seg = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (seg >= n_seg) return;
    const int begin = row_ptr[seg], end = row_ptr[seg + 1];
    for (int c = lane; c < d / 8; c += 32) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int e = begin; e < end; ++e) {
            const long long i = order[e];
            if (i < n_a) {
                if (a_bf16) {
                    add_bf16x8(acc, *reinterpret_cast<const uint4*>(
                        static_cast<const __nv_bfloat16*>(a) + i * d + c * 8));
                } else {
                    add_f32x8(acc, static_cast<const float*>(a) + i * d + c * 8);
                }
            } else {
                add_f32x8(acc, b + (i - n_a) * d + c * 8);
            }
        }
        float* dst = out + static_cast<size_t>(seg) * d + c * 8;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: d a multiple of 8,
// 16-byte aligned a, b and out; b may be null when every row is in a.
int segment_sum_csr(const void* a, int a_bf16, long long n_a, const void* b,
                    const void* order, const void* row_ptr, void* out,
                    int n_seg, int d, void* stream) {
    const int warps_per_block = 8;
    const int blocks = (n_seg + warps_per_block - 1) / warps_per_block;
    if (blocks > 0) {
        segment_sum_csr_kernel<<<blocks, warps_per_block * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            a, a_bf16, n_a, static_cast<const float*>(b),
            static_cast<const int32_t*>(order),
            static_cast<const int32_t*>(row_ptr), static_cast<float*>(out),
            n_seg, d);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
