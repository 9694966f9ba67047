// Segment sum over segment-sorted rows (B3): the deterministic landings of
// the CSR backward (its d_x and the sender sums that make dW_s), of the
// dense backward's overflow d_x under ovf_ssum, and of the v1 backward's
// d_y_s.
//
// Replaces the TPU kernel radargnn_tpu/ops/pallas_kernels.py:
// _segsum_kernel (:854, reached through pallas_segment_sum_csr) on Hopper
// (sm_90a).
//
// What it computes. Rows are numbered across two sources: row i is a[i]
// (bf16 or f32) for i < n_a, else b[i - n_a] (f32); both have `pitch`
// columns. `order` lists the rows to sum, grouped by segment, and segment
// n owns order[row_ptr[n] .. row_ptr[n+1]):
//   out[n][:width] = sum over those rows' first `width` columns, in f32,
//                    in the order listed (0 for an empty segment);
//   out[n][width:pitch] = 0.
// So the CSR backward sums H columns of its hp-wide bf16(d_op) rows and
// hands dW_s's pass sums whose padding columns are zero, as they were when
// the padding (zero in d_op) was summed.
//
// What bounds it on the card. Bytes, in principle: each listed row's
// `width` columns and its index read once, the f32 output written once,
// one add per element read. At the CSR path's five layer shapes that is
// 0.336 ms a step for the d_op sums at H and 0.162 for d_x (281,600 rows
// over 14,080 senders, 20 each); under ovf_ssum (14,424 rows, 77 % of the
// 14,080 segments empty, at most 19 rows) 0.022, mostly the N x d zero
// rows. In practice a segment is a short chain of dependent loads
// (row_ptr, then its indices, then its rows), so what holds it is how many
// rows are in flight across the SM: the design this one replaces (one warp
// a segment, 8 columns a lane, a row's index then the row, one row at a
// time) kept one 16-byte load in flight a lane and read the d_op rows'
// padding columns; at d <= 144 up to three quarters of its lanes had no
// columns (PERF.md: benchmarks/segsum_sites.py --phases).
//
// Design. A segment's width / 8 chunks of 8 columns (16-byte bf16 loads)
// are owned by as many consecutive threads, one chunk a thread, packed
// with no idle lanes: a warp lands 4 segments at d = 64 and 2 at 128, and
// a segment spans warps at d = 144 (18 lanes), 272 (34) and 464 (58)
// (power-of-two groups, 32 lanes at 144 and 64 at 272, ran 4 % slower
// there; PERF.md). Each
// thread sums its columns over all of the segment's rows, kRows at a time:
// the kRows rows' loads are issued together, the next kRows indices are
// read while they are in flight, then the rows are added in listed order.
// A thread keeps to 64 registers, so 32 warps an SM overlap their chains
// (16 rows in flight a lane and 16 warps an SM ran slower than the old
// design; PERF.md). No segment's rows are split, no atomics: each column's
// sum is bitwise a sequential f32 sum in listed order, and every run gives
// the same bits. A segment's lanes read an index at one address (one
// transaction, no shuffles: the segments sharing a warp run their own trip
// counts). An empty segment reads row_ptr and writes its zero row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// at most 64 registers a thread, so that 32 warps an SM are resident: a
// segment is a short chain of dependent loads (row_ptr, its indices, its
// rows), and resident warps are what overlaps those chains
constexpr int kMinBlocks = 4;
// rows in flight a lane: 4 bf16 rows (a 16-byte load each) or 2 f32 rows
// (two each); twice as many spend registers that cost more resident warps
// than the rows in flight gain (PERF.md)
constexpr int kRowsBf16 = 4;
constexpr int kRowsF32 = 2;

// 8 columns of one row as loaded: bf16 in lo; f32 in lo and hi
struct Chunk {
    uint4 lo, hi;
};

template <bool kBf16, bool kHasB>
__device__ __forceinline__ void load_row(const void* __restrict__ a,
                                         long long n_a,
                                         const float* __restrict__ b, int i,
                                         int pitch, int c, Chunk& r) {
    if (!kHasB || i < n_a) {
        if (kBf16) {
            r.lo = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(a)
                + static_cast<long long>(i) * pitch + c * 8));
        } else {
            const uint4* p = reinterpret_cast<const uint4*>(
                static_cast<const float*>(a)
                + static_cast<long long>(i) * pitch + c * 8);
            r.lo = __ldg(p);
            r.hi = __ldg(p + 1);
        }
    } else {
        const uint4* p = reinterpret_cast<const uint4*>(
            b + (i - n_a) * pitch + c * 8);
        r.lo = __ldg(p);
        r.hi = __ldg(p + 1);
    }
}

__device__ __forceinline__ void add_f32(float* acc, const uint4& v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
}

template <bool kBf16>
__device__ __forceinline__ void add_row(float* acc, const Chunk& r,
                                        bool f32_row) {
    if (kBf16 && !f32_row) {
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&r.lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            acc[2 * e] += f.x;
            acc[2 * e + 1] += f.y;
        }
    } else {
        add_f32(acc, r.lo);
        add_f32(acc + 4, r.hi);
    }
}

// `lanes` consecutive threads own one segment, one 8-column chunk each
// (width / 8 of them, at least 1).
template <int kRows, bool kBf16, bool kHasB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    segment_sum_csr_kernel(const void* __restrict__ a, long long n_a,
                           const float* __restrict__ b,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ row_ptr,
                           float* __restrict__ out, int n_seg, int width,
                           int pitch, int lanes) {
    const long long t =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long seg = t / lanes;
    if (seg >= n_seg) return;
    const int c = static_cast<int>(t - seg * lanes);
    const int n_chunks = width >> 3;
    float* dst = out + seg * pitch;
    // the columns past width, shared out over the segment's lanes
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int z = n_chunks + c; z < (pitch >> 3); z += lanes) {
        float4* p = reinterpret_cast<float4*>(dst + z * 8);
        p[0] = zero;
        p[1] = zero;
    }
    if (c >= n_chunks) return;
    const int begin = __ldg(row_ptr + seg), end = __ldg(row_ptr + seg + 1);
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    int nxt[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
        nxt[u] = begin + u < end ? order[begin + u] : 0;
    for (int e = begin; e < end; e += kRows) {
        int idx[kRows];
        Chunk raw[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) idx[u] = nxt[u];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            if (e + u < end)
                load_row<kBf16, kHasB>(a, n_a, b, idx[u], pitch, c, raw[u]);
        }
        // the next rows' indices while these rows are in flight
#pragma unroll
        for (int u = 0; u < kRows; ++u)
            nxt[u] = e + kRows + u < end ? order[e + kRows + u] : 0;
        // the adds in listed order
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            if (e + u < end)
                add_row<kBf16>(acc, raw[u], kHasB && idx[u] >= n_a);
        }
    }
    float4* p = reinterpret_cast<float4*>(dst + c * 8);
    p[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    p[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <bool kBf16, bool kHasB>
void launch(const void* a, long long n_a, const float* b,
            const int32_t* order, const int32_t* row_ptr, float* out,
            int n_seg, int width, int pitch, cudaStream_t stream) {
    constexpr int kRows = kBf16 && !kHasB ? kRowsBf16 : kRowsF32;
    const int lanes = width >= 8 ? width / 8 : 1;
    const long long threads = static_cast<long long>(n_seg) * lanes;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    segment_sum_csr_kernel<kRows, kBf16, kHasB>
        <<<blocks, kThreads, 0, stream>>>(a, n_a, b, order, row_ptr, out,
                                          n_seg, width, pitch, lanes);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// The caller checks shapes, types and alignment: width <= pitch, both
// multiples of 8; 16-byte aligned a, b and out; b may be null when every
// row is in a.
int segment_sum_csr(const void* a, int a_bf16, long long n_a, const void* b,
                    const void* order, const void* row_ptr, void* out,
                    int n_seg, int width, int pitch, void* stream) {
    if (n_seg > 0) {
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        const auto* ord = static_cast<const int32_t*>(order);
        const auto* ptr = static_cast<const int32_t*>(row_ptr);
        const auto* bf = static_cast<const float*>(b);
        auto* o = static_cast<float*>(out);
        if (a_bf16 && b != nullptr) {
            launch<true, true>(a, n_a, bf, ord, ptr, o, n_seg, width, pitch,
                               st);
        } else if (a_bf16) {
            launch<true, false>(a, n_a, bf, ord, ptr, o, n_seg, width, pitch,
                                st);
        } else if (b != nullptr) {
            launch<false, true>(a, n_a, bf, ord, ptr, o, n_seg, width, pitch,
                                st);
        } else {
            launch<false, false>(a, n_a, bf, ord, ptr, o, n_seg, width,
                                 pitch, st);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
