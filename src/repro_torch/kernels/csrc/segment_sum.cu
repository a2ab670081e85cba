// Bucketed segment-sum, for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_sum/segment_sum.py::segment_sum_bucketed
// which computes, per node bucket i, onehot(local_ids[i])^T @ data[i]:
// data [NB, ME, D] f32 holds each bucket's (padded) edge features,
// local_ids [NB, ME] int32 their destination offsets in [0, block_n), -1 for
// padding, and out [NB, block_n, D] f32 the per-destination sums.
//
// The one-hot product was the TPU's way to a scatter on its matrix unit;
// Hopper has no such reason, so the kernel sums each output row directly.
// The host bucketing (ops.py::bucket_edges) sorts edges stably by
// destination, so inside a bucket the valid entries come first with
// non-decreasing local ids, in input order, followed by the -1 padding.  A
// row r's edges are therefore the contiguous run [lower_bound(r),
// lower_bound(r+1)) of the predicate "id < 0 or id >= r", found by binary
// search; the thread for (r, feature) adds them one at a time in that
// order, which fixes the float summation order.
//
// Bound: bytes.  The data it needs are the valid entries (E·D floats), the
// row boundaries of local_ids and the output (NB·block_n·D floats); one add
// per valid entry.  Design: one thread block per bucket, one thread per
// (row, feature) pair; padding entries are never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int lower_bound(const int32_t* ids, int n, int r) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t v = ids[mid];
    if (v < 0 || v >= r) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void segment_sum_bucketed_kernel(const float* __restrict__ data,
                                            const int32_t* __restrict__ ids,
                                            float* __restrict__ out,
                                            int ME, int D, int block_n) {
  const int64_t bucket = blockIdx.x;
  const int32_t* lid = ids + bucket * ME;
  const float* x = data + bucket * ME * D;
  float* y = out + bucket * block_n * D;
  for (int t = threadIdx.x; t < block_n * D; t += blockDim.x) {
    const int r = t / D;
    const int f = t - r * D;
    const int lo = lower_bound(lid, ME, r);
    const int hi = lower_bound(lid, ME, r + 1);
    float acc = 0.0f;
    for (int e = lo; e < hi; ++e) acc = __fadd_rn(acc, x[(int64_t)e * D + f]);
    y[t] = acc;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// data [NB, ME, D] f32, local_ids [NB, ME] int32, out [NB, block_n, D] f32.
int segment_sum_bucketed_launch(const void* data, const void* local_ids,
                                void* out, int NB, int ME, int D, int block_n,
                                void* stream) {
  if (NB > 0) {
    segment_sum_bucketed_kernel<<<NB, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int32_t*)local_ids, (float*)out, ME, D,
        block_n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
