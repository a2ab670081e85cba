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
// destination, so inside a bucket the valid entries are a prefix with
// non-decreasing local ids, in input order, followed by the -1 padding.
// Each output (row, feature) adds its row's entries one at a time in that
// order, from 0.0, with __fadd_rn: bit for bit the plain version's sum.
//
// Bound: bytes.  The data it needs are the valid entries (E·D floats and E
// ids) and the output (NB·block_n·D floats); one add per valid entry.  At
// the degree feed (NB 4,691, ME 662, D 1, 1.4 M edges) a bucket holds about
// 300 entries, 2.4 KB: the work of a bucket is a few hundred adds, so what
// costs is the latency of its dependent round trips and every instruction
// that is not an add.  Design: one warp per bucket, so that the whole
// feed's buckets are resident at once (kWarps a block) and no block
// barrier is needed; where the longest bucket (ME) exceeds kWarpMaxME, as
// in a feed with hub nodes, one block per bucket, so that a long bucket's
// ids are walked by kWarps warps at once and its rows summed by kWarps·32
// threads.  Two passes:
//
//   1. row starts: each warp loads its slice of the bucket's ids,
//      kIdChunks·32 a round (coalesced, all in flight together), and stops
//      at the round that holds the first -1.  Entry e opens rows
//      id[e-1]+1 .. id[e] (the previous id from the neighbouring lane by a
//      shuffle); the warp that meets the first -1 (or the bucket's end)
//      sets every row past the last id to start at n, the valid count, so
//      an empty row's run is empty.  No binary search and no per-row
//      global load;
//   2. sums: the bucket's threads stage the n·D floats of data into shared
//      memory, kStageLoads coalesced loads a thread in flight (padding data
//      is never read), and each thread sums its (row, feature) outputs'
//      runs from there, in order.
//
// A bucket longer than one tile is staged tile by tile; each thread
// carries its outputs' partial sums across tiles through the output itself
// (it alone reads and writes them), so the order stays input order and a
// hub bucket of any length works.  Tensor cores and TMA have nothing to do
// here: there is no product, and a tile is a few KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;             // warps a block
constexpr int kIdChunks = 8;          // 32-id chunks a lane loads a round
constexpr int kStageLoads = 8;        // data loads a thread has in flight
constexpr int kWarpMaxME = 1024;      // buckets up to this long: a warp each
constexpr int kWarpTile = 1024;       // data floats a warp stages at once
constexpr int kBlockTile = 4096;      // data floats a block stages at once

// G warps sum one bucket: 1 (a warp a bucket, kWarps buckets a block) or
// kWarps (a block a bucket, for long buckets).
template <int G>
__device__ __forceinline__ void group_sync() {
  if (G == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Grid (ceil(NB · G / kWarps)); dynamic shared memory per bucket: row
// starts [block_n + 1] then data [tile].
template <int G>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_bucketed_kernel(const float* __restrict__ data,
                            const int32_t* __restrict__ ids,
                            float* __restrict__ out, int NB, int ME, int D,
                            int block_n, int tile) {
  constexpr int kGroups = kWarps / G;   // buckets a block
  constexpr int kGT = 32 * G;           // threads a bucket
  extern __shared__ int32_t smem[];
  __shared__ int n_s[kGroups];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = warp / G;              // this bucket's group in the block
  const int wg = warp % G;              // this warp in the group
  const int gt = wg * 32 + lane;        // this thread in the group
  const int64_t bucket = (int64_t)blockIdx.x * kGroups + gi;
  if (bucket >= NB) return;
  int32_t* start = smem + gi * (block_n + 1 + tile);
  float* xs = reinterpret_cast<float*>(start + block_n + 1);
  const int32_t* lid = ids + bucket * ME;
  const float* x = data + bucket * (int64_t)ME * D;
  float* y = out + bucket * (int64_t)block_n * D;

  // 1. row starts.  Each warp walks its slice [lo, hi) of the entries; the
  // warp that meets the first -1 (or the end, ME) writes n and the rows
  // past the last id.
  const int slice = (ME + G - 1) / G;
  const int lo = wg * slice;
  const int hi = min(ME, lo + slice);
  int prev = lo > 0 && lo < ME ? __ldg(lid + lo - 1) : -1;
  // a slice that starts after the first -1 holds nothing
  if (lo < ME && (lo == 0 || prev >= 0)) {
    for (int e0 = lo;; e0 += 32 * kIdChunks) {
      int v[kIdChunks];
#pragma unroll
      for (int j = 0; j < kIdChunks; ++j) {
        const int e = e0 + 32 * j + lane;
        v[j] = e < hi ? __ldg(lid + e) : -1;
      }
      bool done = false;
#pragma unroll
      for (int j = 0; j < kIdChunks; ++j) {
        const int e = e0 + 32 * j + lane;
        const unsigned pad = __ballot_sync(kFull, v[j] < 0);
        int p = __shfl_up_sync(kFull, v[j], 1);
        if (lane == 0) p = prev;
        const int first = pad ? __ffs(pad) - 1 : 32;
        if (lane < first) {
          const int c = min(v[j], block_n);
          for (int r = p + 1; r <= c; ++r) start[r] = e;
        }
        const int before = __shfl_sync(kFull, v[j], (first + 31) & 31);
        if (pad) {
          const int n = e0 + 32 * j + first;
          if (n < hi || hi == ME) {     // a -1, or the bucket's end
            const int last = min(first ? before : prev, block_n);
            for (int r = last + 1 + lane; r <= block_n; r += 32) start[r] = n;
            if (lane == 0) n_s[gi] = n;
          }
          done = true;
          break;
        }
        prev = __shfl_sync(kFull, v[j], 31);
      }
      if (done) break;
    }
  }
  group_sync<G>();
  const int n = ME > 0 ? n_s[gi] : 0;

  // 2. sums, tile by tile of staged data
  const int pairs = block_n * D;
  const int T = tile / D;      // entries a tile
  if (n == 0) {
    for (int t = gt; t < pairs; t += kGT) y[t] = 0.0f;
  }
  for (int t0 = 0; t0 < n; t0 += T) {
    const int len = min(T, n - t0);
    const float* xt = x + (int64_t)t0 * D;
    for (int i0 = gt; i0 < len * D; i0 += kGT * kStageLoads) {
      float q[kStageLoads];
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int i = i0 + kGT * j;
        q[j] = i < len * D ? __ldg(xt + i) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int i = i0 + kGT * j;
        if (i < len * D) xs[i] = q[j];
      }
    }
    group_sync<G>();
    for (int t = gt; t < pairs; t += kGT) {
      const int r = D == 1 ? t : t / D;
      const int f = t - r * D;
      const int a = max(start[r], t0);
      const int b = min(start[r + 1], t0 + len);
      if (t0 > 0 && a >= b) continue;
      float acc = t0 == 0 ? 0.0f : y[t];
      for (int e = a; e < b; ++e) acc = __fadd_rn(acc, xs[(e - t0) * D + f]);
      y[t] = acc;
    }
    group_sync<G>();    // before the next tile overwrites xs
  }
}

template <int G>
int launch(const void* data, const void* local_ids, void* out, int NB,
           int ME, int D, int block_n, int tile_floats, cudaStream_t stream) {
  const int tile = D > tile_floats ? D : tile_floats;
  const size_t smem = sizeof(int32_t) * (kWarps / G) *
                      ((size_t)block_n + 1 + tile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_sum_bucketed_kernel<G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = kWarps / G;
  const unsigned grid = (unsigned)((NB + groups - 1) / groups);
  segment_sum_bucketed_kernel<G><<<grid, kWarps * 32, smem, stream>>>(
      (const float*)data, (const int32_t*)local_ids, (float*)out, NB, ME, D,
      block_n, tile);
  return (int)cudaGetLastError();
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
  if (NB <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  return ME <= kWarpMaxME
             ? launch<1>(data, local_ids, out, NB, ME, D, block_n, kWarpTile,
                         s)
             : launch<kWarps>(data, local_ids, out, NB, ME, D, block_n,
                              kBlockTile, s);
}

}  // extern "C"
