// Delta-chain application over packed membership bitmaps, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/delta_apply/delta_apply.py::delta_apply_chain_pallas
//     (and its jax.vmap batched form, kernels/delta_apply/ops.py)
//       -> delta_apply_chain_kernel
//   * src/repro/kernels/delta_apply/delta_apply.py::delta_apply_fused_pallas
//       -> delta_apply_fused_kernel
//
// Both compute m_0 = base, m_i = (m_{i-1} & ~del_i) | add_i, out = m_K over
// 32-bit words (the host hands int32 views of uint32 words; only bitwise
// operations touch them, so signedness does not matter).
//
// Bound: bytes.  The chain reads (K+1)·W words and writes W words per batch
// row, one or two bitwise operations per word read; the fused kernel adds
// accw (W floats), pop (one int per group), the optional weights (32·W
// floats) and the optional live indicator (32·W floats).
//
// delta_apply_chain_kernel: each thread owns one word and loops K in
// registers, so every input word is read once with coalesced 32-bit loads
// and every output written once; the batch is the grid's y axis.  The
// ragged edge (W not a multiple of the block) is masked here: a word past
// W is the all-zero identity, so no host-side padding copy is needed.
//
// delta_apply_fused_kernel is a one-pass stream whose output is mostly the
// live indicator (128 bytes per word), so its design is about filling the
// card and keeping bytes in flight:
//   * one launch lands both planes of a singlepoint retrieval, the node
//     plane (with per-slot weights) and the edge plane (same B and K,
//     different W), the node plane's groups first;
//   * the TPU kernel's grid step, one block_w-word group, is no longer one
//     block: at W = 43,737 that gave 43 blocks for 132 SMs.  A group is a
//     thread block cluster of up to kMaxCluster blocks, each landing one
//     kThreads-word tile at a time, one word a thread; each thread issues
//     its word's weight loads and every add and del load (unrolled for K
//     <= kMaxUnroll, in groups of kMaxUnroll above; streaming hints on the
//     read-once words) before the fold;
//   * pop[g], the popcount of the group, is reduced in the block, then
//     across the cluster through distributed shared memory by rank 0,
//     which writes it: no atomics, and no zeroing pass before the launch.
//     The blocks keep their counts of up to kFlush groups in shared memory,
//     so that the cluster meets at a barrier once every kFlush groups;
//   * the clusters stride over the groups of both planes, as many as fit
//     on the card at once;
//   * the tile's landed words go through shared memory so that the live
//     indicator (32 floats a word) leaves in coalesced 16-byte stores.
// TMA and wgmma have nothing to do here: there is no product, and
// coalesced loads and stores already reach the byte bound of one pass.
//
// accw[w] sums bit_j * weight[32w+j] for j = 0..31 one term at a time, in
// that order, with an explicit product (a non-finite weight propagates as
// in the reference; 0 * inf = nan), so the partials are bit-identical to
// the reference's.  __fmul_rn/__fadd_rn keep nvcc from contracting the
// pair into an FMA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void delta_apply_chain_kernel(const int32_t* __restrict__ base,
                                         const int32_t* __restrict__ adds,
                                         const int32_t* __restrict__ dels,
                                         int32_t* __restrict__ out,
                                         int K, int64_t W) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t b = blockIdx.y;
  const int32_t* a = adds + b * K * W + w;
  const int32_t* d = dels + b * K * W + w;
  int32_t m = base[b * W + w];
  for (int k = 0; k < K; ++k) {
    m = (m & ~d[(int64_t)k * W]) | a[(int64_t)k * W];
  }
  out[b * W + w] = m;
}

// ---------------------------------------------------------------------------
// fused chain + analytics
// ---------------------------------------------------------------------------

constexpr int kMaxUnroll = 8;    // K steps whose loads go together
constexpr int kMaxCluster = 8;   // blocks a group's cluster (portable size)
constexpr int kFlush = 64;       // groups between two writes of pop

struct FusedPlane {
  const int32_t* base;     // [B, W]
  const int32_t* adds;     // [B, K, W]
  const int32_t* dels;     // [B, K, W]
  const float* weights;    // [32·W], shared by the batch, or null
  int32_t* mask;           // [B, W]
  int32_t* pop;            // [B, G]
  float* accw;             // [B, W]
  float* live;             // [B, 32·W] or null
  int64_t W;
  int64_t G;               // ceil(W / block_w)
};

// Steps k0 .. k0 + n - 1 of word w in row b (n <= kMaxUnroll; N is n when
// it is known at compile time): every load first, then the fold.
template <int N>
__device__ __forceinline__ uint32_t fused_steps(uint32_t m, const FusedPlane& P,
                                                int64_t b, int K, int k0,
                                                int n, int64_t w) {
  uint32_t a[kMaxUnroll], d[kMaxUnroll];
#pragma unroll
  for (int i = 0; i < kMaxUnroll; ++i) {
    if (N >= 0 ? i < N : i < n) {
      const int64_t off = (b * K + k0 + i) * P.W + w;
      a[i] = (uint32_t)__ldcs(P.adds + off);
      d[i] = (uint32_t)__ldcs(P.dels + off);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxUnroll; ++i) {
    if (N >= 0 ? i < N : i < n) m = (m & ~d[i]) | a[i];
  }
  return m;
}

// One tile: words w0 .. w0 + valid - 1 (valid <= kThreads) of row b of
// plane P, one a thread; returns the thread's popcount.  KU is K when K <=
// kMaxUnroll, else -1 (groups of kMaxUnroll steps).
template <int KU>
__device__ __forceinline__ int fused_tile(const FusedPlane& P, int64_t b,
                                          int K, int64_t w0, int valid,
                                          uint32_t* words) {
  const int64_t W = P.W;
  const int64_t w = w0 + threadIdx.x;
  uint32_t m = 0;
  if ((int)threadIdx.x < valid) {
    float4 wt[8];
    if (P.weights != nullptr) {
      // padded by the host to 32·W floats, 16-byte aligned
      const float4* wp = reinterpret_cast<const float4*>(P.weights + w * 32);
#pragma unroll
      for (int q = 0; q < 8; ++q) wt[q] = __ldg(wp + q);
    }
    m = (uint32_t)__ldcs(P.base + b * W + w);
    if (KU >= 0) {
      m = fused_steps<KU>(m, P, b, K, 0, KU, w);
    } else {
      for (int k0 = 0; k0 < K; k0 += kMaxUnroll) {
        m = fused_steps<-1>(m, P, b, K, k0, min(kMaxUnroll, K - k0), w);
      }
    }
    P.mask[b * W + w] = (int32_t)m;
    float acc;
    if (P.weights != nullptr) {
      acc = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float c[4] = {wt[q].x, wt[q].y, wt[q].z, wt[q].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bit = (float)((m >> (4 * q + r)) & 1u);
          acc = __fadd_rn(acc, __fmul_rn(bit, c[r]));
        }
      }
    } else {
      acc = (float)__popc(m);
    }
    P.accw[b * W + w] = acc;
  }
  if (P.live != nullptr) {
    words[threadIdx.x] = m;
    __syncthreads();
    // quad q of the tile covers bits 4(q%8)..4(q%8)+3 of word q/8
    float4* out = reinterpret_cast<float4*>(P.live + (b * W + w0) * 32);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q < valid * 8) {
        const uint32_t v = words[q >> 3] >> (4 * (q & 7));
        out[q] = make_float4((float)(v & 1u), (float)((v >> 1) & 1u),
                             (float)((v >> 2) & 1u), (float)((v >> 3) & 1u));
      }
    }
    __syncthreads();    // before the next tile overwrites words
  }
  return __popc(m);
}

// This block's share of group g of row b of plane P: tiles r, r + C, ...
// of the group for block rank r; returns the block's popcount of them (in
// thread 0).  warp_pop is one of two slots, used in turn, so that a warp
// writing the next group's counts never meets thread 0 still reading.
template <int KU>
__device__ __forceinline__ int fused_group(const FusedPlane& P, int64_t b,
                                           int64_t g, int K, int block_w,
                                           int rank, int C, uint32_t* words,
                                           int* warp_pop) {
  const int64_t end = (g + 1) * block_w < P.W ? (g + 1) * block_w : P.W;
  int count = 0;
  for (int64_t w0 = g * block_w + (int64_t)rank * kThreads; w0 < end;
       w0 += (int64_t)C * kThreads) {
    const int valid = end - w0 < kThreads ? (int)(end - w0) : kThreads;
    count += fused_tile<KU>(P, b, K, w0, valid, words);
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if ((threadIdx.x & 31) == 0) warp_pop[threadIdx.x >> 5] = count;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) total += warp_pop[i];
  }
  return total;
}

// Clusters of C blocks stride over the groups of both planes: group q <
// B·p0.G is plane 0's (row q / G), the rest plane 1's.  Each block keeps
// its popcount of each group in counts; every kFlush groups, and after
// the last, rank 0 sums the ranks' counts through distributed shared
// memory and writes pop (two cluster barriers a flush, not a group).
template <int KU>
__global__ void __launch_bounds__(kThreads, 1)
delta_apply_fused_kernel(FusedPlane p0, FusedPlane p1, int B, int K,
                         int block_w) {
  __shared__ uint32_t words[kThreads];
  __shared__ int warp_pop[2][kThreads / 32];
  __shared__ int counts[kFlush];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t clusters = gridDim.x / C;
  const int64_t n0 = (int64_t)B * p0.G;
  const int64_t total = n0 + (int64_t)B * p1.G;
  int it = 0;
  for (int64_t q = blockIdx.x / C; q < total; q += clusters, ++it) {
    const int slot = it % kFlush;
    const int count =
        q < n0 ? fused_group<KU>(p0, q / p0.G, q % p0.G, K, block_w, rank, C,
                                 words, warp_pop[it & 1])
               : fused_group<KU>(p1, (q - n0) / p1.G, (q - n0) % p1.G, K,
                                 block_w, rank, C, words, warp_pop[it & 1]);
    if (threadIdx.x == 0) counts[slot] = count;
    if (slot == kFlush - 1 || q + clusters >= total) {
      cluster.sync();
      // thread k of rank 0 writes the pop of the flush's k-th group
      if (rank == 0 && (int)threadIdx.x <= slot) {
        int sum = 0;
        for (int r = 0; r < C; ++r) {
          sum += cluster.map_shared_rank(counts, r)[threadIdx.x];
        }
        const int64_t qk = q - (int64_t)(slot - (int)threadIdx.x) * clusters;
        if (qk < n0) {
          p0.pop[qk] = sum;            // row-major [B, G]: index q itself
        } else {
          p1.pop[qk - n0] = sum;
        }
      }
      cluster.sync();   // counts are read before they are reused
    }
  }
}

using FusedKernel = void (*)(FusedPlane, FusedPlane, int, int, int);

template <int KU>
FusedKernel fused_kernel_for(int K) {
  if constexpr (KU > kMaxUnroll) {
    return delta_apply_fused_kernel<-1>;
  } else {
    return K == KU ? delta_apply_fused_kernel<KU>
                   : fused_kernel_for<KU + 1>(K);
  }
}

FusedPlane fused_plane(const void* base, const void* adds, const void* dels,
                       const void* weights, void* mask, void* pop, void* accw,
                       void* live, long long W, int block_w) {
  FusedPlane p;
  p.base = (const int32_t*)base;
  p.adds = (const int32_t*)adds;
  p.dels = (const int32_t*)dels;
  p.weights = (const float*)weights;
  p.mask = (int32_t*)mask;
  p.pop = (int32_t*)pop;
  p.accw = (float*)accw;
  p.live = (float*)live;
  p.W = W;
  p.G = (W + block_w - 1) / block_w;
  return p;
}

int fused_launch(FusedPlane p0, FusedPlane p1, int B, int K, int block_w,
                 void* stream) {
  const int64_t groups = (int64_t)B * (p0.G + p1.G);
  if (groups == 0) return (int)cudaGetLastError();
  const FusedKernel fn = fused_kernel_for<0>(K);
  // a group's blocks form one cluster, at most kMaxCluster (portable)
  int C = (block_w + kThreads - 1) / kThreads;
  C = C < kMaxCluster ? C : kMaxCluster;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // clusters that fit on the card at once, per kernel and cluster size,
  // found once per process (one device)
  static int resident[kMaxUnroll + 2][kMaxCluster + 1] = {};
  int& cap = resident[K > kMaxUnroll ? kMaxUnroll + 1 : K][C];
  if (cap == 0) {
    cfg.gridDim = dim3(C);
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&cap, (const void*)fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (cap == 0) cap = 1;
  }
  const int64_t clusters = groups < cap ? groups : cap;
  cfg.gridDim = dim3((unsigned)(clusters * C));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, p0, p1, B, K, block_w);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// base [B, W], adds/dels [B, K, W], out [B, W]; all int32, contiguous.
int delta_apply_chain_launch(const void* base, const void* adds,
                             const void* dels, void* out, int B, int K,
                             long long W, void* stream) {
  if (B > 0 && W > 0) {
    dim3 grid((unsigned)((W + kThreads - 1) / kThreads), (unsigned)B);
    delta_apply_chain_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)base, (const int32_t*)adds, (const int32_t*)dels,
        (int32_t*)out, K, (int64_t)W);
  }
  return (int)cudaGetLastError();
}

// base [B, W], adds/dels [B, K, W] int32; weights [32·W] f32 or null (shared
// by the batch); mask [B, W] int32, pop [B, G] int32 with G = ceil(W /
// block_w), accw [B, W] f32, live [B, 32·W] f32 or null.
int delta_apply_fused_launch(const void* base, const void* adds,
                             const void* dels, const void* weights,
                             void* mask, void* pop, void* accw, void* live,
                             int B, int K, long long W, int block_w,
                             void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  const FusedPlane none = fused_plane(nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, 0,
                                      block_w);
  return fused_launch(fused_plane(base, adds, dels, weights, mask, pop, accw,
                                  live, W, block_w),
                      none, B, K, block_w, stream);
}

// Both planes of one singlepoint retrieval in one launch: the node plane's
// arguments (W_n words), then the edge plane's (W_e), each as for
// delta_apply_fused_launch; B, K and block_w are shared.
int delta_apply_fused_pair_launch(
    const void* base_n, const void* adds_n, const void* dels_n,
    const void* weights_n, void* mask_n, void* pop_n, void* accw_n,
    void* live_n, long long W_n, const void* base_e, const void* adds_e,
    const void* dels_e, const void* weights_e, void* mask_e, void* pop_e,
    void* accw_e, void* live_e, long long W_e, int B, int K, int block_w,
    void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  return fused_launch(
      fused_plane(base_n, adds_n, dels_n, weights_n, mask_n, pop_n, accw_n,
                  live_n, W_n, block_w),
      fused_plane(base_e, adds_e, dels_e, weights_e, mask_e, pop_e, accw_e,
                  live_e, W_e, block_w),
      B, K, block_w, stream);
}

}  // extern "C"
