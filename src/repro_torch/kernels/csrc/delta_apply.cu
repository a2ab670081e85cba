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
// floats) and the optional live indicator (32·W floats).  Design: each
// thread owns one word and loops K in registers, so every input word is
// read once with coalesced 32-bit loads and every output written once; the
// batch is the grid's y axis.  The ragged edge (W not a multiple of the
// block) is masked here: a word past W is the all-zero identity, so no
// host-side padding copy is needed.
//
// The fused kernel keeps the Pallas kernel's reduction groups so its
// partials are bit-identical to the reference: pop[g] is the popcount of
// the g-th block_w-word group (an integer block reduction, exact in any
// order), and accw[w] sums bit_j * weight[32w+j] for j = 0..31 one term at
// a time, in that order, with an explicit product (a non-finite weight
// propagates as in the reference; 0 * inf = nan).  __fmul_rn/__fadd_rn
// keep nvcc from contracting the pair into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

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

// One thread block per block_w-word group g and batch row b (grid (G, B)).
// Dynamic shared memory holds the group's landed words, so the live
// indicator (32 floats per word) is written with coalesced float4 stores.
__global__ void delta_apply_fused_kernel(const int32_t* __restrict__ base,
                                         const int32_t* __restrict__ adds,
                                         const int32_t* __restrict__ dels,
                                         const float* __restrict__ weights,
                                         int32_t* __restrict__ mask,
                                         int32_t* __restrict__ pop,
                                         float* __restrict__ accw,
                                         float* __restrict__ live,
                                         int K, int64_t W, int block_w) {
  extern __shared__ uint32_t words[];
  __shared__ int warp_pop[kThreads / 32];
  const int64_t g = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t G = gridDim.x;
  const int64_t w0 = g * block_w;
  const int32_t* a = adds + b * K * W;
  const int32_t* d = dels + b * K * W;

  int count = 0;
  for (int i = threadIdx.x; i < block_w; i += blockDim.x) {
    const int64_t w = w0 + i;
    uint32_t m = 0;
    if (w < W) {
      int32_t s = base[b * W + w];
      for (int k = 0; k < K; ++k) {
        s = (s & ~d[(int64_t)k * W + w]) | a[(int64_t)k * W + w];
      }
      m = (uint32_t)s;
      mask[b * W + w] = s;
      float acc;
      if (weights != nullptr) {
        // weights are padded by the host to 32·W floats, 16-byte aligned
        const float4* wp = reinterpret_cast<const float4*>(weights + w * 32);
        acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = wp[q];
          const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float bit = (float)((m >> (4 * q + r)) & 1u);
            acc = __fadd_rn(acc, __fmul_rn(bit, c[r]));
          }
        }
      } else {
        acc = (float)__popc(m);
      }
      accw[b * W + w] = acc;
    }
    words[i] = m;
    count += __popc(m);
  }

  // deterministic integer reduction of the group's popcount
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if ((threadIdx.x & 31) == 0) warp_pop[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_pop[i];
    pop[b * G + g] = total;
  }

  if (live != nullptr) {
    // quad q of the group covers bits 4(q%8)..4(q%8)+3 of word q/8
    const int64_t valid = W - w0 < block_w ? W - w0 : block_w;
    float4* out = reinterpret_cast<float4*>(live + (b * W + w0) * 32);
    for (int64_t q = threadIdx.x; q < valid * 8; q += blockDim.x) {
      const uint32_t m = words[q >> 3] >> (4 * (q & 7));
      out[q] = make_float4((float)(m & 1u), (float)((m >> 1) & 1u),
                           (float)((m >> 2) & 1u), (float)((m >> 3) & 1u));
    }
  }
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
  if (B > 0 && W > 0) {
    const long long G = (W + block_w - 1) / block_w;
    dim3 grid((unsigned)G, (unsigned)B);
    const size_t smem = (size_t)block_w * sizeof(uint32_t);
    delta_apply_fused_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)base, (const int32_t*)adds, (const int32_t*)dels,
        (const float*)weights, (int32_t*)mask, (int32_t*)pop, (float*)accw,
        (float*)live, K, (int64_t)W, block_w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
