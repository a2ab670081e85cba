// Flash-attention forward (online softmax), for sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`), which computes attention over q [B, H, Sq, D] and
// k, v [B, H, Sk, D | Dv] on a sequential (B·H, q-block, kv-block) grid,
// with a running max, denominator and accumulator in VMEM scratch.  Same
// function here: inputs read as f32; s = q·kᵀ·scale; keys masked by
// kpos < Sk, causal qpos >= kpos and window qpos - kpos < window, where
// qpos = i + q_offset; masked scores are -1e30 and their probabilities 0;
// out = acc / max(l, 1e-30) in the input dtype, so a row with no unmasked
// key comes out exactly 0.
//
// Design, shared by both kernels.  One thread block per (b·Hq + h, tile of
// query rows), 4 warps.  The sequential kv grid axis of the TPU kernel
// becomes a loop over 32-key tiles inside the block; the block reads KV head
// h / (Hq / Hkv) directly, so GQA needs no repeated copy of K and V.  Tiles
// wholly above the causal diagonal or wholly older than the window are not
// visited: a fully masked tile leaves m, l and acc unchanged, so skipping is
// exact, and it keeps decode (Sq = 1 against the whole max_len cache) from
// reading the unwritten tail.
//
// * bf16 (`attention_mma_kernel`): 64 query rows per block, 16 per warp.
//   Q and a double-buffered ring of K / V tiles are copied to shared memory
//   with cp.async (16-byte chunks; rows padded by 16 bytes so fragment
//   loads hit distinct banks).  q·kᵀ runs on the tensor cores as
//   mma.sync m16n8k16 (bf16 products are exact in f32, f32 accumulators);
//   the score fragments stay in registers for the online softmax.  p stays
//   f32: each p is split into three bf16 terms hi + mid + lo that sum to it
//   exactly, and p·v is the sum of three bf16 mma products, again with f32
//   accumulators, so p is never rounded to bf16.
// * f32 (`attention_simt_kernel`): f32 products and sums on CUDA cores, no
//   TF32.  Lane j of a warp scores key j against the warp's R rows, the
//   warp reduces max and sum with shuffles, and p·v runs with p broadcast
//   by shuffle and lane-strided output columns, up to Dv = 256 in
//   registers.
//
// No route of ops.attention reaches this file.  Decode calls (at most 8
// query rows per KV head) go to the split-K kernel of flash_decode.cu, other
// bf16 calls at any head dim up to 256 to the wgmma/TMA kernel of
// flash_prefill.cu, and other f32 calls to the TF32 tensor-core kernel of
// flash_prefill_f32.cu.  Both kernels here stay as yardsticks only:
// ops._attention_mma and ops._attention_simt call them (counting no
// launch), and chip_smoke.py times them beside their replacements in the
// same run.  mma.sync runs below the wgmma rate and p·v costs three
// products in attention_mma_kernel; attention_simt_kernel uses no tensor
// core; their times against the kernels that replaced them are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBK = 32;                 // keys per tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;           // strides in elements; last dim 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, Hq, Hkv, Sq, Sk, D, Dv;
  int causal;
  int window;                           // 0: no window
  int q_offset;
  float scale;
};

// The keys that rows [q0, q0 + rows) can see, [begin, end), with begin
// rounded down to a tile.
struct KeyRange {
  int begin, end;
};

__device__ __forceinline__ KeyRange key_range(const Params& p, int q0,
                                              int rows) {
  const int last = min(q0 + rows, p.Sq) - 1;
  KeyRange r{0, p.Sk};
  if (p.causal) r.end = min(r.end, last + p.q_offset + 1);
  if (p.window > 0) r.begin = max(0, q0 + p.q_offset - p.window + 1);
  r.begin -= r.begin % kBK;
  return r;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int key) {
  bool ok = key < p.Sk;
  if (p.causal) ok = ok && qpos >= key;
  if (p.window > 0) ok = ok && (qpos - key) < p.window;
  return ok;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------- bf16, mma

constexpr int kRowsPerWarp = 16;
constexpr int kBQ = kWarps * kRowsPerWarp;    // query rows per block
constexpr int kPad = 8;                       // bf16 elements = 16 bytes
constexpr int kMaxNT = kMaxD / 8;             // 8-column output tiles

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;                // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols bf16 from global (row stride gstride) into shared memory (row
// stride sstride), rows at or past `valid_rows` zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int sstride,
                                          const __nv_bfloat16* g,
                                          long long gstride, int rows,
                                          int cols, int valid_rows) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const bool ok = r < valid_rows;
    cp_async16(s + r * sstride + c, g + (ok ? r * gstride : 0) + c, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p = hi + mid + lo exactly: each term is p's remainder rounded to bf16.
// Packs the three terms of (x, y) into three bf16x2 registers.
__device__ __forceinline__ void split3(float x, float y, uint32_t out[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[t] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
attention_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + kPad, ldk = D + kPad, ldv = Dv + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * ldq;                 // [2][kBK][ldk]
  __nv_bfloat16* vs = ks + 2 * kBK * ldk;             // [2][kBK][ldv]

  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;              // fragment row, pair
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_ss;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;

  const KeyRange kr = key_range(p, q0, kBQ);
  const int n_tiles = kr.end > kr.begin ? (kr.end - kr.begin + kBK - 1) / kBK
                                        : 0;
  auto load_kv = [&](int it) {
    const int kt = kr.begin + it * kBK, buf = it & 1;
    load_tile(ks + buf * kBK * ldk, ldk, kg + (long long)kt * p.k_ss, p.k_ss,
              kBK, D, p.Sk - kt);
    load_tile(vs + buf * kBK * ldv, ldv, vg + (long long)kt * p.v_ss, p.v_ss,
              kBK, Dv, p.Sk - kt);
  };
  load_tile(qs, ldq, qg, p.q_ss, kBQ, D, p.Sq - q0);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const int row0 = warp * kRowsPerWarp;
  const bool active = q0 + row0 < p.Sq;     // this warp has a real row
  const int qpos0 = q0 + row0 + g + p.q_offset;   // rows g and g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[kMaxNT][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt = kr.begin + it * kBK;
    const __nv_bfloat16* kb = ks + (it & 1) * kBK * ldk;
    const __nv_bfloat16* vb = vs + (it & 1) * kBK * ldv;
    if (active) {
      // scores: 16 rows x 32 keys as four m16n8 accumulators
      float s[kBK / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* qa = qs + (row0 + g) * ldq + 2 * t;
      for (int k0 = 0; k0 < D; k0 += 16) {
        const uint32_t a[4] = {ld32(qa + k0), ld32(qa + 8 * ldq + k0),
                               ld32(qa + k0 + 8), ld32(qa + 8 * ldq + k0 + 8)};
#pragma unroll
        for (int nt = 0; nt < kBK / 8; ++nt) {
          const __nv_bfloat16* kb_ = kb + (nt * 8 + g) * ldk + k0 + 2 * t;
          mma_bf16(s[nt], a, ld32(kb_), ld32(kb_ + 8));
        }
      }
      // mask, online softmax; this thread holds rows g (i = 0) and g + 8
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = kt + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = visible(p, qpos0 + 8 * i, key) ? s[nt][e] * p.scale
                                                    : kNegInf;
          mx[i] = fmaxf(mx[i], s[nt][e]);
        }
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float pr = s[nt][e] == kNegInf ? 0.0f
                                               : expf(s[nt][e] - m[i]);
          s[nt][e] = pr;
          rs[i] += pr;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(kFull, rs[i], 1);
        rs[i] += __shfl_xor_sync(kFull, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int nt = 0; nt < kMaxNT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
      // p·v: the score accumulators of keys 16kk..16kk+15 are the A
      // fragment of one m16n8k16 step
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[3][4];
        uint32_t tmp[3];
        split3(s[2 * kk][0], s[2 * kk][1], tmp);
#pragma unroll
        for (int u = 0; u < 3; ++u) a[u][0] = tmp[u];
        split3(s[2 * kk][2], s[2 * kk][3], tmp);
#pragma unroll
        for (int u = 0; u < 3; ++u) a[u][1] = tmp[u];
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], tmp);
#pragma unroll
        for (int u = 0; u < 3; ++u) a[u][2] = tmp[u];
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], tmp);
#pragma unroll
        for (int u = 0; u < 3; ++u) a[u][3] = tmp[u];
        const __nv_bfloat16* vr = vb + (kk * 16 + 2 * t) * ldv + g;
#pragma unroll
        for (int nt = 0; nt < kMaxNT; ++nt) {
          if (nt * 8 < Dv) {
            const __nv_bfloat16* v_ = vr + nt * 8;
            const uint32_t b0 = pack2(v_, v_ + ldv);
            const uint32_t b1 = pack2(v_ + 8 * ldv, v_ + 9 * ldv);
            mma_bf16(o[nt], a[0], b0, b1);
            mma_bf16(o[nt], a[1], b0, b1);
            mma_bf16(o[nt], a[2], b0, b1);
          }
        }
      }
    }
    __syncthreads();          // this tile's buffers may now be refilled
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + g + 8 * i;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = og + (long long)qi * p.o_ss + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) {
      if (nt * 8 < Dv) {
        const __nv_bfloat162 y = __floats2bfloat162_rn(o[nt][2 * i] / den,
                                                       o[nt][2 * i + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = y;
      }
    }
  }
}

// ----------------------------------------------------------------- f32, SIMT

constexpr int kMaxJ = kMaxD / 32;       // output columns per lane

template <int R>
size_t simt_smem_bytes(int D, int Dv) {
  return ((size_t)kWarps * R * D + (size_t)kBK * (D + 1) +
          (size_t)kBK * Dv) * sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
attention_simt_kernel(const Params p) {
  constexpr int BQ = kWarps * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, Dv = p.Dv;
  const int ldk = D + 1;                 // odd stride: lane j, row j, no
  float* qs = reinterpret_cast<float*>(smem_raw);      // conflicts
  float* ksm = qs + BQ * D;                            // [kBK][ldk]
  float* vsm = ksm + kBK * ldk;                        // [kBK][Dv]

  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    qs[i] = qi < p.Sq ? qg[(long long)qi * p.q_ss + d] : 0.0f;
  }
  const KeyRange kr = key_range(p, q0, BQ);

  const int row0 = warp * R;
  float m[R], l[R], acc[R][kMaxJ];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[r][j] = 0.0f;
  }

  for (int kt = kr.begin; kt < kr.end; kt += kBK) {
    __syncthreads();          // the previous tile is consumed; Q is staged
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int key = kt + j;
      ksm[j * ldk + d] = key < p.Sk ? kg[(long long)key * p.k_ss + d] : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * Dv; i += blockDim.x) {
      const int j = i / Dv, d = i - j * Dv;
      const int key = kt + j;
      vsm[i] = key < p.Sk ? vg[(long long)key * p.v_ss + d] : 0.0f;
    }
    __syncthreads();

    // scores of key (kt + lane) against this warp's R rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    const float* krow = ksm + lane * ldk;
    const float* qrow = qs + row0 * D;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(qrow[r * D + d], kd, s[r]);
    }

    const int key = kt + lane;
    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = visible(p, q0 + row0 + r + p.q_offset, key);
      const float sc = ok ? s[r] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      const float pr = ok ? expf(sc - m_new) : 0.0f;
      l[r] = l[r] * alpha + warp_sum(pr);
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[r][j] *= alpha;
      m[r] = m_new;
      pv[r] = pr;
    }

    for (int jk = 0; jk < kBK; ++jk) {
      float pk[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pk[r] = __shfl_sync(kFull, pv[r], jk);
      const float* vrow = vsm + jk * Dv;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int d = lane + 32 * j;
        if (d < Dv) {
          const float vd = vrow[d];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(pk[r], vd, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = og + (long long)qi * p.o_ss;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int d = lane + 32 * j;
      if (d < Dv) orow[d] = acc[r][j] / den;
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int rows, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows - 1) / rows, p.B * p.Hq);
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] and
// o [B, Hq, Sq, Dv], each given by its batch, head and sequence strides
// (in elements; the last dimension is contiguous).  bf16 = 1 for
// __nv_bfloat16 tensors (then D % 16 == 0, Dv % 8 == 0, every stride a
// multiple of 8 and every pointer 16-byte aligned), 0 for f32.
// window = 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int B, int Hq, int Hkv, int Sq,
                           int Sk, int D, int Dv, int causal, int window,
                           int q_offset, float scale, int bf16,
                           void* stream) {
  if (D > kMaxD || Dv > kMaxD || (bf16 && (D % 16 || Dv % 8)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  const Params p{q,    k,    v,    o,    q_sb, q_sh,  q_ss,     k_sb,
                 k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,  o_sh,     o_ss,
                 B,    Hq,   Hkv,  Sq,   Sk,   D,     Dv,       causal,
                 window, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const size_t smem = ((size_t)kBQ * (D + kPad) + 2 * kBK * (D + kPad) +
                         2 * kBK * (Dv + kPad)) * sizeof(__nv_bfloat16);
    return (int)launch(attention_mma_kernel, p, kBQ, smem, st);
  }
  if (Sq <= kWarps)                     // decode: one row per warp
    return (int)launch(attention_simt_kernel<1>, p, kWarps,
                       simt_smem_bytes<1>(D, Dv), st);
  return (int)launch(attention_simt_kernel<8>, p, kWarps * 8,
                     simt_smem_bytes<8>(D, Dv), st);
}

}  // extern "C"
