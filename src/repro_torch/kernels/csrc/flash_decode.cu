// Split-K attention for calls with few query rows per KV head (decode), for
// sm_90a.
//
// Replaces, for those calls, the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`); flash_attention.cu takes every other call.  Same
// function: inputs read as f32; s = q·kᵀ·scale; keys masked by kpos < Sk,
// causal qpos >= kpos and window qpos - kpos < window, where qpos = i +
// q_offset; masked scores are -1e30 and their probabilities 0; out = acc /
// max(l, 1e-30) in the input dtype, so a row with no unmasked key comes out
// exactly 0.
//
// Bound.  Decode is bound by bytes: every visible K and V row is read once
// and each is used by only G·Sq <= 8 query rows, a few operations per byte.
// The design is about reading those bytes with the whole card:
//
// * Split over keys.  The host cuts the visible keys [lo, hi) into n_splits
//   contiguous chunks whose inner boundaries are multiples of the 32-key
//   tile, and launches one block per (split, b, KV head) so that B·Hkv·
//   n_splits blocks fill the SMs.  No key outside [lo, hi) is read (the
//   unwritten tail of a decode cache included).
// * GQA grouped.  A block serves all G·Sq query rows that read its KV head
//   (query heads hk·G .. hk·G + G - 1), so each K / V byte is read once per
//   (b, hk), not G times.
// * Copies.  K and V tiles stream into a 3-stage shared-memory ring with
//   cp.async 16-byte copies; the next two tiles are in flight while one is
//   scored.  Keys outside the split are zero-filled, never loaded.
// * Math on CUDA cores in f32 (no tensor cores: at most 8 rows).  A lane
//   holds 8 elements of each row's q in registers (lanes over D).  A warp
//   takes KW = 32 / RP keys of a tile at a time (RP: rows padded to 4 or 8):
//   each lane forms its partial dot products for the RP x KW (row, key)
//   pairs, and one reduce-scatter of 31 shuffles leaves pair l's full score
//   in lane l.  The online softmax runs on those lanes; p·v broadcasts each
//   p by shuffle and accumulates 8 output columns per lane per row.  Each
//   warp keeps its own running (m, l, acc); at the end the block merges its
//   four warps in shared memory and writes, per row, the unnormalised acc
//   [Dv] and (m, l) of its split to an f32 workspace.
// * Combine.  A second kernel, one block per (b, h, row), its warps over
//   the splits and its lanes over Dv: M = max m_s,
//   L = Σ l_s·exp(m_s - M), out = Σ acc_s·exp(m_s - M) / max(L, 1e-30).  A
//   split that sees no key has m = -1e30, l = 0, acc = 0 and adds nothing;
//   a row with no key at all comes out exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;               // keys per tile (ops.DECODE_TILE)
constexpr int kStages = 3;              // shared-memory ring depth
constexpr int kMaxD = 256;
constexpr int kMaxRows = 8;             // G·Sq (ops.DECODE_MAX_ROWS)
constexpr int kEl = 8;                  // elements of a row per lane, D <= 256
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws_acc;                        // [B, Hq, Sq, n_splits, Dv]
  float* ws_ml;                         // [B, Hq, Sq, n_splits, 2]
  long long q_sb, q_sh, q_ss;           // strides in elements; last dim 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, Hq, Hkv, Sq, Sk, D, Dv;
  int causal;
  int window;                           // 0: no window
  int q_offset;
  float scale;
  int lo, hi;                           // the visible keys of the call
  int tiles_per_split, n_splits;
};

// Elements of T in one 16-byte chunk.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int n = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const uint4 u, float* x, float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4 u, float* x,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_elem(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_elem(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

// This lane's kEl elements of a row of n elements (a multiple of the chunk):
// chunks lane and lane + 32, zeros past n.
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int n, int lane,
                                         float x[kEl]) {
  constexpr int P = Chunk<T>::n;
#pragma unroll
  for (int t = 0; t < kEl / P; ++t) {
    const int d = (lane + 32 * t) * P;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (d < n) u = *reinterpret_cast<const uint4*>(row + d);
    unpack(u, x + t * P, T());
  }
}

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

// One halving step of the reduce-scatter: lanes whose bit H is set keep the
// upper H values, the others the lower H, each adding its partner's copy.
template <int H>
__device__ __forceinline__ void scatter_step(float v[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// v[0..31] in every lane -> the warp's sum of v[lane], in lane.
__device__ __forceinline__ float reduce_scatter(float v[32], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

template <int KW>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = KW / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int KW>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = KW / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int RP>
size_t split_smem_bytes(int D, int Dv) {
  const size_t ring = (size_t)kStages * kTile * (D + Dv) * sizeof(T);
  const size_t merge = (size_t)kWarps * RP * (Dv + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

template <typename T, int RP>
__global__ void __launch_bounds__(kThreads)
attention_decode_split_kernel(const Params p) {
  constexpr int KW = 32 / RP;                 // keys per warp pass
  constexpr int kPasses = kTile / (kWarps * KW);
  constexpr int P = Chunk<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, Dv = p.Dv;
  T* ks = reinterpret_cast<T*>(smem_raw);             // [kStages][kTile][D]
  T* vs = ks + kStages * kTile * D;                   // [kStages][kTile][Dv]

  const int split = blockIdx.x;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y - b * p.Hkv;
  const int G = p.Hq / p.Hkv, R = G * p.Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // this split's keys [kb, ke), read in tiles from tile0
  const int t0 = p.lo / kTile;
  const int kb = max(p.lo, (t0 + split * p.tiles_per_split) * kTile);
  const int ke = min(p.hi, (t0 + (split + 1) * p.tiles_per_split) * kTile);
  const int tile0 = kb - kb % kTile;
  const int n_tiles = ke > kb ? (ke - tile0 + kTile - 1) / kTile : 0;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  // a tile's copies: thread t takes 16-byte column t % c of rows t / c,
  // t / c + kThreads / c, ... (c chunks per row, at most 64)
  const int ck = D / P, cv = Dv / P;
  const int k_step = kThreads / ck, v_step = kThreads / cv;
  const int k_row = threadIdx.x / ck, k_col = (threadIdx.x % ck) * P;
  const int v_row = threadIdx.x / cv, v_col = (threadIdx.x % cv) * P;
  auto load = [&](int it) {
    const int kt = tile0 + it * kTile, buf = it % kStages;
    T* kd = ks + buf * kTile * D + k_col;
    T* vd = vs + buf * kTile * Dv + v_col;
    if (k_row < k_step)
      for (int j = k_row; j < kTile; j += k_step) {
        const int key = kt + j;
        const bool ok = key >= kb && key < ke;
        cp_async16(kd + j * D,
                   kg + (long long)(ok ? key : kb) * p.k_ss + k_col, ok);
      }
    if (v_row < v_step)
      for (int j = v_row; j < kTile; j += v_step) {
        const int key = kt + j;
        const bool ok = key >= kb && key < ke;
        cp_async16(vd + j * Dv,
                   vg + (long long)(ok ? key : kb) * p.v_ss + v_col, ok);
      }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }

  // q of the block's rows in registers; row r is query head hk·G + r / Sq,
  // query r % Sq
  float qr[RP][kEl];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    if (r < R) {
      const int g = r / p.Sq, i = r - g * p.Sq;
      const T* qrow = static_cast<const T*>(p.q) + b * p.q_sb +
                      (hk * G + g) * p.q_sh + i * p.q_ss;
      load_row(qrow, D, lane, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < kEl; ++e) qr[r][e] = 0.0f;
    }
  }
  // after the scores' reduce-scatter, lane holds row lane / KW, key lane % KW
  const int my_row = lane / KW, my_key = lane % KW;
  const bool row_ok = my_row < R;
  const int qpos = (row_ok ? my_row % p.Sq : 0) + p.q_offset;
  float m_run = kNegInf, l_run = 0.0f;        // of row my_row
  float acc[RP][kEl];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int e = 0; e < kEl; ++e) acc[r][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();             // tile it has landed
    __syncthreads();                          // and tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) load(it + kStages - 1);
    cp_async_commit();
    const int kt = tile0 + it * kTile, buf = it % kStages;
    const T* kt_s = ks + buf * kTile * D;
    const T* vt_s = vs + buf * kTile * Dv;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int j0 = (pass * kWarps + warp) * KW;
      float part[32];                         // [RP][KW] partial dots
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float kx[kEl];
        load_row(kt_s + (j0 + j) * D, D, lane, kx);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < kEl; ++e) s = fmaf(qr[r][e], kx[e], s);
          part[r * KW + j] = s;
        }
      }
      float s = reduce_scatter(part, lane);
      const int key = kt + j0 + my_key;
      bool ok = row_ok && key >= kb && key < ke;
      if (p.causal) ok = ok && qpos >= key;
      if (p.window > 0) ok = ok && (qpos - key) < p.window;
      s = ok ? s * p.scale : kNegInf;
      const float m_new = fmaxf(m_run, group_max<KW>(s));
      const float alpha = expf(m_run - m_new);
      const float pr = ok ? expf(s - m_new) : 0.0f;
      l_run = l_run * alpha + group_sum<KW>(pr);
      m_run = m_new;
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const float a = __shfl_sync(kFull, alpha, r * KW);
#pragma unroll
        for (int e = 0; e < kEl; ++e) acc[r][e] *= a;
      }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float vx[kEl];
        load_row(vt_s + (j0 + j) * Dv, Dv, lane, vx);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float prj = __shfl_sync(kFull, pr, r * KW + j);
#pragma unroll
          for (int e = 0; e < kEl; ++e)
            acc[r][e] = fmaf(prj, vx[e], acc[r][e]);
        }
      }
    }
  }

  // merge the warps' (m, l, acc) in shared memory, now free of tiles
  cp_async_wait<0>();
  __syncthreads();
  float* macc = reinterpret_cast<float*>(smem_raw);   // [kWarps][RP][Dv]
  float* mml = macc + kWarps * RP * Dv;               // [kWarps][RP][2]
#pragma unroll
  for (int r = 0; r < RP; ++r) {
#pragma unroll
    for (int t = 0; t < kEl / P; ++t) {
      const int d = (lane + 32 * t) * P;
      if (d < Dv) {
#pragma unroll
        for (int e = 0; e < P; ++e)
          macc[(warp * RP + r) * Dv + d + e] = acc[r][t * P + e];
      }
    }
  }
  if (my_key == 0) {
    mml[(warp * RP + my_row) * 2] = m_run;
    mml[(warp * RP + my_row) * 2 + 1] = l_run;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * Dv; idx += kThreads) {
    const int r = idx / Dv, d = idx - r * Dv;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mml[(w * RP + r) * 2]);
    float A = 0.0f, L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(mml[(w * RP + r) * 2] - M);
      A += macc[(w * RP + r) * Dv + d] * c;
      L += mml[(w * RP + r) * 2 + 1] * c;
    }
    const int g = r / p.Sq, i = r - g * p.Sq;
    const long long row =
        ((long long)(b * p.Hq + hk * G + g) * p.Sq + i) * p.n_splits + split;
    p.ws_acc[row * Dv + d] = A;
    if (d == 0) {
      p.ws_ml[row * 2] = M;
      p.ws_ml[row * 2 + 1] = L;
    }
  }
}

constexpr int kCombineWarps = 8;

// One block per (b, h, row).  Every warp finds M and L with its lanes over
// the splits; warp w sums splits w, w + 8, ... with each lane on 16-byte
// column chunks lane and lane + 32; the warps' sums meet in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
attention_decode_combine_kernel(const Params p) {
  __shared__ float part[kCombineWarps][kMaxD];
  const int row = blockIdx.x;                 // (b·Hq + h)·Sq + i
  const int bh = row / p.Sq, i = row - bh * p.Sq;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = p.n_splits, Dv = p.Dv;
  const float* ml = p.ws_ml + (long long)row * n * 2;
  const float* acc = p.ws_acc + (long long)row * n * Dv;
  float M = kNegInf;
  for (int s = lane; s < n; s += 32) M = fmaxf(M, ml[2 * s]);
  M = group_max<32>(M);
  float L = 0.0f;
  for (int s = lane; s < n; s += 32) L += ml[2 * s + 1] * expf(ml[2 * s] - M);
  L = group_sum<32>(L);
  float a[kEl];
#pragma unroll
  for (int e = 0; e < kEl; ++e) a[e] = 0.0f;
#pragma unroll 4
  for (int s = warp; s < n; s += kCombineWarps) {
    const float c = expf(ml[2 * s] - M);
    float x[kEl];
    load_row(acc + (long long)s * Dv, Dv, lane, x);
#pragma unroll
    for (int e = 0; e < kEl; ++e) a[e] = fmaf(c, x[e], a[e]);
  }
#pragma unroll
  for (int t = 0; t < kEl / 4; ++t) {
    const int d = (lane + 32 * t) * 4;
    if (d < Dv) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[warp][d + e] = a[t * 4 + e];
    }
  }
  __syncthreads();
  const float den = fmaxf(L, 1e-30f);
  T* orow = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + i * p.o_ss;
  for (int d = threadIdx.x; d < Dv; d += kCombineWarps * 32) {
    float A = 0.0f;
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) A += part[w][d];
    orow[d] = to_elem(A / den, T());
  }
}

template <typename T, int RP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, RP>(p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      attention_decode_split_kernel<T, RP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_decode_split_kernel<T, RP>
      <<<dim3(p.n_splits, p.B * p.Hkv), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_decode_combine_kernel<T>
      <<<p.B * p.Hq * p.Sq, kCombineWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] and
// o [B, Hq, Sq, Dv], each given by its batch, head and sequence strides (in
// elements; the last dimension is contiguous, every stride a multiple of a
// 16-byte chunk and every pointer 16-byte aligned); D and Dv multiples of
// the chunk (8 bf16 or 4 f32) and at most 256; (Hq / Hkv)·Sq <= 8.
// ws_acc [B, Hq, Sq, n_splits, Dv] and ws_ml [.., 2] are f32 scratch.  The
// keys [lo, hi) (0 <= lo <= hi <= Sk) hold every key a row may see; split
// s reads [max(lo, (t0 + s·tiles)·32), min(hi, (t0 + (s + 1)·tiles)·32))
// with t0 = lo / 32, and the splits must reach hi.  window = 0 means no
// window; bf16 = 1 for __nv_bfloat16 tensors, 0 for f32.
int flash_decode_launch(const void* q, const void* k, const void* v, void* o,
                        float* ws_acc, float* ws_ml, long long q_sb,
                        long long q_sh, long long q_ss, long long k_sb,
                        long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, long long o_sb,
                        long long o_sh, long long o_ss, int B, int Hq,
                        int Hkv, int Sq, int Sk, int D, int Dv, int causal,
                        int window, int q_offset, float scale, int lo, int hi,
                        int tiles_per_split, int n_splits, int bf16,
                        void* stream) {
  const int chunk = bf16 ? 8 : 4;
  if (D > kMaxD || Dv > kMaxD || D % chunk || Dv % chunk || Hkv <= 0 ||
      Hq % Hkv || (Hq / Hkv) * Sq > kMaxRows || B * Hkv > 65535 || lo < 0 ||
      hi < lo || hi > Sk || tiles_per_split < 1 || n_splits < 1 ||
      (long long)(lo / kTile + (long long)n_splits * tiles_per_split) *
              kTile < hi)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  const Params p{q,    k,    v,    o,      ws_acc,   ws_ml, q_sb, q_sh,
                 q_ss, k_sb, k_sh, k_ss,   v_sb,     v_sh,  v_ss, o_sb,
                 o_sh, o_ss, B,    Hq,     Hkv,      Sq,    Sk,   D,
                 Dv,   causal, window, q_offset, scale, lo,  hi,
                 tiles_per_split, n_splits};
  cudaStream_t st = (cudaStream_t)stream;
  const bool small = (Hq / Hkv) * Sq <= 4;
  if (bf16)
    return (int)(small ? launch<__nv_bfloat16, 4>(p, st)
                       : launch<__nv_bfloat16, 8>(p, st));
  return (int)(small ? launch<float, 4>(p, st) : launch<float, 8>(p, st));
}

}  // extern "C"
