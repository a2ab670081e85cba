// Split-K attention for MLA's absorbed decode (bf16, D up to 576, Dv up to
// 512), for sm_90a.
//
// Replaces, for bf16 calls with a head dim past 256 (ops.route), the Pallas
// TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`), which deepseek-v3's absorbed decode calls in latent
// space (src/repro/models/transformer/model.py:288-290): q [B, 128, Sq,
// 576] (512 latent + 64 RoPE dims), one KV head k [B, 1, Sk, 576], v the
// latent c_kv [B, 1, Sk, 512], scale 192^-0.5.  Same function: inputs read
// as f32; s = q·kᵀ·scale; keys masked by kpos < Sk, causal qpos >= kpos and
// window qpos - kpos < window, where qpos = i + q_offset; masked scores are
// -1e30 and their probabilities 0; out = acc / max(l, 1e-30) in bf16, so a
// row with no unmasked key comes out exactly 0.  GQA: query head h reads KV
// head h / (Hq / Hkv).
//
// Bound.  At the served decode shape (B = 8, 128 heads, ~4,100 keys) the
// call reads K once, 37.8 MB (0.0113 ms at 3.35 TB/s), and does 2·(576 +
// 512) operations per (row, key) pair, 9.1 GFLOP (0.0092 ms at the bf16
// tensor rate): about balanced, so both the bytes and the tensor cores
// matter.  flash_decode.cu cannot take it (128 query rows share the KV
// head; its lanes hold at most 8 rows), nor flash_prefill.cu (its rows keep
// their Dv f32 outputs in registers: a 64-row tile at Dv = 512 would be 256
// registers a thread on one warpgroup).  The design:
//
// * Rows.  A block serves 64 query rows (head g, query i; rows r = g·Sq +
//   i of one KV head), so every K byte is read once per 64 rows, not once
//   per head.  Q's 64 x D tile is staged in shared memory once (72 KB at
//   D = 576).
// * Split over keys.  The host cuts the visible keys [lo, hi) into
//   n_splits chunks on 32-key tile boundaries (ops.plan_mla_splits); the
//   grid is (split, row block, b·Hkv), sized to one wave of the SMs (one
//   block an SM: it holds ~194 KB of shared memory).  B = 8 gives only 16
//   row blocks, so without the split 16 of 132 SMs would work.  Each split
//   writes its unnormalised acc [Dv] and (m, l) per row to an f32
//   workspace, and a combine kernel merges them as flash_decode.cu does.
// * Tiles.  32-key K tiles (32 x 576 bf16, 36 KB) stream into a
//   shared-memory ring by cp.async 16-byte copies, 3 stages deep; keys
//   outside the split are zero-filled, never loaded.  When v is a view of
//   k's first Dv columns (ops._mla: v_in_k) P·V reads V from the same K
//   tile and no V tile is loaded; otherwise V tiles have a ring of their
//   own (2 stages: shared memory runs out at 3).  Rows are padded by 8
//   bf16 so that ldmatrix reads them without bank conflicts.
// * Products on mma.sync m16n8k16 (bf16 in, f32 accumulate), operands by
//   ldmatrix.  S = Q·Kᵀ: eight warps, warp w takes 16 rows (w % 4) x 16
//   keys (w / 4) of the 64 x 32 tile over the whole D.  P·V: warp w owns
//   output columns [64w, 64w + 64) of all 64 rows, a 64 x 64 f32
//   accumulator (128 registers a thread), so the 64 x 512 accumulator is
//   split over the warps by columns and P is shared through shared memory.
// * p in two products, as flash_prefill.cu: P_hi = bf16(p), P_lo =
//   bf16(p - P_hi), O += P_hi·V + P_lo·V, carrying p to within 2^-16 |p|
//   (the Pallas kernel keeps p in f32).
// * Online softmax across the two warps that share a row: each writes its
//   16-key row maxima to shared memory, both read both, so both hold the
//   same running max m; each keeps a partial sum l over its keys, added
//   at the end.  The rows' rescale factors pass to the P·V warps through
//   shared memory.  Three __syncthreads a tile.
//
// wgmma and TMA (a warp-specialised producer, Q in registers as the A
// operand) are a later redesign's work; see PERF.md for this design's time
// against its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;               // query rows a block (ops.MLA_ROWS)
constexpr int kTile = 32;               // keys a tile (ops.DECODE_TILE)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 576;              // ops.MLA_MAX_D
constexpr int kMaxDv = 512;             // ops.MLA_MAX_DV
constexpr int kWarpCols = kMaxDv / kWarps;   // 64 output columns a warp
constexpr int kPad = 8;                 // bf16 of padding a shared row
constexpr int kLdp = kTile + kPad;      // P's row stride
constexpr float kNegInf = -1e30f;
constexpr int kCombineThreads = 128;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a·b on one m16n8k16 tile: a the 16 x 16 A fragment, b0/b1 the
// 16 x 8 B fragment, c the 16 x 8 f32 accumulator.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int kStages, bool kVInK>
size_t smem_bytes(int D, int Dv) {
  const size_t q = (size_t)kRows * (D + kPad);
  const size_t k = (size_t)kStages * kTile * (D + kPad);
  const size_t v = kVInK ? 0 : (size_t)kStages * kTile * (Dv + kPad);
  const size_t p = 2 * (size_t)kRows * kLdp;
  return (q + k + v + p) * sizeof(bf16) + 6 * kRows * sizeof(float);
}

template <int kStages, bool kVInK>
__global__ void __launch_bounds__(kThreads, 1)
mla_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + kPad;                           // Q and K rows
  const int ldv = kVInK ? ldq : Dv + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // [kRows][ldq]
  bf16* ks = qs + kRows * ldq;                        // [kStages][kTile][ldq]
  bf16* vs = kVInK ? ks : ks + kStages * kTile * ldq;
  bf16* ph = vs + (kVInK ? kStages * kTile * ldq : kStages * kTile * ldv);
  bf16* pl = ph + kRows * kLdp;                       // [kRows][kLdp] each
  float* red_max = reinterpret_cast<float*>(pl + kRows * kLdp);  // [2][64]
  float* alpha_s = red_max + 2 * kRows;                          // [64]
  float* red_l = alpha_s + kRows;                                // [2][64]
  float* m_s = red_l + 2 * kRows;                                // [64]

  const int split = blockIdx.x, r0 = blockIdx.y * kRows;
  const int b = blockIdx.z / p.Hkv, hk = blockIdx.z - b * p.Hkv;
  const int G = p.Hq / p.Hkv, R = G * p.Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // this split's keys [kb, ke), read in tiles from tile0
  const int t0 = p.lo / kTile;
  const int kb = max(p.lo, (t0 + split * p.tiles_per_split) * kTile);
  const int ke = min(p.hi, (t0 + (split + 1) * p.tiles_per_split) * kTile);
  const int tile0 = kb - kb % kTile;
  const int n_tiles = ke > kb ? (ke - tile0 + kTile - 1) / kTile : 0;

  // Q tile: row r is query head hk·G + (r0 + r) / Sq, query (r0 + r) % Sq;
  // rows past R are zero-filled
  const int d_chunks = D / 8, dv_chunks = Dv / 8;     // 16-byte chunks
  for (int c = threadIdx.x; c < kRows * d_chunks; c += kThreads) {
    const int r = c / d_chunks, col = (c - r * d_chunks) * 8;
    const int row = r0 + r;
    const bool ok = row < R;
    const int g = ok ? row / p.Sq : 0, i = ok ? row - g * p.Sq : 0;
    cp_async16(qs + r * ldq + col,
               p.q + b * p.q_sb + (hk * G + g) * p.q_sh + i * p.q_ss + col,
               ok);
  }
  cp_async_commit();

  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  auto load = [&](int it) {
    const int kt = tile0 + it * kTile, buf = it % kStages;
    bf16* kd = ks + buf * kTile * ldq;
    for (int c = threadIdx.x; c < kTile * d_chunks; c += kThreads) {
      const int j = c / d_chunks, col = (c - j * d_chunks) * 8;
      const int key = kt + j;
      const bool ok = key >= kb && key < ke;
      cp_async16(kd + j * ldq + col,
                 kg + (long long)(ok ? key : kb) * p.k_ss + col, ok);
    }
    if (!kVInK) {
      bf16* vd = vs + buf * kTile * ldv;
      for (int c = threadIdx.x; c < kTile * dv_chunks; c += kThreads) {
        const int j = c / dv_chunks, col = (c - j * dv_chunks) * 8;
        const int key = kt + j;
        const bool ok = key >= kb && key < ke;
        cp_async16(vd + j * ldv + col,
                   vg + (long long)(ok ? key : kb) * p.v_ss + col, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }

  // scores: this warp's 16 rows (mw) x 16 keys (kw) of each tile; its
  // thread holds rows sr[0] = 16·mw + gid and sr[1] = sr[0] + 8
  const int mw = warp & 3, kw = warp >> 2;
  int sr[2], qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sr[h] = 16 * mw + gid + 8 * h;
    const int row = r0 + sr[h];
    row_ok[h] = row < R;
    qpos[h] = (row_ok[h] ? row % p.Sq : 0) + p.q_offset;
  }
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  // P·V: output columns [64·warp, 64·warp + 64) of all 64 rows
  const int c_warp = kWarpCols * warp;
  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();             // Q and tile it have landed
    __syncthreads();                          // and tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) load(it + kStages - 1);
    cp_async_commit();
    const int kt = tile0 + it * kTile, buf = it % kStages;
    const bf16* kt_s = ks + buf * kTile * ldq;
    const bf16* vt_s = vs + buf * kTile * ldv;

    // S = Q·Kᵀ over the whole D
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    {
      const bf16* qa = qs + (16 * mw + (lane & 15)) * ldq + (lane >> 4) * 8;
      const int j = lane >> 3;
      const bf16* kb_s =
          kt_s + (16 * kw + (j >> 1) * 8 + (lane & 7)) * ldq + (j & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, qa + kk);
        ldmatrix_x4(bb, kb_s + kk);
        mma_bf16(s[0], a, bb[0], bb[1]);
        mma_bf16(s[1], a, bb[2], bb[3]);
      }
    }
    // mask, scale and the warp's row maxima
    unsigned ok_bits = 0;
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = kt + 16 * kw + 8 * n + 2 * tig + (e & 1);
        bool ok = row_ok[h] && key >= kb && key < ke;
        if (p.causal) ok = ok && qpos[h] >= key;
        if (p.window > 0) ok = ok && (qpos[h] - key) < p.window;
        s[n][e] = ok ? s[n][e] * p.scale : kNegInf;
        ok_bits |= (unsigned)ok << (4 * n + e);
        tmax[h] = fmaxf(tmax[h], s[n][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      if (tig == 0) red_max[kw * kRows + sr[h]] = tmax[h];
    }
    __syncthreads();
    // both warps of a row reach the same running max
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mt = fmaxf(red_max[sr[h]], red_max[kRows + sr[h]]);
      const float m_new = fmaxf(m_run[h], mt);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 2 * h + e;
          pr[e] = (ok_bits >> (4 * n + idx)) & 1u
                      ? expf(s[n][idx] - m_run[h])
                      : 0.0f;
          l_run[h] += pr[e];
        }
        const bf16 h0 = __float2bfloat16_rn(pr[0]);
        const bf16 h1 = __float2bfloat16_rn(pr[1]);
        const bf16 l0 = __float2bfloat16_rn(pr[0] - __bfloat162float(h0));
        const bf16 l1 = __float2bfloat16_rn(pr[1] - __bfloat162float(h1));
        const int at = sr[h] * kLdp + 16 * kw + 8 * n + 2 * tig;
        *reinterpret_cast<uint32_t*>(ph + at) = pack_bf16(h0, h1);
        *reinterpret_cast<uint32_t*>(pl + at) = pack_bf16(l0, l1);
      }
    if (kw == 0 && tig == 0) {
      alpha_s[sr[0]] = alpha[0];
      alpha_s[sr[1]] = alpha[1];
    }
    __syncthreads();

    // O = O·alpha + P_hi·V + P_lo·V over this warp's columns
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float a0 = alpha_s[16 * mi + gid], a1 = alpha_s[16 * mi + gid + 8];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        acc[mi][ni][0] *= a0;
        acc[mi][ni][1] *= a0;
        acc[mi][ni][2] *= a1;
        acc[mi][ni][3] *= a1;
      }
    }
    if (c_warp < Dv) {
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t bv[8][2];
        const int j = lane >> 3;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4] = {0u, 0u, 0u, 0u};
          const int c0 = c_warp + 16 * np;
          if (c0 < Dv)
            ldmatrix_x4_trans(r, vt_s + (kk + (j & 1) * 8 + (lane & 7)) * ldv +
                                     c0 + (j >> 1) * 8);
          bv[2 * np][0] = r[0];
          bv[2 * np][1] = r[1];
          bv[2 * np + 1][0] = r[2];
          bv[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t ah[4], al[4];
          const int at = (16 * mi + (lane & 15)) * kLdp + kk + (lane >> 4) * 8;
          ldmatrix_x4(ah, ph + at);
          ldmatrix_x4(al, pl + at);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            if (c_warp + 8 * ni < Dv) {
              mma_bf16(acc[mi][ni], ah, bv[ni][0], bv[ni][1]);
              mma_bf16(acc[mi][ni], al, bv[ni][0], bv[ni][1]);
            }
          }
        }
      }
    }
  }

  // the rows' sums l over both warps' keys, and m, through shared memory
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if (tig == 0) {
      red_l[kw * kRows + sr[h]] = l_run[h];
      if (kw == 0) m_s[sr[h]] = m_run[h];
    }
  }
  __syncthreads();
  // this split's unnormalised acc and (m, l), row by row
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * mi + gid + 8 * h, row = r0 + rl;
      if (row >= R) continue;
      const int g = row / p.Sq, i = row - g * p.Sq;
      const long long wrow =
          ((long long)(b * p.Hq + hk * G + g) * p.Sq + i) * p.n_splits +
          split;
      float* dst = p.ws_acc + wrow * Dv;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = c_warp + 8 * ni;
        if (col < Dv)
          *reinterpret_cast<float2*>(dst + col + 2 * tig) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
      if (warp == 0 && tig == 0) {
        p.ws_ml[wrow * 2] = m_s[rl];
        p.ws_ml[wrow * 2 + 1] = red_l[rl] + red_l[kRows + rl];
      }
    }
}

// One block per (b, h, i) row: M = max m_s, L = Σ l_s·exp(m_s - M),
// out = Σ acc_s·exp(m_s - M) / max(L, 1e-30); a thread per 4 columns.
__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const Params p) {
  const int row = blockIdx.x;                 // (b·Hq + h)·Sq + i
  const int bh = row / p.Sq, i = row - bh * p.Sq;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int n = p.n_splits, Dv = p.Dv;
  const float* ml = p.ws_ml + (long long)row * n * 2;
  const float* acc = p.ws_acc + (long long)row * n * Dv;
  float M = kNegInf;
  for (int s = 0; s < n; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.0f;
  for (int s = 0; s < n; ++s) L += ml[2 * s + 1] * expf(ml[2 * s] - M);
  const float den = fmaxf(L, 1e-30f);
  bf16* orow = p.o + b * p.o_sb + h * p.o_sh + i * p.o_ss;
  for (int d = threadIdx.x * 4; d < Dv; d += kCombineThreads * 4) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < n; ++s) {
      const float c = expf(ml[2 * s] - M);
      const float4 x =
          *reinterpret_cast<const float4*>(acc + (long long)s * Dv + d);
      a[0] = fmaf(c, x.x, a[0]);
      a[1] = fmaf(c, x.y, a[1]);
      a[2] = fmaf(c, x.z, a[2]);
      a[3] = fmaf(c, x.w, a[3]);
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(orow + d);
    dst[0] = __floats2bfloat162_rn(a[0] / den, a[1] / den);
    dst[1] = __floats2bfloat162_rn(a[2] / den, a[3] / den);
  }
}

template <int kStages, bool kVInK>
cudaError_t launch(const Params& p, int row_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<kStages, kVInK>(p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel<kStages, kVInK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mla_split_kernel<kStages, kVInK>
      <<<dim3(p.n_splits, row_blocks, p.B * p.Hkv), kThreads, smem, stream>>>(
          p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_combine_kernel<<<p.B * p.Hq * p.Sq, kCombineThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// bf16 q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] and
// o [B, Hq, Sq, Dv], each given by its batch, head and sequence strides (in
// elements; the last dimension is contiguous, every stride a multiple of 8
// and every pointer 16-byte aligned); D a multiple of 16 up to 576, Dv a
// multiple of 8 up to 512.  v_in_k = 1 when v is k's first Dv columns (the
// same pointer and strides, Dv <= D): V is then read from K's tiles.
// ws_acc [B, Hq, Sq, n_splits, Dv] and ws_ml [.., 2] are f32 scratch.  The
// keys [lo, hi) (0 <= lo <= hi <= Sk) hold every key a row may see; split
// s reads [max(lo, (t0 + s·tiles)·32), min(hi, (t0 + (s + 1)·tiles)·32))
// with t0 = lo / 32, and the splits must reach hi.  window = 0 means no
// window.
int flash_mla_launch(const void* q, const void* k, const void* v, void* o,
                     float* ws_acc, float* ws_ml, long long q_sb,
                     long long q_sh, long long q_ss, long long k_sb,
                     long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, long long o_sb,
                     long long o_sh, long long o_ss, int B, int Hq, int Hkv,
                     int Sq, int Sk, int D, int Dv, int causal, int window,
                     int q_offset, float scale, int lo, int hi,
                     int tiles_per_split, int n_splits, int v_in_k,
                     void* stream) {
  if (Hkv <= 0 || Hq % Hkv || D <= 0 || D > kMaxD || D % 16 || Dv <= 0 ||
      Dv > kMaxDv || Dv % 8 || (v_in_k && Dv > D) || lo < 0 || hi < lo ||
      hi > Sk || tiles_per_split < 1 || n_splits < 1 || n_splits > 65535 ||
      (long long)(lo / kTile + (long long)n_splits * tiles_per_split) *
              kTile < hi)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  const long long rows = (long long)(Hq / Hkv) * Sq;
  const long long row_blocks = (rows + kRows - 1) / kRows;
  if (row_blocks > 65535 || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(o),
                 ws_acc, ws_ml, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                 v_sh, v_ss, o_sb, o_sh, o_ss, B, Hq, Hkv, Sq, Sk, D, Dv,
                 causal, window, q_offset, scale, lo, hi, tiles_per_split,
                 n_splits};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(v_in_k ? launch<3, true>(p, (int)row_blocks, st)
                      : launch<2, false>(p, (int)row_blocks, st));
}

}  // extern "C"
