// Flash-attention prefill in f32 for Hopper (sm_90a): both products on the
// tensor cores as three TF32 products, K and V through TMA and an mbarrier
// ring fed by a producer warp.
//
// Replaces, for every f32 call that is not decode (ops.attention routes f32
// calls that ops.decode_shape does not take here), the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`).  Same function: s = q·kᵀ·scale; keys masked by kpos < Sk,
// causal qpos >= kpos and window qpos - kpos < window, where qpos = i +
// q_offset; online softmax in f32; out = acc / max(l, 1e-30), so a row with
// no unmasked key comes out exactly 0.  GQA: query head h reads KV head
// h / (Hq / Hkv) directly.
//
// Bound.  Prefill is bound by operations: 2·(D + Dv) per unmasked (query,
// key) pair.  At the f32 CUDA-core rate (67 TFLOP/s) that is the bound
// PERF.md holds this kernel to; the three TF32 products below do three
// times that work at the TF32 tensor rate (495 TFLOP/s), a floor 0.41 times
// as long.  The design:
//
// * Three TF32 products in place of one f32 product.  Each operand is split
//   as x = x_hi + x_lo with x_hi = tf32(x) and x_lo = tf32(x - x_hi)
//   (cvt.rna: round to nearest, 10 mantissa bits), and A·B is taken as
//   A_hi·B_hi + A_hi·B_lo + A_lo·B_hi, accumulated in f32.  Error bound:
//   |x_lo| <= 2^-11 |x| and x - x_hi - x_lo is at most 2^-11 |x_lo| <=
//   2^-22 |x|, so the dropped terms (A_lo·B_lo and the two residues) leave
//   each elementwise product within 3·2^-22 |a||b| (about 7.2e-7, some 21
//   bits; one TF32 product alone is good to 2^-10).  A score is off by at
//   most 3·2^-22·scale·Σ|q_i k_i| plus f32 summation, an output by that
//   relative to p plus 3·2^-22 max|v|: within the 3e-5 the tests hold f32
//   to, where one product would miss it (ref.split_tf32 emulates this on
//   the CPU; tests/test_torch_attention.py holds both against the Pallas
//   kernel).
// * mma.sync m16n8k8 (TF32), not wgmma.  wgmma takes 32-bit operands
//   K-major only, which fits Q·Kᵀ but not P·V (V is [keys, Dv], MN-major:
//   it would need a transpose in shared memory, and the B operand's hi and
//   lo would need a second copy there).  mma.sync takes its B fragments
//   from shared memory by plain per-thread loads in either layout, and the
//   consumers split every fragment into hi and lo in registers as they load
//   it, so shared memory holds each tile once.
// * P needs no shuffle.  In the score accumulator a thread holds keys 2t
//   and 2t+1 of each 8-key group (t = lane % 4); the TF32 A operand wants
//   columns t and t+4.  P·V sums over keys in any order, so the k-th column
//   of A is taken as key π(k) with π(t) = 2t, π(t+4) = 2t+1: the
//   accumulator's registers are then the A fragment as they stand, and the
//   B fragment reads V's rows 2t and 2t+1 to match.
// * TMA.  Q (once) and the K and V of each 32-key tile arrive by
//   cp.async.bulk.tensor from f32 CUtensorMaps encoded per call, 4-D over
//   (D, S, H, B) with the tensors' own strides (strided views are read as
//   they are), 128-byte swizzle: a box row holds 32 f32, so D columns are
//   D / 32 boxes side by side.  The maps' column extent is the call's real
//   D or Dv; TMA zero-fills past it, boxes wholly past it are not loaded,
//   and the products skip their columns.  With the swizzle, the fragment
//   loads of a warp hit 32 distinct banks.
// * Two warps on every scheduler.  mma.sync from one warp leaves the
//   tensor cores idle through its load, split and accumulator latencies, so
//   a block runs eight consumer warps (two warpgroups) of 16 query rows
//   each, 128 rows, beside a producer warpgroup whose first thread issues
//   every TMA load; setmaxnreg hands the producer's registers to the
//   consumers (24 and 240 a thread: O alone is Dv / 2 f32 a thread).  Q
//   takes 128 KB of shared memory at D = 256, so K and V do not move as
//   whole tiles: each [32 keys][32 columns] box (4 KB) passes through a
//   16-slot ring (64 KB) with a "full" barrier (TMA bytes) and an "empty"
//   barrier (one arrival per consumer warp) per slot, K's boxes of a tile
//   then V's, and the consumers take each box as it lands.  Q·Kᵀ keeps
//   hi·hi and the two cross products in three accumulators, so no chain
//   of dependent products is longer than D / 8.
// * Masks only where needed and heaviest tiles first, as in
//   flash_prefill.cu: each warp visits the key tiles its rows see and masks
//   only those that straddle the diagonal, the window's edge or Sk
//   (ops.prefill_tile_plan with block_m = 16, block_n = 32 mirrors it); the
//   last query tile goes onto the grid first.
// * Row statistics for training, as in flash_prefill.cu: with non-null
//   row_m / row_l the epilogue writes each row's softmax max and
//   denominator (store_stats); serving passes null and out is unchanged.
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kWarpRows = 16;   // query rows per consumer warp: one m16 tile
constexpr int kConsumerWGs = 2;
constexpr int kConsumers = 4 * kConsumerWGs;  // consumer warps
constexpr int kBM = kConsumers * kWarpRows;   // query rows per block
constexpr int kBN = 32;         // keys per tile
constexpr int kChunk = 32;      // f32 per 128-byte swizzled row
constexpr int kBox = kBN * kChunk;            // f32 in a K or V box
constexpr int kRing = 16;       // boxes in the K / V ring
constexpr int kThreads = 128 * (1 + kConsumerWGs);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// More than half of an SM's 228 KB: a second block never shares an SM, so
// setmaxnreg always finds the registers the consumers ask for.
constexpr int kMinSmem = 116 * 1024;

struct Params {
  float* o;
  long long o_sb, o_sh, o_ss;   // output strides in elements; last dim 1
  int Hq, Hkv, Sq, Sk;
  int d, dv;                    // real head dims (multiples of 4)
  int causal;
  int window;                   // 0: no window
  int q_offset;
  float scale_log2;             // scale · log2(e)
  float* row_m;                 // null, or [B, Hq, Sq] f32 row statistics:
  float* row_l;                 // max of s·scale, and the softmax denominator
};

// ------------------------------------------------------------- tile plan

// The key tiles [first, end) that the real rows [r0, min(r0 + rows, Sq))
// can see, and those rows' positions [qlo, qhi]; first == end when they see
// no key (ops.prefill_tile_plan, block_n = kBN).
struct Tiles {
  int first, end, qlo, qhi;
};

__device__ __forceinline__ Tiles key_tiles(const Params& p, int r0,
                                           int rows) {
  Tiles t{0, 0, 0, 0};
  const int r1 = min(r0 + rows, p.Sq);
  if (r1 <= r0) return t;
  t.qlo = r0 + p.q_offset;
  t.qhi = r1 - 1 + p.q_offset;
  const int begin = p.window > 0 ? max(0, t.qlo - p.window + 1) : 0;
  const int end = p.causal ? min(p.Sk, t.qhi + 1) : p.Sk;
  if (end > begin) {
    t.first = begin / kBN;
    t.end = (end + kBN - 1) / kBN;
  }
  return t;
}

// True when some (row, key) of tile kt is masked for these rows.
__device__ __forceinline__ bool tile_masked(const Params& p, const Tiles& t,
                                            int kt) {
  const int k0 = kt * kBN, k1 = k0 + kBN;
  return k1 > p.Sk || (p.causal && k1 - 1 > t.qlo) ||
         (p.window > 0 && t.qhi - k0 >= p.window);
}

// ---------------------------------------------- barriers, TMA, TF32 mma

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed; traps after about
// 2^34 cycles, so that a protocol fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One box of a 4-D map at coordinates (d, s, h, b) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(d),
      "r"(s), "r"(h), "r"(b) : "memory");
}

// Element (r, c) of a [rows][32] f32 box as TMA's 128-byte swizzle lays it
// out from a 1024-byte-aligned base: the 16-byte group c / 4 of row r is
// stored at group (c / 4) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kChunk + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: the TF32 operands of the three-term product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// C[16 x 8] += A[16 x 8] · B[8 x 8] in TF32, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The row statistics of the training forward (ops.attention_stats), the
// reference's m and l (_flash_fwd_impl), as in flash_prefill.cu: m is kept
// in the log2 domain here, so the reference's pair is (m·ln 2, l); a row
// with no visible key stores -1e30 and l = 0.  Serving passes null.
__device__ __forceinline__ void store_stats(const Params& p, int b, int h,
                                            int row, float m, float l) {
  const long long at = ((long long)b * p.Hq + h) * p.Sq + row;
  p.row_m[at] = m == -INFINITY ? -1e30f : m * 0.6931471805599453f;
  p.row_l[at] = l;
}

// ---------------------------------------------------------------- kernel

// Shared memory, from a 1024-byte-aligned base (the swizzle atom): Q as
// D / 32 boxes of [kBM rows][32], then the ring of kRing [kBN keys][32]
// boxes, then the barriers.
template <int D>
struct Smem {
  static constexpr int kQ = kBM * D;
  static constexpr int kBars = 1 + 2 * kRing;
  static constexpr size_t kBytes =
      1024 + 4 * (size_t)(kQ + kRing * kBox) + 8 * kBars;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
attention_prefill_f32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Params p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* qs = reinterpret_cast<float*>(base);
  float* ring = qs + L::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kRing * kBox);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kRing;

  const int b = blockIdx.x / p.Hq, h = blockIdx.x - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;     // heaviest first
  const int d_chunks = (p.d + kChunk - 1) / kChunk;      // boxes loaded
  const int dv_chunks = (p.dv + kChunk - 1) / kChunk;
  int first = 0, end = 0;          // the block's tiles: its warps' union
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) {
    const Tiles t = key_tiles(p, q0 + w * kWarpRows, kWarpRows);
    if (t.end == t.first) continue;
    first = end == first ? t.first : min(first, t.first);
    end = max(end, t.end);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);          // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 4 * kBM * kChunk * d_chunks);
      for (int c = 0; c < d_chunks; ++c)
        tma_load(qs + c * kBM * kChunk, &tq, q_full, c * kChunk, q0, h, b);
      int slot = 0;
      uint32_t phase = 0;
      for (int kt = first; kt < end; ++kt) {
        for (int c = 0; c < d_chunks + dv_chunks; ++c) {   // K's, then V's
          mbar_wait(&empty[slot], phase ^ 1);
          mbar_expect_tx(&full[slot], 4 * kBox);
          if (c < d_chunks)
            tma_load(ring + slot * kBox, &tk, &full[slot], c * kChunk,
                     kt * kBN, hk, b);
          else
            tma_load(ring + slot * kBox, &tv, &full[slot],
                     (c - d_chunks) * kChunk, kt * kBN, hk, b);
          if (++slot == kRing) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;        // fragment row, column
  const int r0 = (threadIdx.x / 32 - 4) * kWarpRows;   // the warp's Q rows
  const Tiles mine = key_tiles(p, q0 + r0, kWarpRows);
  const int row_a = q0 + r0 + g;                 // and row_a + 8
  const int qpos_a = row_a + p.q_offset;

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  int slot = 0;
  uint32_t phase = 0;
  // the warp is done with the box in `slot`: hand it back to the producer
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == kRing) {
      slot = 0;
      phase ^= 1;
    }
  };

  mbar_wait(q_full, 0);
  for (int kt = first; kt < end; ++kt) {
    if (kt < mine.first || kt >= mine.end) {
      // a tile only other warps' rows see: release its boxes once loaded
      for (int c = 0; c < d_chunks + dv_chunks; ++c) {
        mbar_wait(&full[slot], phase);
        release();
      }
      continue;
    }
    // S = Q·Kᵀ for the warp's 16 rows and the tile's 32 keys: hi·hi in sh,
    // the cross products in sx and sy
    float sh[kBN / 8][4], sx[kBN / 8][4], sy[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[j][e] = sx[j][e] = sy[j][e] = 0.0f;
    for (int c = 0; c < d_chunks; ++c) {
      mbar_wait(&full[slot], phase);
      const float* qc = qs + c * kBM * kChunk;
      const float* kc = ring + slot * kBox;
#pragma unroll
      for (int u = 0; u < kChunk / 8; ++u) {
        const int col = 8 * u + t4;              // and col + 4
        uint32_t ahi[4], alo[4];
        split(qc[swz(r0 + g, col)], ahi[0], alo[0]);
        split(qc[swz(r0 + g + 8, col)], ahi[1], alo[1]);
        split(qc[swz(r0 + g, col + 4)], ahi[2], alo[2]);
        split(qc[swz(r0 + g + 8, col + 4)], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          uint32_t b0h, b0l, b1h, b1l;
          split(kc[swz(8 * j + g, col)], b0h, b0l);
          split(kc[swz(8 * j + g, col + 4)], b1h, b1l);
          mma_tf32(sh[j], ahi, b0h, b1h);
          mma_tf32(sx[j], ahi, b0l, b1l);
          mma_tf32(sy[j], alo, b0h, b1h);
        }
      }
      release();
    }

    // online softmax in the log2 domain; this thread holds rows row_a
    // (i = 0) and row_a + 8 (i = 1), keys 8j + 2·t4 + {0, 1}
    float s[kBN / 8][4];
    float mx[2] = {-INFINITY, -INFINITY};
    const bool masked = tile_masked(p, mine, kt);
    const int k0 = kt * kBN + 2 * t4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (sh[j][e] + (sx[j][e] + sy[j][e])) * p.scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + (e & 1);
          const int qpos = qpos_a + 8 * (e >> 1);
          const bool ok = key < p.Sk && (!p.causal || qpos >= key) &&
                          (p.window == 0 || qpos - key < p.window);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.0f : m_new;   // no key yet: p = 0
      alpha[i] = ex2(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // p, its row sums (this thread's columns; the quad is summed at the
    // end) and its TF32 terms as A fragments: A column k of keys 8j..8j+7
    // is key 8j + π(k), so the fragment is (s[j][0], s[j][2], s[j][1],
    // s[j][3]) and the B fragment reads V's rows 8j + 2·t4 and + 1
    uint32_t phi[kBN / 8][4], plo[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - mu[e >> 1]);
        l[e >> 1] += s[j][e];
      }
      split(s[j][0], phi[j][0], plo[j][0]);
      split(s[j][2], phi[j][1], plo[j][1]);
      split(s[j][1], phi[j][2], plo[j][2]);
      split(s[j][3], phi[j][3], plo[j][3]);
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P·V, one V box (32 keys, output columns 32cv..32cv + 31) at a
    // time
#pragma unroll
    for (int cv = 0; cv < DV / kChunk; ++cv) {
      if (cv < dv_chunks) {
        mbar_wait(&full[slot], phase);
        const float* vc = ring + slot * kBox;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int kr = 8 * j + 2 * t4;
#pragma unroll
          for (int nn = 0; nn < kChunk / 8; ++nn) {
            const int n = cv * (kChunk / 8) + nn;
            if (8 * n < p.dv) {                 // the real Dv columns
              uint32_t b0h, b0l, b1h, b1l;
              split(vc[swz(kr, 8 * nn + g)], b0h, b0l);
              split(vc[swz(kr + 1, 8 * nn + g)], b1h, b1l);
              mma_tf32(o[n], phi[j], b0h, b1h);
              mma_tf32(o[n], phi[j], b0l, b1l);
              mma_tf32(o[n], plo[j], b0h, b1h);
            }
          }
        }
        release();
      }
    }
  }

  // out = acc / max(l, 1e-30): rows with no key have l = 0 and acc = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row_a + 8 * i;
    if (row >= p.Sq) continue;
    if (p.row_m != nullptr && t4 == 0) store_stats(p, b, h, row, m[i], l[i]);
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss +
                  2 * t4;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      if (8 * n + 2 * t4 < p.dv)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * i] / den, o[n][2 * i + 1] / den);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime, so
// the library links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 4-D f32 map over (d, s, h, b) with element strides (ss, sh, sb) and a
// box of 32 columns by `rows` rows, 128-byte swizzle, zero fill past the
// extents (d is the call's real head dim).  A dimension of size 1 is never
// stepped: its stride is set to a legal value.
bool encode(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
            long long ss, long long sh, long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "flash_prefill_f32: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const long long row = 4LL * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(s > 1 ? 4 * ss : row),
                                 (cuuint64_t)(h > 1 ? 4 * sh : row),
                                 (cuuint64_t)(b > 1 ? 4 * sb : row)};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_prefill_f32: cuTensorMapEncodeTiled failed (%d): "
            "dims %d %d %d %d, strides %lld %lld %lld\n", (int)r, d, s, h, b,
            ss, sh, sb);
    return false;
  }
  return true;
}

template <int D, int DV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int B,
                   cudaStream_t stream) {
  auto kernel = attention_prefill_f32_kernel<D, DV>;
  const int smem = (int)(Smem<D>::kBytes > (size_t)kMinSmem
                             ? Smem<D>::kBytes : kMinSmem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.Hq, (p.Sq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// f32 q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] and
// o [B, Hq, Sq, Dv], each given by its batch, head and sequence strides (in
// elements; the last dimension contiguous, every other stride a multiple of
// 4, every pointer 16-byte aligned; D and Dv multiples of 4), run by the
// instantiation (Di, Dvi), one of (64, 64), (128, 128), (256, 256)
// (ops.PREFILL_F32_DIMS) with Di >= D and Dvi >= Dv.  window = 0 means no
// window.  row_m and row_l are null (serving), or both f32 [B, Hq, Sq],
// contiguous, for the rows' statistics (store_stats).
int flash_prefill_f32_launch(const void* q, const void* k, const void* v,
                             void* o, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long o_sb, long long o_sh,
                             long long o_ss, int B, int Hq, int Hkv, int Sq,
                             int Sk, int D, int Dv, int Di, int Dvi,
                             int causal, int window, int q_offset,
                             float scale, float* row_m, float* row_l,
                             void* stream) {
  if ((row_m == nullptr) != (row_l == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Hkv <= 0 || Hq % Hkv || (Sq + kBM - 1) / kBM > 65535 || D < 1 ||
      Dv < 1 || D > Di || Dv > Dvi || D % 4 || Dv % 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, Sq, Hq, B, q_ss, q_sh, q_sb, kBM) ||
      !encode(&tk, k, D, Sk > 0 ? Sk : 1, Hkv, B, k_ss, k_sh, k_sb, kBN) ||
      !encode(&tv, v, Dv, Sk > 0 ? Sk : 1, Hkv, B, v_ss, v_sh, v_sb, kBN))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<float*>(o), o_sb, o_sh, o_ss, Hq, Hkv, Sq, Sk,
                 D, Dv, causal, window, q_offset,
                 scale * 1.4426950408889634f, row_m, row_l};
  cudaStream_t st = (cudaStream_t)stream;
  if (Di == 64 && Dvi == 64) return (int)launch<64, 64>(tq, tk, tv, p, B, st);
  if (Di == 128 && Dvi == 128)
    return (int)launch<128, 128>(tq, tk, tv, p, B, st);
  if (Di == 256 && Dvi == 256)
    return (int)launch<256, 256>(tq, tk, tv, p, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
