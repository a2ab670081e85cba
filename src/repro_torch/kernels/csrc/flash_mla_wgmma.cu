// MLA's absorbed-decode attention for Hopper (sm_90a): bf16, D up to 576,
// Dv up to 512, on wgmma and TMA, warp-specialised, the key splits of one
// query block merged in a thread block cluster.
//
// Replaces, for bf16 calls with a head dim past 256 (ops.route: the route
// "flash_mla"), the Pallas TPU kernel
//  src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`), which deepseek-v3's absorbed decode calls in latent
// space (src/repro/models/transformer/model.py:288-290): q [B, 128, Sq,
// 576] (512 latent + 64 RoPE dims), one KV head k [B, 1, Sk, 576], v the
// latent c_kv, k's first 512 columns, scale 192^-0.5.  Same function as
// flash_mla.cu, the first design (kept as a yardstick, ops._mla_mma):
// s = q·kᵀ·scale; keys masked by kpos < Sk, causal qpos >= kpos and window
// qpos - kpos < window, where qpos = i + q_offset; a masked score gives
// p = 0 exactly; out = acc / max(l, 1e-30) rounded once to bf16, so a row
// that sees no key comes out 0.  GQA: query head h reads KV head
// h / (Hq / Hkv).
//
// Bound.  At the served decode shape (B = 8, 128 heads, 4,101 visible keys
// of a 4,128-key cache) the call reads K once, 37.8 MB, 0.0119 ms at
// 3.35 TB/s with q and o; its counted work, 2·(576 + 512) operations per
// (row, key) pair, is 0.0092 ms at the bf16 tensor rate.  This kernel does
// 3,200 per pair (p in two products, below): 13.4 GFLOP, 0.0136 ms, so its
// own floor is the tensor cores.  The design keeps them fed:
//
// * Rows and splits.  A block serves 64 query rows of one KV head (head g,
//   query i: row g·Sq + i), so a K byte is read once per 64 rows.  The
//   host cuts the visible keys [lo, hi) into n_splits runs of 64-key tiles
//   (ops.plan_mla_wgmma_splits); the grid is (split, row block, b·Hkv) and
//   the n_splits blocks of a row block form one thread block cluster.
// * Warp specialisation.  Three warpgroups: a producer, whose first thread
//   issues every TMA load, and two consumers (setmaxnreg 24 / 240).  K
//   tiles of 64 keys x 576 arrive by cp.async.bulk.tensor through a
//   2-stage ring of full / empty mbarriers, from a 4-D map over (D, S, H,
//   B) that starts at key lo and ends at hi: TMA zero-fills keys outside
//   the visible range and columns past the real D, and the host copies
//   nothing.  Q's 64 x 576 tile is loaded once, by the consumers, with
//   cp.async into the same 128-byte-swizzled layout (its rows are (head,
//   query) pairs, which one TMA box covers only when Sq divides 64).
// * V is not loaded when v is k's first Dv columns (ops._mla: v_in_k): P·V
//   reads the K tile's first 8 chunks as the B operand, MN-major with the
//   transpose bit, as flash_prefill.cu reads its V tile.  A v of its own
//   gets a V ring in the <32, false> instantiation (32-key tiles).
// * Products.  S = Q·Kᵀ is wgmma m64n64k16 with both operands in shared
//   memory, 36 k-steps a tile.  A 64-key tile is the narrowest that keeps
//   this product off the shared-memory limit: each instruction reads
//   (64 + N) x 32 bytes for 64·N·32 operations, 128 B a clock at the full
//   tensor rate at N = 64 (the SM's shared-memory bandwidth), 192 B at
//   N = 32.  O += P·V is wgmma m64n256k16: the 64 x 512 f32 accumulator is
//   split between the consumers by columns, 256 each (128 registers a
//   thread).  p is carried in two products, P_hi = bf16(p) and P_lo =
//   bf16(p - P_hi), within 2^-16 |p|, as flash_prefill.cu does.
// * Ping-pong (FlashMLA's schedule).  Consumer 0 computes S and the softmax
//   of the even tiles, consumer 1 of the odd ones.  The owner of a tile
//   writes P_hi, P_lo and the rows' running max m and rescale factor to
//   shared memory and signals a named barrier; both consumers then rescale
//   their O and l and add P·V over their own 256 columns, the owner with P
//   from registers, the other from shared memory.  The next owner starts
//   its softmax from the m it received.  Each keeps a partial l over its
//   own tiles; they are added at the end.
// * Masks only where needed.  A tile takes the per-element mask only when
//   some key of it lies outside the split or past a row's causal diagonal
//   or window, or the block has rows past the KV head's: at decode, the
//   tile that holds the last visible key (and the first, when the visible
//   keys start inside a tile).  exp2 with scale·log2(e) folded in.
// * Shared memory (232,448 bytes a block at most), from a 1024-byte-aligned
//   base (ops.mla_smem_bytes is the same count):
//     <64, true>   Q 73,728 + K ring 2 x 73,728 + P_hi 8,192 + row
//                  statistics 1,024 + 4 mbarriers 32 + alignment 1,024
//                  = 231,456 B.  A second P buffer does not fit, so P_lo
//                  goes into the tile's RoPE chunk (key columns 512-575):
//                  once the owner's S is done nothing reads those columns
//                  (P·V reads the first 512), and the chunk is exactly one
//                  64 x 64 swizzled bf16 operand.  The owner writes it only
//                  after its own S has completed, and the stage is
//                  reloaded only after both consumers have released it.
//     <32, false>  Q 73,728 + K ring 2 x 36,864 + V ring 2 x 32,768 +
//                  P_hi and P_lo 2 x 8,192 + 1,024 + 32 + 1,024 = 231,456 B
//                  (a 32-key P in a 64-column swizzled operand).
// * The split merge, in the cluster.  Each block writes its unnormalised
//   64 x Dv partial (f32) and its rows' (m, l) into its own shared memory,
//   which Q and the ring no longer need; after a cluster barrier block
//   `rank` merges rows [rank·⌈64/n⌉, ...) across the n blocks, reading
//   the others' through distributed shared memory (M = max m, weights
//   2^(m - M), out = Σ weight·O / max(Σ weight·l, 1e-30), divided once
//   as the plain version divides), and stores bf16; a second
//   cluster barrier keeps every block alive until the others have read
//   it.  No workspace, no second launch.  (Of the variants timed on the
//   card, this one, a load per split and column quad in flight, beat
//   more loads in flight per thread and rows pushed to the merging block
//   by remote stores, at the served shape.)  The host picks n (at most
//   8, the portable cluster size) from cudaOccupancyMaxActiveClusters so
//   that the grid stays one wave.
#include <cooperative_groups.h>
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;               // query rows a block (ops.MLA_ROWS)
constexpr int kMaxD = 576;              // ops.MLA_MAX_D
constexpr int kMaxDv = 512;             // ops.MLA_MAX_DV
constexpr int kChunk = 64;              // bf16 per 128-byte swizzled row
constexpr int kDChunks = kMaxD / kChunk;     // 9: K's chunk 8 is RoPE
constexpr int kConsumers = 2;
constexpr int kWgCols = kMaxDv / kConsumers; // O columns a consumer owns
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxCluster = 8;          // ops.MLA_MAX_CLUSTER
constexpr int kPartLd = kMaxDv + 8;     // f32 row stride of the partial O
// Parts that a timing build leaves out, to see what each costs
// (scripts/mla_kernel_breakdown.py builds with -DMLA_OMIT=<bits>; the
// library is built without, the whole kernel): 1 masks every tile, 2
// computes no S, 4 no P·V, 8 no P_lo·V, 16 reads no partial in the merge.
// Any bit set gives wrong results.
#ifndef MLA_OMIT
#define MLA_OMIT 0
#endif
constexpr int kOmit = MLA_OMIT;
// named barriers (0 is __syncthreads): a tile's P and row statistics
// published, by stage; the two consumer warpgroups together
constexpr int kBarPublish = 1;
constexpr int kBarConsumers = 3;

struct Params {
  const bf16* q;
  bf16* o;
  long long q_sb, q_sh, q_ss;           // strides in elements; last dim 1
  long long o_sb, o_sh, o_ss;
  int Hq, Hkv, Sq;
  int d, d_chunks;                      // real D and its 64-column boxes
  int dv, dv_chunks;                    // real Dv and its boxes
  int causal;
  int window;                           // 0: no window
  int q_offset;
  float scale_log2;                     // scale · log2(e)
  int lo, hi;                           // the visible keys of the call
  int tiles_per_split;                  // n_splits is gridDim.x
};

// Shared memory, in bf16 elements from the aligned base: Q as 9 chunks of
// [64 rows][64], the K ring as 2 stages of 9 chunks of [kBN keys][64], the
// V ring (a v of its own) as 2 stages of 8 chunks, P_hi (and P_lo when it
// has no RoPE chunk to live in) as [64 rows][64]; then the row statistics
// (m and the rescale factor, by stage) and the barriers.
template <int kBN, bool kVInK>
struct Smem {
  static_assert(!kVInK || kBN == kChunk,
                "P_lo lives in the RoPE chunk of a 64-key K tile");
  static constexpr int kQ = kRows * kMaxD;
  static constexpr int kK = kBN * kMaxD;
  static constexpr int kV = kVInK ? 0 : kBN * kMaxDv;
  static constexpr int kP = kRows * kChunk;
  static constexpr int kPBufs = kVInK ? 1 : 2;
  static constexpr size_t kStats = 4 * kRows * sizeof(float);
  static constexpr size_t kBars = 4 * sizeof(uint64_t);
  static constexpr size_t kBytes =
      1024 + 2 * (size_t)(kQ + 2 * (kK + kV) + kPBufs * kP) + kStats + kBars;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
  // the merge reuses Q and the rings: the partial O [64][kPartLd], m [64],
  // l by consumer [2][64], the weights and L [64][kMaxCluster + 1]
  static_assert(4 * kRows * (kPartLd + 4 + kMaxCluster) <=
                    2 * (kQ + 2 * (kK + kV)), "the merge's region");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// ------------------------------------------------ barriers, copies, TMA

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

// Waits until the phase of parity `parity` has completed.  A wait past
// about 2^34 cycles (seconds; a tile takes microseconds) traps, so that a
// protocol fault ends the launch with an error instead of hanging the card.
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

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;                // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)), "l"(gmem), "r"(n) : "memory");
}

// One box of a 4-D map at coordinates (d, s, h, b) into shared memory,
// completing on `bar`; coordinates out of the map (negative ones too) are
// zero-filled.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(d),
      "r"(s), "r"(h), "r"(b) : "memory");
}

// ----------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units), layout 1
// (128-byte swizzle) in bits 62-63.  K-major (Q, K, P): rows 128 bytes
// apart, 8-row groups 1024 bytes apart (SBO); LBO unused.  MN-major (V):
// LBO is the step between 64-column chunks, SBO between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* ptr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// Element offset of (row, col) in a [rows][64] bf16 chunk with the
// 128-byte swizzle, as TMA writes it and wgmma reads it: the 16-byte unit
// col / 8 of a row is stored at unit (col / 8) ^ (row % 8).
__device__ __forceinline__ int sw128_at(int row, int col) {
  return row * kChunk + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = hi + lo with hi = bf16(p) and lo = bf16(p - hi), for a pair (x, y):
// the A-fragment registers of the two p·v products.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16x2(x - __low2float(h), y - __high2float(h));
}

// S tile: D[64 x 64] (+)= A[64 x 16] · B[16 x 64], A and B K-major in shared
// memory; `accumulate` = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at 32 keys (the separate-V instantiation).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 256] (+)= P[64 x 16] · V[16 x 256]: P K-major and V MN-major (the
// transpose bit) in shared memory: the tile another warpgroup's softmax made.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 256] += P[64 x 16] · V[16 x 256]: P from registers (bf16x2 pairs in
// the accumulator's row layout), V MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int kBN>
__device__ __forceinline__ void wgmma_ss_s(float (&d)[kBN / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (kBN == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n32(d, da, db, accumulate);
}

// ---------------------------------------------------------------- kernel

template <int kBN, bool kVInK>
__global__ void __launch_bounds__(kThreads, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<kBN, kVInK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = qs + L::kQ;
  bf16* vs = ks + 2 * L::kK;
  bf16* p_hi = vs + 2 * L::kV;
  float* st_m = reinterpret_cast<float*>(p_hi + L::kPBufs * L::kP);  // [2][64]
  float* st_alpha = st_m + 2 * kRows;                                // [2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(st_alpha + 2 * kRows);
  uint64_t* empty = full + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = gridDim.x;      // the cluster: one row block's splits
  const int split = blockIdx.x;        // its rank in the cluster
  const int r0 = blockIdx.y * kRows;
  const int b = blockIdx.z / p.Hkv, hk = blockIdx.z - b * p.Hkv;
  const int G = p.Hq / p.Hkv, R = G * p.Sq;

  // this split's keys [kb, ke), read in tiles from tile0
  const int t0 = p.lo / kBN;
  const int kb = max(p.lo, (t0 + split * p.tiles_per_split) * kBN);
  const int ke = min(p.hi, (t0 + (split + 1) * p.tiles_per_split) * kBN);
  const int tile0 = kb / kBN;
  const int n_tiles = ke > kb ? (ke - tile0 * kBN + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);      // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // boxes wholly past the real D or Dv are not loaded
      const uint32_t bytes =
          2 * kBN * kChunk * (p.d_chunks + (kVInK ? 0 : p.dv_chunks));
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it & 1;
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        const int key = (tile0 + it) * kBN - p.lo;   // the maps start at lo
#pragma unroll
        for (int c = 0; c < kDChunks; ++c)
          if (c < p.d_chunks)
            tma_load(ks + s * L::kK + c * kBN * kChunk, &tk, &full[s],
                     c * kChunk, key, hk, b);
        if constexpr (!kVInK) {
#pragma unroll
          for (int c = 0; c < kMaxDv / kChunk; ++c)
            if (c < p.dv_chunks)
              tma_load(vs + s * L::kV + c * kBN * kChunk, &tv, &full[s],
                       c * kChunk, key, hk, b);
        }
      }
    }
    __syncwarp();
    cluster.sync();          // the cluster's partials are written
    cluster.sync();          // and merged
    return;
  }

  // -------------------------------------------------------------- consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = wg - 1;                            // consumer 0 or 1
  const int ctid = threadIdx.x - 128;              // 0..255 over both
  const int tid = ctid - 128 * w;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;         // fragment row, column pair

  // Q's tile: row r is query head hk·G + (r0 + r) / Sq, query (r0 + r) %
  // Sq; rows past R and columns past D zero-filled
  {
    const int units = p.d_chunks * (kChunk / 8);   // 16-byte units a row
    for (int u = ctid; u < kRows * units; u += 2 * 128) {
      const int r = u / units, x = u - r * units;
      const int row = r0 + r, col = 8 * x;
      const bool ok = row < R && col < p.d;
      const int gq = ok ? row / p.Sq : 0, i = ok ? row - gq * p.Sq : 0;
      cp_async16(qs + (col / kChunk) * kRows * kChunk +
                     sw128_at(r, col % kChunk),
                 p.q + b * p.q_sb + (long long)(hk * G + gq) * p.q_sh +
                     (long long)i * p.q_ss + (ok ? col : 0),
                 ok);
    }
    asm volatile("cp.async.commit_group;\n"
                 "cp.async.wait_group 0;\n" ::: "memory");
    fence_proxy_async();
    named_sync(kBarConsumers, 2 * 128);
  }

  // this thread's accumulator rows: ra and ra + 8 of the block's 64
  const int ra = 16 * warp + g;
  bool row_ok[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + ra + 8 * h;
    row_ok[h] = row < R;
    qpos[h] = (row_ok[h] ? row % p.Sq : 0) + p.q_offset;
  }
  // a block with rows past R masks every tile; otherwise a tile is masked
  // only if some key lies outside the split, or past the causal diagonal
  // or the window of some row (qpos in [q_offset, q_offset + Sq - 1])
  const bool block_rows_masked = r0 + kRows > R;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float o[kWgCols / 2];                 // O columns [256w, 256w + 256)
#pragma unroll
  for (int i = 0; i < kWgCols / 2; ++i) o[i] = 0.0f;
  const bool has_cols = kWgCols * w < p.dv;     // Dv <= 256: consumer 1 none

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1;
    const bf16* kt = ks + s * L::kK;
    const bf16* vt = (kVInK ? kt : vs + s * L::kV) + 4 * w * kBN * kChunk;
    bf16* p_lo = kVInK ? ks + s * L::kK + (kDChunks - 1) * kBN * kChunk
                       : p_hi + L::kP;
    float alpha[2];
    mbar_wait(&full[s], (it >> 1) & 1);
    if ((it & 1) == w) {
      // --------------------------------------- this consumer's tile: S, p
      float sc[kBN / 2];
      if constexpr (kOmit & 2) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.0f;
      } else {
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kDChunks; ++c) {
          if (c < p.d_chunks) {           // columns past the real D: none
#pragma unroll
            for (int j = 0; j < kChunk / 16; ++j)
              wgmma_ss_s<kBN>(
                  sc, sw128_desc(qs + c * kRows * kChunk + j * 16, 16, 1024),
                  sw128_desc(kt + c * kBN * kChunk + j * 16, 16, 1024),
                  c + j > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
      }

      // mask and scale (log2 domain); keys 8j + 2·tq4 + {0, 1} of the tile
      const int k_lo = (tile0 + it) * kBN, k0 = k_lo + 2 * tq4;
      float mx[2] = {-INFINITY, -INFINITY};
      if ((kOmit & 1) || block_rows_masked || k_lo < kb || k_lo + kBN > ke ||
          (p.causal && k_lo + kBN - 1 > p.q_offset) ||
          (p.window > 0 && p.q_offset + p.Sq - 1 - k_lo >= p.window)) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + (e & 1), h = e >> 1;
            const bool ok = row_ok[h] && key >= kb && key < ke &&
                            (!p.causal || qpos[h] >= key) &&
                            (p.window == 0 || qpos[h] - key < p.window);
            const float x = ok ? sc[4 * j + e] * p.scale_log2 : -INFINITY;
            sc[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * j + e] * p.scale_log2;
            sc[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
      float mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        mu[h] = m_new == -INFINITY ? 0.0f : m_new;   // no key yet: p = 0
        alpha[h] = ex2(m_run[h] - mu[h]);
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
      // p, its row sums and its two bf16 terms as A fragments (keys
      // 16kk..16kk + 15), also written to shared memory for the other
      // consumer
      uint32_t hi[kBN / 16][4], lo[kBN / 16][4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[e] = ex2(sc[4 * j + e] - mu[e >> 1]);
          l_run[e >> 1] += pr[e];
        }
        const int kk = j >> 1, r = 2 * (j & 1);
        split2(pr[0], pr[1], hi[kk][r], lo[kk][r]);
        split2(pr[2], pr[3], hi[kk][r + 1], lo[kk][r + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = sw128_at(ra + 8 * h, 8 * j + 2 * tq4);
          *reinterpret_cast<uint32_t*>(p_hi + at) = hi[kk][r + h];
          *reinterpret_cast<uint32_t*>(p_lo + at) = lo[kk][r + h];
        }
      }
      if (tq4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          st_m[s * kRows + ra + 8 * h] = m_run[h];
          st_alpha[s * kRows + ra + 8 * h] = alpha[h];
        }
      }
      fence_proxy_async();
      named_arrive(kBarPublish + s, 2 * 128);

      // O = O·alpha + P_hi·V + P_lo·V over this consumer's columns
      if (has_cols) {
#pragma unroll
        for (int i = 0; i < kWgCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        reg_fence(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t db = sw128_desc(vt + kk * 16 * kChunk,
                                         kBN * kChunk * 2, 1024);
          if constexpr (!(kOmit & 4)) wgmma_rs_n256(o, hi[kk], db);
          if constexpr (!(kOmit & 12)) wgmma_rs_n256(o, lo[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(o);
      }
    } else {
      // ------------------------- the other consumer's tile: P from shared
      named_sync(kBarPublish + s, 2 * 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        alpha[h] = st_alpha[s * kRows + ra + 8 * h];
        m_run[h] = st_m[s * kRows + ra + 8 * h];
        l_run[h] *= alpha[h];
      }
      if (has_cols) {
#pragma unroll
        for (int i = 0; i < kWgCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        reg_fence(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t db = sw128_desc(vt + kk * 16 * kChunk,
                                         kBN * kChunk * 2, 1024);
          if constexpr (!(kOmit & 4))
            wgmma_ss_n256(o, sw128_desc(p_hi + kk * 16, 16, 1024), db, 1);
          if constexpr (!(kOmit & 12))
            wgmma_ss_n256(o, sw128_desc(p_lo + kk * 16, 16, 1024), db, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(o);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ------------------------------------------- the split merge (cluster)
  // Q, the rings and P are read for the last time: the region becomes this
  // block's partial O [64][kPartLd], m [64], l by consumer [2][64] and the
  // merge weights and L [64][kMaxCluster + 1]
  named_sync(kBarConsumers, 2 * 128);
  float* part = reinterpret_cast<float*>(base);
  float* m_fin = part + kRows * kPartLd;
  float* l_fin = m_fin + kRows;
  float* wts = l_fin + 2 * kRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    const int r = ra + 8 * h;
    if (tq4 == 0) {
      l_fin[w * kRows + r] = l_run[h];
      if (w == 0) m_fin[r] = m_run[h];
    }
    if (has_cols) {
#pragma unroll
      for (int j = 0; j < kWgCols / 8; ++j)
        *reinterpret_cast<float2*>(part + r * kPartLd + kWgCols * w + 8 * j +
                                   2 * tq4) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
  cluster.sync();            // every split's partial written

  // this block's rows [rb, re): weights 2^(m_j - M) of each split j (M =
  // max m_j; a split that saw no key of the row weighs 0) and L = Σ_j
  // weight_j·l_j, then out = Σ_j weight_j·O_j / max(L, 1e-30), O_j read
  // from the other blocks' shared memory (this block's own from its own)
  const int per = (kRows + n_splits - 1) / n_splits;
  const int rb = min(kRows, split * per), re = min(kRows, rb + per);
  if (ctid < re - rb) {
    const int r = rb + ctid;
    float mj[kMaxCluster], lj[kMaxCluster], M = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      mj[j] = -INFINITY;
      lj[j] = 0.0f;
      if (j < n_splits) {
        const float* mr = j == split ? m_fin
                                     : cluster.map_shared_rank(m_fin, j);
        mj[j] = mr[r];
        lj[j] = mr[kRows + r] + mr[2 * kRows + r];     // l_fin follows m
      }
      M = fmaxf(M, mj[j]);
    }
    float L = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      mj[j] = mj[j] == -INFINITY ? 0.0f : ex2(mj[j] - M);
      L += mj[j] * lj[j];
      wts[ctid * (kMaxCluster + 1) + j] = mj[j];
    }
    wts[ctid * (kMaxCluster + 1) + kMaxCluster] = fmaxf(L, 1e-30f);
  }
  named_sync(kBarConsumers, 2 * 128);
  // a thread per column quad and every other row: the row's weights and
  // output address are worked out once a row, its n loads are in flight
  // together
  const int cq = ctid & 127;
  if (!(kOmit & 16) && 4 * cq < p.dv) {
    for (int r = rb + (ctid >> 7); r < re; r += 2) {
      const int row = r0 + r;
      if (row >= R) break;
      const float* w_r = wts + (r - rb) * (kMaxCluster + 1);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (j < n_splits) {
          const float* pj =
              j == split ? part : cluster.map_shared_rank(part, j);
          const float4 x =
              *reinterpret_cast<const float4*>(pj + r * kPartLd + 4 * cq);
          acc.x = fmaf(w_r[j], x.x, acc.x);
          acc.y = fmaf(w_r[j], x.y, acc.y);
          acc.z = fmaf(w_r[j], x.z, acc.z);
          acc.w = fmaf(w_r[j], x.w, acc.w);
        }
      }
      const float den = w_r[kMaxCluster];
      const int gq = row / p.Sq, i = row - gq * p.Sq;
      bf16* orow = p.o + b * p.o_sb + (long long)(hk * G + gq) * p.o_sh +
                   (long long)i * p.o_ss;
      *reinterpret_cast<uint2*>(orow + 4 * cq) =
          make_uint2(bf16x2(acc.x / den, acc.y / den),
                     bf16x2(acc.z / den, acc.w / den));
    }
  }
  cluster.sync();            // no block leaves while another reads it
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

// A 4-D bf16 map over (d, s, h, b) with element strides (ss, sh, sb) and a
// box of 64 columns by `rows` rows, 128-byte swizzle, zero fill past the
// extents (d is the call's real head dim, which may end inside a box).  A
// dimension of size 1 is never stepped: its stride is set to a legal value.
bool encode(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
            long long ss, long long sh, long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "flash_mla_wgmma: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const long long row = 2LL * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(s > 1 ? 2 * ss : row),
                                 (cuuint64_t)(h > 1 ? 2 * sh : row),
                                 (cuuint64_t)(b > 1 ? 2 * sb : row)};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_mla_wgmma: cuTensorMapEncodeTiled failed (%d): "
            "dims %d %d %d %d, strides %lld %lld %lld\n", (int)r, d, s, h, b,
            ss, sh, sb);
    return false;
  }
  return true;
}

template <int kBN, bool kVInK>
cudaLaunchConfig_t config(dim3 grid, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Smem<kBN, kVInK>::kBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = grid.x;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kBN, bool kVInK>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(mla_wgmma_kernel<kBN, kVInK>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Smem<kBN, kVInK>::kBytes);
}

template <int kBN, bool kVInK>
cudaError_t launch(const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, dim3 grid, cudaStream_t stream) {
  cudaError_t err = set_smem<kBN, kVInK>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<kBN, kVInK>(grid, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, mla_wgmma_kernel<kBN, kVInK>, tk, tv, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kBN, bool kVInK>
cudaError_t max_clusters(int cluster, int* count) {
  cudaError_t err = set_smem<kBN, kVInK>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<kBN, kVInK>(dim3(cluster, 1, 1), 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, mla_wgmma_kernel<kBN, kVInK>,
                                        &cfg);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// How many clusters of `cluster` blocks (1 to 8) of the instantiation for
// v_in_k can be resident on the current device at once, in *count.
int flash_mla_wgmma_max_clusters(int cluster, int v_in_k, int* count) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  return (int)(v_in_k ? max_clusters<64, true>(cluster, count)
                      : max_clusters<32, false>(cluster, count));
}

// bf16 q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] and
// o [B, Hq, Sq, Dv], each given by its batch, head and sequence strides (in
// elements; the last dimension is contiguous, every stride a multiple of 8
// and every pointer 16-byte aligned); D a multiple of 16 up to 576, Dv a
// multiple of 8 up to 512.  v_in_k = 1 when v is k's first Dv columns (the
// same pointer and strides, Dv <= D): V is then read from K's tiles, which
// hold 64 keys; otherwise 32.  The keys [lo, hi) (0 <= lo <= hi <= Sk) hold
// every key a row may see; with tile = 64 or 32 and t0 = lo / tile, split s
// reads [max(lo, (t0 + s·tiles)·tile), min(hi, (t0 + (s + 1)·tiles)·tile)),
// the splits must reach hi, and they form one cluster: n_splits <= 8.
// window = 0 means no window.
int flash_mla_wgmma_launch(const void* q, const void* k, const void* v,
                           void* o, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int B, int Hq, int Hkv, int Sq,
                           int Sk, int D, int Dv, int causal, int window,
                           int q_offset, float scale, int lo, int hi,
                           int tiles_per_split, int n_splits, int v_in_k,
                           void* stream) {
  const int tile = v_in_k ? 64 : 32;
  if (Hkv <= 0 || Hq % Hkv || D <= 0 || D > kMaxD || D % 16 || Dv <= 0 ||
      Dv > kMaxDv || Dv % 8 || (v_in_k && Dv > D) || lo < 0 || hi < lo ||
      hi > Sk || tiles_per_split < 1 || n_splits < 1 ||
      n_splits > kMaxCluster ||
      (long long)(lo / tile + (long long)n_splits * tiles_per_split) * tile <
          hi)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  const long long rows = (long long)(Hq / Hkv) * Sq;
  const long long row_blocks = (rows + kRows - 1) / kRows;
  if (row_blocks > 65535 || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  // the maps start at key lo and end at hi: TMA zero-fills every key
  // outside the visible range, whatever the cache holds there
  const int span = hi > lo ? hi - lo : 1;
  CUtensorMap tk, tv;
  if (!encode(&tk, static_cast<const bf16*>(k) + lo * k_ss, D, span, Hkv, B,
              k_ss, k_sh, k_sb, tile) ||
      (!v_in_k && !encode(&tv, static_cast<const bf16*>(v) + lo * v_ss, Dv,
                          span, Hkv, B, v_ss, v_sh, v_sb, tile)))
    return (int)cudaErrorInvalidValue;
  if (v_in_k) tv = tk;
  const Params p{static_cast<const bf16*>(q), static_cast<bf16*>(o), q_sb,
                 q_sh, q_ss, o_sb, o_sh, o_ss, Hq, Hkv, Sq, D,
                 (D + kChunk - 1) / kChunk, Dv, (Dv + kChunk - 1) / kChunk,
                 causal, window, q_offset, scale * 1.4426950408889634f, lo,
                 hi, tiles_per_split};
  const dim3 grid(n_splits, (unsigned)row_blocks, (unsigned)(B * Hkv));
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(v_in_k ? launch<64, true>(tk, tv, p, grid, st)
                      : launch<32, false>(tk, tv, p, grid, st));
}

}  // extern "C"
