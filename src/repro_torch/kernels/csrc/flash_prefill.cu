// Flash-attention prefill for Hopper (sm_90a): wgmma on both products, Q, K
// and V through TMA and an mbarrier ring, warp-specialised.
//
// Replaces, for every bf16 call that is not decode (ops.route: any
// D and Dv up to 256), the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body `_kernel`).  Same function: s = q·kᵀ·scale; keys masked by kpos < Sk,
// causal qpos >= kpos and window qpos - kpos < window, where qpos = i +
// q_offset; online softmax in f32; out = acc / max(l, 1e-30) in bf16, so a
// row with no unmasked key comes out exactly 0.  GQA: query head h reads KV
// head h / (Hq / Hkv) directly.  f32 calls go to flash_prefill_f32.cu and
// decode calls to flash_decode.cu.
//
// Bound.  Prefill is bound by operations: 2·(D + Dv) per unmasked (query,
// key) pair at the bf16 tensor rate (its times against that bound are in
// PERF.md).  The design is about keeping the tensor cores on that work:
//
// * Products on wgmma.  S = Q·Kᵀ is wgmma m64n64k16 with Q and K read from
//   shared memory through descriptors (K-major, 128-byte swizzle).  O += P·V
//   takes P from registers as the A operand: the f32 S accumulator, turned
//   pairwise into bf16x2, is already in the A-fragment layout.  V is the B
//   operand straight from shared memory, MN-major (the transpose bit set),
//   so V is never transposed.
// * p in two products.  The Pallas kernel keeps p in f32 for p·v.  Here
//   P_hi = bf16(p) and P_lo = bf16(p - P_hi), and O += P_hi·V + P_lo·V: p
//   is carried to within 2^-16 |p| (one product would round it to bf16,
//   2^-8), for 1.5x the counted tensor work at D = Dv.
// * TMA.  Q (once) and each 64-key K and V tile arrive by
//   cp.async.bulk.tensor from CUtensorMaps encoded on the host for each
//   call, 4-D over (D, S, H, B) with the tensors' own strides, so strided
//   views (a transposed projection, a layer of a [L, B, Hkv, max_len, D]
//   cache) are read as they are.  A map's S extent is the call's Sq or Sk:
//   TMA zero-fills rows past it.  With the 128-byte swizzle a box row holds
//   64 bf16, so a tile of D columns is D / 64 boxes side by side, and the
//   descriptors step across those 64-column chunks.
// * Any head dim through five instantiations.  The kernel is instantiated
//   at (D, Dv) in ops.PREFILL_DIMS; a call runs the smallest that holds its
//   dims (ops.prefill_dims: stablelm-12b's D = 160 at (192, 192)).  Its
//   maps keep the call's real D and Dv as the column extent, so TMA
//   zero-fills the columns past them in shared memory: zeros change no
//   score and add nothing to p·v, and the host copies nothing.  Boxes
//   wholly past the real dims are not loaded (and Q·Kᵀ skips their
//   chunks); p·v still runs at the instantiated Dv, and only the real Dv
//   columns are stored.
// * Warp specialisation.  A block is 3 warpgroups: one producer, whose
//   first thread issues every TMA load, and two consumers of 64 query rows
//   each (128 rows a block).  K and V tiles pass through a 2-stage ring:
//   "full" barriers (TMA bytes) and "empty" barriers (one arrival per
//   consumer warp).  setmaxnreg hands the producer's registers to the
//   consumers (24 and 240 a thread): the O accumulator alone is Dv / 2 f32
//   registers a thread.  At D = Dv = 256 the block holds 192 KB of shared
//   memory, so one block runs per SM.
// * Masks only where needed.  Each consumer warpgroup visits the key tiles
//   its rows can see and masks only those that straddle the causal
//   diagonal, the window's edge or Sk (key_tiles / tile_masked, mirrored by
//   ops.prefill_tile_plan); interior tiles skip the mask.  exp2 with
//   scale·log2(e) folded in; a masked score is -inf and gives p = 0
//   exactly, so a row that sees no key keeps l = 0 and comes out 0.
// * Heaviest tiles first.  Blocks go onto the grid with the last query tile
//   first (blockIdx.y counts down), all (b, h) of a query tile together, so
//   causal rows with the most keys start in the first wave.
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWgRows = 64;     // rows per consumer warpgroup
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kBM = kConsumers * kWgRows;   // query rows per block
constexpr int kBN = 64;         // keys per tile
constexpr int kStages = 2;      // K / V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kChunk = 64;      // bf16 per 128-byte swizzled row
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// More than half of an SM's 228 KB: a second block never shares an SM, so
// setmaxnreg always finds the registers the consumers ask for.
constexpr int kMinSmem = 116 * 1024;

struct Params {
  bf16* o;
  long long o_sb, o_sh, o_ss;   // output strides in elements; last dim 1
  int Hq, Hkv, Sq, Sk;
  int d_chunks, dv_chunks;      // 64-column boxes that hold the real D, Dv
  int dv;                       // real Dv (a multiple of 8): columns stored
  int causal;
  int window;                   // 0: no window
  int q_offset;
  float scale_log2;             // scale · log2(e)
};

// ------------------------------------------------------------- tile plan

// The key tiles [first, end) that the real rows [r0, min(r0 + 64, Sq)) of
// a warpgroup can see, and those rows' positions [qlo, qhi]; first == end
// when they see no key.  ops.prefill_tile_plan is the same arithmetic
// (block_m = kWgRows = ops.PREFILL_WG_ROWS, block_n = kBN =
// ops.PREFILL_BLOCK_N), held against the mask by the CPU tests.
struct Tiles {
  int first, end, qlo, qhi;
};

__device__ __forceinline__ Tiles key_tiles(const Params& p, int r0) {
  Tiles t{0, 0, 0, 0};
  const int r1 = min(r0 + kWgRows, p.Sq);
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

// True when some (row, key) of tile kt is masked for these rows: the tile
// runs past Sk, past the first row's diagonal, or past the last row's
// window.  Tiles outside [first, end) are wholly masked and not visited.
__device__ __forceinline__ bool tile_masked(const Params& p, const Tiles& t,
                                            int kt) {
  const int k0 = kt * kBN, k1 = k0 + kBN;
  return k1 > p.Sk || (p.causal && k1 - 1 > t.qlo) ||
         (p.window > 0 && t.qhi - k0 >= p.window);
}

// ------------------------------------------------- barriers, TMA, wgmma

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

// A shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units), layout 1
// (128-byte swizzle) in bits 62-63.  K-major (Q, K): rows 128 bytes apart,
// 8-row groups 1024 bytes apart (SBO); LBO unused.  MN-major (V): LBO is
// the step between 64-column chunks, SBO between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* ptr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
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

// D[64 x 64] (+)= A[64 x 16] · B[16 x 64], A and B in shared memory
// (K-major), D f32 in registers; `accumulate` = 0 overwrites D.
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

// D[64 x N] += A[64 x 16] · B[16 x N]: A from registers (bf16x2 pairs in the
// accumulator's row layout), B in shared memory MN-major (the transpose bit
// set: V's rows are keys, its columns contiguous), D f32 in registers.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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


template <int DV>
__device__ __forceinline__ void wgmma_rs(float (&d)[DV / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DV == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (DV == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (DV == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// ---------------------------------------------------------------- kernel

// Shared memory, from a 1024-byte-aligned base (the swizzle atom): Q as
// D / 64 chunks of [kBM rows][64], then per stage K as D / 64 chunks of
// [kBN keys][64] and V as DV / 64 chunks of [kBN keys][64], then the
// barriers.
template <int D, int DV>
struct Smem {
  static constexpr int kQ = kBM * D;
  static constexpr int kK = kBN * D;
  static constexpr int kV = kBN * DV;
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr size_t kBytes =
      1024 + 2 * (size_t)(kQ + kStages * (kK + kV)) + 8 * kBars;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
attention_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const Params p) {
  using L = Smem<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = qs + L::kQ;
  bf16* vs = ks + kStages * L::kK;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.x / p.Hq, h = blockIdx.x - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;     // heaviest first
  const Tiles t0 = key_tiles(p, q0), t1 = key_tiles(p, q0 + kWgRows);
  int first, end;                  // the block's tiles: both warpgroups'
  if (t0.end == t0.first) {
    first = t1.first;
    end = t1.end;
  } else if (t1.end == t1.first) {
    first = t0.first;
    end = t0.end;
  } else {
    first = min(t0.first, t1.first);
    end = max(t0.end, t1.end);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
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
      // boxes wholly past the real D or Dv are not loaded (see the header)
      mbar_expect_tx(q_full, 2 * kBM * kChunk * p.d_chunks);
#pragma unroll
      for (int c = 0; c < D / kChunk; ++c)
        if (c < p.d_chunks)
          tma_load(qs + c * kBM * kChunk, &tq, q_full, c * kChunk, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = first; kt < end; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&k_full[stage], 2 * kBN * kChunk * p.d_chunks);
#pragma unroll
        for (int c = 0; c < D / kChunk; ++c)
          if (c < p.d_chunks)
            tma_load(ks + stage * L::kK + c * kBN * kChunk, &tk,
                     &k_full[stage], c * kChunk, kt * kBN, hk, b);
        mbar_expect_tx(&v_full[stage], 2 * kBN * kChunk * p.dv_chunks);
#pragma unroll
        for (int c = 0; c < DV / kChunk; ++c)
          if (c < p.dv_chunks)
            tma_load(vs + stage * L::kV + c * kBN * kChunk, &tv,
                     &v_full[stage], c * kChunk, kt * kBN, hk, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c_wg = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;       // fragment row, column pair
  const Tiles mine = c_wg == 0 ? t0 : t1;
  const int row_a = q0 + c_wg * kWgRows + 16 * warp + g;   // and row_a + 8
  const int qpos_a = row_a + p.q_offset;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const bf16* qw = qs + c_wg * kWgRows * kChunk;

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = first; kt < end; ++kt) {
    if (kt < mine.first || kt >= mine.end) {
      // a tile only the other warpgroup's rows see: release it once loaded
      mbar_wait(&k_full[stage], phase);
      mbar_wait(&v_full[stage], phase);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    } else {
      // S = Q·Kᵀ for this warpgroup's 64 rows and the tile's 64 keys
      float s[32];
      mbar_wait(&k_full[stage], phase);
      const bf16* kb = ks + stage * L::kK;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < D / kChunk; ++c) {
        if (c < p.d_chunks) {             // columns past the real D: none
#pragma unroll
          for (int j = 0; j < kChunk / 16; ++j) {
            const uint64_t da = sw128_desc(qw + c * kBM * kChunk + j * 16,
                                           16, 1024);
            const uint64_t db = sw128_desc(kb + c * kBN * kChunk + j * 16,
                                           16, 1024);
            wgmma_ss_n64(s, da, db, c + j > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

      // online softmax in the log2 domain; this thread holds rows row_a
      // (i = 0) and row_a + 8 (i = 1), keys 8j + 2·tq4 + {0, 1}
      float mx[2] = {-INFINITY, -INFINITY};
      if (tile_masked(p, mine, kt)) {
        const int k0 = kt * kBN + 2 * tq4;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + (e & 1);
            const int qpos = qpos_a + 8 * (e >> 1);
            const bool ok = key < p.Sk && (!p.causal || qpos >= key) &&
                            (p.window == 0 || qpos - key < p.window);
            const float x = ok ? s[4 * j + e] * p.scale_log2 : -INFINITY;
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[4 * j + e] * p.scale_log2;
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
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
      // end) and its two bf16 terms as A fragments: keys 16kk..16kk + 15
      uint32_t hi[kBN / 16][4], lo[kBN / 16][4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[e] = ex2(s[4 * j + e] - mu[e >> 1]);
          l[e >> 1] += pr[e];
        }
        const int kk = j >> 1, r = 2 * (j & 1);
        split2(pr[0], pr[1], hi[kk][r], lo[kk][r]);
        split2(pr[2], pr[3], hi[kk][r + 1], lo[kk][r + 1]);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P_hi·V + P_lo·V
      mbar_wait(&v_full[stage], phase);
      const bf16* vb = vs + stage * L::kV;
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * 16 * kChunk,
                                       kBN * kChunk * 2, 1024);
        wgmma_rs<DV>(o, hi[kk], db);
        wgmma_rs<DV>(o, lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // out = acc / max(l, 1e-30): rows with no key have l = 0 and acc = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row_a + 8 * i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss +
                 2 * tq4;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (8 * j < p.dv) {                 // the real Dv columns only
        const __nv_bfloat162 y = __floats2bfloat162_rn(
            o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = y;
      }
    }
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

// A 4-D bf16 map over (d, s, h, b) with element strides (ss, sh, sb) and a
// box of 64 columns by `rows` rows, 128-byte swizzle, zero fill past the
// extents (d is the call's real head dim, which may be narrower than the
// box or end inside one).  A dimension of size 1 is never stepped: its
// stride is set to a legal value.
bool encode(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
            long long ss, long long sh, long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "flash_prefill: cuTensorMapEncodeTiled not found\n");
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
    fprintf(stderr, "flash_prefill: cuTensorMapEncodeTiled failed (%d): "
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
  auto kernel = attention_prefill_kernel<D, DV>;
  const int smem = (int)(Smem<D, DV>::kBytes > (size_t)kMinSmem
                             ? Smem<D, DV>::kBytes : kMinSmem);
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

// bf16 q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv] and
// o [B, Hq, Sq, Dv], each given by its batch, head and sequence strides (in
// elements; the last dimension contiguous, every other stride a multiple of
// 8, every pointer 16-byte aligned; D a multiple of 16, Dv of 8), run by
// the instantiation (Di, Dvi), one of (64, 64), (128, 128), (192, 128),
// (192, 192), (256, 256) (ops.PREFILL_DIMS) with Di >= D and Dvi >= Dv.
// window = 0 means no window.
int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss, int B,
                         int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
                         int Di, int Dvi, int causal, int window, int q_offset,
                         float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || (Sq + kBM - 1) / kBM > 65535 || D < 1 ||
      Dv < 1 || D > Di || Dv > Dvi || D % 16 || Dv % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, Sq, Hq, B, q_ss, q_sh, q_sb, kBM) ||
      !encode(&tk, k, D, Sk > 0 ? Sk : 1, Hkv, B, k_ss, k_sh, k_sb, kBN) ||
      !encode(&tv, v, Dv, Sk > 0 ? Sk : 1, Hkv, B, v_ss, v_sh, v_sb, kBN))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<bf16*>(o), o_sb, o_sh, o_ss, Hq, Hkv, Sq, Sk,
                 (D + kChunk - 1) / kChunk, (Dv + kChunk - 1) / kChunk, Dv,
                 causal, window, q_offset, scale * 1.4426950408889634f};
  cudaStream_t st = (cudaStream_t)stream;
  if (Di == 64 && Dvi == 64) return (int)launch<64, 64>(tq, tk, tv, p, B, st);
  if (Di == 128 && Dvi == 128)
    return (int)launch<128, 128>(tq, tk, tv, p, B, st);
  if (Di == 192 && Dvi == 128)
    return (int)launch<192, 128>(tq, tk, tv, p, B, st);
  if (Di == 192 && Dvi == 192)
    return (int)launch<192, 192>(tq, tk, tv, p, B, st);
  if (Di == 256 && Dvi == 256)
    return (int)launch<256, 256>(tq, tk, tv, p, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
