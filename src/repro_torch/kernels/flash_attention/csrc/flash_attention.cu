// Flash attention forward (online softmax), one launch per call.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (body
// `_flash_kernel`) of src/repro/kernels/flash_attention/kernel.py:
//
//   q (B,H,Sq,D), k/v (B,KV,Skv,D) -> o (B,H,Sq,D) in q's dtype; query head
//   h reads kv head h / (H/KV) (GQA; K/V are never copied per query head);
//   s = (q . k) * D**-0.5, masked to -1e30 where causal (q_pos < k_pos) or
//   outside the sliding window (q_pos - k_pos >= window > 0), positions
//   being the row and column indices from 0; m, l and acc in f32; p rounded
//   to v's dtype before the PV product (f32 accumulation); l clamped at
//   1e-30.
//
// Bound at the main-path shape (prefill of internlm2-1.8b: B=4, S=4096,
// H=16, KV=8, D=128, bf16, causal): tensor-core FLOPs.  4*B*H*S^2*D/2 is
// ~275 GFLOP against 64 MB of q/k/v/o, ~4,300 FLOP per byte, far above the
// H100's ~295 FLOP/byte ridge; only wgmma reaches the tensor cores' full
// rate.  The bf16 kernel (`flash_fwd_bf16_wgmma`) is shaped for that:
//   * one block per (b, h, 128-row query tile), heaviest causal tiles
//     first; three warpgroups: two consumers of 64 query rows each, and a
//     producer warpgroup one thread of which issues every copy.
//     setmaxnreg moves registers from the producer (40 a thread) to the
//     consumers (232); at D=256 from 24 to 240, where a consumer holds its
//     64 x 256 f32 O (128 registers) beside S and P.  The role is taken
//     from a shuffle, so the compiler sees it is warp-uniform;
//   * the producer loads the Q tile once, then streams K and V tiles of 96
//     keys (64 at D <= 64 and at D=256) with TMA (cp.async.bulk.tensor)
//     into a ring of three stages (four at D <= 64; two at D=256, whose 64
//     KB Q tile and 2 x 64 KB of K and V fill shared memory), each stage
//     with full and empty mbarriers for K and for V; no consumer thread
//     computes an address or issues a copy, and only the mbarriers order
//     the warpgroups.  A K/V tile serves 128 query rows: at gemma-7b's
//     prefill (D=256) the blocks read ~4.2 GB of K and V from L2, half of
//     what 64-row blocks would;
//   * S = Q K^T is wgmma m64n96k16 (m64n64k16 for 64-key tiles: 16 steps
//     at D=256) with Q and K read from shared memory
//     (K-major); the online softmax runs on S in registers, in base 2 with
//     the scale folded in (one FMA and one ex2 a score on unmasked tiles);
//     P is rounded to bf16 in registers and is the A operand of O += P V
//     (wgmma m64nDk16), V the B operand read from shared memory in its
//     (keys, D) layout, MN-major, which wgmma transposes as it reads
//     (allowed for 16-bit types);
//   * each consumer issues QK_j^T and then P_{j-1} V_{j-1}, and runs tile
//     j's softmax while that PV product is in flight (the first tile is
//     peeled, so every wait is unconditional).  Nothing but the products
//     writes their registers while they run: a write there makes ptxas
//     serialise every wgmma (warning C7515).  A row whose max did not move
//     keeps o as it is, and a warp skips the rescale when none of its rows
//     moved.  P stays in f32 until PV_{j-1} is done and is packed to bf16
//     only then: packed as the softmax formed it, it landed in the
//     registers the running product reads, and ptxas serialised every
//     wgmma (C7513);
//   * ptxas holds code from which a trap is reachable to the launch's 168
//     registers a thread, setmaxnreg or not (probes/setmaxnreg.py,
//     probes/flash_variants.py): with the waits' hang trap the D=256
//     consumers spilled ~600 bytes and ran 2.5x slower.  At D=256 the waits
//     give up without a trap and the consumers use the 240 registers they
//     are granted, without spills; a wait that gives up adds one to a
//     device word the wrapper owns (`give_ups`), which the wrapper's
//     check_give_ups() reads where its caller already synchronises and
//     raises on, so a give-up never passes silently.  The waits at
//     D <= 128 still trap, and there 96-key tiles fit at D=112 and spill
//     a few bytes at D=128;
//   * the tensor maps are built on the host over the strided (B,H,S,D)
//     views the wrapper is handed (the model's (B,S,H,D) buffers, no
//     copy), four dimensions with the views' own byte strides, and passed
//     as __grid_constant__ parameters.  cuTensorMapEncodeTiled is taken
//     through cudaGetDriverEntryPoint, so the library needs no -lcuda;
//   * tiles land 128-byte swizzled (64-byte at D=32, whose rows are 64
//     bytes), which wgmma's descriptors read without bank conflicts.  A
//     swizzled row spans 64 bf16 columns, so D=128 loads as two 64-column
//     slabs and D=256 as four (PV is m64n256k16, the four slabs of V LBO
//     apart).  D=112 loads as two slabs too: columns 112-127 of the second
//     lie outside the tensor map and TMA fills them with zeros.  The
//     products skip them: QK^T takes 7 steps of 16 columns, not 8, and PV
//     is m64n112k16, so D=112 does the products it needs and no more;
//   * TMA zero-fills rows past Sq and Skv; a zero key scores 0, not -inf,
//     so keys past Skv are masked to -inf here, and query rows past Sq are
//     computed on zeros and never stored.  The mask is computed only on
//     tiles that need it (diagonal, window edge, ragged end); under
//     `causal` the loop stops at the diagonal tile, and the first consumer
//     skips the block's last tile, which its rows never see;
//   * the reduction order depends on the tile positions only, never on the
//     strides, so every layout of the same numbers gives the same output.
// Left for later: trap-free waits at D <= 128 (the consumers then take
// the registers setmaxnreg grants) and 128-key tiles there, a persistent
// grid of one block an SM (one tile's epilogue over the next one's loads),
// the output stored through shared memory with TMA, and FP8.  Ping-pong
// scheduling of the two consumers (named barriers) was tried and moved
// nothing measurable.
//
// f32 runs on plain FMAs in 64-row tiles (`flash_fwd_f32`; the sweep's
// dtype, not the main path's), reading its operands through element
// strides.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ_F32 = 64;     // query rows per block: 16 x 16 threads
constexpr int BK = 64;         // keys per kv tile (f32)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Skv;
  long long qs_b, qs_h, qs_s;   // strides in elements (head dim: 1)
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  long long os_b, os_h, os_s;
  int causal, window;
  float scale;
};

// Whether any score of the (BQ-row tile at q0, 64-key tile at k0) pair is
// masked.
template <int BQ>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int k0) {
  return k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > q0) ||
         (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
}

// Kv tiles a BQ-row query tile at q0 runs: all of them, or under `causal`
// up to and including the one holding key q0 + BQ - 1.
template <int BQ>
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  const int n = (p.Skv + BK - 1) / BK;
  return p.causal ? min(n, (q0 + BQ - 1) / BK + 1) : n;
}

__device__ __forceinline__ float mask_score(float s, int qp, int kp, int Skv,
                                            int causal, int window) {
  if (kp >= Skv) return -INFINITY;   // past the ragged end: contributes 0
  bool keep = !causal || qp >= kp;
  if (window > 0) keep = keep && (qp - kp) < window;
  return keep ? s : kNegInf;
}

__device__ __forceinline__ float apply_mask(float s, int qp, int kp,
                                            const Params& p) {
  return mask_score(s, qp, kp, p.Skv, p.causal, p.window);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int TQ = 128;        // query rows per block: 2 consumers x 64
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS_BF16 = 128 * (CONSUMERS + 1);  // + the producer

// Shared-memory geometry of one head dim: tiles are slabs of SW-byte
// swizzled rows (SW / 2 columns each).
template <int D>
struct Geo {
  // keys a K/V tile and the ring's depth: 96 x 3 at D=96, 112 and 128,
  // where the larger tile pays (D=128 spills a few bytes of P, and is still
  // faster than with 64 keys), 64 x 4 below; 64 x 2 at D=256, whose Q tile
  // (64 KB) and two stages of K and V (128 KB) fill shared memory
  static constexpr int TK = D == 256 ? 64 : D >= 96 ? 96 : 64;
  static constexpr int STAGES = D == 256 ? 2 : D >= 96 ? 3 : 4;
  // setmaxnreg's registers a thread: a consumer at D=256 holds its 64 x 256
  // f32 O (128 registers) beside S and P.  The producer gives up what the
  // consumers take: 128 x (168 - R_P) = 256 x (R_C - 168) of the 168 a
  // thread the launch grants (65,536 / 384, rounded down to 8)
  static constexpr int CONSUMER_REGS = D == 256 ? 240 : 232;
  static constexpr int PRODUCER_REGS = D == 256 ? 24 : 40;
  static_assert(128 * (168 - PRODUCER_REGS) ==
                CONSUMERS * 128 * (CONSUMER_REGS - 168),
                "the producer frees exactly what the consumers take");
  // whether a wait that never ends traps (see mbar_wait)
  static constexpr bool TRAP = D != 256;
  static constexpr int SW = D == 32 ? 64 : 128;
  static constexpr int SLAB = SW / 2;                    // columns a slab
  static constexpr int NSLAB = (D + SLAB - 1) / SLAB;
  static constexpr int Q_BYTES = TQ * SW * NSLAB;
  static constexpr int KV_BYTES = TK * SW * NSLAB;       // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // 1 KB of slack to align the tiles to the swizzle's 1 KB period
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // B128 or B64
};

// Which coordinate of a tensor map is the sequence, head and batch index
// (the head dim is always coordinate 0): the maps order their dimensions
// by stride, which the host chose.
struct MapOrder {
  int s, h, b;
};

struct TmaParams {
  void* o;
  int H, KV, Sq, Skv;
  long long os_b, os_h, os_s;   // output strides in elements (head dim: 1)
  int causal, window;
  float sl2;                    // scale * log2(e)
  MapOrder qo, ko, vo;
  int* give_ups;                // waits that gave up (see mbar_wait)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A phase that
// never completes (a lost arrival or copy) gives up after 2^26 polls, each
// a suspended try_wait (seconds; a block's waits are on its own copies and
// warps, microseconds), instead of holding the card: with TRAP the kernel
// traps, else the wait adds one to `*give_ups` and returns, and the block
// runs on to a wrong output that the wrapper refuses (check_give_ups).
// A trap reachable after setmaxnreg.inc holds ptxas to the launch's 168
// registers a thread there (probes/flash_variants.py), so the D=256
// kernel, whose consumers need 240, counts its give-ups instead.
template <bool TRAP>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity,
                                          int* give_ups) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (polls == (1u << 26)) {
      if constexpr (TRAP) {
        __trap();
      } else {
        atomicAdd(give_ups, 1);
        return;
      }
    }
  }
}

// One TMA box of a 4-d tensor map into shared memory, completing on `bar`.
// (col, row, h, b) are placed at the map's own coordinates.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         const MapOrder& o, int col, int row,
                                         int h, int b, uint64_t* bar) {
  const int c1 = o.s == 1 ? row : o.h == 1 ? h : b;
  const int c2 = o.s == 2 ? row : o.h == 2 ? h : b;
  const int c3 = o.s == 3 ? row : o.h == 3 ? h : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_words(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 96, f32) (+)= A (64 x 16, shared, K-major) * B (96 x 16, shared,
// K-major)^T; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss_n96(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 96, f32) = A (64 x 16, shared, K-major) * B (96 x 16, shared,
// K-major)^T: the first product of a chain, which reads nothing of d
__device__ __forceinline__ void wgmma_ss_n96_zero(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared,
// K-major)^T; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = A (64 x 16, shared, K-major) * B (64 x 16, shared,
// K-major)^T: the first product of a chain, which reads nothing of d
__device__ __forceinline__ void wgmma_ss_n64_zero(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers) * B (16 x 256, shared,
// MN-major: transposed as it is read, which wgmma allows for 16-bit types)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, shared,
// MN-major: transposed as it is read, which wgmma allows for 16-bit types)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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

// d (64 x 112, f32) += A (64 x 16, bf16 in registers) * B (16 x 112, shared,
// MN-major: transposed as it is read, which wgmma allows for 16-bit types)
__device__ __forceinline__ void wgmma_rs_n112(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96, f32) += A (64 x 16, bf16 in registers) * B (16 x 96, shared,
// MN-major: transposed as it is read, which wgmma allows for 16-bit types)
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared,
// MN-major: transposed as it is read, which wgmma allows for 16-bit types)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, bf16 in registers) * B (16 x 32, shared,
// MN-major: transposed as it is read, which wgmma allows for 16-bit types)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int TK>
__device__ __forceinline__ void wgmma_qk_zero(float* s, uint64_t da,
                                              uint64_t db) {
  if constexpr (TK == 96) wgmma_ss_n96_zero(s, da, db);
  else wgmma_ss_n64_zero(s, da, db);
}

template <int TK>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t da, uint64_t db) {
  if constexpr (TK == 96) wgmma_ss_n96(s, da, db, 1);
  else wgmma_ss_n64(s, da, db, 1);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 256) wgmma_rs_n256(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (D == 112) wgmma_rs_n112(o, a, db);
  else if constexpr (D == 96) wgmma_rs_n96(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n32(o, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one consumer thread's two rows (qp0, qp1) over a
// TK-key tile at k0, in base 2 with the scale folded in.  s[i] holds row
// (i % 4 < 2 ? qp0 : qp1), key k0 + 8 (i / 4) + 2t + (i % 2).  Nothing but
// the products writes s (a write there while PV runs would serialise every
// wgmma): the scaled, masked score is formed twice, for the max and for p.
// The mask is computed only on tiles that need it (diagonal, window edge,
// ragged end).
template <int TK>
struct Softmax {
  const TmaParams& p;
  int qlo, qp0, qp1, t;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's
  float c0 = 1.f, c1 = 1.f;   // the last tile's correction of o and l

  __device__ __forceinline__ Softmax(const TmaParams& p_, int qlo_, int qp0_,
                                     int qp1_, int t_)
      : p(p_), qlo(qlo_), qp0(qp0_), qp1(qp1_), t(t_) {}

  template <bool MASK>
  __device__ __forceinline__ float score(const float* s, int i, int k0) const {
    const float x = s[i] * p.sl2;
    if (!MASK) return x;
    return mask_score(x, (i & 2) ? qp1 : qp0,
                      k0 + 8 * (i >> 2) + 2 * t + (i & 1), p.Skv, p.causal,
                      p.window);
  }

  template <bool MASK>
  __device__ __forceinline__ void run(const float* s, float* pr, int k0) {
    // unmasked, the max is taken over the raw scores (the scale is
    // positive) and p = 2^(s * scale - m) is one FMA and one exp2
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const float x = MASK ? score<MASK>(s, i, k0) : s[i];
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    if (!MASK) {
      mx0 *= p.sl2;
      mx1 *= p.sl2;
    }
    // the four threads of a quad hold a row's scores between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const float mn = (i & 2) ? mn1 : mn0;
      pr[i] = ex2(MASK ? score<MASK>(s, i, k0) - mn : fmaf(s[i], p.sl2, -mn));
      if (i & 2) sum1 += pr[i];
      else sum0 += pr[i];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
  }

  __device__ __forceinline__ void tile(const float* s, float* pr, int k0) {
    const bool need = k0 + TK > p.Skv || (p.causal && k0 + TK - 1 > qlo) ||
                      (p.window > 0 && qlo + 63 - k0 >= p.window);
    if (need) run<true>(s, pr, k0);
    else run<false>(s, pr, k0);
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS_BF16, 1)
    flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const TmaParams p) {
  using G = Geo<D>;
  constexpr int TK = G::TK, STAGES = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;
  unsigned char* Ks = base + G::Q_BYTES;                       // STAGES tiles
  unsigned char* Vs = Ks + STAGES * G::KV_BYTES;               // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + G::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  // one block per (query tile, h, b), all on grid.x with the tile fastest
  // (a (tiles, H, B) grid's order, without its 65535 limit on H and B): the
  // heaviest causal tiles of every head go first, the light ones fill the
  // tail
  const int n_qt = (p.Sq + TQ - 1) / TQ;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * TQ;   // heaviest first
  const int h = (int)((blockIdx.x / n_qt) % p.H);
  const int b = (int)(blockIdx.x / n_qt / p.H);
  const int kvh = h / (p.H / p.KV);
  const int n_all = (p.Skv + TK - 1) / TK;
  const int n_tiles = p.causal ? min(n_all, (q0 + TQ - 1) / TK + 1) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMERS * 4);   // one arrival a consumer warp
      mbar_init(v_empty + s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform by construction (a shuffle), so the
  // compiler gives each branch the register budget its setmaxnreg sets
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every copy.  A K
    // stage is refilled once both consumers' QK^T have read it, a V stage
    // once their PV has ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(G::PRODUCER_REGS) : "memory");
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
      for (int s = 0; s < G::NSLAB; ++s)
        tma_load(Qs + s * TQ * G::SW, &qmap, p.qo, s * G::SLAB, q0, h, b,
                 q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES, use = j / STAGES;
        unsigned char* kd = Ks + st * G::KV_BYTES;
        unsigned char* vd = Vs + st * G::KV_BYTES;
        if (use > 0)
          mbar_wait<G::TRAP>(k_empty + st, (use - 1) & 1, p.give_ups);
        mbar_expect_tx(k_full + st, G::KV_BYTES);
#pragma unroll
        for (int s = 0; s < G::NSLAB; ++s)
          tma_load(kd + s * TK * G::SW, &kmap, p.ko, s * G::SLAB, j * TK,
                   kvh, b, k_full + st);
        if (use > 0)
          mbar_wait<G::TRAP>(v_empty + st, (use - 1) & 1, p.give_ups);
        mbar_expect_tx(v_full + st, G::KV_BYTES);
#pragma unroll
        for (int s = 0; s < G::NSLAB; ++s)
          tma_load(vd + s * TK * G::SW, &vmap, p.vo, s * G::SLAB, j * TK,
                   kvh, b, v_full + st);
      }
    }
  } else {
    // ---- consumers: 64 query rows each.  Iteration j issues QK_j^T, then
    // P_{j-1} V_{j-1}, and runs tile j's softmax while the PV product is in
    // flight; the first tile is peeled, so every wait is unconditional ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(G::CONSUMER_REGS) : "memory");
    const int wg = role;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qlo = q0 + wg * 64;             // this warpgroup's first row
    const int qp0 = qlo + warp * 16 + g;      // this thread's rows: qp0, +8
    const int qp1 = qp0 + 8;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    Softmax<TK> sm(p, qlo, qp0, qp1, t);
    uint32_t pa[TK / 16][4];   // P of the last tile, bf16 A fragments
    float s[TK / 2], pr[TK / 2];

    // descriptors of stage 0's tiles (Q: this warpgroup's 64 rows); a
    // descriptor steps by its byte offset >> 4 in the address field
    const uint64_t q_desc = gmma_desc(smem_u32(Qs) + wg * 64 * G::SW, 16,
                                      8 * G::SW, G::LAYOUT);
    const uint64_t k_desc = gmma_desc(smem_u32(Ks), 16, 8 * G::SW, G::LAYOUT);
    const uint64_t v_desc = gmma_desc(smem_u32(Vs), TK * G::SW, 8 * G::SW,
                                      G::LAYOUT);
    // S = Q K_j^T (64 rows x TK keys) over the slabs of the head dim, and
    // O += P V_j (V MN-major, 16 keys a step, the slabs LBO apart).  Each
    // batch is fenced on its own, and no other instruction defines a
    // register of a product while one runs
    auto issue_qk = [&](int j) {
      const int st = j % STAGES;
      mbar_wait<G::TRAP>(k_full + st, (j / STAGES) & 1, p.give_ups);
      fence_regs<D / 2>(o);         // settled while no product is in flight
      fence_words<TK / 4>(&pa[0][0]);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < G::NSLAB; ++sl) {
#pragma unroll
        for (int kk = 0; kk < G::SLAB / 16; ++kk) {
          if (sl * G::SLAB + kk * 16 >= D) break;   // D=96's, D=112's zeros
          const uint64_t da = q_desc + ((sl * TQ * G::SW + kk * 32) >> 4);
          const uint64_t db = k_desc + ((st * G::KV_BYTES + sl * TK * G::SW +
                                         kk * 32) >> 4);
          if (sl == 0 && kk == 0) wgmma_qk_zero<TK>(s, da, db);
          else wgmma_qk<TK>(s, da, db);
        }
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const int st = j % STAGES;
      mbar_wait<G::TRAP>(v_full + st, (j / STAGES) & 1, p.give_ups);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk],
                        v_desc + ((st * G::KV_BYTES + kk * 16 * G::SW) >> 4));
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);   // this warp is done with the stage
    };
    // P rounded to bf16, in the A-operand layout of m64k16: the accumulator
    // of keys 16kk..16kk+15 is that fragment already
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        pa[kk][0] = pack_bf16(pr[8 * kk + 0], pr[8 * kk + 1]);
        pa[kk][1] = pack_bf16(pr[8 * kk + 2], pr[8 * kk + 3]);
        pa[kk][2] = pack_bf16(pr[8 * kk + 4], pr[8 * kk + 5]);
        pa[kk][3] = pack_bf16(pr[8 * kk + 6], pr[8 * kk + 7]);
      }
    };

    mbar_wait<G::TRAP>(q_full, 0, p.give_ups);
    // under `causal` the first warpgroup's rows end a tile before the
    // block's: it skips that last, fully masked tile (no later tile
    // refills its stage, so nothing waits for its release)
    const int n_mine =
        p.causal ? min(n_tiles, (qlo + 63) / TK + 1) : n_tiles;
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs<TK / 2>(s);
    release(k_empty);
    sm.tile(s, pr, 0);
    pack_p();
    for (int j = 1; j < n_mine; ++j) {
      issue_qk(j);
      issue_pv(j - 1);
      wgmma_wait<1>();              // QK_j^T is done; PV_{j-1} may run on
      fence_regs<TK / 2>(s);
      release(k_empty + j % STAGES);
      sm.tile(s, pr, j * TK);
      wgmma_wait<0>();              // PV_{j-1} is done: o and pa are free
      fence_regs<D / 2>(o);
      release(v_empty + (j - 1) % STAGES);
      // a row whose max did not move keeps o as it is (c = 1 exactly); the
      // warp skips the rescale when none of its rows moved
      if (__any_sync(0xffffffffu, sm.c0 != 1.f || sm.c1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? sm.c1 : sm.c0;
      }
      pack_p();
    }
    issue_pv(n_mine - 1);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);

    float l0 = sm.l0, l1 = sm.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.os_b +
                        h * p.os_h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (qp0 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + qp0 * p.os_s + d) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (qp1 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + qp1 * p.os_s + d) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMAs, 16x16 threads, each owning 4 rows x (4 keys | D/16 dims)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32(const Params p) {
  constexpr int BQ = BQ_F32;
  constexpr int LDQ = D + 1;    // odd stride: conflict-free column walks
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * D;

  const int n_qt = (p.Sq + BQ - 1) / BQ;   // grid.x: (query tile, h, b)
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * BQ;
  const int h = (int)((blockIdx.x / n_qt) % p.H);
  const int b = (int)(blockIdx.x / n_qt / p.H);
  const int kvh = h / (p.H / p.KV);
  const float* qg = static_cast<const float*>(p.q) + b * p.qs_b + h * p.qs_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  // q is scaled as it lands, as the reference scales q in f32 before q.k
  for (int c = threadIdx.x; c < BQ * D; c += 256) {
    const int r = c / D, d = c % D;
    Qs[r * LDQ + d] =
        q0 + r < p.Sq ? qg[(long long)(q0 + r) * p.qs_s + d] * p.scale : 0.f;
  }

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = kv_tiles<BQ>(p, q0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    for (int c = threadIdx.x; c < BK * D; c += 256) {
      const int r = c / D, d = c % D;
      const bool in = k0 + r < p.Skv;
      Ks[r * LDQ + d] = in ? kg[(long long)(k0 + r) * p.ks_s + d] : 0.f;
      Vs[r * D + d] = in ? vg[(long long)(k0 + r) * p.vs_s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

    const bool need = tile_needs_mask<BQ>(p, q0, k0);
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (need)
          s[i][jj] = apply_mask(s[i][jj], q0 + ty * 4 + i, k0 + tx + 16 * jj, p);
        mx = fmaxf(mx, s[i][jj]);
      }
      // a row's 64 scores live in the 16 lanes sharing ty
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pe = expf(s[i][jj] - mn);
        sum += pe;
        Ps[(ty * 4 + i) * LDP + tx + 16 * jj] = pe;
      }
      l[i] = l[i] * corr[i] + sum;
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) acc[i][jj] *= corr[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) vv[jj] = Vs[c * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.os_b + h * p.os_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + ty * 4 + i;
    if (row < p.Sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        og[(long long)row * p.os_s + tx + 16 * jj] = acc[i][jj] * inv;
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem =
      (2 * BQ_F32 * (D + 1) + BK * D + BQ_F32 * (BK + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + BQ_F32 - 1) / BQ_F32) * p.H * p.B);
  flash_fwd_f32<D><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Error codes past the runtime's: a tensor map the driver refused
// (kMapError + its CUresult), or no driver entry point.
constexpr int kMapError = 100000;
constexpr int kNoEntryPoint = 99999;

// One (B,H,S,D) bf16 view's tensor map.  geo: 4 dims (innermost first; the
// head dim is dim 0), 3 byte strides of dims 1-3, 4 box dims, the swizzle
// bytes, then which map coordinate is s, h and b: 15 values, from the
// wrapper's `_tma_geometry`.
int encode_map(CUtensorMap* map, const void* ptr, const long long* geo,
               int box_rows, int swizzle, MapOrder* order) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEntryPoint;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(geo[i]);
    box[i] = static_cast<cuuint32_t>(geo[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(geo[4 + i]);
  order->s = static_cast<int>(geo[12]);
  order->h = static_cast<int>(geo[13]);
  order->b = static_cast<int>(geo[14]);
  // the kernel's tiles: one swizzled slab wide, box_rows rows
  if (geo[11] != swizzle || box[0] * 2 != static_cast<cuuint32_t>(swizzle) ||
      box[order->s] != static_cast<cuuint32_t>(box_rows) ||
      box[order->h] != 1 || box[order->b] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

template <int D>
int launch_bf16(const Params& p, const long long* geo, int* give_ups,
                cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap qmap, kmap, vmap;
  TmaParams tp;
  int err = encode_map(&qmap, p.q, geo, TQ, G::SW, &tp.qo);
  if (err == 0) err = encode_map(&kmap, p.k, geo + 15, G::TK, G::SW, &tp.ko);
  if (err == 0) err = encode_map(&vmap, p.v, geo + 30, G::TK, G::SW, &tp.vo);
  if (err != 0) return err;
  tp.o = p.o;
  tp.H = p.H;
  tp.KV = p.KV;
  tp.Sq = p.Sq;
  tp.Skv = p.Skv;
  tp.os_b = p.os_b;
  tp.os_h = p.os_h;
  tp.os_s = p.os_s;
  tp.causal = p.causal;
  tp.window = p.window;
  tp.sl2 = p.scale * kLog2e;
  tp.give_ups = give_ups;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)((p.Sq + TQ - 1) / TQ) * p.H * p.B);
  flash_fwd_bf16_wgmma<D><<<grid, THREADS_BF16, G::SMEM, stream>>>(
      qmap, kmap, vmap, tp);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, bool bf16, const long long* geo, int* give_ups,
           cudaStream_t stream) {
  if (!bf16) return static_cast<int>(launch_f32<D>(p, stream));
  return launch_bf16<D>(p, geo, give_ups, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, s) of
// q, k, v and o in turn; the head dim is contiguous.  tma (bfloat16 only):
// 3 x 15 values, the tensor-map geometry of q, k and v (see encode_map).
// give_ups (bfloat16 only): one int32 on the device, which a wait that
// gives up adds one to (see mbar_wait).  Returns 0 on success, else
// cudaGetLastError() after the launch, or a code past 99,998 for a tensor
// map (see kMapError); the caller raises.
extern "C" int flash_attention_bhsd_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int B, int H, int KV, int Sq, int Skv, int D,
    const long long* strides, const long long* tma, int causal, int window,
    float scale, int* give_ups, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Skv = Skv;
  p.qs_b = strides[0]; p.qs_h = strides[1]; p.qs_s = strides[2];
  p.ks_b = strides[3]; p.ks_h = strides[4]; p.ks_s = strides[5];
  p.vs_b = strides[6]; p.vs_h = strides[7]; p.vs_s = strides[8];
  p.os_b = strides[9]; p.os_h = strides[10]; p.os_s = strides[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  if (bf16 && (tma == nullptr || give_ups == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(p, bf16, tma, give_ups, s);
    case 64: return launch<64>(p, bf16, tma, give_ups, s);
    case 96: return launch<96>(p, bf16, tma, give_ups, s);  // phi-3-vision
    // zamba2's shared block
    case 112: return launch<112>(p, bf16, tma, give_ups, s);
    case 128: return launch<128>(p, bf16, tma, give_ups, s);
    case 256: return launch<256>(p, bf16, tma, give_ups, s);  // gemma-7b
    default: return (int)cudaErrorInvalidValue;
  }
}
