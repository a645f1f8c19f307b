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
// H100's ~295 FLOP/byte ridge.  What the design does about it:
//   * the TPU kernel's sequential kv grid axis, with (m, l, acc) in VMEM
//     scratch, becomes a loop inside one block: one block per (b, h,
//     128-row query tile), 8 warps of 16 query rows; each 64-key K/V tile
//     streams through shared memory once per block and is read by all eight
//     warps, double-buffered with cp.async so the next tile's copy overlaps
//     this tile's products;
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//     accumulation); S stays in registers and is re-packed as the A operand
//     of the PV product, so scores never touch shared or device memory;
//     V's B fragments come from ldmatrix.trans; the softmax runs in base 2
//     (the scale folded with log2 e), which is the same function;
//   * under `causal` the loop stops at the diagonal tile (the counterpart of
//     the reference's `pl.when(run)` skip) and the heaviest query tiles are
//     scheduled first;
//   * the mask is computed only on tiles that need it (diagonal, window
//     edge, ragged end); keys past Skv score -inf so a ragged last tile
//     contributes nothing, and query rows past Sq are computed on zeros and
//     never stored: every (Sq, Skv) the reference takes is taken here;
//   * q/k/v/o are read through strides (the head dim contiguous), so the
//     model's (B,S,H,D) layout needs no transpose.
// f32 runs on plain FMAs in 64-row tiles (the sweep's dtype, not the main
// path's).  wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ_BF16 = 128;   // query rows per block: 8 warps of 16
constexpr int BQ_F32 = 64;     // query rows per block: 16 x 16 threads
constexpr int BK = 64;         // keys per kv tile
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

__device__ __forceinline__ float apply_mask(float s, int qp, int kp,
                                            const Params& p) {
  if (kp >= p.Skv) return -INFINITY;   // past the ragged end: contributes 0
  bool keep = !p.causal || qp >= kp;
  if (p.window > 0) keep = keep && (qp - kp) < p.window;
  return keep ? s : kNegInf;
}

// Start copying rows [row0, row0 + ROWS) of a (rows, D) slab into shared
// memory with row stride LD, 16 bytes a cp.async; rows past `nrows` are
// zero-filled (a zero-byte source read, from the slab's first row).
template <typename T, int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long stride, int row0,
                                                int nrows) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int CH = D / PER;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool in = row0 + r < nrows;
    const T* g = src + (long long)(in ? row0 + r : 0) * stride + cc * PER;
    const uint32_t d = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + r * LD + cc * PER));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(g), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_bf16(const Params p) {
  constexpr int BQ = BQ_BF16;
  constexpr int LD = D + 8;   // padded rows: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  // Q, then two stages of (K, V)
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KVs = Qs + BQ * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.qs_b + h * p.qs_h;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.vs_b + kvh * p.vs_h;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;          // this thread's rows: r0, r0 + 8
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  const float sl2 = p.scale * kLog2e;    // scores in base 2

  const int n_tiles = kv_tiles<BQ>(p, q0);
  load_tile_async<__nv_bfloat16, D, LD, BQ, 256>(Qs, qg, p.qs_s, q0, p.Sq);
  load_tile_async<__nv_bfloat16, D, LD, BK, 256>(KVs, kg, p.ks_s, 0, p.Skv);
  load_tile_async<__nv_bfloat16, D, LD, BK, 256>(KVs + BK * LD, vg, p.vs_s, 0,
                                                 p.Skv);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {   // prefetch the next tile into the other stage
      __nv_bfloat16* nxt = KVs + ((j + 1) & 1) * 2 * BK * LD;
      load_tile_async<__nv_bfloat16, D, LD, BK, 256>(nxt, kg, p.ks_s, k0 + BK,
                                                     p.Skv);
      load_tile_async<__nv_bfloat16, D, LD, BK, 256>(nxt + BK * LD, vg,
                                                     p.vs_s, k0 + BK, p.Skv);
      cp_async_commit();
      cp_async_wait<1>();    // everything but that prefetch has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* base = Qs + kk * 16 + 2 * t;
        qf[kk][0] = ld32(base + r0 * LD);
        qf[kk][1] = ld32(base + (r0 + 8) * LD);
        qf[kk][2] = ld32(base + r0 * LD + 8);
        qf[kk][3] = ld32(base + (r0 + 8) * LD + 8);
      }
    }
    const __nv_bfloat16* Ks = KVs + (j & 1) * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[n], qf[kk], ld32(kb), ld32(kb + 8));
      }
    }

    const bool need = tile_needs_mask<BQ>(p, q0, k0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (need)
          x = apply_mask(x, e < 2 ? qp0 : qp1, k0 + n * 8 + 2 * t + (e & 1), p);
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the four threads of a group hold a row's 64 scores between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + sum0;   // this thread's share of the row sum
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V: P (rounded to bf16) is the A operand straight from registers
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* vrow =
          Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + dn * 16);
        mma_16816(o[2 * dn], a, bv[0], bv[1]);
        mma_16816(o[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.os_b + h * p.os_h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (qp0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + qp0 * p.os_s + d) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (qp1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + qp1 * p.os_s + d) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
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

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
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
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  cudaError_t err;
  if (bf16) {
    constexpr int smem = (BQ_BF16 + 4 * BK) * (D + 8) * 2;   // Q + 2 x (K, V)
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + BQ_BF16 - 1) / BQ_BF16, p.H, p.B);
    flash_fwd_bf16<D><<<grid, 256, smem, stream>>>(p);
  } else {
    constexpr int smem =
        (2 * BQ_F32 * (D + 1) + BK * D + BQ_F32 * (BK + 1)) * 4;
    err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + BQ_F32 - 1) / BQ_F32, p.H, p.B);
    flash_fwd_f32<D><<<grid, 256, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, s) of
// q, k, v and o in turn; the head dim is contiguous.  Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
extern "C" int flash_attention_bhsd_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int B, int H, int KV, int Sq, int Skv, int D,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
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
  const bool bf16 = dtype == 1;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch<32>(p, bf16, s);
    case 64: return (int)launch<64>(p, bf16, s);
    case 112: return (int)launch<112>(p, bf16, s);   // zamba2's shared block
    case 128: return (int)launch<128>(p, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
