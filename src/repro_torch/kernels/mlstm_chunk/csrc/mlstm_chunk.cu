// xLSTM chunkwise mLSTM cell, one launch per call.
//
// Replaces the Pallas TPU kernel `mlstm_chunk_bhsd` (body `_mlstm_kernel`) of
// src/repro/kernels/mlstm_chunk/kernel.py.  For each (b, h), over the chunks of
// l rows in order, with an f32 carry C (d x d), n (d) and m, all zero at the
// start:
//
//   b     = cumsum(log_f)                                        (l,)
//   D     = b_i - b_j + log_i_j  for j <= i (masked above)       (l, l)
//   m_tot = max(rowmax D, b + m)
//   W     = (q k^T * scale) * exp(D - m_tot)
//   h     = [W v + (q*scale) C * exp(b + m - m_tot)]
//           / max(|rowsum W + (q*scale) n * exp(b + m - m_tot)|, exp(-m_tot))
//   m'    = max(b_last + m, max_j(b_last - b_j + log_i_j))
//   w     = exp(b_last - b + log_i - m')
//   C     = C * exp(b_last + m - m') + (k * w)^T v
//   n     = n * exp(b_last + m - m') + sum_j k_j w_j
//
// q/k/v (B,H,S,d) share a dtype (f32 or bf16) and are read through strides (the
// d dim contiguous), the gates (B,H,S) are f32, h (B,H,S,d) is in q's dtype;
// every product is in f32.  One deliberate difference: the TPU kernel drops the
// carry after the last chunk, this one also writes it, f32 C (B,H,d,d), n
// (B,H,d) and m (B,H), for the decode cache of a prefill.
//
// Bound at the main-path shape (xlstm-350m prefill: B=4, H=4, S=2048, d=512,
// chunk 64, f32): matrix products.  q C and (k w)^T v are 2 l d^2 FLOPs each
// per chunk, q k^T and W v 2 d per query-key pair on or below the diagonal:
// ~36.5 GFLOP against ~0.29 GB moved.  Every product runs on the tensor cores
// as 3xTF32 (mma.sync m16n8k8, hi*lo + lo*hi + hi*hi accumulated in f32: plain
// TF32 keeps ~3 decimal digits, short of the reference's 1e-4), so the bound
// is 36.5 GFLOP at 495/3 TFLOP/s, 0.221 ms (the bytes need 0.085 ms).
//
// The design, two kernels a call:
//   * `mlstm_qk_kernel`: q k^T of every chunk at once, one block per (b, h,
//     chunk), the 16 x 8 tiles on or below the diagonal only, into an f32
//     scratch (B, H, S, 64).  It needs no carry, so it is the one product
//     that runs in parallel over the chunks, and it is computed once per
//     (b, h, chunk), not once per column tile of C;
//   * `mlstm_chunk_kernel`: the carry does not fit one SM (C is 1 MB of f32
//     at d = 512), but its columns are independent given the chunk's
//     scalars: h[:, cols] needs C[:, cols], and C[:, cols] += (k w)^T
//     v[:, cols].  So a CTA of 16 warps owns one (b, h) and 64 columns of C
//     (128 KB at d = 512), kept in shared memory for the whole scan (C never
//     leaves the chip until the final carry is written), and walks the
//     chunks.  At the serving geometry that is 16 x 8 = 128 CTAs, one wave
//     on 132 SMs.  Every CTA keeps all of n (2 KB) and updates it itself;
//   * each chunk walks d in slabs of 64 rows: for slab s, h_inter += q[:, s]
//     C[s, cols] and q n[s] with the old C and n, then C[s, cols] = C[s, cols]
//     * dec + (k[:, s] w)^T v[:, cols] and n[s] likewise, so every slab of q
//     and k is read once a chunk and feeds both products.  Slab s + 1 (the
//     next chunk's first after the last) is copied by cp.async, 16 bytes a
//     copy, into the second of two buffers while slab s computes; v and the
//     chunk's q k^T are copied while the last chunk's outputs are written;
//     the gates are loaded a chunk ahead into registers;
//   * the chunk's gate scalars (b, m_tot, m', w) are computed by a warp scan
//     and warp reductions, W once per CTA in place of q k^T before the
//     slabs; the key steps of W v (2 to 8, by the warp's rows) are spread
//     over the slabs, so no warp waits at a barrier for the diagonal's
//     longest rows, and W's row sums come from the same A fragments; n's
//     update sum_j k_j w_j from the update's own A fragments;
//   * shared memory tiles are 64 floats a row with the column XOR-swizzled by
//     the row (bits 2-4), so the A and B fragments of mma.sync read every
//     operand, row- or column-wise, without bank conflicts and cp.async's
//     16-byte pieces stay whole.  At d = 512 the C tile, two q and two k
//     slab buffers, v, q k^T, n and four vectors take all 227 KB a block
//     may have;
//   * h_inter: a warp takes two m-tiles and two n-tiles over one half of
//     each slab's keys (each A fragment split once for two n-tiles, each B
//     pair once for two m-tiles), the halves summed at the chunk's end in
//     the last slab's free q buffer; the update and W v: one m-tile and two
//     n-tiles a warp, the three products of a 3xTF32 step into two
//     accumulators (hi * hi; the cross terms); whole slabs unrolled;
//   * the arithmetic keeps the reference's order: (b_i - b_j) + log_i_j,
//     (b_last - b_j) + log_i_j - m', C * dec + new.
// A design with one thread-block cluster per (b, h) instead (the column
// CTAs summing partial q k^T through distributed shared memory, no q k^T
// kernel) is kept as probes/mlstm_cluster.cu: an H100 80GB HBM3 (700 W)
// runs only 15 clusters of 8 such CTAs at once, so the 16 of the serving
// geometry take two waves (probes/mlstm_variants.py reads the occupancy and
// times both; PERF.md).  Left for later:
// wgmma (TF32 from shared memory takes K-major operands only, and 3xTF32
// would need hi and lo copies of the C tile), and a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LM = 64;                // chunk rows, at most
constexpr int DM = 512;               // head dim, at most
constexpr int TV = 64;                // columns of C a CTA owns; a slab of d
constexpr int QK_THREADS = 512;       // the q k^T kernel: 16 warps
constexpr int CHUNK_THREADS = 512;    // the chunk loop: 16 warps
constexpr int TILE = LM * TV;         // floats of one swizzled 64 x 64 tile

// dynamic shared memory of the chunk kernel, in floats: the C tile (tiles *
// 64 rows), two q and two k slabs, the v tile, the chunk's q k^T, all of n
// (tiles * 64), then four vectors of LM: 227 KB, all a block may take, at
// d = 512
__host__ __device__ __forceinline__ int c_floats(int tiles) {
  return tiles * TV * TV;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int tiles) {
  return (size_t)(c_floats(tiles) + 6 * TILE + tiles * TV + 4 * LM) *
         sizeof(float);
}
constexpr int QK_SMEM = 2 * TILE * sizeof(float);   // the q k^T kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* li;   // log input gate (B,H,S)
  const float* lf;   // log forget gate (B,H,S)
  void* h;
  float* C;          // (B,H,d,d) f32, contiguous
  float* n;          // (B,H,d) f32, contiguous
  float* m;          // (B,H) f32
  float* qk;         // (B*H*n_chunks, L, 64) f32 scratch: q k^T of a chunk
  int B, H, S, d, L, tiles;
  int vec4;          // q, k, v rows copy as 16-byte pieces (f32)
  int h_pairs;       // h takes its columns two at a time
  float scale;       // d ** -0.5, rounded from double as torch rounds it
  long long qs_b, qs_h, qs_s;   // strides in elements (the d dim: 1)
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  long long is_b, is_h, is_s;   // log_i
  long long fs_b, fs_h, fs_s;   // log_f
  long long hs_b, hs_h, hs_s;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's cast
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The swizzled offset of (row, col) in a 64-wide tile.  The column is XORed
// with 8 (row & 3) + 4 ((row >> 2) & 1): an A fragment (rows g, columns t)
// and a B fragment read across rows (rows t, columns g) both land on 32
// distinct banks, the accumulator's float2 pairs on distinct bank pairs, and
// aligned groups of 4 columns stay together (cp.async's 16-byte pieces).
__device__ __forceinline__ int swz(int row, int col) {
  return row * TV + (col ^ (((row & 3) << 3) | (((row >> 2) & 1) << 2)));
}

// x = hi + lo: hi is x cut to TF32's 10 mantissa bits (a mask, not a
// conversion), lo the exact f32 rest, whose low 13 bits the tensor core
// drops.  hi*hi + hi*lo + lo*hi then carries ~21 bits of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) split once and used across n-tiles: a b in 3xTF32,
// hi * hi into `c` and the small cross terms lo * hi + hi * lo into `e`, so
// the three products of a step form chains of one and two, not one of three
// (mma.sync's latency, not its rate, bounded the single chain); the caller
// adds e to c at the end.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float a[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
  __device__ __forceinline__ void mma(float c[4], float e[4], float b0,
                                      float b1) const {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    mma_tf32(e, lo, bh0, bh1);
    mma_tf32(e, hi, bl0, bl1);
    mma_tf32(c, hi, bh0, bh1);
  }
};

// c = 0, e = 0 for two n-tiles; then c += e
__device__ __forceinline__ void zero2(float c[2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) c[u][0] = c[u][1] = c[u][2] = c[u][3] = 0.f;
}
__device__ __forceinline__ void fold2(float c[2][4], const float e[2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[u][x] += e[u][x];
}

// A fragment of rows r0.. and columns k0.. of a swizzled tile: (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)
__device__ __forceinline__ void a_frag(const float* tile, int r0, int k0,
                                       int g, int t, float a[4]) {
  a[0] = tile[swz(r0 + g, k0 + t)];
  a[1] = tile[swz(r0 + g + 8, k0 + t)];
  a[2] = tile[swz(r0 + g, k0 + t + 4)];
  a[3] = tile[swz(r0 + g + 8, k0 + t + 4)];
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, 64) x columns [0, 64) of a (rows, cols) slab of global memory, row
// stride `stride` elements, into a swizzled tile as f32, zero past `rows` and
// `cols` (cols a multiple of 16).  f32 goes by cp.async, 16 bytes a copy when
// `vec4`, else 4, the caller committing the group; bf16 is loaded and upcast
// at once (cp.async cannot convert).
template <int NT, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int rows, int cols,
                                      bool vec4, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec4) {
      const int q = (tid & 15) * 4;
#pragma unroll
      for (int r = tid >> 4; r < LM; r += NT / 16) {
        const bool in = r < rows && q < cols;
        const T* gp = in ? src + r * stride + q : src;
        const uint32_t d = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + swz(r, q)));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(gp), "r"(in ? 16 : 0) : "memory");
      }
    } else {
      const int q = tid & 63;
      for (int r = tid >> 6; r < LM; r += NT / 64) {
        const bool in = r < rows && q < cols;
        const T* gp = in ? src + r * stride + q : src;
        const uint32_t d = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + swz(r, q)));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(gp), "r"(in ? 4 : 0) : "memory");
      }
    }
  } else {
    constexpr int STEP = NT / 64, U = LM / STEP;
    const int q = tid & 63;
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = (tid >> 6) + STEP * u;
      v[u] = r < rows && q < cols ? to_f(src[r * stride + q]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) dst[swz((tid >> 6) + STEP * u, q)] = v[u];
  }
}


// ---------------------------------------------------------------------------
// q k^T of every chunk, all chunks in parallel (it needs no carry)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(QK_THREADS)
    mlstm_qk_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ks = sm + TILE;
  const int n_chunks = p.S / p.L;
  const int bh = (int)(blockIdx.x / n_chunks), ck = (int)(blockIdx.x % n_chunks);
  const int b = bh / p.H, hh = bh % p.H;
  const int d = p.d, L = p.L;
  const long long s0 = (long long)ck * L;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs_b + hh * p.qs_h +
                s0 * p.qs_s;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks_b + hh * p.ks_h +
                s0 * p.ks_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a warp's 16 rows and 16 keys (two n-tiles), those on or below the
  // diagonal: several blocks an SM hide each other's copies
  const int r0 = 16 * (warp & 3), n0 = 16 * (warp >> 2);
  const bool busy = r0 < L && n0 <= r0 + 8 && n0 < L;
  float acc[2][4], err[2][4];
  zero2(acc);
  zero2(err);
  for (int e0 = 0; e0 < d; e0 += TV) {
    if (e0) __syncthreads();   // the last slab is read
    stage<QK_THREADS, T>(Qs, qg + e0, p.qs_s, L, d - e0, p.vec4 != 0, tid);
    stage<QK_THREADS, T>(Ks, kg + e0, p.ks_s, L, d - e0, p.vec4 != 0, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (!busy) continue;
    const int kmax = min(TV, d - e0);
#pragma unroll 2
    for (int kk = 0; kk < kmax; kk += 8) {
      float a[4];
      a_frag(Qs, r0, kk, g, t, a);
      AFrag fa;
      fa.set(a);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j0 = n0 + 8 * u;
        if (j0 <= r0 + 8 && j0 < L)
          fa.mma(acc[u], err[u], Ks[swz(j0 + g, kk + t)],
                 Ks[swz(j0 + g, kk + t + 4)]);
      }
    }
  }
  if (!busy) return;
  fold2(acc, err);
  float* out = p.qk + (long long)blockIdx.x * L * TV;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j0 = n0 + 8 * u;
    if (j0 > r0 + 8 || j0 >= L) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      if (i < L)
        store2(out + i * TV + j0 + 2 * t, acc[u][2 * half],
               acc[u][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the chunk loop: one CTA of 16 warps per (b, h, 64 columns of C)
// ---------------------------------------------------------------------------

// One k-step of h_inter += q[:, slab] C[slab, cols] over two m-tiles (rows
// r0.. and r0 + 16..) and two n-tiles (n0..), keys kk..kk+7 of the slab:
// each A fragment split once for two n-tiles and each B pair once for two
// m-tiles; and, in the warps of the first n-tiles (`with_qn`), q n over the
// same keys (rows g, g + 8, g + 16, g + 24 of r0.., summed across the quad
// at the end).
__device__ __forceinline__ void inter_step(const float* Qs, const float* Cb,
                                            const float* nsl, int r0, int n0,
                                            int ncols, int kk, int g, int t,
                                            float c[2][2][4], float qn[4],
                                            bool with_qn) {
  float a[2][4];
  a_frag(Qs, r0, kk, g, t, a[0]);
  a_frag(Qs, r0 + 16, kk, g, t, a[1]);
  if (with_qn) {
    const float n_lo = nsl[kk + t], n_hi = nsl[kk + t + 4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      qn[2 * m] = fmaf(a[m][2], n_hi, fmaf(a[m][0], n_lo, qn[2 * m]));
      qn[2 * m + 1] = fmaf(a[m][3], n_hi, fmaf(a[m][1], n_lo, qn[2 * m + 1]));
    }
  }
  AFrag fa[2];
  fa[0].set(a[0]);
  fa[1].set(a[1]);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int col = n0 + 8 * u + g;
    if (n0 + 8 * u >= ncols) continue;
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(Cb[swz(kk + t, col)], bh0, bl0);
    split_tf32(Cb[swz(kk + t + 4, col)], bh1, bl1);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_tf32(c[m][u], fa[m].lo, bh0, bh1);
      mma_tf32(c[m][u], fa[m].hi, bl0, bl1);
      mma_tf32(c[m][u], fa[m].hi, bh0, bh1);
    }
  }
}

// One row step of (k[:, slab] w)^T v[:, cols]: the warp's slab rows r0..,
// its two n-tiles n0.., chunk rows j0..j0+7; and of sum_j k_j w_j for the
// same rows (g and g + 8, summed across the quad at the end): the A
// fragment's own values.
__device__ __forceinline__ void update_step(const float* Ks, const float* Vs,
                                            const float* wv, int r0, int n0,
                                            int ncols, int j0, int g, int t,
                                            float c[2][4], float e[2][4],
                                            float nsum[2]) {
  const float w0 = wv[j0 + t], w1 = wv[j0 + t + 4];
  const float a[4] = {Ks[swz(j0 + t, r0 + g)] * w0,
                      Ks[swz(j0 + t, r0 + g + 8)] * w0,
                      Ks[swz(j0 + t + 4, r0 + g)] * w1,
                      Ks[swz(j0 + t + 4, r0 + g + 8)] * w1};
  nsum[0] += a[0] + a[2];
  nsum[1] += a[1] + a[3];
  AFrag fa;
  fa.set(a);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int col = n0 + 8 * u + g;
    if (n0 + 8 * u < ncols)
      fa.mma(c[u], e[u], Vs[swz(j0 + t, col)], Vs[swz(j0 + t + 4, col)]);
  }
}

// One key step of W v: the warp's rows r0.., its two n-tiles n0.., keys
// j0..j0+7; and of the row sums of W (rows g and g + 8, summed across the
// quad at the end).
__device__ __forceinline__ void wv_step(const float* Ws, const float* Vs,
                                        int r0, int n0, int ncols, int j0,
                                        int g, int t, float c[2][4],
                                        float e[2][4], float rs[2]) {
  float a[4];
  a_frag(Ws, r0, j0, g, t, a);
  rs[0] += a[0] + a[2];
  rs[1] += a[1] + a[3];
  AFrag fa;
  fa.set(a);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int col = n0 + 8 * u + g;
    if (n0 + 8 * u < ncols)
      fa.mma(c[u], e[u], Vs[swz(j0 + t, col)], Vs[swz(j0 + t + 4, col)]);
  }
}

template <typename T>
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
    mlstm_chunk_kernel(const __grid_constant__ Params p) {
  constexpr int NT = CHUNK_THREADS;
  extern __shared__ __align__(16) float sm[];
  const int tiles = p.tiles;
  float* Cs = sm;                        // tiles*64 x 64: columns c0.. of C
  float* Qb = Cs + c_floats(tiles);      // two q slabs
  float* Kb = Qb + 2 * TILE;             // two k slabs
  float* Vs = Kb + 2 * TILE;             // v[:, c0..]
  float* Ss = Vs + TILE;                 // q k^T of the chunk
  float* ns = Ss + TILE;                 // all of n
  float* bs = ns + tiles * TV;           // b = cumsum(log_f)
  float* lis = bs + LM;                  // log_i
  float* mtot = lis + LM;                // m_tot
  float* wv = mtot + LM;                 // w = exp(b_last - b + log_i - m')

  const int r = (int)(blockIdx.x % tiles);   // the column tile
  const int bh = (int)(blockIdx.x / tiles);
  const int b = bh / p.H, hh = bh % p.H;
  const int d = p.d, L = p.L;
  const int c0 = r * TV;
  const int ncols = min(TV, d - c0);
  const T* qg = static_cast<const T*>(p.q) + b * p.qs_b + hh * p.qs_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks_b + hh * p.ks_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs_b + hh * p.vs_h;
  const float* lig = p.li + b * p.is_b + hh * p.is_h;
  const float* lfg = p.lf + b * p.fs_b + hh * p.fs_h;
  const float* sg = p.qk + (long long)bh * p.S * TV;
  T* hg = static_cast<T*>(p.h) + b * p.hs_b + hh * p.hs_h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a warp's 16 rows (m-tile) and 16 columns (two n-tiles) of every product
  const int r0 = 16 * (warp & 3), n0 = 16 * (warp >> 2);
  const int i0 = r0 + g, i1 = i0 + 8;
  // h_inter: a warp takes two m-tiles and two n-tiles over one half of
  // each slab's keys; the halves are summed at the chunk's end
  const int kh = warp >> 3, ir0 = 32 * (warp & 1), in0 = 16 * ((warp >> 1) & 3);
  const float scale = p.scale;
  const bool vec4 = p.vec4 != 0;
  const int n_chunks = p.S / L;

  auto stage_slab = [&](int ck, int s, int buf) {
    const long long s0 = (long long)ck * L;
    stage<NT, T>(Qb + buf * TILE, qg + s0 * p.qs_s + s * TV, p.qs_s, L,
                 d - s * TV, vec4, tid);
    stage<NT, T>(Kb + buf * TILE, kg + s0 * p.ks_s + s * TV, p.ks_s, L,
                 d - s * TV, vec4, tid);
  };
  auto stage_chunk = [&](int ck) {   // v[:, cols] and q k^T of chunk ck
    stage<NT, T>(Vs, vg + (long long)ck * L * p.vs_s + c0, p.vs_s, L, ncols,
                 vec4, tid);
    stage<NT, float>(Ss, sg + (long long)ck * L * TV, TV, L, TV, true, tid);
  };

  for (int e = tid; e < c_floats(tiles); e += NT) Cs[e] = 0.f;
  for (int e = tid; e < tiles * TV; e += NT) ns[e] = 0.f;
  stage_slab(0, 0, 0);
  cp_commit();
  stage_chunk(0);
  cp_commit();
  float li_r = 0.f, lf_r = 0.f;   // the gates of a row, a chunk ahead
  if (tid < L) {
    li_r = lig[tid * p.is_s];
    lf_r = lfg[tid * p.fs_s];
  }
  float m_prev = 0.f;

  for (int ck = 0; ck < n_chunks; ++ck) {
    const long long s0 = (long long)ck * L;
    __syncthreads();   // the last chunk's reads of the vectors are done
    if (tid < LM) {
      lis[tid] = li_r;
      bs[tid] = lf_r;
    }
    li_r = lf_r = 0.f;
    if (ck + 1 < n_chunks && tid < L) {
      li_r = lig[(s0 + L + tid) * p.is_s];
      lf_r = lfg[(s0 + L + tid) * p.fs_s];
    }
    __syncthreads();

    // ---- the gate scalars: b by warp 0's scan (two rows a lane); then in
    // every warp m' and dec_c by a warp max (w stored by warp 0); m_tot,
    // eight threads a row
    if (warp == 0) {
      const float v0 = bs[2 * lane], v1 = v0 + bs[2 * lane + 1];
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += x;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      bs[2 * lane] = excl + v0;
      bs[2 * lane + 1] = excl + v1;
    }
    __syncthreads();
    float m_next, dec_c;
    {
      const float last = bs[L - 1];
      const float t0 = lane < L ? (last - bs[lane]) + lis[lane] : -INFINITY;
      const float t1 =
          lane + 32 < L ? (last - bs[lane + 32]) + lis[lane + 32] : -INFINITY;
      float mx = fmaxf(t0, t1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      m_next = fmaxf(last + m_prev, mx);
      dec_c = expf(last + m_prev - m_next);
      if (warp == 0) {
        wv[lane] = lane < L ? expf(t0 - m_next) : 0.f;
        wv[lane + 32] = lane + 32 < L ? expf(t1 - m_next) : 0.f;
      }
    }
    {
      const int i = tid >> 3, q8 = tid & 7;
      const float bi = bs[i];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q8 + jj;
        if (j <= i && j < L) mx = fmaxf(mx, (bi - bs[j]) + lis[j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (q8 == 0) mtot[i] = fmaxf(mx, bi + m_prev);
    }

    cp_wait<0>();      // slab 0, v and q k^T of this chunk
    __syncthreads();   // ... and m_tot and w are visible

    // ---- W = (S * scale) * exp(D - m_tot), masked to j <= i, in place of
    // q k^T, eight threads a row
    {
      const int i = tid >> 3, q8 = tid & 7;
      const float bi = bs[i], mt = mtot[i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = q8 + 8 * jj, o = swz(i, j);
        float w = 0.f;
        if (j <= i && i < L)
          w = Ss[o] * scale * expf((bi - bs[j]) + lis[j] - mt);
        Ss[o] = w;
      }
    }

    // ---- the slabs of d: h_inter += q[:, s] C[s, cols] and q n (old C and
    // n); then C[s, cols] = C[s, cols] * dec_c + (k[:, s] w)^T v[:, cols]
    // and n[s] = n[s] * dec_c + sum_j k_j[s] w_j.  The key steps of W v
    // (2 to 8 by the warp's rows) are spread over the slabs, one or two a
    // slab, so no warp waits at a barrier for the diagonal's longest rows
    float hacc[2][2][4], hd[2][4], hderr[2][4];
    float qn[4] = {0.f, 0.f, 0.f, 0.f}, rs[2] = {0.f, 0.f};
    zero2(hacc[0]);
    zero2(hacc[1]);
    zero2(hd);
    zero2(hderr);
    const int wv_steps = r0 < L ? min(r0 / 8 + 2, (L + 7) / 8) : 0;
    for (int s = 0; s < tiles; ++s) {
      const int buf = (ck * tiles + s) & 1;
      cp_wait<0>();
      __syncthreads();   // slab s (and, s == 0, W) is in; the other buffer is free
      if (s + 1 < tiles) stage_slab(ck, s + 1, buf ^ 1);
      else if (ck + 1 < n_chunks) stage_slab(ck + 1, 0, buf ^ 1);
      cp_commit();
      const float* Qs = Qb + buf * TILE;
      const float* Ks = Kb + buf * TILE;
      float* Cb = Cs + s * TILE;
      const int kmax = min(TV, d - s * TV);
      if (ir0 < L && kmax == TV) {   // a whole slab: unrolled
#pragma unroll
        for (int kk = 32 * kh; kk < 32 * kh + 32; kk += 8)
          inter_step(Qs, Cb, ns + s * TV, ir0, in0, ncols, kk, g, t, hacc,
                      qn, in0 == 0);
      } else if (ir0 < L) {
        for (int kk = 32 * kh; kk < min(kmax, 32 * kh + 32); kk += 8)
          inter_step(Qs, Cb, ns + s * TV, ir0, in0, ncols, kk, g, t, hacc,
                      qn, in0 == 0);
      }
      for (int js = s; js < wv_steps; js += tiles)
        wv_step(Ss, Vs, r0, n0, ncols, 8 * js, g, t, hd, hderr, rs);
      __syncthreads();   // C[s] and n[s] are read

      if (s * TV + r0 < d && n0 < ncols) {
        float nacc[2][4], nerr[2][4], nsum[2] = {0.f, 0.f};
        zero2(nacc);
        zero2(nerr);
        if (L == LM) {   // a whole chunk: unrolled
#pragma unroll
          for (int j0 = 0; j0 < LM; j0 += 8)
            update_step(Ks, Vs, wv, r0, n0, ncols, j0, g, t, nacc, nerr,
                        nsum);
        } else {
          for (int j0 = 0; j0 < L; j0 += 8)
            update_step(Ks, Vs, wv, r0, n0, ncols, j0, g, t, nacc, nerr,
                        nsum);
        }
        fold2(nacc, nerr);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (n0 + 8 * u >= ncols) continue;
          const int cc = n0 + 8 * u + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* cp = reinterpret_cast<float2*>(
                Cb + swz(r0 + g + 8 * half, cc));
            float2 x = *cp;
            x.x = x.x * dec_c + nacc[u][2 * half];
            x.y = x.y * dec_c + nacc[u][2 * half + 1];
            *cp = x;
          }
        }
        if (n0 == 0) {   // n[s] for the warp's rows, once per m-tile
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float x = nsum[half];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            float* np = ns + s * TV + r0 + g + 8 * half;
            if (t == 0) *np = *np * dec_c + x;
          }
        }
      }
    }
    fold2(hd, hderr);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      qn[x] += __shfl_xor_sync(0xffffffffu, qn[x], 1);
      qn[x] += __shfl_xor_sync(0xffffffffu, qn[x], 2);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 1);
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 2);
    }
    // the two key halves of h_inter summed into the last slab's q buffer
    // (free until the next chunk's second slab), and q n into log_i's place
    float* Hs = Qb + ((ck * tiles + tiles - 1) & 1) * TILE;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if (kh == pass) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* hp = reinterpret_cast<float2*>(
                  Hs + swz(ir0 + 16 * m + g + 8 * half, in0 + 8 * u + 2 * t));
              const float2 x = make_float2(hacc[m][u][2 * half],
                                           hacc[m][u][2 * half + 1]);
              *hp = pass ? make_float2(hp->x + x.x, hp->y + x.y) : x;
            }
        if (in0 == 0 && t == 0) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = ir0 + g + 8 * x;
            lis[i] = pass ? lis[i] + qn[x] : qn[x];
          }
        }
      }
      __syncthreads();   // (the second: every warp is done with v and W)
    }
    if (ck + 1 < n_chunks) stage_chunk(ck + 1);
    cp_commit();

    // ---- h = (W v + h_inter * scale * dec_in) / denom
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? i1 : i0;
      if (i >= L) continue;
      const float mt = mtot[i];
      const float di = expf((bs[i] + m_prev) - mt);
      const float norm = rs[half] + lis[i] * scale * di;
      const float denom = fmaxf(fabsf(norm), expf(-mt));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = n0 + 8 * u + 2 * t;
        if (cc >= ncols) continue;
        const float2 hi = *reinterpret_cast<const float2*>(Hs + swz(i, cc));
        const float v0 = (hd[u][2 * half] + hi.x * scale * di) / denom;
        const float v1 = (hd[u][2 * half + 1] + hi.y * scale * di) / denom;
        T* dst = hg + (s0 + i) * p.hs_s + c0 + cc;
        if (p.h_pairs) {
          store2(dst, v0, v1);
        } else {
          store(dst, v0);
          store(dst + 1, v1);
        }
      }
    }
    m_prev = m_next;
  }

  // ---- the final carry: this CTA's columns of C and slice of n
  __syncthreads();
  float* Cg = p.C + (long long)bh * d * d;
  for (int x = tid; x < d * TV; x += NT) {
    const int e = x / TV, c = x % TV;
    if (c < ncols) Cg[(long long)e * d + c0 + c] = Cs[swz(e, c)];
  }
  if (tid < ncols) p.n[(long long)bh * d + c0 + tid] = ns[c0 + tid];
  if (r == 0 && tid == 0) p.m[bh] = m_prev;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_qk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QK_SMEM);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes(p.tiles);
  err = cudaFuncSetAttribute(mlstm_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned bh = (unsigned)p.B * (unsigned)p.H;
  mlstm_qk_kernel<T><<<bh * (unsigned)(p.S / p.L), QK_THREADS, QK_SMEM,
                       stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_chunk_kernel<T><<<bh * (unsigned)p.tiles, CHUNK_THREADS, bytes,
                          stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and h share it; the gates are f32).
// strides: 18 element strides: q, k, v, log_i, log_f and h, each (b, h, s);
// the d dims are contiguous.  d a multiple of 16 up to 512, L <= 64 dividing
// S (the wrapper checks).  qk: an f32 scratch of B * H * S * 64 floats (q
// k^T of every chunk).  C, n and m receive the final carry.  Two kernels: q
// k^T of every chunk, then the chunk loop, one CTA per (b, h, 64 columns of
// C).  Returns cudaGetLastError() after the launches (0 on success); the
// caller raises on anything else.
extern "C" int mlstm_chunk_bhsd_launch(int device, int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* log_i, const void* log_f,
                                       void* h, void* C, void* n, void* m,
                                       void* qk, int B, int H, int S, int d,
                                       int L, const long long* strides,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > LM || S % L != 0 || d < 16 || d > DM || d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.li = static_cast<const float*>(log_i);
  p.lf = static_cast<const float*>(log_f);
  p.h = h;
  p.C = static_cast<float*>(C);
  p.n = static_cast<float*>(n);
  p.m = static_cast<float*>(m);
  p.qk = static_cast<float*>(qk);
  p.B = B;
  p.H = H;
  p.S = S;
  p.d = d;
  p.L = L;
  p.tiles = (d + TV - 1) / TV;
  p.scale = (float)pow((double)d, -0.5);
  p.qs_b = strides[0]; p.qs_h = strides[1]; p.qs_s = strides[2];
  p.ks_b = strides[3]; p.ks_h = strides[4]; p.ks_s = strides[5];
  p.vs_b = strides[6]; p.vs_h = strides[7]; p.vs_s = strides[8];
  p.is_b = strides[9]; p.is_h = strides[10]; p.is_s = strides[11];
  p.fs_b = strides[12]; p.fs_h = strides[13]; p.fs_s = strides[14];
  p.hs_b = strides[15]; p.hs_h = strides[16]; p.hs_s = strides[17];
  bool v4 = dtype == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  for (int i = 0; i < 9; ++i) v4 = v4 && strides[i] % 4 == 0;
  p.vec4 = v4;
  const int es = dtype == 0 ? 4 : 2;
  p.h_pairs = aligned(h, 2 * es) && p.hs_b % 2 == 0 && p.hs_h % 2 == 0 &&
              p.hs_s % 2 == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, s);
    case 1: return (int)launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
