// The clustered design of the mLSTM chunk kernel, kept to be timed beside
// src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu by
// probes/mlstm_variants.py; the package does not build or load it.  Its C
// entry point takes the package kernel's arguments less the q k^T scratch.
//
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
// The design:
//   * the carry does not fit one SM (C is 1 MB of f32 at d = 512), but its
//     columns are independent given the chunk's scalars: h[:, cols] needs
//     C[:, cols], and C[:, cols] += (k w)^T v[:, cols].  So a (b, h) is one
//     thread-block CLUSTER of tiles = ceil(d / 64) CTAs (8 at d = 512, the
//     portable maximum; 2 at d = 128; 1 at d <= 64), and CTA r keeps columns
//     64r.. of C (128 KB at d = 512) in shared memory for the whole scan:
//     C never leaves the chip until the final carry is written;
//   * q k^T and q n need all of d.  CTA r takes the same 64-wide slice of d
//     for them: it computes the partial S = q[:, slice] k[:, slice]^T (the
//     16 x 8 tiles on or below the diagonal only) and the partial q n, and
//     the cluster sums the partials through distributed shared memory, in
//     place: CTA r adds rows r*64/tiles.. of every CTA's partial, in rank
//     order, and writes the sum back into every CTA's buffer, between two
//     cluster barriers.  S is computed once per (b, h, chunk), not once per
//     column tile;
//   * each chunk walks d in slabs of 64 rows: for slab s, h_inter += q[:, s]
//     C[s, cols] with the old C, then C[s, cols] = C[s, cols] * dec + (k[:, s]
//     w)^T v[:, cols], so every slab of q and k is read once a chunk and
//     feeds both products.  Slab s + 1 (the next chunk's first after the
//     last) is copied by cp.async, 16 bytes a copy, into the second of two
//     buffers while slab s computes; v is copied while the next chunk's gate
//     scalars are computed; the gates are loaded a chunk ahead into
//     registers.  CTA r walks the slabs in order and arrives at the cluster
//     barrier right after its own slab, so the other CTAs' partials are
//     ready (the wait is free) by the time its slab loop ends;
//   * the chunk's gate scalars (b, m_tot, dec_in, m', w, about 64 numbers)
//     are computed by a warp scan and warp reductions;
//   * shared memory tiles are 64 floats a row with the column XOR-swizzled by
//     the row (bits 2-4), so the A and B fragments of mma.sync read every
//     operand, row- or column-wise, without bank conflicts and cp.async's
//     16-byte pieces stay whole.  At d = 512 the C tile, two q and two k
//     slab buffers, the v tile and S fill 226 KB of the 227 a block may take;
//   * the arithmetic keeps the reference's order: (b_i - b_j) + log_i_j,
//     (b_last - b_j) + log_i_j - m', C * dec + new.
// Left for later: wgmma (TF32 from shared memory, K-major operands only) for
// S and W v, TMA multicast of q and k to the cluster, and a persistent grid.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LM = 64;                // chunk rows, at most
constexpr int DM = 512;               // head dim, at most
constexpr int TV = 64;                // columns of C a CTA owns; a slab of d
constexpr int MAX_CLUSTER = DM / TV;  // 8, the portable cluster size
constexpr int THREADS = 256;          // 8 warps
constexpr int TILE = LM * TV;         // floats of one swizzled 64 x 64 tile

// dynamic shared memory, in floats: the C tile (tiles * 64 rows), two q and
// two k slabs, the v tile, S (64 rows, then a row of 64 q n partials), then
// seven vectors of LM and four scalars
__host__ __device__ __forceinline__ int c_floats(int tiles) {
  return tiles * TV * TV;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int tiles) {
  return (size_t)(c_floats(tiles) + 4 * TILE + TILE + TILE + LM + 7 * LM + 4) *
         sizeof(float);
}

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

// An A fragment (16 x 8) split once and used across n-tiles: c += a b in
// 3xTF32, the small cross terms first, then hi * hi.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float a[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
  __device__ __forceinline__ void mma(float c[4], float b0, float b1) const {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    mma_tf32(c, lo, bh0, bh1);
    mma_tf32(c, hi, bl0, bl1);
    mma_tf32(c, hi, bh0, bh1);
  }
};

// A fragment of rows r0.. and columns k0.. of a swizzled tile: (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)
__device__ __forceinline__ void a_frag(const float* tile, int r0, int k0,
                                       int g, int t, float a[4]) {
  a[0] = tile[swz(r0 + g, k0 + t)];
  a[1] = tile[swz(r0 + g + 8, k0 + t)];
  a[2] = tile[swz(r0 + g, k0 + t + 4)];
  a[3] = tile[swz(r0 + g + 8, k0 + t + 4)];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int rows, int cols,
                                      bool vec4, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec4) {
      const int q = (tid & 15) * 4;
#pragma unroll
      for (int r = tid >> 4; r < LM; r += THREADS / 16) {
        const bool in = r < rows && q < cols;
        const T* gp = in ? src + r * stride + q : src;
        const uint32_t d = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + swz(r, q)));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(gp), "r"(in ? 16 : 0) : "memory");
      }
    } else {
      const int q = tid & 63;
      for (int r = tid >> 6; r < LM; r += THREADS / 64) {
        const bool in = r < rows && q < cols;
        const T* gp = in ? src + r * stride + q : src;
        const uint32_t d = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + swz(r, q)));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(gp), "r"(in ? 4 : 0) : "memory");
      }
    }
  } else {
    constexpr int STEP = THREADS / 64, U = LM / STEP;
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_chunk_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float sm[];
  const int tiles = p.tiles;
  float* Cs = sm;                        // tiles*64 x 64: columns c0.. of C
  float* Qb = Cs + c_floats(tiles);      // two q slabs
  float* Kb = Qb + 2 * TILE;             // two k slabs
  float* Vs = Kb + 2 * TILE;             // v[:, c0..]
  float* Sb = Vs + TILE;                 // S (partial, summed, then W)
  float* qns = Sb + TILE;                // q n (partial, then summed)
  float* bs = qns + LM;                  // b = cumsum(log_f)
  float* lis = bs + LM;                  // log_i
  float* mtot = lis + LM;                // m_tot
  float* decin = mtot + LM;              // exp(b + m - m_tot)
  float* wv = decin + LM;                // w = exp(b_last - b + log_i - m')
  float* ns = wv + LM;                   // n[c0..], this CTA's slice
  float* rsum = ns + LM;                 // rowsum W
  float* scal = rsum + LM;               // m', exp(b_last + m - m')

  const int r = (int)(blockIdx.x % tiles);   // rank in the (b, h)'s cluster
  const int bh = (int)(blockIdx.x / tiles);
  const int b = bh / p.H, hh = bh % p.H;
  const int d = p.d, L = p.L;
  const int c0 = r * TV;                 // columns of C and h; slice of d
  const int ncols = min(TV, d - c0);
  const T* qg = static_cast<const T*>(p.q) + b * p.qs_b + hh * p.qs_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks_b + hh * p.ks_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs_b + hh * p.vs_h;
  const float* lig = p.li + b * p.is_b + hh * p.is_h;
  const float* lfg = p.lf + b * p.fs_b + hh * p.fs_h;
  T* hg = static_cast<T*>(p.h) + b * p.hs_b + hh * p.hs_h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a warp's 16 rows (m-tile) and 32 columns (four n-tiles) of every product
  const int r0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const float scale = p.scale;
  const bool vec4 = p.vec4 != 0;
  const int n_chunks = p.S / L;

  auto stage_slab = [&](int ck, int s, int buf) {
    const long long s0 = (long long)ck * L;
    stage<T>(Qb + buf * TILE, qg + s0 * p.qs_s + s * TV, p.qs_s, L,
             d - s * TV, vec4, tid);
    stage<T>(Kb + buf * TILE, kg + s0 * p.ks_s + s * TV, p.ks_s, L,
             d - s * TV, vec4, tid);
  };
  auto stage_v = [&](int ck) {
    stage<T>(Vs, vg + (long long)ck * L * p.vs_s + c0, p.vs_s, L, ncols,
             vec4, tid);
  };

  for (int e = tid; e < c_floats(tiles); e += THREADS) Cs[e] = 0.f;
  if (tid < LM) ns[tid] = 0.f;
  stage_slab(0, 0, 0);
  cp_commit();
  stage_v(0);
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

    // ---- the gate scalars: b by a warp scan (two rows a lane), m' and w
    // by a warp max; then m_tot and dec_in, four threads a row
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
      __syncwarp();
      const float last = bs[L - 1];
      const float t0 = lane < L ? (last - bs[lane]) + lis[lane] : -INFINITY;
      const float t1 =
          lane + 32 < L ? (last - bs[lane + 32]) + lis[lane + 32] : -INFINITY;
      float mx = fmaxf(t0, t1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(last + m_prev, mx);
      wv[lane] = lane < L ? expf(t0 - mn) : 0.f;
      wv[lane + 32] = lane + 32 < L ? expf(t1 - mn) : 0.f;
      if (lane == 0) {
        scal[0] = mn;
        scal[1] = expf(last + m_prev - mn);
      }
    }
    __syncthreads();
    {
      const int i = tid >> 2, q4 = tid & 3;
      const float bi = bs[i];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * q4 + jj;
        if (j <= i && j < L) mx = fmaxf(mx, (bi - bs[j]) + lis[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (q4 == 0) {
        const float minter = bi + m_prev, mt = fmaxf(mx, minter);
        mtot[i] = mt;
        decin[i] = expf(minter - mt);
      }
    }
    const float m_next = scal[0], dec_c = scal[1];

    // ---- the slabs of d: h_inter += q[:, s] C[s, cols] (old C); on this
    // CTA's own slab the partial S and q n and the n update; then C[s, cols]
    // = C[s, cols] * dec_c + (k[:, s] w)^T v[:, cols]
    float hacc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) hacc[u][0] = hacc[u][1] = hacc[u][2] = hacc[u][3] = 0.f;
    for (int s = 0; s < tiles; ++s) {
      const int buf = (ck * tiles + s) & 1;
      if (s == 0) cp_wait<1>(); else cp_wait<0>();   // v may still be in flight
      __syncthreads();   // slab s is in; the other buffer is free
      if (s + 1 < tiles) stage_slab(ck, s + 1, buf ^ 1);
      else if (ck + 1 < n_chunks) stage_slab(ck + 1, 0, buf ^ 1);
      cp_commit();
      const float* Qs = Qb + buf * TILE;
      const float* Ks = Kb + buf * TILE;
      float* Cb = Cs + s * TILE;
      const bool own = s == r;
      const int kmax = min(TV, d - s * TV);
      float sacc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[u][0] = sacc[u][1] = sacc[u][2] = sacc[u][3] = 0.f;
      if (r0 < L) {
#pragma unroll 2
        for (int kk = 0; kk < kmax; kk += 8) {
          float a[4];
          a_frag(Qs, r0, kk, g, t, a);
          AFrag fa;
          fa.set(a);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = n0 + 8 * u + g;
            if (n0 + 8 * u < ncols)
              fa.mma(hacc[u], Cb[swz(kk + t, col)], Cb[swz(kk + t + 4, col)]);
          }
          if (own) {   // S: the key tiles on or below the diagonal
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j0 = n0 + 8 * u;
              if (j0 <= r0 + 15 && j0 < L)
                fa.mma(sacc[u], Ks[swz(j0 + g, kk + t)],
                       Ks[swz(j0 + g, kk + t + 4)]);
            }
          }
        }
      }
      if (own) {
        if (r0 < L) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j0 = n0 + 8 * u;
            if (j0 <= r0 + 15 && j0 < L) {
              store2(Sb + swz(r0 + g, j0 + 2 * t), sacc[u][0], sacc[u][1]);
              store2(Sb + swz(r0 + g + 8, j0 + 2 * t), sacc[u][2], sacc[u][3]);
            }
          }
        }
        {   // q n over the slice, with the old n
          const int i = tid >> 2, q4 = tid & 3;
          float acc = 0.f;
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) {
            const int e = 16 * q4 + jj;
            acc = fmaf(Qs[swz(i, e)], ns[e], acc);
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          if (q4 == 0) qns[i] = acc;
        }
        if (tiles > 1) cluster_arrive();   // this CTA's partials are out
      }
      if (s == 0) cp_wait<1>();   // v has landed
      __syncthreads();   // C[s] is read; v, S and q n are visible

      if (s * TV + r0 < d) {
        float nacc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) nacc[u][0] = nacc[u][1] = nacc[u][2] = nacc[u][3] = 0.f;
#pragma unroll 2
        for (int j0 = 0; j0 < L; j0 += 8) {
          const float w0 = wv[j0 + t], w1 = wv[j0 + t + 4];
          const float a[4] = {Ks[swz(j0 + t, r0 + g)] * w0,
                              Ks[swz(j0 + t, r0 + g + 8)] * w0,
                              Ks[swz(j0 + t + 4, r0 + g)] * w1,
                              Ks[swz(j0 + t + 4, r0 + g + 8)] * w1};
          AFrag fa;
          fa.set(a);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = n0 + 8 * u + g;
            if (n0 + 8 * u < ncols)
              fa.mma(nacc[u], Vs[swz(j0 + t, col)], Vs[swz(j0 + t + 4, col)]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
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
      }
      if (own && tid < TV) {   // n[c0..] = n * dec_c + sum_j k_j w_j
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc = fmaf(Ks[swz(j, tid)], wv[j], acc);
        ns[tid] = ns[tid] * dec_c + acc;
      }
    }

    // ---- S and q n summed over the cluster, in place: CTA r sums rows
    // r*per.. of every CTA's partials in rank order and writes the sum back
    // into all of them
    if (tiles > 1) {
      cluster_wait();   // every CTA's partials are out
      cg::cluster_group cluster = cg::this_cluster();
      const int per = (LM + tiles - 1) / tiles;
      const int i0 = r * per, i1 = min(L, i0 + per);
      for (int x = tid; x < (i1 - i0) * (TV + 1); x += THREADS) {
        const int i = i0 + x / (TV + 1), pc = x % (TV + 1);
        int off = TILE + i;   // q n
        if (pc < TV) {
          const int j = pc ^ (((i & 3) << 3) | (((i >> 2) & 1) << 2));
          if (j > i) continue;   // above the diagonal: never read
          off = i * TV + pc;
        }
        float sum = 0.f;
        for (int y = 0; y < tiles; ++y) sum += *cluster.map_shared_rank(Sb + off, y);
        for (int y = 0; y < tiles; ++y) *cluster.map_shared_rank(Sb + off, y) = sum;
      }
      cluster_arrive();
      cluster_wait();   // S and q n are whole in every CTA
    }

    // ---- W = (S * scale) * exp(D - m_tot), masked to j <= i, in place; its
    // row sums, four threads a row
    {
      const int i = tid >> 2, q4 = tid & 3;
      const float bi = bs[i], mt = mtot[i];
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * q4 + jj, o = swz(i, j);
        float w = 0.f;
        if (j <= i && i < L)
          w = Sb[o] * scale * expf((bi - bs[j]) + lis[j] - mt);
        Sb[o] = w;
        rs += w;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      if (q4 == 0) rsum[i] = rs;
    }
    __syncthreads();

    // ---- h = (W v + h_inter * scale * dec_in) / denom
    float hd[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) hd[u][0] = hd[u][1] = hd[u][2] = hd[u][3] = 0.f;
    if (r0 < L) {
      for (int j0 = 0; j0 <= r0 + 15 && j0 < L; j0 += 8) {
        float a[4];
        a_frag(Sb, r0, j0, g, t, a);
        AFrag fa;
        fa.set(a);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = n0 + 8 * u + g;
          if (n0 + 8 * u < ncols)
            fa.mma(hd[u], Vs[swz(j0 + t, col)], Vs[swz(j0 + t + 4, col)]);
        }
      }
    }
    __syncthreads();   // every warp is done with v
    if (ck + 1 < n_chunks) stage_v(ck + 1);
    cp_commit();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      if (i >= L) continue;
      const float di = decin[i];
      const float norm = rsum[i] + qns[i] * scale * di;
      const float denom = fmaxf(fabsf(norm), expf(-mtot[i]));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = n0 + 8 * u + 2 * t;
        if (cc >= ncols) continue;
        const float v0 =
            (hd[u][2 * half] + hacc[u][2 * half] * scale * di) / denom;
        const float v1 =
            (hd[u][2 * half + 1] + hacc[u][2 * half + 1] * scale * di) / denom;
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

  // ---- the final carry
  __syncthreads();
  float* Cg = p.C + (long long)bh * d * d;
  for (int x = tid; x < d * TV; x += THREADS) {
    const int e = x / TV, c = x % TV;
    if (c < ncols) Cg[(long long)e * d + c0 + c] = Cs[swz(e, c)];
  }
  if (tid < ncols) p.n[(long long)bh * d + c0 + tid] = ns[tid];
  if (r == 0 && tid == 0) p.m[bh] = m_prev;
}

template <typename T>
cudaError_t configure(const Params& p, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t bytes = smem_bytes(p.tiles);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)p.B * (unsigned)p.H * (unsigned)p.tiles);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.tiles;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T>(p, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, mlstm_chunk_kernel<T>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and h share it; the gates are f32).
// strides: 18 element strides: q, k, v, log_i, log_f and h, each (b, h, s);
// the d dims are contiguous.  d a multiple of 16 up to 512, L <= 64 dividing
// S (the wrapper checks).  C, n and m receive the final carry.  One cluster
// of ceil(d / 64) CTAs per (b, h).  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int mlstm_chunk_bhsd_launch(int device, int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* log_i, const void* log_f,
                                       void* h, void* C, void* n, void* m,
                                       int B, int H, int S, int d, int L,
                                       const long long* strides, void* stream) {
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

// How many clusters of the f32 kernel at head dim d the card runs at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int mlstm_chunk_max_active_clusters(int device, int d) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (d < 16 || d > DM || d % 16 != 0) return -(int)cudaErrorInvalidValue;
  Params p{};
  p.B = p.H = 1;
  p.tiles = (d + TV - 1) / TV;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure<float>(p, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return -(int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, mlstm_chunk_kernel<float>,
                                       &cfg);
  return err != cudaSuccess ? -(int)err : clusters;
}
