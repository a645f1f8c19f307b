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
// chunk 64, f32): f32 FMAs.  q C and (k w)^T v are 2 l d^2 FLOPs each per
// chunk, q k^T and W v 2 d per query-key pair on or below the diagonal:
// ~36.5 GFLOP against ~0.29 GB moved, ~128 FLOP a byte, far above the ~20
// FLOP/byte ridge of 66.9 TFLOP/s over 3.35 TB/s.  This first form is simple
// and right; what it does about the bound:
//   * the TPU kernel keeps the (d, d) carry in VMEM, one program per (b, h);
//     at d = 512 that is 1 MB of f32, more than four times an SM's shared
//     memory.  Columns of C are independent given the chunk's scalars
//     (h[:, cols] needs C[:, cols]; C[:, cols] += (k w)^T v[:, cols]), so a
//     block owns one (b, h) and a tile of TV = 64 columns of C (128 KB of
//     shared memory at d = 512) and of h, and loops over the chunks (blocks
//     run in no order, so nothing carries between them).  At the serving
//     geometry that is 16 pairs x 8 tiles = 128 blocks, one wave on 132 SMs;
//   * each block recomputes what needs all of d: the gate scalars, q k^T (7
//     of its 8 copies are redundant, ~28 % of what a block executes at d =
//     512) and the normaliser n (every block keeps all of n; the first tile
//     writes it).  q and k stream through shared memory in slabs of 64 of d,
//     transposed, so every product is a 4x4 register tile per thread fed by
//     16-byte loads;
//   * the arithmetic keeps the reference's order: (b_i - b_j) + log_i_j,
//     (b_last - b_j) + log_i_j - m', C * dec + new.
// The masked upper triangle of q k^T, tensor cores (3xTF32) and a single
// q k^T per (b, h, chunk) shared by its column tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LM = 64;        // chunk rows, at most
constexpr int DM = 512;       // head dim, at most
constexpr int TV = 64;        // columns of C and h a block owns
constexpr int KS = 64;        // slab of d streamed through shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 register tile each
constexpr int LDT = 68;       // row stride of the 64-wide tiles (16-byte rows)
constexpr int TILE = KS * LDT;

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
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows of d rounded up to whole slabs
__host__ __device__ __forceinline__ int slab_rows(int d) {
  return (d + KS - 1) / KS * KS;
}

__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  // C tile, two 64 x LDT tiles, n, eight vectors of LM scalars, 4 scalars
  return (size_t)slab_rows(d) * TV + 2 * TILE + slab_rows(d) + 8 * LM + 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) mlstm_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int DR = slab_rows(p.d);
  float* Cs = sm;                    // DR x TV: this block's columns of C
  float* As = Cs + DR * TV;          // q slab^T, then W^T, then (k w) slab
  float* Bs = As + TILE;             // k slab^T, then the v tile
  float* ns = Bs + TILE;             // DR: all of n
  float* bs = ns + DR;               // LM: b = cumsum(log_f)
  float* lis = bs + LM;              // LM: log_i
  float* lfs = lis + LM;             // LM: log_f
  float* mtot = lfs + LM;            // LM: m_tot
  float* decin = mtot + LM;          // LM: exp(b + m - m_tot)
  float* tend = decin + LM;          // LM: b_last - b + log_i
  float* wkv = tend + LM;            // LM: exp(tend - m')
  float* qns = wkv + LM;             // LM: q n (unscaled)
  float* scal = qns + LM;            // m', exp(b_last + m - m')

  const int bh = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int b = bh / p.H, hh = bh % p.H;
  const int c0 = tile * TV;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs_b + hh * p.qs_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks_b + hh * p.ks_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs_b + hh * p.vs_h;
  const float* lig = p.li + b * p.is_b + hh * p.is_h;
  const float* lfg = p.lf + b * p.fs_b + hh * p.fs_h;
  T* hg = static_cast<T*>(p.h) + b * p.hs_b + hh * p.hs_h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int L = p.L, d = p.d;
  const float scale = p.scale;

  for (int e = tid; e < DR * TV; e += THREADS) Cs[e] = 0.f;
  for (int e = tid; e < DR; e += THREADS) ns[e] = 0.f;
  float m_prev = 0.f;

  const int n_chunks = p.S / L;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const long long s0 = (long long)ck * L;
    __syncthreads();   // the last chunk's reads of every buffer are done

    // ---- the chunk's gate scalars (the same in every block of this (b, h))
    if (tid < L) {
      lis[tid] = lig[(s0 + tid) * p.is_s];
      lfs[tid] = lfg[(s0 + tid) * p.fs_s];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) {
        acc += lfs[j];
        bs[j] = acc;
      }
    }
    __syncthreads();
    if (tid < L) {
      const float bi = bs[tid];
      float mx = -INFINITY;
      for (int j = 0; j <= tid; ++j) mx = fmaxf(mx, bi - bs[j] + lis[j]);
      const float minter = bi + m_prev;
      const float mt = fmaxf(mx, minter);
      mtot[tid] = mt;
      decin[tid] = expf(minter - mt);
      tend[tid] = bs[L - 1] - bi + lis[tid];
    }
    __syncthreads();
    if (tid == 0) {
      float mx = -INFINITY;
      for (int j = 0; j < L; ++j) mx = fmaxf(mx, tend[j]);
      const float mn = fmaxf(bs[L - 1] + m_prev, mx);
      scal[0] = mn;
      scal[1] = expf(bs[L - 1] + m_prev - mn);
    }
    __syncthreads();
    const float m_next = scal[0], dec_c = scal[1];
    if (tid < L) wkv[tid] = expf(tend[tid] - m_next);

    // ---- S = q k^T and h_inter = q C[:, cols] over slabs of d; q n too.
    // Thread (ty, tx): rows 4ty..4ty+3, S columns (keys) and h columns
    // 4tx..4tx+3.
    float s[4][4], hi[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = hi[r][c] = 0.f;
    float qn = 0.f;
    for (int e0 = 0; e0 < DR; e0 += KS) {
      __syncthreads();   // the last slab's reads are done
      for (int x = tid; x < LM * KS; x += THREADS) {
        const int i = x / KS, e = x % KS;
        const bool in = i < L && e0 + e < d;
        As[e * LDT + i] = in ? to_f(qg[(s0 + i) * p.qs_s + e0 + e]) : 0.f;
        Bs[e * LDT + i] = in ? to_f(kg[(s0 + i) * p.ks_s + e0 + e]) : 0.f;
      }
      __syncthreads();
      if (tid < LM) {
#pragma unroll 8
        for (int e = 0; e < KS; ++e) qn = fmaf(As[e * LDT + tid], ns[e0 + e], qn);
      }
#pragma unroll 4
      for (int e = 0; e < KS; ++e) {
        const float4 qv = ld4(As + e * LDT + 4 * ty);
        const float4 kv = ld4(Bs + e * LDT + 4 * tx);
        const float4 cv = ld4(Cs + (e0 + e) * TV + 4 * tx);
        const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
        const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
            hi[r][c] = fmaf(qr[r], cc[c], hi[r][c]);
          }
      }
    }
    __syncthreads();   // the slabs' reads are done: As and Bs are free

    // ---- W = (S * scale) * exp(D - m_tot), masked to j <= i, stored as W^T;
    // its row sums; the v tile
    if (tid < LM) qns[tid] = qn;
    float rsum[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      rsum[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * tx + c;
        float w = 0.f;
        if (j <= i && i < L)
          w = s[r][c] * scale * expf(bs[i] - bs[j] + lis[j] - mtot[i]);
        As[j * LDT + i] = w;
        rsum[r] += w;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], off);
    for (int x = tid; x < LM * TV; x += THREADS) {
      const int j = x / TV, c = x % TV;
      Bs[j * LDT + c] = j < L && c0 + c < d
          ? to_f(vg[(s0 + j) * p.vs_s + c0 + c]) : 0.f;
    }
    __syncthreads();

    // ---- h = (W v + h_inter * scale * dec_in) / denom
    {
      float hd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) hd[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float4 wv = ld4(As + j * LDT + 4 * ty);
        const float4 vv = ld4(Bs + j * LDT + 4 * tx);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) hd[r][c] = fmaf(wr[r], vc[c], hd[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        if (i >= L) continue;
        const float di = decin[i];
        const float norm = rsum[r] + qns[i] * scale * di;
        const float denom = fmaxf(fabsf(norm), expf(-mtot[i]));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + 4 * tx + c;
          if (col < d)
            store(hg + (s0 + i) * p.hs_s + col,
                  (hd[r][c] + hi[r][c] * scale * di) / denom);
        }
      }
    }

    // ---- the carry: C[:, cols] = C * dec_c + (k w)^T v[:, cols] and
    // n = n * dec_c + sum_j k_j w_j, over slabs of d.  Thread (ty, tx): C
    // rows e0 + 4ty..4ty+3, columns 4tx..4tx+3.
    for (int e0 = 0; e0 < DR; e0 += KS) {
      __syncthreads();   // W^T (first slab) or the last slab is read
      for (int x = tid; x < LM * KS; x += THREADS) {
        const int j = x / KS, e = x % KS;
        As[j * LDT + e] = j < L && e0 + e < d
            ? to_f(kg[(s0 + j) * p.ks_s + e0 + e]) * wkv[j] : 0.f;
      }
      __syncthreads();
      if (tid < KS) {
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc += As[j * LDT + tid];
        ns[e0 + tid] = ns[e0 + tid] * dec_c + acc;
      }
      float up[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) up[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float4 kv = ld4(As + j * LDT + 4 * ty);
        const float4 vv = ld4(Bs + j * LDT + 4 * tx);
        const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) up[r][c] = fmaf(kr[r], vc[c], up[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* row = Cs + (e0 + 4 * ty + r) * TV + 4 * tx;
#pragma unroll
        for (int c = 0; c < 4; ++c) row[c] = row[c] * dec_c + up[r][c];
      }
    }
    m_prev = m_next;
  }

  // ---- the final carry
  __syncthreads();
  float* Cg = p.C + (long long)bh * d * d;
  for (int x = tid; x < d * TV; x += THREADS) {
    const int e = x / TV, c = x % TV;
    if (c0 + c < d) Cg[(long long)e * d + c0 + c] = Cs[e * TV + c];
  }
  if (tile == 0) {
    for (int e = tid; e < d; e += THREADS) p.n[(long long)bh * d + e] = ns[e];
    if (tid == 0) p.m[bh] = m_prev;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  mlstm_chunk_kernel<T><<<p.B * p.H * p.tiles, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and h share it; the gates are f32).
// strides: 18 element strides: q, k, v, log_i, log_f and h, each (b, h, s);
// the d dims are contiguous.  d a multiple of 16 up to 512, L <=
// 64 dividing S (the wrapper checks).  C, n and m receive the final carry.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
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
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, s);
    case 1: return (int)launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
