// Mamba-2 SSD chunked scan, one launch per call.
//
// Replaces the Pallas TPU kernel `ssd_chunk_bhcp` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_chunk/kernel.py.  For each (b, h), over the chunks of
// l rows in order, with an f32 (P, N) state carried from chunk to chunk:
//
//   a_cum = cumsum(a)                                        (l,)
//   y     = ((C B^T) * L) x + (C state^T) * exp(a_cum)[:, None]
//           with L[i,j] = exp(a_cum[i] - a_cum[j]) for j <= i, else 0
//   state = state * exp(a_cum[-1]) + x^T (B * exp(a_cum[-1] - a_cum)[:, None])
//
// x (B,H,S,P) is the dt-weighted input, a (B,H,S) is A*dt, b and c (B,1,S,N)
// are shared across heads (n_groups = 1); y (B,H,S,P) is in x's dtype.  One
// deliberate difference: the TPU kernel drops the state after the last chunk,
// this one also writes it, f32 (B,H,P,N), for the decode cache of a prefill.
//
// Bound at the main-path shape (zamba2-7b prefill: B=4, H=112, S=4096, P=N=64,
// chunk 128, f32): f32 FMAs.  ~45 GFLOP of matrix products (C B^T once per
// (b, chunk); the rest per head) against ~0.96 GB moved, ~47 FLOP per byte,
// above the ~20 FLOP/byte ridge of 66.9 TFLOP/s over 3.35 TB/s.  This first
// form is simple and right; what it does about the bound:
//   * the TPU grid's sequential "arbitrary" chunk axis becomes a loop inside
//     one block per (b, h) (blocks run in no order, so nothing carries
//     between them); the state stays in registers, 16 entries a thread, and
//     is mirrored into shared memory for the C state^T product;
//   * each chunk's x, B, C (upcast to f32 as they land), a_cum and the masked
//     (l, l) tile of C B^T * L live in shared memory (~180 KB, one block an
//     SM); every product is a 16x16-thread register tile on f32 FMAs, rows
//     padded to odd strides so the column walks do not conflict;
//   * the arithmetic keeps the reference's order: exp(a_cum[-1] - a_cum) and
//     state * exp(a_cum[-1]) + new;
//   * a ragged last chunk (S not a multiple of l) is masked: rows past S load
//     x = 0, a = 0, b = c = 0, which leaves the state unchanged, and are never
//     stored; so every S is taken, not only multiples of the chunk.
// Computing C B^T once per (b, chunk) for all heads, tensor cores (3xTF32) and
// a chunk-parallel two-pass form are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LM = 128;   // chunk rows, at most
constexpr int PM = 64;    // head dim P, at most
constexpr int NM = 64;    // state dim N, at most
constexpr int THREADS = 256;
constexpr int LDB = NM + 1;   // B and C rows (odd: conflict-free column walks)
constexpr int LDG = LM + 1;   // (C B^T) * L rows
constexpr int LDS = NM + 1;   // state rows
// shared memory, in floats
constexpr int OFF_X = 0;                    // LM x PM
constexpr int OFF_B = OFF_X + LM * PM;      // LM x LDB
constexpr int OFF_C = OFF_B + LM * LDB;     // LM x LDB
constexpr int OFF_G = OFF_C + LM * LDB;     // LM x LDG
constexpr int OFF_S = OFF_G + LM * LDG;     // PM x LDS
constexpr int OFF_A = OFF_S + PM * LDS;     // LM: a, then a_cum
constexpr int OFF_E = OFF_A + LM;           // LM: exp(a_cum)
constexpr int OFF_W = OFF_E + LM;           // LM: exp(a_cum[-1] - a_cum)
constexpr int SMEM_BYTES = (OFF_W + LM) * 4;

struct Params {
  const void* x;
  const void* a;
  const void* b;
  const void* c;
  void* y;
  float* state;            // (B, H, P, N) f32, contiguous
  int B, H, S, P, N, L;
  long long xs_b, xs_h, xs_s;   // strides in elements (P, N dims: 1)
  long long as_b, as_h, as_s;
  long long bs_b, bs_s;
  long long cs_b, cs_s;
  long long ys_b, ys_h, ys_s;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* Xs = sm + OFF_X;
  float* Bs = sm + OFF_B;
  float* Cs = sm + OFF_C;
  float* Gs = sm + OFF_G;
  float* Ss = sm + OFF_S;
  float* As = sm + OFF_A;
  float* Es = sm + OFF_E;
  float* Ws = sm + OFF_W;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const T* xg = static_cast<const T*>(p.x) + b * p.xs_b + h * p.xs_h;
  const T* ag = static_cast<const T*>(p.a) + b * p.as_b + h * p.as_h;
  const T* bg = static_cast<const T*>(p.b) + b * p.bs_b;
  const T* cg = static_cast<const T*>(p.c) + b * p.cs_b;
  T* yg = static_cast<T*>(p.y) + b * p.ys_b + h * p.ys_h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // state rows ty + 16r (p), columns tx + 16c (n)
  float st[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[r][c] = 0.f;

  const int n_chunks = (p.S + p.L - 1) / p.L;
  for (int k = 0; k < n_chunks; ++k) {
    const long long s0 = (long long)k * p.L;
    const int rows = min(p.L, p.S - (int)s0);   // rows of this chunk in S
    __syncthreads();   // the last chunk's reads are done
    // stage the chunk, zero-padded to LM x PM / LM x NM
    for (int e = tid; e < LM * PM; e += THREADS) {
      const int r = e / PM, q = e % PM;
      Xs[e] = r < rows && q < p.P ? to_f(xg[(s0 + r) * p.xs_s + q]) : 0.f;
    }
    for (int e = tid; e < LM * NM; e += THREADS) {
      const int r = e / NM, n = e % NM;
      const bool in = r < rows && n < p.N;
      Bs[r * LDB + n] = in ? to_f(bg[(s0 + r) * p.bs_s + n]) : 0.f;
      Cs[r * LDB + n] = in ? to_f(cg[(s0 + r) * p.cs_s + n]) : 0.f;
    }
    if (tid < LM) As[tid] = tid < rows ? to_f(ag[(s0 + tid) * p.as_s]) : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ss[(ty + 16 * r) * LDS + tx + 16 * c] = st[r][c];
    __syncthreads();

    // a_cum (inclusive) by warp 0: four rows a lane, then a scan over lanes
    if (tid < 32) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = As[4 * tid + i];
      v[1] += v[0];
      v[2] += v[1];
      v[3] += v[2];
      float incl = v[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      // rows past the chunk hold a = 0, so a_cum[LM - 1] is the chunk's last
      const float last = __shfl_sync(0xffffffffu, excl + v[3], 31);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ac = excl + v[i];
        As[4 * tid + i] = ac;
        Es[4 * tid + i] = expf(ac);
        Ws[4 * tid + i] = expf(last - ac);
      }
    }
    __syncthreads();

    // G = (C B^T) * L, rows ty + 16r (i), columns tx + 16c (j)
    {
      float g[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) g[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < p.N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Cs[(ty + 16 * r) * LDB + n];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bs[(tx + 16 * c) * LDB + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        const float ai = As[i];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tx + 16 * c;
          Gs[i * LDG + j] = j <= i ? g[r][c] * expf(ai - As[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = G x + (C state^T) * exp(a_cum), rows ty + 16r (i), columns
    // tx + 16c (p)
    {
      float yd[8][4], yo[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yd[r][c] = yo[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        float gv[8], xv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) gv[r] = Gs[(ty + 16 * r) * LDG + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = Xs[j * PM + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yd[r][c] = fmaf(gv[r], xv[c], yd[r][c]);
      }
#pragma unroll 4
      for (int n = 0; n < p.N; ++n) {
        float cv[8], sv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Cs[(ty + 16 * r) * LDB + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = Ss[(tx + 16 * c) * LDS + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yo[r][c] = fmaf(cv[r], sv[c], yo[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i >= rows) continue;
        const float e = Es[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = tx + 16 * c;
          if (q < p.P) store(yg + (s0 + i) * p.ys_s + q, yd[r][c] + yo[r][c] * e);
        }
      }
    }

    // state = state * exp(a_cum[-1]) + x^T (B * exp(a_cum[-1] - a_cum)),
    // rows ty + 16r (p), columns tx + 16c (n)
    {
      float nw[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) nw[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const float w = Ws[j];
        float xv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = Xs[j * PM + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[j * LDB + tx + 16 * c] * w;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) nw[r][c] = fmaf(xv[r], bv[c], nw[r][c]);
      }
      const float decay = expf(As[LM - 1]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[r][c] = st[r][c] * decay + nw[r][c];
    }
  }

  float* sg = p.state + (long long)blockIdx.x * p.P * p.N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = tx + 16 * c;
      if (q < p.P && n < p.N) sg[q * p.N + n] = st[r][c];
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T><<<p.B * p.H, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a, b, c and y share it).  strides: 13
// element strides: x (b, h, s), a (b, h, s), b (b, s), c (b, s), y (b, h, s);
// the P and N dims are contiguous.  L <= 128, P <= 64, N <= 64 (the wrapper
// checks).  Returns cudaGetLastError() after the launch (0 on success); the
// caller raises on anything else.
extern "C" int ssd_chunk_bhcp_launch(int device, int dtype, const void* x,
                                     const void* a, const void* b,
                                     const void* c, void* y, void* state,
                                     int B, int H, int S, int P, int N, int L,
                                     const long long* strides, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > LM || P < 1 || P > PM || N < 1 || N > NM)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.c = c;
  p.y = y;
  p.state = static_cast<float*>(state);
  p.B = B;
  p.H = H;
  p.S = S;
  p.P = P;
  p.N = N;
  p.L = L;
  p.xs_b = strides[0]; p.xs_h = strides[1]; p.xs_s = strides[2];
  p.as_b = strides[3]; p.as_h = strides[4]; p.as_s = strides[5];
  p.bs_b = strides[6]; p.bs_s = strides[7];
  p.cs_b = strides[8]; p.cs_s = strides[9];
  p.ys_b = strides[10]; p.ys_h = strides[11]; p.ys_s = strides[12];
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, s);
    case 1: return (int)launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
