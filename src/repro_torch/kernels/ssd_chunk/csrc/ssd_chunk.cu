// Mamba-2 SSD chunked scan: three launches a call, every chunk in parallel
// but for a short state-passing pass.
//
// Replaces the Pallas TPU kernel `ssd_chunk_bhcp` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_chunk/kernel.py.  For each (b, h), over the chunks of
// l rows, with an f32 (P, N) state carried from chunk to chunk:
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
// Bound at the main-path shape (zamba2-7b prefill: B=4, H=112, S=4096,
// P=N=64, chunk 128, f32): ~45 GFLOP of matrix products (C B^T once per
// (b, chunk); the rest per head) and ~0.96 GB of operands.  On the tensor
// cores in 3xTF32 (three TF32 products a product, 495 TFLOP/s / 3) the
// products need 0.275 ms and the bytes 0.287 ms at 3.35 TB/s, so the card
// is bound by bytes.  The TPU kernel walks the chunks of one (b, h) in
// order; the chunked decomposition of the SSD algorithm makes every chunk
// independent but for one short pass:
//   (a) `ssd_chunk_state_kernel`, one block per (b, chunk, 8 heads): the
//       chunk's B once, then for each head a_cum by a warp scan (one warp a
//       head), w = exp(a_cum[-1] - a_cum), and the chunk's contribution
//       (x * w)^T B, (P, N) f32, into a scratch (B, H, n_chunks, P, N); and
//       a_cum[-1] into (B, H, n_chunks);
//   (b) `ssd_chunk_pass_kernel`, one thread an entry of a (b, h)'s (P, N)
//       state: s_in[k] = s; s = s * exp(a_last[k]) + contrib[k], the
//       reference's own association, each chunk's entering state written
//       over its contribution and the final state to the (B, H, P, N)
//       output;
//   (c) `ssd_chunk_scan_kernel`, one block per (b, chunk, 16 heads), 16
//       warps: C B^T once for the 16 heads, the key tiles j <= i only, into
//       shared memory; then two groups of 8 warps take the heads in turn,
//       each group with its own x and s_in buffers, so one group's copies
//       overlap the other's products.  For each head G = (C B^T) * L over
//       the lower triangle and y = G x + (C s_in^T) * exp(a_cum), in that
//       order, stored through the strided y view.  A warp owns a strip of
//       16 rows i; the warps on one scheduler get strips s and 7 - s, so
//       each scheduler's share of the triangle is the same.
// The blocks of (a) and (c) take a head tile fastest, so the blocks in
// flight together read and write the same rows of the model layout; (a)
// copies each head's x with cp.async (16 bytes a copy where the rows allow)
// into one of two buffers while it computes the head before.
// Every product runs on mma.sync m16n8k8 TF32 with the 3xTF32 split (hi*lo
// + lo*hi + hi*hi, accumulated in f32): plain TF32 keeps ~3 decimal digits,
// short of the reference's f32 tolerance (1e-4); the split keeps ~21 bits.
// Operands are upcast to f32 as they land in shared memory (bf16 too), so
// there is one compute path.  The 8 keys of a G x step are taken in the
// order 0,2,4,6,1,3,5,7, which puts a pair of C B^T columns where the A
// fragment wants them; x's rows are read in the same order.  A ragged last
// chunk (S not a multiple of l) is masked: rows past S load x = a = b = c =
// 0, which leaves the state unchanged, and are never stored.
// Left for later: fusing the three passes (the scratch's ~0.7 GB of
// traffic), wgmma (TF32 from shared memory) in place of mma.sync, and TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LM = 128;       // chunk rows, at most
constexpr int PM = 64;        // head dim P, at most
constexpr int NM = 64;        // state dim N, at most
constexpr int HT = 8;         // heads a block, pass (a)
constexpr int HTC = 16;       // heads a block, pass (c)
constexpr int THREADS_A = 256;   // pass (a): 8 warps
constexpr int THREADS_B = 256;   // pass (b)
constexpr int THREADS_C = 512;   // pass (c): 16 warps
constexpr int LDA = 72;       // pass (a) rows: (8t + g) banks, conflict-free
constexpr int LDC = 68;       // pass (c) rows: (4g + t) banks, conflict-free
constexpr int LDG = 136;      // pass (c) C B^T rows: float2 reads, (8g + 2t)
constexpr int PASS_PER = 4;   // state entries a thread in pass (b)
constexpr float kLog2e = 1.4426950408889634f;

// pass (a) shared memory, in floats: B, two buffers of x, w (HT rows)
constexpr int A_OFF_B = 0;
constexpr int A_OFF_X = A_OFF_B + LM * LDA;
constexpr int A_OFF_W = A_OFF_X + 2 * LM * LDA;
constexpr int A_SMEM = (A_OFF_W + HT * LM) * 4;
// pass (c): C, C B^T, two buffers for B then x, two for s_in, a_cum (HTC
// rows)
constexpr int C_OFF_C = 0;
constexpr int C_OFF_G = C_OFF_C + LM * LDC;
constexpr int C_OFF_X = C_OFF_G + LM * LDG;
constexpr int C_OFF_S = C_OFF_X + 2 * LM * LDC;
constexpr int C_OFF_A = C_OFF_S + 2 * PM * LDC;
constexpr int C_SMEM = (C_OFF_A + HTC * LM) * 4;

struct Params {
  const void* x;
  const void* a;
  const void* b;
  const void* c;
  void* y;
  float* state;            // (B, H, P, N) f32, contiguous
  float* scratch;          // (B, H, n_chunks, P, N) f32: contrib, then s_in
  float* alast;            // (B, H, n_chunks) f32: a_cum[-1] of each chunk
  int B, H, S, P, N, L, n_chunks;
  int vec4;                // x, b, c rows copy as 16-byte pieces (f32)
  int y_pairs;             // y takes its columns two at a time
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
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi is x cut to TF32's 10 mantissa bits (a mask, not a
// conversion: cvt is a quarter-rate instruction and would bound the loop),
// lo the exact f32 rest, whose low 13 bits the tensor core drops.  hi*hi +
// hi*lo + lo*hi then carries ~21 bits of each product.
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

// Inclusive a_cum of one head's chunk (LM rows, a = 0 past the chunk) by
// one warp, four rows a lane; returns a_cum[LM - 1], the chunk's last.
template <typename T>
__device__ __forceinline__ float warp_cumsum(const T* ag, long long as_s,
                                             int rows, float* out) {
  const int lane = threadIdx.x & 31;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * lane + i;
    v[i] = r < rows ? to_f(ag[r * as_s]) : 0.f;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float incl = v[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[4 * lane + i] = excl + v[i];
  return __shfl_sync(0xffffffffu, excl + v[3], 31);
}

// Rows [0, rows_pad) x cols [0, 64) of a (rows, cols) slab, row stride
// `stride` elements, into shared memory with row stride LD, as f32; zero
// past `rows` and `cols`; by the NT threads numbered `tid`.  f32 goes by
// cp.async, 16 bytes a copy when `vec4` (the rows and the slab 16-byte
// aligned, cols a multiple of 4), else 4; the copies are one commit group,
// waited for by the caller.  bf16 is loaded and upcast at once (cp.async
// cannot convert), 8 loads in flight a thread.
template <int NT, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int rows,
                                      int rows_pad, int cols, bool vec4,
                                      int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec4) {
      const int q = (tid & 15) * 4;
      for (int r = tid >> 4; r < rows_pad; r += NT / 16) {
        const bool in = r < rows && q < cols;
        const T* gp = in ? src + r * stride + q : src;
        const uint32_t d = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + r * LD + q));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(gp), "r"(in ? 16 : 0) : "memory");
      }
    } else {
      const int q = tid & 63;
      for (int r = tid >> 6; r < rows_pad; r += NT / 64) {
        const bool in = r < rows && q < cols;
        const T* gp = in ? src + r * stride + q : src;
        const uint32_t d = static_cast<uint32_t>(
            __cvta_generic_to_shared(dst + r * LD + q));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(gp), "r"(in ? 4 : 0) : "memory");
      }
    }
  } else {
    constexpr int STEP = NT / 64, U = 8;
    const int q = tid & 63;
    for (int rb = tid >> 6; rb < rows_pad; rb += STEP * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + STEP * u;
        v[u] = r < rows && q < cols ? to_f(src[r * stride + q]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + STEP * u;
        if (r < rows_pad) dst[r * LD + q] = v[u];
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// (a) chunk states
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS_A, 2)
    ssd_chunk_state_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm + A_OFF_B;
  float* Xb[2] = {sm + A_OFF_X, sm + A_OFF_X + LM * LDA};
  float* Ws = sm + A_OFF_W;
  // the head tile varies fastest: the blocks in flight together read the
  // same rows of the model layout
  const int nht = (p.H + HT - 1) / HT;   // grid.x: (head tile, chunk, b)
  const int h0 = (int)(blockIdx.x % nht) * HT;
  const int k = (int)(blockIdx.x / nht % p.n_chunks);
  const int b = (int)(blockIdx.x / nht / p.n_chunks);
  const int nh = min(HT, p.H - h0);
  const long long s0 = (long long)k * p.L;
  const int rows = min(p.L, p.S - (int)s0);
  const int rows8 = (rows + 7) & ~7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* xg = static_cast<const T*>(p.x) + b * p.xs_b + s0 * p.xs_s;
  auto prefetch = [&](int i) {   // head h0 + i's x
    stage<THREADS_A, LDA>(Xb[i & 1], xg + (h0 + i) * p.xs_h, p.xs_s, rows,
                          rows8, p.P, p.vec4, threadIdx.x);
  };

  stage<THREADS_A, LDA>(Bs, static_cast<const T*>(p.b) + b * p.bs_b +
                                s0 * p.bs_s,
                        p.bs_s, rows, rows8, p.N, p.vec4, threadIdx.x);
  prefetch(0);
  if (warp < nh) {   // one warp a head: a_cum, then w = exp(last - a_cum)
    const int h = h0 + warp;
    float* w = Ws + warp * LM;
    const float last = warp_cumsum(
        static_cast<const T*>(p.a) + b * p.as_b + h * p.as_h + s0 * p.as_s,
        p.as_s, rows, w);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) w[4 * lane + i] = expf(last - w[4 * lane + i]);
    if (lane == 0) p.alast[((long long)b * p.H + h) * p.n_chunks + k] = last;
  }

  // contrib (P x N) = (x * w)^T B: warp w owns rows p of m-tile (w & 3),
  // columns n of n-tiles 4 (w >> 2) .. + 3.  Even and odd k-steps
  // accumulate apart (8 independent chains a warp), then add
  const int pm = (warp & 3) * 16, nn = (warp >> 2) * 32;
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    stage_wait();
    __syncthreads();   // x of head i and w have landed; every warp is done
                       // with the other buffer (head i - 1)
    if (i + 1 < nh) prefetch(i + 1);
    const float* Xs = Xb[i & 1];
    const float* w = Ws + i * LM;
    float acc[2][4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
    for (int kb = 0; kb < rows8; kb += 16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k0 = kb + 8 * u;
        if (k0 >= rows8) break;
        const float* x0 = Xs + (k0 + t) * LDA + pm + g;
        const float* x1 = x0 + 4 * LDA;
        const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
        const float a[4] = {x0[0] * w0, x0[8] * w0, x1[0] * w1, x1[8] * w1};
        AFrag fa;
        fa.set(a);
        const float* b0 = Bs + (k0 + t) * LDA + nn + g;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fa.mma(acc[u][j], b0[8 * j], b0[8 * j + 4 * LDA]);
      }
    }
    float* out = p.scratch +
                 (((long long)b * p.H + h) * p.n_chunks + k) * p.P * p.N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nn + 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pr = pm + g + 8 * half;
        if (pr >= p.P) continue;
        const float v0 = acc[0][j][2 * half] + acc[1][j][2 * half];
        const float v1 = acc[0][j][2 * half + 1] + acc[1][j][2 * half + 1];
        float* o = out + pr * p.N + n;
        if (n + 1 < p.N && (p.N & 1) == 0) {   // 8-byte aligned pairs
          store2(o, v0, v1);
        } else {
          if (n < p.N) o[0] = v0;
          if (n + 1 < p.N) o[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) state passing
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS_B)
    ssd_chunk_pass_kernel(const Params p) {
  constexpr int AHEAD = 4;   // chunks whose loads are in flight together
  const long long bh = blockIdx.x;
  const int pn = p.P * p.N;
  const int e0 = blockIdx.y * THREADS_B * PASS_PER + threadIdx.x;
  float s[PASS_PER];
#pragma unroll
  for (int j = 0; j < PASS_PER; ++j) s[j] = 0.f;
  const float* al = p.alast + bh * p.n_chunks;
  float* sc = p.scratch + bh * p.n_chunks * pn;
  for (int k0 = 0; k0 < p.n_chunks; k0 += AHEAD) {
    float contrib[AHEAD][PASS_PER], decay[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int k = k0 + u;
      decay[u] = k < p.n_chunks ? expf(al[k]) : 0.f;
#pragma unroll
      for (int j = 0; j < PASS_PER; ++j) {
        const int e = e0 + j * THREADS_B;
        contrib[u][j] = k < p.n_chunks && e < pn
                            ? sc[(long long)k * pn + e] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int k = k0 + u;
      if (k >= p.n_chunks) break;
#pragma unroll
      for (int j = 0; j < PASS_PER; ++j) {
        const int e = e0 + j * THREADS_B;
        if (e < pn) {
          sc[(long long)k * pn + e] = s[j];   // the state entering chunk k
          s[j] = s[j] * decay[u] + contrib[u][j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PASS_PER; ++j) {
    const int e = e0 + j * THREADS_B;
    if (e < pn) p.state[bh * pn + e] = s[j];
  }
}

// ---------------------------------------------------------------------------
// (c) outputs
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS_C, 1)
    ssd_chunk_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm + C_OFF_C;
  float* Gs = sm + C_OFF_G;   // C B^T, the rows' key tiles j <= i
  float* As = sm + C_OFF_A;
  // two groups of 8 warps, each with its own x and s_in buffers, take the
  // block's heads in turn: while one group copies a head in, the other
  // computes, with nothing but a group barrier between a group's steps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp >> 3, gtid = threadIdx.x & 255;
  float* Xs = sm + C_OFF_X + grp * LM * LDC;   // group 1's holds B first
  float* Ss = sm + C_OFF_S + grp * PM * LDC;
  const int nht = (p.H + HTC - 1) / HTC;   // grid.x: (head tile, chunk, b)
  const int h0 = (int)(blockIdx.x % nht) * HTC;
  const int k = (int)(blockIdx.x / nht % p.n_chunks);
  const int b = (int)(blockIdx.x / nht / p.n_chunks);
  const int nh = min(HTC, p.H - h0);
  const long long s0 = (long long)k * p.L;
  const int rows = min(p.L, p.S - (int)s0);
  const int rows8 = (rows + 7) & ~7;
  const int rows16 = (rows + 15) & ~15;   // whole strips of C
  const int g = lane >> 2, t = lane & 3;
  // a warp owns a strip of 16 rows i.  Warps w, w + 4 (and the other
  // group's) share a scheduler: they get strips s and 7 - s, so each
  // scheduler's share of the triangle is the same
  const int w8 = warp & 7;
  const int strip = w8 < 4 ? w8 : 11 - w8;
  const int i0 = strip * 16 + g, i1 = i0 + 8;   // this thread's rows
  const bool active = strip * 16 < rows8;       // the strip has rows
  const int n_jt = 2 * strip + 2;               // key tiles j <= i
  const T* xg = static_cast<const T*>(p.x) + b * p.xs_b + s0 * p.xs_s;
  const float* sg = p.scratch + (((long long)b * p.H) * p.n_chunks + k) *
                                    p.P * p.N;
  const long long s_head = (long long)p.n_chunks * p.P * p.N;
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + grp) : "memory");
  };

  stage<THREADS_C, LDC>(Cs, static_cast<const T*>(p.c) + b * p.cs_b +
                                s0 * p.cs_s,
                        p.cs_s, rows, rows16, p.N, p.vec4, threadIdx.x);
  float* Bs = sm + C_OFF_X + LM * LDC;   // group 1's x buffer, for now
  stage<THREADS_C, LDC>(Bs, static_cast<const T*>(p.b) + b * p.bs_b +
                                s0 * p.bs_s,
                        p.bs_s, rows, rows8, p.N, p.vec4, threadIdx.x);
  if (warp < nh) {
    const int h = h0 + warp;
    warp_cumsum(static_cast<const T*>(p.a) + b * p.as_b + h * p.as_h +
                    s0 * p.as_s,
                p.as_s, rows, As + warp * LM);
  }
  stage_wait();
  __syncthreads();

  // C B^T into shared memory, once for the heads: the strip's key tiles j
  // with j % 2 == grp
  if (active) {
    float cb[LM / 16][4];
#pragma unroll
    for (int u = 0; u < LM / 16; ++u) cb[u][0] = cb[u][1] = cb[u][2] = cb[u][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NM; kb += 8) {
      const float* c0 = Cs + i0 * LDC + kb + t;
      const float a[4] = {c0[0], c0[8 * LDC], c0[4], c0[8 * LDC + 4]};
      AFrag fa;
      fa.set(a);
#pragma unroll
      for (int u = 0; u < LM / 16; ++u) {
        const int j = 2 * u + grp;
        if (j < n_jt && 8 * j < rows8) {
          const float* bj = Bs + (8 * j + g) * LDC + kb + t;
          fa.mma(cb[u], bj[0], bj[4]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LM / 16; ++u) {
      const int j = 2 * u + grp;
      if (j < n_jt && 8 * j < rows8) {
        store2(Gs + i0 * LDG + 8 * j + 2 * t, cb[u][0], cb[u][1]);
        store2(Gs + i1 * LDG + 8 * j + 2 * t, cb[u][2], cb[u][3]);
      }
    }
  }
  __syncthreads();   // C B^T complete; group 1's buffer free of B

  for (int hi = grp; hi < nh; hi += 2) {
    const int h = h0 + hi;
    stage<256, LDC>(Xs, xg + h * p.xs_h, p.xs_s, rows, rows8, p.P, p.vec4,
                    gtid);
    stage<256, LDC>(Ss, sg + h * s_head, (long long)p.N, p.P, PM, p.N,
                    (p.N & 3) == 0, gtid);
    stage_wait();
    group_sync();   // head h has landed
    if (active) {
      const float* ac = As + hi * LM;
      const float ai0 = ac[i0], ai1 = ac[i1];

      // y_diag = G x over the lower triangle, G = (C B^T) * exp(a_cum[i] -
      // a_cum[j]); the 8 keys of step j are taken in the order
      // 0,2,4,6,1,3,5,7 (A fragment column t <-> key 2t, t + 4 <-> key
      // 2t + 1), and x's rows alike
      float yd[PM / 8][4];
#pragma unroll
      for (int n = 0; n < PM / 8; ++n) yd[n][0] = yd[n][1] = yd[n][2] = yd[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < LM / 8; ++j) {
        if (j < n_jt && 8 * j < rows8) {
          const int ja = 8 * j + 2 * t, jb = ja + 1;
          const float2 aj = *reinterpret_cast<const float2*>(ac + ja);
          const float2 g0 = *reinterpret_cast<const float2*>(Gs + i0 * LDG + ja);
          const float2 g1 = *reinterpret_cast<const float2*>(Gs + i1 * LDG + ja);
          const float a[4] = {
              ja <= i0 ? g0.x * ex2((ai0 - aj.x) * kLog2e) : 0.f,
              ja <= i1 ? g1.x * ex2((ai1 - aj.x) * kLog2e) : 0.f,
              jb <= i0 ? g0.y * ex2((ai0 - aj.y) * kLog2e) : 0.f,
              jb <= i1 ? g1.y * ex2((ai1 - aj.y) * kLog2e) : 0.f};
          AFrag fa;
          fa.set(a);
          const float* xa = Xs + ja * LDC + g;
#pragma unroll
          for (int n = 0; n < PM / 8; ++n)
            fa.mma(yd[n], xa[8 * n], xa[8 * n + LDC]);
        }
      }

      // y = y_diag + (C s_in^T) * exp(a_cum), four 8-column tiles of p at
      // a time
      const float e0 = expf(ai0), e1 = expf(ai1);
      T* yg = static_cast<T*>(p.y) + b * p.ys_b + h * p.ys_h;
#pragma unroll
      for (int nq = 0; nq < PM / 8; nq += 4) {
        float yo[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) yo[n][0] = yo[n][1] = yo[n][2] = yo[n][3] = 0.f;
#pragma unroll
        for (int kb = 0; kb < NM; kb += 8) {
          const float* c0 = Cs + i0 * LDC + kb + t;
          const float a[4] = {c0[0], c0[8 * LDC], c0[4], c0[8 * LDC + 4]};
          AFrag fa;
          fa.set(a);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* sv = Ss + (8 * (nq + n) + g) * LDC + kb + t;
            fa.mma(yo[n], sv[0], sv[4]);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int q = 8 * (nq + n) + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = r ? i1 : i0;
            const float e = r ? e1 : e0;
            if (i >= rows || q >= p.P) continue;
            const float v0 = yd[nq + n][2 * r] + yo[n][2 * r] * e;
            const float v1 = yd[nq + n][2 * r + 1] + yo[n][2 * r + 1] * e;
            T* dst = yg + (s0 + i) * p.ys_s + q;
            if (p.y_pairs) {
              store2(dst, v0, v1);
            } else {
              store(dst, v0);
              if (q + 1 < p.P) store(dst + 1, v1);
            }
          }
        }
      }
    }
    group_sync();   // every warp of the group is done with x and s_in
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      A_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_a((unsigned)((p.H + HT - 1) / HT) * p.n_chunks * p.B);
  ssd_chunk_state_kernel<T><<<grid_a, THREADS_A, A_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_block = THREADS_B * PASS_PER;
  const dim3 pass_grid(p.B * p.H, (p.P * p.N + per_block - 1) / per_block);
  ssd_chunk_pass_kernel<<<pass_grid, THREADS_B, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_c((unsigned)((p.H + HTC - 1) / HTC) * p.n_chunks * p.B);
  ssd_chunk_scan_kernel<T><<<grid_c, THREADS_C, C_SMEM, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a, b, c and y share it).  strides: 13
// element strides: x (b, h, s), a (b, h, s), b (b, s), c (b, s), y (b, h, s);
// the P and N dims are contiguous.  scratch: f32 (B, H, n_chunks, P, N) and
// alast: f32 (B, H, n_chunks), n_chunks = ceil(S / L), both allocated by the
// caller.  L <= 128, P <= 64, N <= 64 (the wrapper checks).  Returns
// cudaGetLastError() after the launches (0 on success); the caller raises on
// anything else.
extern "C" int ssd_chunk_bhcp_launch(int device, int dtype, const void* x,
                                     const void* a, const void* b,
                                     const void* c, void* y, void* state,
                                     void* scratch, void* alast, int B, int H,
                                     int S, int P, int N, int L,
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
  p.scratch = static_cast<float*>(scratch);
  p.alast = static_cast<float*>(alast);
  p.B = B;
  p.H = H;
  p.S = S;
  p.P = P;
  p.N = N;
  p.L = L;
  p.n_chunks = (S + L - 1) / L;
  p.xs_b = strides[0]; p.xs_h = strides[1]; p.xs_s = strides[2];
  p.as_b = strides[3]; p.as_h = strides[4]; p.as_s = strides[5];
  p.bs_b = strides[6]; p.bs_s = strides[7];
  p.cs_b = strides[8]; p.cs_s = strides[9];
  p.ys_b = strides[10]; p.ys_h = strides[11]; p.ys_s = strides[12];
  const int es = dtype == 0 ? 4 : 2;
  // f32 rows of x, b and c copy 16 bytes at a time when every row start is
  // 16-byte aligned and P, N are multiples of 4
  p.vec4 = dtype == 0 && P % 4 == 0 && N % 4 == 0 && aligned(x, 16) &&
           aligned(b, 16) && aligned(c, 16) && p.xs_b % 4 == 0 &&
           p.xs_h % 4 == 0 && p.xs_s % 4 == 0 && p.bs_b % 4 == 0 &&
           p.bs_s % 4 == 0 && p.cs_b % 4 == 0 && p.cs_s % 4 == 0;
  p.y_pairs = P % 2 == 0 && aligned(y, 2 * es) && p.ys_b % 2 == 0 &&
              p.ys_h % 2 == 0 && p.ys_s % 2 == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, s);
    case 1: return (int)launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
