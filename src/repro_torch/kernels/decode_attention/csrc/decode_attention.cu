// Ring decode attention: one decode token of every session against the
// shared attention block's ring cache, in one launch.
//
// Replaces no TPU kernel: the reference's ring decode
// (`_ring_decode_attn` of src/repro/models/transformer.py) is two plain
// `jnp.einsum`s and a masked softmax, left to XLA.  The port ran them as
// two f32 einsums over an f32 copy of the whole bf16 ring, made anew at
// every call; this kernel computes the same thing from the ring as it is:
//
//   s[g, w] = q[g] . k[w]   (f32 sums of exact products) where
//             0 <= pos[w] <= length, else -1e30
//   p[g]    = softmax(s[g]) in f32, normalised, then rounded to v's dtype
//   out[g]  = sum_w p[g, w] v[w] in f32, rounded once to q's dtype
//
// for each (session b, KV head), its G query heads.  q (B,1,KV,G,Dh) is
// already scaled; k, v (B,W,KV,Dh) and pos (B,W) are read through their
// strides (Dh contiguous), in place; `length` is read on the device, so the
// launch can be captured in a CUDA graph.  No atomics: every sum is taken
// in one fixed order, so the result is the same bit for bit at every run.
//
// Bound: device-memory bytes.  The work is 4 FLOPs a slot, head and Dh
// element against 2 x Dh x 2 bytes of K and V a slot and KV head in bf16:
// about 1 FLOP a byte where the card does ~295.  At the main path's shape
// (zamba2-7b decode: B=8, W=4,096, KV=32, G=1, Dh=112, bf16) a call reads
// the FILLED slots of the ring, 2,050 to 2,970 of 4,096 in a window: 235 to
// 341 MB, 70 to 102 us at 3.35 TB/s.  What the design does about it:
//   * K and V are each read once, 16 bytes a copy, by `cp.async` into a
//     ring of NSTAGE = 3 tiles of T slots (up to 32 KB a tile: 128 slots,
//     28 KB at the main shape) in shared memory, so two tiles a block and
//     two blocks an SM are in flight while a third is computed on;
//   * a slot whose position is masked adds exactly 0 to the reference's
//     sums (exp(-1e30 - max) = 0 in f32), so a tile whose positions are all
//     masked (the empty part of a ring that has not wrapped) is never read;
//   * one block a (session, KV head) keeps the scores of its whole window
//     in shared memory (W x G x 4 bytes, 16 KB at the main shape; in a
//     device scratch the wrapper allocates where they would not fit), so
//     the softmax sees the global max and sum before P is rounded, as the
//     reference does, with no second pass over K and no cross-block
//     reduction.  At the main shape 256 blocks fill the 132 SMs at two a
//     block in one wave;
//   * the scores: L lanes a slot (L the power of two >= Dh/8), each an
//     8-element product, summed by a butterfly of shuffles; P.V: the same
//     lanes a slot, each slot group's partial sums added by shuffles within
//     the warp, then across the 8 warps in order.  A slot group takes
//     UNROLL slots at once, so the chains of dependent shuffles and FMAs
//     overlap: one slot at a time the arithmetic, not the bytes, set the
//     pace (45 % of the bound; 68-78 % with UNROLL 4 and 28 KB tiles).
// Left for later: a split of the window over blocks where the (session,
// head) pairs are fewer than the SMs (the TP ranks' small head counts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 3;          // tiles in the shared-memory ring
constexpr int GB = 4;              // query heads a P.V pass keeps in registers
constexpr int UNROLL = 4;          // rows a slot group takes at once
constexpr int POS_BATCH = 8;       // positions a thread loads at once
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use
constexpr float NEG_INF = -1e30f;  // the reference's mask value

struct Params {
  const void* q;           // (B,1,KV,G,Dh), contiguous
  const void* k;
  const void* v;
  const int32_t* pos;
  const int32_t* length;   // 0-d
  void* out;               // (B,1,KV*G*Dh), contiguous
  float* scores;           // (B*KV, G, W) f32 scratch, or null: in shared
  int KV, G, Dh, W, T, ntiles;
  long long ks_b, ks_s, ks_h;   // strides in elements (Dh: 1)
  long long vs_b, vs_s, vs_h;
  long long ps_b, ps_s;
  // byte offsets into dynamic shared memory
  int off_q, off_wred, off_flag, off_list, off_sc;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// P rounded to v's dtype, as `p.to(cv.dtype)`
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// 8 consecutive elements of a shared-memory row, as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The same value in every thread of the block: each thread's x, reduced by
// a butterfly in each warp, then the warps' results in order 0..WARPS-1.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* wred) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = wred[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, wred[w]) : r + wred[w];
  __syncthreads();   // wred is reused by the next reduction
  return r;
}

// Stream the listed tiles of one operand (rows base + s * s_stride, Dh
// elements each) through the shared-memory ring and call
// body(tile, rows, s0) on each once it has landed; every thread calls it.
template <typename TKV, typename Body>
__device__ __forceinline__ void stream_tiles(const Params& p,
                                             const TKV* base,
                                             long long s_stride,
                                             const int* list, int n,
                                             unsigned char* ring,
                                             Body&& body) {
  const int row_bytes = p.Dh * (int)sizeof(TKV);
  const int copies = row_bytes / 16;          // 16-byte copies a row
  const int tile_bytes = p.T * row_bytes;
  auto issue = [&](int i) {
    const int s0 = list[i] * p.T;
    const int rows = min(p.T, p.W - s0);
    unsigned char* dst = ring + (i % NSTAGE) * tile_bytes;
    for (int j = threadIdx.x; j < rows * copies; j += THREADS) {
      const int r = j / copies, c = j - r * copies;
      cp_async16(dst + r * row_bytes + c * 16,
                 reinterpret_cast<const unsigned char*>(
                     base + (long long)(s0 + r) * s_stride) + c * 16);
    }
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // tile i landed for all; tile i - 1's slot is free
    if (i + NSTAGE - 1 < n) issue(i + NSTAGE - 1);
    cp_async_commit();
    const int s0 = list[i] * p.T;
    body(reinterpret_cast<const TKV*>(ring + (i % NSTAGE) * tile_bytes),
         min(p.T, p.W - s0), s0);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, 2)
    decode_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;           // b * KV + kv head
  const int b = bh / p.KV, h = bh - b * p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, Dh = p.Dh, W = p.W;
  float* qs = reinterpret_cast<float*>(smem + p.off_q);         // (G, Dh)
  float* wred = reinterpret_cast<float*>(smem + p.off_wred);    // WARPS
  int* flag = reinterpret_cast<int*>(smem + p.off_flag);        // ntiles
  int* list = reinterpret_cast<int*>(smem + p.off_list);        // ntiles + 1
  float* sc = p.scores != nullptr
                  ? p.scores + (long long)bh * G * W
                  : reinterpret_cast<float*>(smem + p.off_sc);  // (G, W)
  float* red = reinterpret_cast<float*>(smem);   // (WARPS, GB, Dh), ring's

  // -- the window's positions: a slot attends when 0 <= pos <= length; its
  // scores start at the mask value (0 where it attends, until computed)
  const int length = *p.length;
  for (int i = tid; i < p.ntiles; i += THREADS) flag[i] = 0;
  const TQ* q = static_cast<const TQ*>(p.q) + (long long)bh * G * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) qs[i] = to_f(q[i]);
  __syncthreads();
  const int32_t* pos = p.pos + (long long)b * p.ps_b;
  for (int base = 0; base < W; base += POS_BATCH * THREADS) {
    int ps[POS_BATCH];   // the batch's loads in flight together
#pragma unroll
    for (int u = 0; u < POS_BATCH; ++u) {
      const int s = base + u * THREADS + tid;
      ps[u] = s < W ? __ldg(pos + (long long)s * p.ps_s) : -1;
    }
#pragma unroll
    for (int u = 0; u < POS_BATCH; ++u) {
      const int s = base + u * THREADS + tid;
      if (s >= W) break;
      const bool ok = ps[u] >= 0 && ps[u] <= length;
      if (ok) flag[s / p.T] = 1;
      for (int g = 0; g < G; ++g) sc[g * W + s] = ok ? 0.f : NEG_INF;
    }
  }
  __syncthreads();
  if (warp == 0) {   // the flagged tiles in order, 32 at a time
    int n = 0;
    for (int t0 = 0; t0 < p.ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool f = t < p.ntiles && flag[t];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1u))] = t;
      n += __popc(m);
    }
    // nothing attends: the reference's softmax is uniform over the ring
    if (n == 0)
      for (int t = lane; t < p.ntiles; t += 32) list[t] = t;
    if (lane == 0) list[p.ntiles] = n == 0 ? p.ntiles : n;
  }
  __syncthreads();
  const int n = list[p.ntiles];

  const int C = Dh / 8;                // 8-element chunks of a row
  int L = 1;                           // lanes a slot: a power of two >= C
  while (L < C) L <<= 1;
  const int groups = THREADS / L;      // slots a pass of the block
  const int grp = tid / L, c = tid - grp * L;

  // -- scores: q . k of every attended slot of the listed tiles
  const TKV* kb = static_cast<const TKV*>(p.k) + (long long)b * p.ks_b +
                  (long long)h * p.ks_h;
  stream_tiles<TKV>(p, kb, p.ks_s, list, n, smem,
                    [&](const TKV* tile, int rows, int s0) {
    // UNROLL rows a group at once, their sums independent chains; the
    // trip count is the block's, so every lane reaches the shuffles
    for (int r0 = 0; r0 < rows; r0 += UNROLL * groups) {
      float kf[UNROLL][8];
      bool keep[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * groups + grp;
        keep[u] = r < rows && sc[s0 + r] != NEG_INF;
        if (r < rows && c < C) {
          load8(tile + r * Dh + c * 8, kf[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) kf[u][j] = 0.f;
        }
      }
      for (int g = 0; g < G; ++g) {
        float qf[8];
        load8(qs + g * Dh + min(c, C - 1) * 8, qf);
        float part[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          part[u] = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) part[u] = fmaf(qf[j], kf[u][j], part[u]);
        }
        for (int off = L >> 1; off >= 1; off >>= 1)
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
        if (c == 0)
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (keep[u]) sc[g * W + s0 + r0 + u * groups + grp] = part[u];
      }
    }
  });

  // -- softmax of each head's row over the whole window, in f32; P rounded
  // to v's dtype after the normalisation
  for (int g = 0; g < G; ++g) {
    float* row = sc + g * W;
    float m = NEG_INF;
    for (int s = tid; s < W; s += THREADS) m = fmaxf(m, row[s]);
    m = block_reduce<true>(m, wred);
    float sum = 0.f;
    for (int s = tid; s < W; s += THREADS) sum += expf(row[s] - m);
    sum = block_reduce<false>(sum, wred);
    const TKV* tag = nullptr;
    for (int s = tid; s < W; s += THREADS)
      row[s] = round_to(expf(row[s] - m) / sum, tag);
  }
  __syncthreads();

  // -- P.V over the listed tiles, GB heads a pass
  const TKV* vb = static_cast<const TKV*>(p.v) + (long long)b * p.vs_b +
                  (long long)h * p.vs_h;
  TQ* out = static_cast<TQ*>(p.out) + (long long)bh * G * Dh;
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gn = min(GB, G - g0);
    float acc[GB][8];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[gi][j] = 0.f;
    stream_tiles<TKV>(p, vb, p.vs_s, list, n, smem,
                      [&](const TKV* tile, int rows, int s0) {
      if (c >= C) return;
      for (int r0 = grp; r0 < rows; r0 += UNROLL * groups) {
        float vf[UNROLL][8], pr[UNROLL][GB];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = r0 + u * groups;
          const bool on = r < rows;
          if (on) {
            load8(tile + r * Dh + c * 8, vf[u]);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) vf[u][j] = 0.f;
          }
#pragma unroll
          for (int gi = 0; gi < GB; ++gi)
            pr[u][gi] = on && gi < gn ? sc[(g0 + gi) * W + s0 + r] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int gi = 0; gi < GB; ++gi)
            if (gi < gn)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[gi][j] = fmaf(pr[u][gi], vf[u][j], acc[gi][j]);
      }
    });
    // the slot groups of a warp, then the warps in order
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (gi < gn) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          for (int off = L; off < 32; off <<= 1)
            acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], off);
        if (lane < C) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            red[(warp * GB + gi) * Dh + lane * 8 + j] = acc[gi][j];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < gn * Dh; i += THREADS) {
      const int gi = i / Dh, d = i - gi * Dh;
      float x = red[gi * Dh + d];
      for (int w = 1; w < WARPS; ++w) x += red[(w * GB + gi) * Dh + d];
      store(out + (g0 + gi) * Dh + d, x);
    }
    __syncthreads();   // red lies in the ring the next pass fills
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const Params& p, int blocks, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<TQ, TKV><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int align16(int x) { return (x + 15) & ~15; }

}  // namespace

// q_dtype, kv_dtype: 0 float32, 1 bfloat16.  strides: k's (b, slot, head),
// v's, pos's (b, slot), in elements.  tile: slots a tile.  scores: an f32
// scratch of B * KV * G * W, or null to keep the scores in shared memory.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
extern "C" int decode_attention_launch(
    int device, int q_dtype, int kv_dtype, const void* q, const void* k,
    const void* v, const void* pos, const void* length, void* out,
    void* scores, int B, int KV, int G, int Dh, int W, int tile,
    const long long* strides, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kv_bytes = kv_dtype == 0 ? 4 : 2;
  if (B < 1 || KV < 1 || G < 1 || W < 1 || Dh < 8 || Dh > 256 ||
      Dh % 8 != 0 || tile < 1 || (q_dtype != 0 && q_dtype != 1) ||
      (kv_dtype != 0 && kv_dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = static_cast<const int32_t*>(pos);
  p.length = static_cast<const int32_t*>(length);
  p.out = out;
  p.scores = static_cast<float*>(scores);
  p.KV = KV;
  p.G = G;
  p.Dh = Dh;
  p.W = W;
  p.T = tile;
  p.ntiles = (W + tile - 1) / tile;
  p.ks_b = strides[0]; p.ks_s = strides[1]; p.ks_h = strides[2];
  p.vs_b = strides[3]; p.vs_s = strides[4]; p.vs_h = strides[5];
  p.ps_b = strides[6]; p.ps_s = strides[7];
  // the ring of tiles (P.V's cross-warp partials reuse it), q, the
  // reductions' scratch, the tile flags and list, the scores
  const int ring = align16(NSTAGE * tile * Dh * kv_bytes);
  const int red = WARPS * GB * Dh * 4;
  p.off_q = ring > red ? ring : align16(red);
  p.off_wred = align16(p.off_q + G * Dh * 4);
  p.off_flag = align16(p.off_wred + WARPS * 4);
  p.off_list = align16(p.off_flag + p.ntiles * 4);
  p.off_sc = align16(p.off_list + (p.ntiles + 1) * 4);
  const long long smem =
      p.off_sc + (scores == nullptr ? (long long)G * W * 4 : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = B * KV;
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, blocks, (int)smem, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(p, blocks, (int)smem, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(p, blocks, (int)smem, s);
  return (int)launch<float, float>(p, blocks, (int)smem, s);
}
