// Probe: may code after `setmaxnreg.inc` use more registers a thread than
// the launch grants?
//
// A block of 384 threads under __launch_bounds__(384, 1) starts with 168
// registers a thread (65,536 / 384, rounded down to 8).  One producer
// warpgroup gives registers up (setmaxnreg.dec PRODUCER_REGS) and two
// consumer warpgroups take them (setmaxnreg.inc CONSUMER_REGS), as the
// flash kernel's D=256 layout needs: each consumer holds a 64 x 256 f32
// wgmma accumulator (128 registers a thread) and a 64 x 64 f32 S (32)
// across a loop that issues S = Q K^T (m64n64k16 from shared memory), then
// O += P V (m64n256k16, P from registers) and forms the next P while O's
// product runs, the flash kernel's order.  The build's ptxas report (-v)
// and the SASS (cuobjdump -sass) say whether the consumer branch uses
// registers past R167 and whether anything spills (STL/LDL).
//
// Variants are compile-time switches (probes/setmaxnreg.py builds each):
//   ROLE_SHFL      1: the role comes from a shuffle (warp-uniform to the
//                  compiler); 0: from threadIdx.x / 128
//   SETMAXNREG     0: no setmaxnreg at all (every thread at 168)
//   PRODUCER_REGS, CONSUMER_REGS: the two counts (the producer must free
//                  what the consumers take, or the .inc waits forever)
//   TRAP           1: a trap reachable in the consumers' loop (taken when
//                  a row max is NaN, which never happens), as the flash
//                  kernel's mbarrier waits trap when a phase never ends
//
// Shared memory holds bf16 1/16 everywhere, so every score is 256/256 = 1,
// every p is 2^(1 - 1) = 1, and each iteration adds 64 x 1/16 = 4 to every
// element of O: after `iters` iterations O is 4 * iters exactly, and the
// runner checks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ROLE_SHFL
#define ROLE_SHFL 1
#endif
#ifndef SETMAXNREG
#define SETMAXNREG 1
#endif
#ifndef PRODUCER_REGS
#define PRODUCER_REGS 24
#endif
#ifndef CONSUMER_REGS
#define CONSUMER_REGS 240
#endif
#ifndef TRAP
#define TRAP 0
#endif

namespace {

constexpr int THREADS = 384;
constexpr int SW = 128;                    // 128-byte swizzled rows
constexpr int Q_BYTES = 128 * SW * 4;      // 128 rows x 4 slabs of 64 cols
constexpr int KV_BYTES = 64 * SW * 4;      // 64 keys x 4 slabs
constexpr int SMEM = Q_BYTES + KV_BYTES + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s (64 x 64) (+)= A (64 x 16, shared, K-major) * B (64 x 16, K-major)^T
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

// o (64 x 256) += A (64 x 16, bf16 registers) * B (16 x 256, MN-major)
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

__global__ void __launch_bounds__(THREADS, 1)
    setmaxnreg_probe(float* out, int iters) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const __nv_bfloat16 sixteenth = __float2bfloat16(0.0625f);
  for (int i = threadIdx.x; i < (Q_BYTES + KV_BYTES) / 2; i += THREADS)
    reinterpret_cast<__nv_bfloat16*>(base)[i] = sixteenth;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

#if ROLE_SHFL
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
#else
  const int role = threadIdx.x / 128;
#endif
  if (role == 2) {
#if SETMAXNREG
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS) : "memory");
#endif
    return;
  }
#if SETMAXNREG
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS) : "memory");
#endif
  const int tid = threadIdx.x % 128;
  unsigned char* Ks = base + Q_BYTES;
  const uint64_t q_desc =
      gmma_desc(smem_u32(base) + role * 64 * SW, 16, 8 * SW);
  const uint64_t k_desc = gmma_desc(smem_u32(Ks), 16, 8 * SW);
  const uint64_t v_desc = gmma_desc(smem_u32(Ks), 64 * SW, 8 * SW);

  float o[128], s[32];
  uint32_t pa[4][4], pn[16];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = pack_bf16(1.f, 1.f);
  float m0 = -1e30f, m1 = -1e30f;
  for (int it = 0; it < iters; ++it) {
    fence_regs<128>(o);
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(s, q_desc + ((sl * 128 * SW + kk * 32) >> 4),
                     k_desc + ((sl * 64 * SW + kk * 32) >> 4),
                     sl + kk > 0);
    wgmma_commit();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n256(o, pa[kk], v_desc + ((kk * 16 * SW) >> 4));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(s);
    // the next P while O's product runs: p = 2^(s - max)
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    m0 = fmaxf(m0, mx0);
    m1 = fmaxf(m1, mx1);
#if TRAP
    if (m0 != m0) __trap();
#endif
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float mn = (i & 2) ? m1 : m0;
      pn[i / 2] = pack_bf16(ex2(s[i] - mn), ex2(s[i + 1] - mn));
    }
    wgmma_wait<0>();
    fence_regs<128>(o);
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = pn[i];
  }
  float* dst = out + ((size_t)blockIdx.x * 256 + role * 128 + tid) * 130;
#pragma unroll
  for (int i = 0; i < 128; ++i) dst[i] = o[i];
  dst[128] = m0;
  dst[129] = m1;
}

}  // namespace

// out: gridDim x 256 consumer threads x 130 floats (O, then the two maxes)
extern "C" int setmaxnreg_probe_launch(float* out, int blocks, int iters,
                                       void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      setmaxnreg_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  setmaxnreg_probe<<<blocks, THREADS, SMEM,
                     reinterpret_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
