// Versioned last-writer-wins row merge, K snapshots folded in place.
//
// Replaces the Pallas TPU kernel `enoki_merge_rows` (body `_merge_kernel`)
// of src/repro/kernels/enoki_merge/kernel.py, as it is driven by
// `repro.core.store.merge_snapshots_fused(aligned=True)`: fold K >= 1
// slot-aligned snapshots into an accumulator arena, in order.
//
//   per row r: win = the first snapshot holding the maximum version among
//              those STRICTLY greater than acc.versions[r] (ties keep acc;
//              equal to the sequential strict-`>` fold of the reference);
//              if a winner exists, acc.values[r], versions[r], keys[r] and
//              lengths[r] become the winner's;
//   vv:        acc.vv[i] = max(acc.vv[i], snap_k.vv[i] for every k).
//
// Bound: device-memory bytes (an H100 SXM moves 3.35 TB/s; there is no
// arithmetic to speak of): every version read once, a winning row read from
// its snapshot and written into the accumulator once.  At the main path's
// arenas (64 rows of 100 KB) that is ~1.8 us, so a call is as long as its
// chain of dependent latencies, and the design shortens that chain:
//   * the merge is in place: a losing row is never touched, and nothing
//     (stacked snapshots, a broadcast predicate, a merged copy) is
//     materialised; payload bytes are copied raw, so one kernel serves
//     every payload dtype (f32, bf16, int32, uint8);
//   * the K snapshot records (five pointers each) travel BY VALUE, as a
//     __grid_constant__ kernel parameter: no device table, no host-to-device
//     copy.  Up to KMAX records fit the parameter space; the wrapper folds
//     more in consecutive launches (an ordered fold splits into ordered
//     groups);
//   * one warp decides a row's winner: lane j reads snapshot j's version
//     (and j + 32's), all in flight together beside acc.versions[row], and a
//     warp reduction keeps the first maximum;
//   * a row is split along its bytes into at most MAX_CLUSTER chunks, its
//     blocks one thread-block cluster (64-row arenas cannot fill 132 SMs
//     otherwise); each thread issues all its 16-byte loads before its
//     stores, UNROLL at a time (4-byte or byte accesses when the row width or
//     a base pointer breaks 16 bytes; the ragged last chunk is masked here);
//   * the winner is decided from acc.versions, which the merge itself
//     rewrites: every block of the row's cluster arrives at the cluster
//     barrier once it has read it, and rank 0 writes versions, keys and
//     lengths after the wait.  No atomics, no tickets to zero.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 64;          // records a launch takes by value (MAX_K in kernel.py)
constexpr int MAX_CLUSTER = 8;    // chunks a row, at most: the portable size
constexpr int THREADS = 256;
constexpr int UNROLL = 8;         // loads a thread keeps in flight

struct SnapPtrs {
  const unsigned char* values;
  const int32_t* versions;
  const int32_t* keys;      // null when the caller merges bare rows
  const int32_t* lengths;   // null when the caller merges bare rows
  const int32_t* vv;        // null when the caller merges bare rows
};

struct Snaps {
  SnapPtrs s[KMAX];
};

struct Acc {
  unsigned char* values;
  int32_t* versions;
  int32_t* keys;
  int32_t* lengths;
  int32_t* vv;
  long long rows, row_bytes, chunk_bytes;
  int k, chunks, nvv;
};

template <typename U>
__device__ __forceinline__ void copy_range(unsigned char* __restrict__ dst,
                                           const unsigned char* __restrict__ src,
                                           int64_t lo, int64_t hi) {
  U* d = reinterpret_cast<U*>(dst + lo);
  const U* s = reinterpret_cast<const U*>(src + lo);
  const int64_t n = (hi - lo) / (int64_t)sizeof(U);
  for (int64_t base = threadIdx.x; base < n; base += THREADS * UNROLL) {
    U r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + (int64_t)u * THREADS;
      if (i < n) r[u] = s[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + (int64_t)u * THREADS;
      if (i < n) d[i] = r[u];
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    enoki_merge_rows_kernel(const Acc a, const __grid_constant__ Snaps snaps) {
  // grid.x: (chunk, row), the chunk fastest; a row's chunks are one cluster
  const int64_t row = blockIdx.x / a.chunks;
  const int chunk = (int)(blockIdx.x % a.chunks);
  __shared__ int s_win;
  __shared__ int32_t s_best;
  if (row >= a.rows) {   // an arena of no rows: one block, for vv alone
    if (threadIdx.x == 0) s_win = -1;
  } else if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int32_t best = a.versions[row];
    int win = -1;
    for (int j = lane; j < a.k; j += 32) {
      const int32_t v = snaps.s[j].versions[row];
      if (v > best) {
        best = v;
        win = j;
      }
    }
    // the larger version wins; of equal ones, the first snapshot (only
    // versions above the accumulator's carry a winner, so -1 never ties one)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int ow = __shfl_xor_sync(0xffffffffu, win, off);
      if (ob > best || (ob == best && ow < win)) {
        best = ob;
        win = ow;
      }
    }
    if (lane == 0) {
      s_win = win;
      s_best = best;
    }
  }
  __syncthreads();
  const int win = s_win;
  if (a.chunks > 1) cluster_arrive();   // acc.versions[row] is read
  if (win >= 0) {
    const int64_t lo = (int64_t)chunk * a.chunk_bytes;
    const int64_t end = lo + a.chunk_bytes;
    const int64_t hi = end < a.row_bytes ? end : a.row_bytes;
    if (lo < hi) {
      unsigned char* dst = a.values + row * a.row_bytes;
      const unsigned char* src = snaps.s[win].values + row * a.row_bytes;
      if (VEC == 16) copy_range<uint4>(dst, src, lo, hi);
      else if (VEC == 4) copy_range<uint32_t>(dst, src, lo, hi);
      else copy_range<unsigned char>(dst, src, lo, hi);
    }
  }
  if (a.chunks > 1) cluster_wait();     // every block of the row read it
  if (win >= 0 && chunk == 0 && threadIdx.x == 0) {
    a.versions[row] = s_best;
    if (a.keys != nullptr) a.keys[row] = snaps.s[win].keys[row];
    if (a.lengths != nullptr) a.lengths[row] = snaps.s[win].lengths[row];
  }
  if (a.vv != nullptr && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < a.nvv; i += THREADS) {
      int32_t m = a.vv[i];
      for (int j = 0; j < a.k; ++j) m = max(m, snaps.s[j].vv[i]);
      a.vv[i] = m;
    }
  }
}

template <int VEC>
cudaError_t launch(const Acc& a, const Snaps& snaps, long long rows,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows > 0 ? rows : 1) * a.chunks));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.chunks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, enoki_merge_rows_kernel<VEC>, a,
                                       snaps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// records: 5 * k pointers (values, versions, keys, lengths, vv of each
// snapshot, 0 for an absent field), read here on the host and passed by
// value.  chunks: blocks a row, 1..8, one cluster; chunk_bytes a multiple of
// 16.  Returns cudaGetLastError() after the launch (0 on success); the
// caller raises on anything else.
extern "C" int enoki_merge_rows_launch(
    int device, void* acc_values, void* acc_versions, void* acc_keys,
    void* acc_lengths, void* acc_vv, const unsigned long long* records, int k,
    long long rows, long long row_bytes, long long chunk_bytes, int chunks,
    int nvv, int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > KMAX || chunks < 1 || chunks > MAX_CLUSTER || rows < 0 ||
      chunk_bytes % 16 != 0 || chunk_bytes * chunks < row_bytes)
    return (int)cudaErrorInvalidValue;
  Snaps snaps = {};
  for (int j = 0; j < k; ++j) {
    const unsigned long long* r = records + 5 * j;
    snaps.s[j].values = reinterpret_cast<const unsigned char*>(r[0]);
    snaps.s[j].versions = reinterpret_cast<const int32_t*>(r[1]);
    snaps.s[j].keys = reinterpret_cast<const int32_t*>(r[2]);
    snaps.s[j].lengths = reinterpret_cast<const int32_t*>(r[3]);
    snaps.s[j].vv = reinterpret_cast<const int32_t*>(r[4]);
  }
  Acc a;
  a.values = static_cast<unsigned char*>(acc_values);
  a.versions = static_cast<int32_t*>(acc_versions);
  a.keys = static_cast<int32_t*>(acc_keys);
  a.lengths = static_cast<int32_t*>(acc_lengths);
  a.vv = static_cast<int32_t*>(acc_vv);
  a.rows = rows;
  a.row_bytes = row_bytes;
  a.chunk_bytes = chunk_bytes;
  a.k = k;
  a.chunks = chunks;
  a.nvv = nvv;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return (int)launch<16>(a, snaps, rows, s);
    case 4: return (int)launch<4>(a, snaps, rows, s);
    case 1: return (int)launch<1>(a, snaps, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
