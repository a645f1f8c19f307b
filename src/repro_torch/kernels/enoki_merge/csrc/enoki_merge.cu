// Versioned last-writer-wins row merge, K snapshots folded in ONE launch.
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
// arithmetic to speak of).  What the design does about it:
//   * the merge is in place, so only the rows a snapshot wins move: the
//     winner's row is read once and written once into the accumulator, a
//     losing row is never touched, and no intermediate array (stacked
//     snapshots, broadcast predicate, merged copy) is ever materialised;
//   * payload bytes are copied raw, 16 bytes a thread when the row width
//     and every base pointer allow it (4-byte or byte accesses otherwise),
//     so one kernel serves every payload dtype (f32, bf16, int32, uint8);
//   * main-path arenas have 64 rows, which cannot fill 132 SMs, so each row
//     is split across blocks along its bytes (grid = rows x chunks) and the
//     ragged last chunk is masked here, with no divisibility constraint.
//
// Snapshots arrive as a small device table of K pointer records copied
// from the host in the same stream (no payload is stacked or copied).  The
// winner is decided from acc.versions, which the merge itself rewrites, so
// the row's metadata is written by the LAST of the row's chunk blocks to
// finish reading it (an atomic ticket per row, zeroed in the same table);
// every chunk block therefore agrees on the winner.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct SnapPtrs {
  const unsigned char* values;
  const int32_t* versions;
  const int32_t* keys;      // null when the caller merges bare rows
  const int32_t* lengths;   // null when the caller merges bare rows
  const int32_t* vv;        // null when the caller merges bare rows
};

template <int VEC>
__device__ __forceinline__ void copy_bytes(unsigned char* __restrict__ dst,
                                           const unsigned char* __restrict__ src,
                                           int64_t lo, int64_t hi) {
  for (int64_t off = lo + (int64_t)threadIdx.x * VEC; off < hi;
       off += (int64_t)blockDim.x * VEC) {
    if (VEC == 16) {
      *reinterpret_cast<uint4*>(dst + off) =
          *reinterpret_cast<const uint4*>(src + off);
    } else if (VEC == 4) {
      *reinterpret_cast<uint32_t*>(dst + off) =
          *reinterpret_cast<const uint32_t*>(src + off);
    } else {
      dst[off] = src[off];
    }
  }
}

template <int VEC>
__global__ void enoki_merge_rows_kernel(
    unsigned char* __restrict__ acc_values, int32_t* acc_versions,
    int32_t* acc_keys, int32_t* acc_lengths, int32_t* acc_vv,
    const SnapPtrs* __restrict__ snaps, int k, int64_t row_bytes,
    int64_t chunk_bytes, int nvv, unsigned int* tickets) {
  const int64_t row = blockIdx.x;
  __shared__ int s_win;
  __shared__ int32_t s_best;
  if (threadIdx.x == 0) {
    int32_t best = acc_versions[row];
    int win = -1;
    for (int j = 0; j < k; ++j) {
      const int32_t v = snaps[j].versions[row];
      if (v > best) {
        best = v;
        win = j;
      }
    }
    s_win = win;
    s_best = best;
  }
  __syncthreads();
  const int win = s_win;
  if (win >= 0) {
    const int64_t lo = (int64_t)blockIdx.y * chunk_bytes;
    const int64_t end = lo + chunk_bytes;
    const int64_t hi = end < row_bytes ? end : row_bytes;
    copy_bytes<VEC>(acc_values + row * row_bytes,
                    snaps[win].values + row * row_bytes, lo, hi);
    if (threadIdx.x == 0) {
      bool last = true;
      if (gridDim.y > 1) {
        // every chunk block read acc_versions[row] before taking a ticket
        __threadfence();
        last = atomicAdd(tickets + row, 1u) == gridDim.y - 1;
      }
      if (last) {
        acc_versions[row] = s_best;
        if (acc_keys != nullptr) acc_keys[row] = snaps[win].keys[row];
        if (acc_lengths != nullptr) acc_lengths[row] = snaps[win].lengths[row];
      }
    }
  }
  if (acc_vv != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
    for (int i = threadIdx.x; i < nvv; i += blockDim.x) {
      int32_t m = acc_vv[i];
      for (int j = 0; j < k; ++j) m = max(m, snaps[j].vv[i]);
      acc_vv[i] = m;
    }
  }
}

}  // namespace

// Copies the K pointer records (plus zeroed per-row tickets when a row spans
// several chunks) from `host_table` into `dev_table`, then launches.  Returns
// cudaGetLastError() (0 on success); the caller raises on anything else.
extern "C" int enoki_merge_rows_launch(
    int device, void* acc_values, void* acc_versions, void* acc_keys,
    void* acc_lengths, void* acc_vv, const void* host_table, void* dev_table,
    long long table_bytes, int k, long long rows, long long row_bytes,
    long long chunk_bytes, int nvv, int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemcpyAsync(dev_table, host_table, (size_t)table_bytes,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (row_bytes + chunk_bytes - 1) / chunk_bytes;
  const SnapPtrs* snaps = reinterpret_cast<const SnapPtrs*>(dev_table);
  unsigned int* tickets = reinterpret_cast<unsigned int*>(
      static_cast<unsigned char*>(dev_table) + (size_t)k * sizeof(SnapPtrs));
  const dim3 grid((unsigned int)rows, (unsigned int)chunks);
  const dim3 block(256);
  unsigned char* av = static_cast<unsigned char*>(acc_values);
  int32_t* aver = static_cast<int32_t*>(acc_versions);
  int32_t* akeys = static_cast<int32_t*>(acc_keys);
  int32_t* alen = static_cast<int32_t*>(acc_lengths);
  int32_t* avv = static_cast<int32_t*>(acc_vv);
  if (vec == 16) {
    enoki_merge_rows_kernel<16><<<grid, block, 0, s>>>(
        av, aver, akeys, alen, avv, snaps, k, row_bytes, chunk_bytes, nvv,
        tickets);
  } else if (vec == 4) {
    enoki_merge_rows_kernel<4><<<grid, block, 0, s>>>(
        av, aver, akeys, alen, avv, snaps, k, row_bytes, chunk_bytes, nvv,
        tickets);
  } else {
    enoki_merge_rows_kernel<1><<<grid, block, 0, s>>>(
        av, aver, akeys, alen, avv, snaps, k, row_bytes, chunk_bytes, nvv,
        tickets);
  }
  return (int)cudaGetLastError();
}
