// Deterministic scatter-add of many rows into a small table, for sm_90a.
//
// Replaces librecommender_tpu/ops/pallas_scatter.py `_scatter_kernel` (reached
// via `scatter_add_rows` and the backward of `gather_rows`):
// out = zeros(n_rows, D).at[ids].add(rows) for (N,) ids and (N, D) f32 rows,
// where N (a batch times its history length) is many times n_rows. Ids
// outside [0, n_rows) are dropped; rows that no id touches come out zero.
//
// What bounds it on an H100: bytes. It moves 4N + 4ND + 4 n_rows D bytes
// (ids, every row once, every output row once) for N D adds, far below the
// card's operations-per-byte balance.
//
// Design. The TPU kernel walks the N rows in order on one core and adds each
// into an accumulator that stays on chip. Here a block owns 16 output rows and
// adds their hits in ascending n, scanning the ids and staging the hits'
// source rows through shared memory: staged_add.cuh, which this kernel shares
// with the segment-sum of table_gather.cu, says how and why.
#include "staged_add.cuh"

namespace {

template <typename Id, int kSlots, bool kSparse>
__global__ void __launch_bounds__(staged::kThreads, 2)
    scatter_rows_kernel(const Id* __restrict__ ids,
                        const float* __restrict__ rows, int N, int D,
                        long long n_rows, int cols, int seg_len, int groups,
                        float* __restrict__ dst) {
  staged::add_tile<Id, kSlots, false, kSparse>(ids, rows, N, D, n_rows, cols,
                                               seg_len, groups, dst);
}

template <typename Id, bool kSparse>
void launch(const staged::Launch& l, cudaStream_t stream, const Id* ids,
            const float* rows, int N, int D, long long n_rows, int cols,
            int seg_len, int groups) {
  if (cols <= 32)
    scatter_rows_kernel<Id, 1, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, rows, N, D, n_rows, cols, seg_len, groups, l.dst);
  else if (cols <= 64)
    scatter_rows_kernel<Id, 2, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, rows, N, D, n_rows, cols, seg_len, groups, l.dst);
  else
    scatter_rows_kernel<Id, 4, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, rows, N, D, n_rows, cols, seg_len, groups, l.dst);
}

template <typename Id>
void choose(const staged::Launch& l, cudaStream_t stream, const void* ids,
            const float* rows, int N, int D, long long n_rows, int cols,
            int seg_len, int groups) {
  if (groups > 1)
    launch<Id, true>(l, stream, static_cast<const Id*>(ids), rows, N, D,
                     n_rows, cols, seg_len, groups);
  else
    launch<Id, false>(l, stream, static_cast<const Id*>(ids), rows, N, D,
                      n_rows, cols, seg_len, groups);
}

}  // namespace

extern "C" {

// out (n_rows, D) = zeros, then rows (N, D) added at ids (N,) in ascending n;
// ids outside [0, n_rows) are dropped. ids are int32, or int64 when ids_int64
// is set. A block owns 16 * groups rows and cols (<= 128) columns of seg_len
// ids, from the host's plan (groups > 1: the sparse-tile form); where
// seg_len < N, partial holds ceil(N / seg_len) tables of (n_rows, D), which a
// second kernel adds into out in segment order. The launch uses 256 * cols
// bytes of dynamic shared memory beside 10 KB of static, within the 48 KB a
// block gets without opting in. All pointers are device memory, row-major.
// Returns the cudaError_t of the launch (0 on success); never synchronises.
int scatter_add_rows(const void* ids, int ids_int64, const float* rows, int N,
                     int D, long long n_rows, int cols, int seg_len,
                     int groups, float* partial, float* out,
                     void* stream_ptr) {
  staged::Launch l;
  cudaError_t err =
      staged::plan(N, D, n_rows, cols, seg_len, groups, partial, out, &l);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ids_int64)
    choose<long long>(l, stream, ids, rows, N, D, n_rows, cols, seg_len,
                      groups);
  else
    choose<int>(l, stream, ids, rows, N, D, n_rows, cols, seg_len, groups);
  return (int)staged::finish(l, n_rows, D, out, stream);
}

}  // extern "C"
