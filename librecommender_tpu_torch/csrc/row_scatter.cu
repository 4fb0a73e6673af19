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
// adds their hits in ascending n: two small kernels first partition the ids
// by tile, stably, so a block reads only its own hits, and it streams their
// source rows through a ring of shared memory with cp.async, many rows in
// flight; a call of few ids skips the partition and every block scans them
// (scan_add.cuh). staged_add.cuh, which this kernel shares with the
// segment-sum of table_gather.cu, says how and why.
#include "scan_add.cuh"

namespace {

template <int kSlots, bool kGroups, int kVec>
__global__ void __launch_bounds__(staged::kThreads, 2)
    scatter_rows_kernel(const float* __restrict__ rows,
                        const int* __restrict__ pos,
                        const int* __restrict__ sub,
                        const int* __restrict__ bstart, int D, long long n_rows,
                        int cols, int groups, int row_tiles,
                        float* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem[];
  staged::add_body<kSlots, false, kGroups, kVec>(rows, pos, sub, bstart, D,
                                                 n_rows, cols, groups,
                                                 row_tiles, dst, smem);
}

template <int kSlots, bool kGroups, int kVec>
cudaError_t launch(const staged::Launch& l, cudaStream_t stream,
                   const float* rows, int D, long long n_rows, int cols,
                   int groups) {
  static bool ready[64];
  return staged::launch_add(scatter_rows_kernel<kSlots, kGroups, kVec>, ready,
                            l, stream, rows, l.pos, l.sub, l.bstart, D, n_rows,
                            cols, groups, l.row_tiles, l.dst);
}

template <bool kGroups, int kVec>
cudaError_t by_cols(const staged::Launch& l, cudaStream_t stream,
                    const float* rows, int D, long long n_rows, int cols,
                    int groups) {
  if (cols <= 32)
    return launch<1, kGroups, kVec>(l, stream, rows, D, n_rows, cols, groups);
  if (cols <= 64)
    return launch<2, kGroups, kVec>(l, stream, rows, D, n_rows, cols, groups);
  return launch<4, kGroups, kVec>(l, stream, rows, D, n_rows, cols, groups);
}

cudaError_t choose(const staged::Launch& l, cudaStream_t stream,
                   const float* rows, int D, long long n_rows, int cols,
                   int groups, int vec) {
  if (groups > 1)
    return vec == 4 ? by_cols<true, 4>(l, stream, rows, D, n_rows, cols, groups)
                    : by_cols<true, 1>(l, stream, rows, D, n_rows, cols, groups);
  return vec == 4 ? by_cols<false, 4>(l, stream, rows, D, n_rows, cols, groups)
                  : by_cols<false, 1>(l, stream, rows, D, n_rows, cols, groups);
}

// The scan form (scan_add.cuh), for calls of few ids.
template <typename Id, int kSlots, bool kSparse>
__global__ void __launch_bounds__(staged::kThreads, 2)
    scatter_rows_kernel_scan(const Id* __restrict__ ids,
                        const float* __restrict__ rows, int N, int D,
                        long long n_rows, int cols, int seg_len, int groups,
                        float* __restrict__ dst) {
  staged::scan_add_tile<Id, kSlots, false, kSparse>(ids, rows, N, D, n_rows, cols,
                                               seg_len, groups, dst);
}

template <typename Id, bool kSparse>
void launch_scan(const staged::Launch& l, cudaStream_t stream, const Id* ids,
            const float* rows, int N, int D, long long n_rows, int cols,
            int seg_len, int groups) {
  if (cols <= 32)
    scatter_rows_kernel_scan<Id, 1, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, rows, N, D, n_rows, cols, seg_len, groups, l.dst);
  else if (cols <= 64)
    scatter_rows_kernel_scan<Id, 2, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, rows, N, D, n_rows, cols, seg_len, groups, l.dst);
  else
    scatter_rows_kernel_scan<Id, 4, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, rows, N, D, n_rows, cols, seg_len, groups, l.dst);
}

template <typename Id>
void choose_scan(const staged::Launch& l, cudaStream_t stream, const void* ids,
            const float* rows, int N, int D, long long n_rows, int cols,
            int seg_len, int groups) {
  if (groups > 1)
    launch_scan<Id, true>(l, stream, static_cast<const Id*>(ids), rows, N, D,
                     n_rows, cols, seg_len, groups);
  else
    launch_scan<Id, false>(l, stream, static_cast<const Id*>(ids), rows, N, D,
                      n_rows, cols, seg_len, groups);
}

}  // namespace

extern "C" {

// out (n_rows, D) = zeros, then rows (N, D) added at ids (N,) in ascending n;
// ids outside [0, n_rows) are dropped. ids are int32, or int64 when ids_int64
// is set. A block owns 16 * groups rows and cols (<= 128) columns of seg_len
// ids, from the host's plan; chunk is the ids a partition block takes (0:
// the scan form of scan_add.cuh, no partition, work unused) and vec the
// floats a copy moves (4 where rows is 16-byte aligned and D a multiple
// of 4, else 1). work holds work_bytes bytes, at least
// staged::workspace_bytes(N, buckets, chunk, chunks) (else nothing is
// launched and the call returns cudaErrorInvalidValue); where seg_len < N,
// partial holds ceil(N / seg_len) tables of
// (n_rows, D), which a last kernel adds into out in segment order. All
// pointers are device memory, row-major. Returns the cudaError_t of the
// launches (0 on success); never synchronises.
int scatter_add_rows(const void* ids, int ids_int64, const float* rows, int N,
                     int D, long long n_rows, int cols, int seg_len,
                     int groups, int chunk, int vec, void* work,
                     long long work_bytes, float* partial, float* out,
                     void* stream_ptr) {
  if (chunk == 0) {   // the scan form
    staged::Launch l;
    cudaError_t err = staged::plan_scan(N, D, n_rows, cols, seg_len, groups,
                                        partial, out, &l);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (ids_int64)
      choose_scan<long long>(l, stream, ids, rows, N, D, n_rows, cols, seg_len,
                             groups);
    else
      choose_scan<int>(l, stream, ids, rows, N, D, n_rows, cols, seg_len,
                       groups);
    return (int)staged::finish(l, n_rows, D, out, stream);
  }
  return staged::ordered_add(ids, ids_int64, rows, N, D, n_rows, cols, seg_len,
                             groups, chunk, vec, work, work_bytes, partial, out,
                             stream_ptr, choose);
}

}  // extern "C"
