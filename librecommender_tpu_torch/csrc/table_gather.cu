// Embedding-table gather and its deterministic segment-sum, for sm_90a.
//
// Replaces:
// - librecommender_tpu/ops/mxu_gather.py `_gather_kernel` (reached via
//   `_gather_call`, `mxu_gather`, `table_lookup`): out[b] = table[ids[b]] for
//   a (R, D) f32 table and (B,) ids, exact; an id outside [0, R) gives a zero
//   row.
// - librecommender_tpu/ops/mxu_gather.py `_segsum_kernel` (reached via
//   `_segsum_call`, `segment_sum_mxu`, the `mxu_gather` backward):
//   out = zeros(R, D).at[ids].add(vals); ids outside [0, R) are dropped.
// - parity/bench_scatter.py `kernel` in `pallas_segsum`: the same function
//   with every value rounded to bf16 (round to nearest even) and f32 sums;
//   here the `bf16` flag of `segment_sum`.
//
// What bounds them on an H100: bytes. The gather moves 4B + 8BD bytes (ids,
// the rows it reads, the rows it writes) and does no arithmetic; the
// segment-sum moves 4B + 4BD + 4RD (ids, values, every output row) for BD
// adds. Both are far below the card's operations-per-byte balance.
//
// Design:
// - Gather: one warp per output row, lanes striding over D, so each row is
//   read and written in coalesced 128-byte runs; any D (65 with BPR's bias
//   column) takes a partial last run.
// - Segment-sum, deterministic without atomics: a block owns 16 output rows
//   and adds their values in ascending b, the order of
//   `torch.zeros(R, D).index_add_(0, ids, vals)` on the CPU, scanning the ids
//   and staging the hits' values through shared memory; a table of few tiles
//   has its ids cut into fixed segments whose partial tables are added in
//   order, a table of many more rows than ids gets larger tiles.
//   staged_add.cuh, which this kernel shares with the scatter-add of
//   row_scatter.cu, says how and why.
#include "staged_add.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ table, const Id* __restrict__ ids,
                  long long R, int B, int D, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const long long id = (long long)ids[b];
  float* dst = out + b * D;
  if (id < 0 || id >= R) {
    for (int d = lane; d < D; d += 32) dst[d] = 0.0f;
    return;
  }
  const float* src = table + id * D;
  for (int d = lane; d < D; d += 32) dst[d] = src[d];
}

template <typename Id, int kSlots, bool kBf16, bool kSparse>
__global__ void __launch_bounds__(staged::kThreads, 2)
    segsum_kernel(const Id* __restrict__ ids, const float* __restrict__ vals,
                  int B, int D, long long R, int cols, int seg_len, int groups,
                  float* __restrict__ dst) {
  staged::add_tile<Id, kSlots, kBf16, kSparse>(ids, vals, B, D, R, cols,
                                               seg_len, groups, dst);
}

template <typename Id, bool kBf16, bool kSparse>
void launch_segsum(const staged::Launch& l, cudaStream_t stream, const Id* ids,
                   const float* vals, int B, int D, long long R, int cols,
                   int seg_len, int groups) {
  if (cols <= 32)
    segsum_kernel<Id, 1, kBf16, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, vals, B, D, R, cols, seg_len, groups, l.dst);
  else if (cols <= 64)
    segsum_kernel<Id, 2, kBf16, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, vals, B, D, R, cols, seg_len, groups, l.dst);
  else
    segsum_kernel<Id, 4, kBf16, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, vals, B, D, R, cols, seg_len, groups, l.dst);
}

template <typename Id>
void choose_segsum(bool bf16, const staged::Launch& l, cudaStream_t stream,
                   const void* ids_ptr, const float* vals, int B, int D,
                   long long R, int cols, int seg_len, int groups) {
  const Id* ids = static_cast<const Id*>(ids_ptr);
  if (bf16 && groups > 1)
    launch_segsum<Id, true, true>(l, stream, ids, vals, B, D, R, cols, seg_len,
                                  groups);
  else if (bf16)
    launch_segsum<Id, true, false>(l, stream, ids, vals, B, D, R, cols,
                                   seg_len, groups);
  else if (groups > 1)
    launch_segsum<Id, false, true>(l, stream, ids, vals, B, D, R, cols,
                                   seg_len, groups);
  else
    launch_segsum<Id, false, false>(l, stream, ids, vals, B, D, R, cols,
                                    seg_len, groups);
}

}  // namespace

extern "C" {

// out (B, D) = table (R, D) rows at ids (B,), zero rows for ids outside
// [0, R). ids are int32, or int64 when ids_int64 is set. All pointers are
// device memory, row-major. Returns the cudaError_t of the launch (0 on
// success); never synchronises.
int table_gather(const float* table, const void* ids, int ids_int64,
                 long long R, int B, int D, float* out, void* stream_ptr) {
  if (R < 1 || B < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((B + kWarps - 1) / kWarps);
  if (ids_int64)
    gather_kernel<long long><<<grid, kThreads, 0, stream>>>(
        table, static_cast<const long long*>(ids), R, B, D, out);
  else
    gather_kernel<int><<<grid, kThreads, 0, stream>>>(
        table, static_cast<const int*>(ids), R, B, D, out);
  return (int)cudaGetLastError();
}

// out (R, D) = zeros, then vals (B, D) rows added at ids (B,) in ascending b;
// ids outside [0, R) are dropped. With bf16 set, each value is rounded to
// bf16 before it is added. A block owns 16 * groups rows and cols (<= 128)
// columns of seg_len ids, from the host's plan (groups > 1: the sparse-tile
// form); where seg_len < B, partial holds ceil(B / seg_len) tables of (R, D),
// which a second kernel adds into out in segment order. The launch uses
// 256 * cols bytes of dynamic shared memory beside 10 KB of static, within
// the 48 KB a block gets without opting in.
int segment_sum(const void* ids, int ids_int64, const float* vals, int B,
                int D, long long R, int cols, int seg_len, int groups,
                int bf16, float* partial, float* out, void* stream_ptr) {
  staged::Launch l;
  cudaError_t err =
      staged::plan(B, D, R, cols, seg_len, groups, partial, out, &l);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ids_int64)
    choose_segsum<long long>(bf16 != 0, l, stream, ids, vals, B, D, R, cols,
                             seg_len, groups);
  else
    choose_segsum<int>(bf16 != 0, l, stream, ids, vals, B, D, R, cols, seg_len,
                       groups);
  return (int)staged::finish(l, R, D, out, stream);
}

}  // extern "C"
