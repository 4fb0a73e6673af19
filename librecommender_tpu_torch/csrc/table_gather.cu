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
// - Gather (gather_rows.cuh says how and why): a thread stores whole 16-byte
//   vectors of the contiguous output, whatever D, with the ids of all its
//   vectors loaded first, then their table values, then the stores; a grid
//   sized to the card strides over the output.
// - Segment-sum, deterministic without atomics on values: a block owns 16
//   output rows (more where the table has many more rows than ids) and adds
//   their values in ascending b, the order of
//   `torch.zeros(R, D).index_add_(0, ids, vals)` on the CPU. Two small kernels
//   first partition the ids by tile, stably, so a block reads only its own
//   hits; it streams their values through a ring of shared memory with
//   cp.async. A call of few ids skips the partition: every block scans them
//   (scan_add.cuh). A table of few tiles has its ids cut into fixed segments whose
//   partial tables are added in order. staged_add.cuh, which this kernel
//   shares with the scatter-add of row_scatter.cu, says how and why.
#include "gather_rows.cuh"
#include "scan_add.cuh"

namespace {

template <typename Id, int kForm, int kIn>
__global__ void __launch_bounds__(gather::kThreads, gather::kBlocksPerSm)
    gather_kernel(const float* __restrict__ table, const Id* __restrict__ ids,
                  long long R, int D, gather::Launch l, float* __restrict__ out) {
  gather::body<Id, kForm, kIn>(table, ids, R, D, l, out);
}

template <typename Id, int kForm>
void launch_form(const gather::Launch& l, cudaStream_t stream,
                 const float* table, const Id* ids, long long R, int D,
                 float* out) {
  if (l.batch == 1)
    gather_kernel<Id, kForm, 1><<<l.grid, gather::kThreads, 0, stream>>>(
        table, ids, R, D, l, out);
  else
    gather_kernel<Id, kForm, gather::kBatch><<<l.grid, gather::kThreads, 0, stream>>>(
        table, ids, R, D, l, out);
}

template <typename Id>
void launch_gather(const gather::Launch& l, cudaStream_t stream,
                   const float* table, const void* ids, long long R, int D,
                   float* out) {
  const Id* id = static_cast<const Id*>(ids);
  if (l.form == gather::kRow16)
    launch_form<Id, gather::kRow16>(l, stream, table, id, R, D, out);
  else if (l.form == gather::kTwoRows)
    launch_form<Id, gather::kTwoRows>(l, stream, table, id, R, D, out);
  else
    launch_form<Id, gather::kFourRows>(l, stream, table, id, R, D, out);
}

// The multiprocessors of the calling thread's current device, read once a
// device.
int sm_count() {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int kSlots, bool kBf16, bool kGroups, int kVec>
__global__ void __launch_bounds__(staged::kThreads, 2)
    segsum_kernel(const float* __restrict__ vals, const int* __restrict__ pos,
                  const int* __restrict__ sub,
                  const int* __restrict__ bstart, int D, long long R, int cols,
                  int groups, int row_tiles, float* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem[];
  staged::add_body<kSlots, kBf16, kGroups, kVec>(vals, pos, sub, bstart, D, R,
                                                 cols, groups, row_tiles, dst,
                                                 smem);
}

template <int kSlots, bool kBf16, bool kGroups, int kVec>
cudaError_t launch_segsum(const staged::Launch& l, cudaStream_t stream,
                          const float* vals, int D, long long R, int cols,
                          int groups) {
  static bool ready[64];
  return staged::launch_add(segsum_kernel<kSlots, kBf16, kGroups, kVec>, ready,
                            l, stream, vals, l.pos, l.sub, l.bstart, D, R, cols,
                            groups, l.row_tiles, l.dst);
}

template <bool kBf16, bool kGroups, int kVec>
cudaError_t by_cols(const staged::Launch& l, cudaStream_t stream,
                    const float* vals, int D, long long R, int cols, int groups) {
  if (cols <= 32)
    return launch_segsum<1, kBf16, kGroups, kVec>(l, stream, vals, D, R, cols, groups);
  if (cols <= 64)
    return launch_segsum<2, kBf16, kGroups, kVec>(l, stream, vals, D, R, cols, groups);
  return launch_segsum<4, kBf16, kGroups, kVec>(l, stream, vals, D, R, cols, groups);
}

template <bool kBf16>
cudaError_t choose_segsum(const staged::Launch& l, cudaStream_t stream,
                          const float* vals, int D, long long R, int cols,
                          int groups, int vec) {
  if (groups > 1)
    return vec == 4 ? by_cols<kBf16, true, 4>(l, stream, vals, D, R, cols, groups)
                    : by_cols<kBf16, true, 1>(l, stream, vals, D, R, cols, groups);
  return vec == 4 ? by_cols<kBf16, false, 4>(l, stream, vals, D, R, cols, groups)
                  : by_cols<kBf16, false, 1>(l, stream, vals, D, R, cols, groups);
}

// The scan form (scan_add.cuh), for calls of few ids.
template <typename Id, int kSlots, bool kBf16, bool kSparse>
__global__ void __launch_bounds__(staged::kThreads, 2)
    segsum_kernel_scan(const Id* __restrict__ ids, const float* __restrict__ vals,
                  int B, int D, long long R, int cols, int seg_len, int groups,
                  float* __restrict__ dst) {
  staged::scan_add_tile<Id, kSlots, kBf16, kSparse>(ids, vals, B, D, R, cols,
                                               seg_len, groups, dst);
}

template <typename Id, bool kBf16, bool kSparse>
void launch_segsum_scan(const staged::Launch& l, cudaStream_t stream, const Id* ids,
                   const float* vals, int B, int D, long long R, int cols,
                   int seg_len, int groups) {
  if (cols <= 32)
    segsum_kernel_scan<Id, 1, kBf16, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, vals, B, D, R, cols, seg_len, groups, l.dst);
  else if (cols <= 64)
    segsum_kernel_scan<Id, 2, kBf16, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, vals, B, D, R, cols, seg_len, groups, l.dst);
  else
    segsum_kernel_scan<Id, 4, kBf16, kSparse>
        <<<l.grid, staged::kThreads, l.smem, stream>>>(
            ids, vals, B, D, R, cols, seg_len, groups, l.dst);
}

template <typename Id>
void choose_segsum_scan(bool bf16, const staged::Launch& l, cudaStream_t stream,
                   const void* ids_ptr, const float* vals, int B, int D,
                   long long R, int cols, int seg_len, int groups) {
  const Id* ids = static_cast<const Id*>(ids_ptr);
  if (bf16 && groups > 1)
    launch_segsum_scan<Id, true, true>(l, stream, ids, vals, B, D, R, cols, seg_len,
                                  groups);
  else if (bf16)
    launch_segsum_scan<Id, true, false>(l, stream, ids, vals, B, D, R, cols,
                                   seg_len, groups);
  else if (groups > 1)
    launch_segsum_scan<Id, false, true>(l, stream, ids, vals, B, D, R, cols,
                                   seg_len, groups);
  else
    launch_segsum_scan<Id, false, false>(l, stream, ids, vals, B, D, R, cols,
                                    seg_len, groups);
}

}  // namespace

extern "C" {

// out (B, D) = table (R, D) rows at ids (B,), zero rows for ids outside
// [0, R). ids are int32, or int64 when ids_int64 is set. All pointers are
// device memory, row-major; out is 16-byte aligned. The launch is
// gather::plan's on the calling thread's current device. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
int table_gather(const float* table, const void* ids, int ids_int64,
                 long long R, int B, int D, float* out, void* stream_ptr) {
  gather::Launch l;
  const cudaError_t err = gather::plan(R, B, D, table, out, sm_count(), &l);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ids_int64)
    launch_gather<long long>(l, stream, table, ids, R, D, out);
  else
    launch_gather<int>(l, stream, table, ids, R, D, out);
  return (int)cudaGetLastError();
}

// out (R, D) = zeros, then vals (B, D) rows added at ids (B,) in ascending b;
// ids outside [0, R) are dropped. With bf16 set, each value is rounded to
// bf16 before it is added. A block owns 16 * groups rows and cols (<= 128)
// columns of seg_len ids, from the host's plan; chunk is the ids a partition
// block takes (0: the scan form of scan_add.cuh, no partition, work unused)
// and vec the floats a copy moves (4 where vals is 16-byte
// aligned and D a multiple of 4, else 1). work holds work_bytes bytes, at
// least staged::workspace_bytes(B, buckets, chunk, chunks) (else nothing is
// launched and the call returns cudaErrorInvalidValue); where seg_len < B,
// partial holds ceil(B / seg_len) tables of (R, D), which a last kernel adds
// into out in segment order. All pointers are device memory, row-major.
// Returns the cudaError_t of the launches (0 on success); never synchronises.
int segment_sum(const void* ids, int ids_int64, const float* vals, int B,
                int D, long long R, int cols, int seg_len, int groups,
                int chunk, int vec, int bf16, void* work, long long work_bytes,
                float* partial, float* out, void* stream_ptr) {
  if (chunk == 0) {   // the scan form
    staged::Launch l;
    cudaError_t err =
        staged::plan_scan(B, D, R, cols, seg_len, groups, partial, out, &l);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (ids_int64)
      choose_segsum_scan<long long>(bf16 != 0, l, stream, ids, vals, B, D, R,
                                    cols, seg_len, groups);
    else
      choose_segsum_scan<int>(bf16 != 0, l, stream, ids, vals, B, D, R, cols,
                              seg_len, groups);
    return (int)staged::finish(l, R, D, out, stream);
  }
  auto add = [bf16](const staged::Launch& l, cudaStream_t stream,
                    const float* v, int d, long long r, int c, int g, int vw) {
    return bf16 ? choose_segsum<true>(l, stream, v, d, r, c, g, vw)
                : choose_segsum<false>(l, stream, v, d, r, c, g, vw);
  };
  return staged::ordered_add(ids, ids_int64, vals, B, D, R, cols, seg_len,
                             groups, chunk, vec, work, work_bytes, partial, out,
                             stream_ptr, add);
}

}  // extern "C"
