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
// - Segment-sum, deterministic without atomics: a block owns `rows` output
//   rows x `cols` columns, accumulated in shared memory. It streams all B ids
//   in ascending chunks of 2048. Each of its 8 warps scans a 256-id slice of
//   the chunk and writes the ids that fall in the block's rows, in ascending
//   b, to a list of its own (a ballot gives each hit its place). After a
//   barrier every warp walks the 8 lists in order, so in ascending b, and
//   adds the rows it owns (local row % 8 == warp); lane l owns columns
//   l, l + 32, .... Each output element is therefore summed by one thread as
//   0 + vals[b0] + vals[b1] + ... in ascending b: the order of
//   `torch.zeros(R, D).index_add_(0, ids, vals)` on the CPU, bit for bit.
//   Then the block writes every owned row, zeros included.
// - Cost of that design: every block scans all B ids, ceil(R / rows) * B
//   compares in all. Small at BPR's tables (R of a few thousand); it grows as
//   R * B. The host picks `rows` (8 to 256) so that the grid still gives each
//   SM about two blocks. Sorting the ids once and reducing segments is the
//   redesign for very large tables.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;             // ids a segment-sum block stages a round
constexpr int kSlice = kChunk / kWarps;  // ids one warp scans a round
constexpr int kMaxCols = 256;            // columns a segment-sum block owns
constexpr int kMaxRows = 256;

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

template <typename Id, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const Id* __restrict__ ids, const float* __restrict__ vals,
                  int B, int D, long long R, int rows, int cols,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // [rows][cols]
  int* hit_b = reinterpret_cast<int*>(acc + rows * cols);  // [kWarps][kSlice]
  unsigned short* hit_r =                              // local row of each hit
      reinterpret_cast<unsigned short*>(hit_b + kChunk);
  __shared__ int hit_n[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long lim = R - r0 < rows ? R - r0 : rows;  // real rows owned
  const int c0 = blockIdx.y * cols;
  const int nc = D - c0 < cols ? D - c0 : cols;         // real columns owned

  for (int i = threadIdx.x; i < rows * cols; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  for (int base = 0; base < B; base += kChunk) {
    // 1. this warp's slice: hits in ascending b, placed by a ballot
    int n = 0;
    const int s0 = base + warp * kSlice;
    int* my_b = hit_b + warp * kSlice;
    unsigned short* my_r = hit_r + warp * kSlice;
    for (int j = 0; j < kSlice; j += 32) {
      const int b = s0 + j + lane;
      long long local = -1;
      if (b < B) local = (long long)ids[b] - r0;
      const bool hit = local >= 0 && local < lim;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int pos = n + __popc(mask & ((1u << lane) - 1u));
        my_b[pos] = b;
        my_r[pos] = (unsigned short)local;
      }
      n += __popc(mask);
    }
    if (lane == 0) hit_n[warp] = n;
    __syncthreads();

    // 2. all hits in ascending b; this warp adds the rows it owns
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = hit_n[w];
      const int* lb = hit_b + w * kSlice;
      const unsigned short* lr = hit_r + w * kSlice;
      for (int j = 0; j < cnt; ++j) {
        const int r = lr[j];
        if ((r & (kWarps - 1)) != warp) continue;  // uniform across the warp
        const float* src = vals + (long long)lb[j] * D + c0;
        float* dst = acc + r * cols;
        for (int c = lane; c < nc; c += 32) {
          float v = src[c];
          if (kBf16) v = __bfloat162float(__float2bfloat16_rn(v));
          dst[c] += v;
        }
      }
    }
    __syncthreads();
  }

  // 3. every owned row, zeros included
  for (int i = threadIdx.x; i < rows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    if (r < lim) out[(r0 + r) * D + c0 + c] = acc[r * cols + c];
  }
}

template <typename Id>
cudaError_t launch_segsum(bool bf16, dim3 grid, size_t smem, cudaStream_t stream,
                          const Id* ids, const float* vals, int B, int D,
                          long long R, int rows, int cols, float* out) {
  if (bf16)
    segsum_kernel<Id, true><<<grid, kThreads, smem, stream>>>(
        ids, vals, B, D, R, rows, cols, out);
  else
    segsum_kernel<Id, false><<<grid, kThreads, smem, stream>>>(
        ids, vals, B, D, R, rows, cols, out);
  return cudaGetLastError();
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
// bf16 before it is added. rows (a power of two in [8, 256]) and cols
// (<= 256) are the block's tile, from the host's plan; the launch uses
// 4 * rows * cols + 6 * 2048 bytes of dynamic shared memory, which must stay
// within the 48 KB a block gets without opting in.
int segment_sum(const void* ids, int ids_int64, const float* vals, int B,
                int D, long long R, int rows, int cols, int bf16, float* out,
                void* stream_ptr) {
  if (R < 1 || B < 0 || D < 1 || rows < kWarps || rows > kMaxRows ||
      (rows & (rows - 1)) != 0 || cols < 1 || cols > kMaxCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long row_tiles = (R + rows - 1) / rows;
  if (row_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_tiles, (D + cols - 1) / cols);
  const size_t smem = sizeof(float) * (size_t)rows * cols +
                      (sizeof(int) + sizeof(unsigned short)) * kChunk;
  if (smem > 48 * 1024 - 64) return (int)cudaErrorInvalidValue;
  if (ids_int64)
    return (int)launch_segsum<long long>(
        bf16 != 0, grid, smem, stream, static_cast<const long long*>(ids),
        vals, B, D, R, rows, cols, out);
  return (int)launch_segsum<int>(bf16 != 0, grid, smem, stream,
                                 static_cast<const int*>(ids), vals, B, D, R,
                                 rows, cols, out);
}

}  // extern "C"
