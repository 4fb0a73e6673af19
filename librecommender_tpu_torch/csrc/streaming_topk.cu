// Streaming top-k over user x item dot products, for sm_90a.
//
// Replaces: librecommender_tpu/ops/pallas_topk.py `_topk_kernel` (reached via
// `_pallas_topk_masked`, `pallas_topk`, `pallas_topk_padded`). Same function:
// for users (U, D) and items (N, D) in float32, the k best items of each row of
// U @ I.T, descending by score, ties to the lower item id, items with id >=
// n_items never returned, without forming the (U, N) score matrix.
//
// What bounds it on an H100: 2*U*N*D float32 operations on the CUDA cores
// (scores must match an f32 reference closely enough that ids agree, so no
// TF32 and no bf16), against N*D*4 bytes of items read once. At U=256,
// N=1e6, D=65 the operations bound (~0.5 ms at 67 TFLOP/s) is six times the
// bytes bound (~78 us at 3.35 TB/s), so the scoring loop is what matters.
//
// Design:
// - Blocks run in no order, so nothing is carried across blocks. Pass 1 runs
//   a grid of (user tiles x item chunks). Each block scores its chunk for R
//   user rows and keeps, per row, the k best (score, id) pairs in shared
//   memory; it writes them to a (U, n_chunks, k) workspace. Pass 2 merges the
//   n_chunks * k candidates of each row, one row a block. With one chunk,
//   pass 1 writes the result directly and pass 2 is not launched. No atomics
//   decide any order: the result is the top k of a set under a total order,
//   so it is the same whatever order candidates arrive in.
// - Scoring: a block holds its R user rows in shared memory and streams item
//   tiles of 128 rows x 32 columns through shared memory. A thread owns 2
//   items x R/4 rows of accumulators and reads float4s, so a step of 4
//   columns costs 2 + R/4 shared loads for 8 * R/4 FMAs. Each score is one
//   f32 FMA chain over d = 0..D-1 in order (zero padding adds exact zeros),
//   so it does not depend on the tiling. Any D: columns are padded to 4.
//   Item slices are staged through registers so that the next slice's global
//   loads overlap the current slice's FMAs.
// - Selection: per row a buffer of P = pow2 >= k + 192 entries; [0, k) holds
//   the current best k sorted, [k, P) is a queue. A score enters the queue
//   only if it beats the current k-th entry, which after the first few tiles
//   drops almost every candidate. When a queue could overflow on the next
//   tile, the block bitonic-sorts each row's buffer and keeps the first k.
//   The buffer is 8*P bytes a row (32 KB at k = 2048), so the rows a block
//   holds (R = 32, 16 or 4) are chosen from k by the host.
// - The ragged edge: items at or past the chunk end or n_items are never
//   loaded (zeros) and never enqueued; user rows past U are zero and skipped.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;    // items per tile: 64 item lanes x 2
constexpr int kTileD = 32;     // columns per shared item slice
constexpr int kTileDP = 36;    // padded slice stride: float4 reads without bank conflicts
constexpr int kSentinelId = INT_MAX;
constexpr int kPass2Rows = 1;  // rows a pass-2 block merges: one, so that
                               // rows merge in parallel blocks

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sort each of the first `rows` rows of (bs, bi) best first, keep the first
// k, empty the queues. Rows past U are never filled, so `rows` is the count of
// real rows in the block. Called by every thread with the same arguments.
__device__ void merge_rows(float* bs, int* bi, int* qn, int rows, int P, int k) {
  const int half = P >> 1;
  const int log_half = __ffs(half) - 1;  // P is a power of two
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < rows * half; t += kThreads) {
        const int r = t >> log_half;
        const int i = t & (half - 1);
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        float* s = bs + r * P;
        int* id = bi + r * P;
        const bool best_first = (lo & size) == 0;
        const float sa = s[lo], sb = s[hi];
        const int ia = id[lo], ib = id[hi];
        if (better(sb, ib, sa, ia) == best_first) {
          s[lo] = sb;
          s[hi] = sa;
          id[lo] = ib;
          id[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
  const int q = P - k;
  for (int t = threadIdx.x; t < rows * q; t += kThreads) {
    const int r = t / q;
    const int p = k + (t - r * q);
    bs[r * P + p] = -INFINITY;
    bi[r * P + p] = kSentinelId;
  }
  for (int t = threadIdx.x; t < rows; t += kThreads) qn[t] = 0;
  __syncthreads();
}

constexpr int kQueued = 1;  // offer() result bits
constexpr int kFull = 2;    // the row's queue could overflow on the next tile

// Queue (s, id) in row r if it beats the row's current k-th entry. Returns
// 0, or kQueued with kFull set when the queue has fewer than kTileN free
// slots left. Callers OR the results of a tile and decide with
// __syncthreads_or, which also keeps the next tile's offers from racing the
// merge.
__device__ __forceinline__ int offer(float* bs, int* bi, int* qn, int P, int k,
                                     int r, float s, int id) {
  const float ts = bs[r * P + k - 1];
  const int ti = bi[r * P + k - 1];
  if (!better(s, id, ts, ti)) return 0;
  const int n = atomicAdd(&qn[r], 1) + 1;
  bs[r * P + k + n - 1] = s;
  bi[r * P + k + n - 1] = id;
  return n > P - k - kTileN ? kQueued | kFull : kQueued;
}

__device__ void init_rows(float* bs, int* bi, int* qn, int R, int P) {
  for (int t = threadIdx.x; t < R * P; t += kThreads) {
    bs[t] = -INFINITY;
    bi[t] = kSentinelId;
  }
  for (int t = threadIdx.x; t < R; t += kThreads) qn[t] = 0;
}

// Shared memory: users [R][d_pad] f32 | items [kTileN][kTileDP] f32 |
//                scores [R][P] f32 | ids [R][P] i32 | queue counts [R] i32
template <int TR>
__global__ void __launch_bounds__(kThreads, 2)
topk_pass1(const float* __restrict__ users, const float* __restrict__ items,
           int U, int n_items, int D, int d_pad, int k, int P, int chunk,
           int n_chunks, float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int R = 4 * TR;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);
  float* is = us + R * d_pad;
  float* bs = is + kTileN * kTileDP;
  int* bi = reinterpret_cast<int*>(bs + R * P);
  int* qn = bi + R * P;

  const int row0 = blockIdx.x * R;
  const int rows = min(R, U - row0);
  const int c = blockIdx.y;
  const int j_begin = c * chunk;
  const int j_end = min(n_items, j_begin + chunk);

  init_rows(bs, bi, qn, R, P);
  for (int t = threadIdx.x; t < R * d_pad; t += kThreads) {
    const int r = t / d_pad;
    const int d = t - r * d_pad;
    us[t] = (row0 + r < U && d < D) ? users[(size_t)(row0 + r) * D + d] : 0.f;
  }

  const int lane = threadIdx.x & 63;   // item lane: items lane and lane + 64
  const int group = threadIdx.x >> 6;  // row group: rows group*TR .. +TR
  // Item slices go global -> registers -> shared memory: the next slice's
  // loads are issued before the current slice is computed, so their latency
  // overlaps the FMAs.
  constexpr int kStage = kTileN * kTileD / kThreads;
  float stage[kStage];
  auto fetch = [&](int j0, int d0) {
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int t = threadIdx.x + m * kThreads;
      const int j = j0 + t / kTileD;
      const int d = d0 + t % kTileD;
      stage[m] = (j < j_end && d < D) ? items[(size_t)j * D + d] : 0.f;
    }
  };
  if (j_begin < j_end) fetch(j_begin, 0);
  for (int j0 = j_begin; j0 < j_end; j0 += kTileN) {
    float acc[TR][2];
#pragma unroll
    for (int q = 0; q < TR; ++q) acc[q][0] = acc[q][1] = 0.f;
    for (int d0 = 0; d0 < d_pad; d0 += kTileD) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kStage; ++m) {
        const int t = threadIdx.x + m * kThreads;
        is[(t / kTileD) * kTileDP + t % kTileD] = stage[m];
      }
      __syncthreads();
      if (d0 + kTileD < d_pad) {
        fetch(j0, d0 + kTileD);
      } else if (j0 + kTileN < j_end) {
        fetch(j0 + kTileN, 0);
      }
      const int d_len = min(kTileD, d_pad - d0);
#pragma unroll 8
      for (int dd = 0; dd < d_len; dd += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(is + lane * kTileDP + dd);
        const float4 a1 =
            *reinterpret_cast<const float4*>(is + (lane + 64) * kTileDP + dd);
#pragma unroll
        for (int q = 0; q < TR; ++q) {
          const float4 u = *reinterpret_cast<const float4*>(
              us + (group * TR + q) * d_pad + d0 + dd);
          acc[q][0] = fmaf(u.x, a0.x, acc[q][0]);
          acc[q][0] = fmaf(u.y, a0.y, acc[q][0]);
          acc[q][0] = fmaf(u.z, a0.z, acc[q][0]);
          acc[q][0] = fmaf(u.w, a0.w, acc[q][0]);
          acc[q][1] = fmaf(u.x, a1.x, acc[q][1]);
          acc[q][1] = fmaf(u.y, a1.y, acc[q][1]);
          acc[q][1] = fmaf(u.z, a1.z, acc[q][1]);
          acc[q][1] = fmaf(u.w, a1.w, acc[q][1]);
        }
      }
    }
    int flags = 0;
#pragma unroll
    for (int q = 0; q < TR; ++q) {
      const int r = group * TR + q;
      if (row0 + r >= U) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + lane + 64 * h;
        if (j < j_end) flags |= offer(bs, bi, qn, P, k, r, acc[q][h], j);
      }
    }
    if (__syncthreads_or(flags & kFull)) merge_rows(bs, bi, qn, rows, P, k);
  }
  __syncthreads();
  merge_rows(bs, bi, qn, rows, P, k);
  for (int t = threadIdx.x; t < R * k; t += kThreads) {
    const int r = t / k;
    const int p = t - r * k;
    if (row0 + r < U) {
      const size_t o = ((size_t)(row0 + r) * n_chunks + c) * k + p;
      out_s[o] = bs[r * P + p];
      out_i[o] = bi[r * P + p];
    }
  }
}

// Merge the n_chunks * k candidates of each row. Each chunk's list is sorted
// best first and the k-th entry only improves, so once a tile of a chunk
// offers nothing in any row, the rest of that chunk cannot enter either.
// Shared memory: scores [R][P] f32 | ids [R][P] i32 | queue counts [R] i32
__global__ void __launch_bounds__(kThreads)
topk_pass2(const float* __restrict__ ws_s, const int* __restrict__ ws_i, int U,
           int n_chunks, int k, int P, int R, float* __restrict__ out_s,
           int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);
  int* bi = reinterpret_cast<int*>(bs + R * P);
  int* qn = bi + R * P;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, U - row0);

  init_rows(bs, bi, qn, R, P);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    for (int p0 = 0; p0 < k; p0 += kTileN) {
      int flags = 0;
      for (int t = threadIdx.x; t < R * kTileN; t += kThreads) {
        const int r = t / kTileN;
        const int p = p0 + (t - r * kTileN);
        if (row0 + r < U && p < k) {
          const size_t o = ((size_t)(row0 + r) * n_chunks + c) * k + p;
          const int id = ws_i[o];
          if (id != kSentinelId) flags |= offer(bs, bi, qn, P, k, r, ws_s[o], id);
        }
      }
      if (__syncthreads_or(flags & kFull)) merge_rows(bs, bi, qn, rows, P, k);
      if (!__syncthreads_or(flags & kQueued)) break;
    }
  }
  merge_rows(bs, bi, qn, rows, P, k);
  for (int t = threadIdx.x; t < R * k; t += kThreads) {
    const int r = t / k;
    const int p = t - r * k;
    if (row0 + r < U) {
      out_s[(size_t)(row0 + r) * k + p] = bs[r * P + p];
      out_i[(size_t)(row0 + r) * k + p] = bi[r * P + p];
    }
  }
}

template <int TR>
cudaError_t launch_pass1(dim3 grid, size_t smem, cudaStream_t stream,
                         const float* users, const float* items, int U,
                         int n_items, int D, int d_pad, int k, int P, int chunk,
                         int n_chunks, float* out_s, int* out_i) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_pass1<TR><<<grid, kThreads, smem, stream>>>(
      users, items, U, n_items, D, d_pad, k, P, chunk, n_chunks, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the top-k of users (U, D) x items (n_items, D), both row-major f32 on
// the device. rows (R: 4, 16 or 32), P, chunk and n_chunks come from the
// host's plan. With n_chunks == 1, ws_s/ws_i are unused and may be null.
// Returns the cudaError_t of the launches (0 on success); never synchronises.
int streaming_topk(const float* users, const float* items, int U, int n_items,
                   int D, int k, int rows, int P, int chunk, int n_chunks,
                   float* ws_s, int* ws_i, float* out_s, int* out_i,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (U < 1 || n_items < 1 || D < 1 || k < 1 || k > n_items || P < k + kTileN ||
      (P & (P - 1)) != 0 || chunk < 1 || n_chunks < 1 ||
      (long long)chunk * n_chunks < n_items)
    return (int)cudaErrorInvalidValue;
  const int d_pad = (D + 3) / 4 * 4;
  const size_t smem1 = ((size_t)rows * d_pad + (size_t)kTileN * kTileDP) * 4 +
                       (size_t)rows * P * 8 + (size_t)rows * 4;
  const bool direct = n_chunks == 1;
  float* s1 = direct ? out_s : ws_s;
  int* i1 = direct ? out_i : ws_i;
  const dim3 grid1((U + rows - 1) / rows, n_chunks);
  cudaError_t err;
  switch (rows) {
    case 4:
      err = launch_pass1<1>(grid1, smem1, stream, users, items, U, n_items, D,
                            d_pad, k, P, chunk, n_chunks, s1, i1);
      break;
    case 16:
      err = launch_pass1<4>(grid1, smem1, stream, users, items, U, n_items, D,
                            d_pad, k, P, chunk, n_chunks, s1, i1);
      break;
    case 32:
      err = launch_pass1<8>(grid1, smem1, stream, users, items, U, n_items, D,
                            d_pad, k, P, chunk, n_chunks, s1, i1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || direct) return (int)err;
  const size_t smem2 = (size_t)kPass2Rows * P * 8 + (size_t)kPass2Rows * 4;
  err = cudaFuncSetAttribute(topk_pass2,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  topk_pass2<<<(U + kPass2Rows - 1) / kPass2Rows, kThreads, smem2, stream>>>(
      ws_s, ws_i, U, n_chunks, k, P, kPass2Rows, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
