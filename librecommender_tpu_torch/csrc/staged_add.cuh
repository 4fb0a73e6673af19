// Deterministic ordered add of many rows into a tile of a table, for sm_90a:
// the body that `segsum_kernel` (table_gather.cu) and `scatter_rows_kernel`
// (row_scatter.cu) share. Both compute
// out = zeros(n_rows, D).at[ids].add(rows) for (N,) ids and (N, D) f32 rows;
// ids outside [0, n_rows) are dropped, rows that no id touches come out zero.
//
// Blocks run in parallel and in no order, and float atomics would change the
// bits from run to run, so a block owns 16 * groups output rows x `cols`
// columns of one segment of the ids and adds each row's hits in ascending n:
// the order of `torch.zeros(n_rows, D).index_add_(0, ids, rows)` on the CPU,
// bit for bit. A call of few ids (at most PART_MIN_IDS a segment, tiles of
// at most 64 rows: ops/table_gather.uses_partition) takes the scan form of
// scan_add.cuh, one kernel in which every block scans its segment's ids.
// Any other call is three kernels on one stream (two where the ids are one
// chunk, one more with segments):
// - Partition. A bucket is one block's tile of one segment, `segment *
//   row_tiles + row_tile`. The ids are cut into chunks of `chunk` (a
//   multiple of 512); `partition_count` counts each chunk's valid ids per
//   bucket (one atomic per warp's equal buckets, `__match_any_sync`);
//   `partition_place` gives each chunk its start in each bucket (an
//   exclusive scan of the count matrix in bucket-major order, done by every
//   chunk block itself; a single chunk counts its own ids and needs no count
//   kernel), then ranks each valid id within its bucket in ascending n: each
//   warp walks a sixteenth of the chunk 32 ids at a time, warps in order,
//   lanes in order, a running count per bucket and warp. The chunk's ids are
//   gathered in bucket order in shared memory first, so each bucket's run
//   goes out in one coalesced piece. The result is `pos`, the positions
//   sorted by (bucket, n), `sub`, each one's row within its tile, and
//   `bstart`, each bucket's start. So a block reads only its own hits,
//   already in order, and no block scans ids.
// - Add. Warp w owns rows w, w + 16, ... of the tile, lane l columns l,
//   l + 32, ... . The block streams its hits' source rows, 32 a chunk, into a
//   ring of kStages chunks in shared memory with cp.async (16-byte copies, or
//   4-byte ones where a row is only 4-byte aligned: D = 65 or 33), kStages -
//   1 chunks of loads in flight while it adds one; the chunks' positions come
//   kStages - 1 chunks ahead of their rows through a ring of their own. Each
//   warp adds the chunk's hits of its rows from shared memory in ascending n
//   (bf16 rounding of the values happens there), keeping its row's sums in
//   registers: four hits at a time, or, where a warp has kDense or more of
//   the chunk's 32 (a sequence model's pad id, a popular item), every staged
//   row in order with the others' values replaced by +0.0f. With groups > 1
//   (a table of many more rows than ids) a warp owns `groups` rows; the sums
//   of those it is not adding wait in shared memory.
// - Segments. A table of few tiles (a 16-row vocabulary looked up 32,768 times
//   a step) would leave the card to one block. The host then cuts the ids
//   into fixed contiguous segments (blockIdx.z), each block writes its tile
//   of its segment's partial table, and `sum_partials_kernel` adds the partial
//   tables in segment order. The cut depends on the shapes only, so the
//   result repeats bit for bit, and equals per-segment index_add_ on the CPU
//   summed in segment order. With one segment the blocks write the result.
//
// A host build of the bodies (a CPU emulation that runs one thread per CUDA
// thread) defines STAGED_EMULATION and supplies the device intrinsics.
#pragma once
#ifndef STAGED_EMULATION
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

namespace staged {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;   // the rows of a 16-row tile, one a warp
constexpr int kChunk = 32;              // hits staged at once
constexpr int kStages = 6;              // chunks of rows in the ring
constexpr int kEntries = 2 * kStages;   // chunks of positions in their ring
constexpr int kMaxCols = 128;           // columns a block owns
constexpr int kDense = 8;               // a warp's hits in a chunk that take every row
constexpr int kBatch = 4;               // staged rows a warp reads at once
constexpr int kMaxGroups = 16;          // 16-row groups a tile holds
constexpr int kMaxIds = 0x3fffffff - 8192;
constexpr int kMaxChunkIds = 12288;     // ids of a partition chunk
constexpr int kDynSmem = 226 * 1024;    // dynamic shared memory a kernel may ask
constexpr unsigned kFull = 0xffffffffu;

#ifndef STAGED_EMULATION
__device__ __forceinline__ void cp_async16(void* to, const void* from) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(from)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* to, const void* from) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(from)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest kPending has landed (for this thread's copies)
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
#endif

// The bucket of the id at position n, or -1 for an id outside [0, n_rows);
// `row` gets its row within the tile.
// tile_rows is a power of two.
template <typename Id>
__device__ __forceinline__ int bucket_of(const Id* __restrict__ ids, int n,
                                         long long n_rows, int tile_rows,
                                         int row_tiles, int seg_len, int* row) {
  const long long id = static_cast<long long>(ids[n]);
  if (id < 0 || id >= n_rows) return -1;
  *row = static_cast<int>(id & (tile_rows - 1));
  return static_cast<int>((n / seg_len) * static_cast<long long>(row_tiles) +
                          (id >> (__ffs(tile_rows) - 1)));
}

// The exclusive prefix of v over the block's threads in thread order, and
// (in *total) the sum of all; `warp_sums` is kWarps ints of shared memory.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int below = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int x = warp_sums[w];
    if (w < warp) below += x;
    all += x;
  }
  __syncthreads();   // warp_sums is free for the next scan
  *total = all;
  return below + incl - v;
}

// counts[c * nb + b]: the valid ids of chunk c = blockIdx.x (positions
// [c * chunk, (c + 1) * chunk)) in bucket b. `hist` is nb ints of shared
// memory, or the block's own row of counts when they do not fit.
template <typename Id>
__device__ __forceinline__ void count_body(const Id* __restrict__ ids, int N,
                                           long long n_rows, int tile_rows,
                                           int row_tiles, int seg_len, int nb,
                                           int chunk, int* __restrict__ counts,
                                           int* hist) {
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  int* const row = counts + static_cast<long long>(c) * nb;
  for (int b = threadIdx.x; b < nb; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lo = c * chunk;
  const int hi = N - lo < chunk ? N : lo + chunk;
#pragma unroll 4
  for (int n0 = lo + (threadIdx.x & ~31); n0 < hi; n0 += kThreads) {
    const int n = n0 + lane;
    int r = 0;
    const int b = n < hi ? bucket_of(ids, n, n_rows, tile_rows, row_tiles,
                                     seg_len, &r)
                         : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[b], __popc(peers));
  }
  if (hist != row) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += kThreads) row[b] = hist[b];
  }
}

// Places the valid ids of chunk c = blockIdx.x: pos[p] = n and sub[p] = the
// id's row within its tile, p = start(b, c) + the ids of bucket b before n in
// the chunk, where start(b, c) counts the valid ids of every bucket before b
// and those of bucket b in chunks before c (from `counts`; with one chunk,
// from the block's own counts, and no count kernel runs). Block 0 also
// writes bstart[b] = start(b, 0) and bstart[nb] = the valid ids in all.
// `cache` (shared memory) holds the chunk's buckets (chunk ints), their rows
// (chunk bytes), then the chunk's positions and buckets in bucket order (2 x
// chunk ints), so that each bucket's run is written in one coalesced piece;
// `state` 2 x nb ints (starts, the chunk's own starts) then kWarps x nb
// 16-bit counts, in shared memory or, where they do not fit, in the block's
// own part of the workspace.
template <typename Id>
__device__ __forceinline__ void place_body(
    const Id* __restrict__ ids, int N, long long n_rows, int tile_rows,
    int row_tiles, int seg_len, int nb, int chunk, int n_chunks,
    const int* __restrict__ counts, int* __restrict__ bstart,
    int* __restrict__ pos, int* __restrict__ sub, unsigned char* cache,
    unsigned char* state) {
  __shared__ int warp_sums[kWarps];
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* const starts = reinterpret_cast<int*>(state);
  int* const local = starts + nb;
  unsigned short* const wcnt = reinterpret_cast<unsigned short*>(local + nb);
  int* const bk = reinterpret_cast<int*>(cache);
  unsigned char* const rw = cache + 4 * static_cast<long long>(chunk);
  int* const sorted_n = reinterpret_cast<int*>(rw + chunk);
  int* const sorted_b = sorted_n + chunk;
  const int lo = c * chunk;
  const int hi = N - lo < chunk ? N : lo + chunk;

  // 0. the chunk's buckets and rows, eight loads in flight a thread
#pragma unroll 8
  for (int i = threadIdx.x; i < hi - lo; i += kThreads) {
    int r = 0;
    bk[i] = bucket_of(ids, lo + i, n_rows, tile_rows, row_tiles, seg_len, &r);
    rw[i] = static_cast<unsigned char>(r);
  }

  // 1. each warp's count per bucket in its sixteenth of the chunk (two
  // 16-bit counts a word)
  unsigned* const words = reinterpret_cast<unsigned*>(wcnt);
  for (int i = threadIdx.x; i < kWarps / 2 * nb; i += kThreads) words[i] = 0;
  __syncthreads();
  const int part = chunk / kWarps;
  const int wlo = lo + warp * part;
  const int whi = hi - wlo < part ? hi : wlo + part;
  for (int n = wlo + lane; n < whi; n += 32) {
    const int b = bk[n - lo];
    if (b >= 0) {
      const long long i = static_cast<long long>(warp) * nb + b;
      atomicAdd(&words[i >> 1], 1u << (16 * (i & 1)));
    }
  }
  __syncthreads();

  // 2. starts, 512 buckets a round: each thread sums its bucket's counts over
  // the chunks, a block scan orders the buckets
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    int tot = 0, before = 0;
    if (b < nb && n_chunks == 1) {
      for (int w = 0; w < kWarps; ++w) tot += wcnt[static_cast<long long>(w) * nb + b];
    } else if (b < nb) {
#pragma unroll 8
      for (int k = 0; k < n_chunks; ++k) {
        const int v = counts[static_cast<long long>(k) * nb + b];
        tot += v;
        if (k < c) before += v;
      }
    }
    int total = 0;
    const int excl = carry + block_scan(tot, warp_sums, &total);
    if (b < nb) {
      starts[b] = excl + before;
      if (c == 0) bstart[b] = excl;
    }
    carry += total;
  }
  if (c == 0 && threadIdx.x == 0) bstart[nb] = carry;

  // 3. per bucket, the counts of the warps before each warp, and where the
  // bucket's run starts in the chunk's own bucket order
  int in_chunk = 0;
  for (int b0 = 0; b0 < nb; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    int run = 0;
    if (b < nb)
      for (int w = 0; w < kWarps; ++w) {
        const int k = wcnt[static_cast<long long>(w) * nb + b];
        wcnt[static_cast<long long>(w) * nb + b] = static_cast<unsigned short>(run);
        run += k;
      }
    int total = 0;
    const int excl = in_chunk + block_scan(run, warp_sums, &total);
    if (b < nb) local[b] = excl;
    in_chunk += total;
  }
  __syncthreads();

  // 4. the chunk again, each warp its sixteenth 32 ids at a time: lanes of
  // one bucket ranked by __match_any_sync, a running count per bucket
  unsigned short* const mine = wcnt + static_cast<long long>(warp) * nb;
  for (int n0 = wlo; n0 < whi; n0 += 32) {
    const int n = n0 + lane;
    const int b = n < whi ? bk[n - lo] : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (b >= 0 && lane == leader) {
      base = local[b] + mine[b];
      mine[b] = static_cast<unsigned short>(mine[b] + __popc(peers));
    }
    base = __shfl_sync(kFull, base, leader);
    if (b >= 0) {
      const int e = base + __popc(peers & ((1u << lane) - 1u));
      sorted_n[e] = n;
      sorted_b[e] = b;
    }
    __syncwarp();
  }
  __syncthreads();

  // 5. the chunk in bucket order: each bucket's run to its place at once
  for (int e = threadIdx.x; e < in_chunk; e += kThreads) {
    const int n = sorted_n[e];
    const int b = sorted_b[e];
    const int p = starts[b] + e - local[b];
    pos[p] = n;
    sub[p] = rw[n - lo];
  }
}

// The add: the block's tile (rows blockIdx.x * 16 * groups.., columns
// blockIdx.y * cols..) of segment blockIdx.z, from its bucket's hits
// pos[bstart[b]..bstart[b + 1]), written to dst + z * n_rows * D. kSlots:
// the columns a lane owns, so a block owns at most 32 * kSlots; kBf16: round
// every value to bf16 first; kGroups: groups > 1, else 1; kVec: floats a copy
// moves (4, or 1 where rows are not 16-byte aligned). `smem`: the ring of
// kStages x kChunk x cols floats, with kGroups the tile's sums (16 * groups x
// cols floats), then kEntries x kChunk positions and as many rows within the
// tile (int32). A chunk's positions arrive kStages - 1 chunks before its rows
// are asked for, its rows kStages - 1 chunks before they are added, so no
// step waits for a load started in the step before.
template <int kSlots, bool kBf16, bool kGroups, int kVec>
__device__ __forceinline__ void add_body(
    const float* __restrict__ rows, const int* __restrict__ pos,
    const int* __restrict__ sub, const int* __restrict__ bstart, int D,
    long long n_rows, int cols, int groups, int row_tiles,
    float* __restrict__ dst, unsigned char* smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int owned = kGroups ? kWarps * groups : kWarps;   // at most 256
  const long long r0 = static_cast<long long>(blockIdx.x) * owned;
  const int lim = n_rows - r0 < owned ? static_cast<int>(n_rows - r0) : owned;
  const int c0 = blockIdx.y * cols;
  const int nc = D - c0 < cols ? D - c0 : cols;    // real columns owned
  const long long b = static_cast<long long>(blockIdx.z) * row_tiles + blockIdx.x;
  const int lo = bstart[b];
  const int hits = bstart[b + 1] - lo;
  const int n_chunks = (hits + kChunk - 1) / kChunk;
  const int pieces = (nc + kVec - 1) / kVec;       // copies a row takes
  float* const ring = reinterpret_cast<float*>(smem);
  float* const sums = ring + kStages * kChunk * cols;
  int* const epos = reinterpret_cast<int*>(sums + (kGroups ? owned * cols : 0));
  int* const esub = epos + kEntries * kChunk;

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.0f;
  int cur = 0;   // kGroups: acc holds row warp + 16 * cur
  if (kGroups)   // only this thread reads or writes these
    for (int g = 0; g < groups; ++g)
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = lane + 32 * s;
        if (c < cols) sums[(warp + kWarps * g) * cols + c] = 0.0f;
      }

  // chunk j's positions and rows within the tile, by warp 0
  auto fetch = [&](int j) {
    const int i = j * kChunk + lane;
    if (warp == 0 && i < hits) {
      const int e = (j % kEntries) * kChunk + lane;
      cp_async4(epos + e, pos + lo + i);
      cp_async4(esub + e, sub + lo + i);
    }
  };
  // chunk j's source rows, whose positions have landed: warp w copies rows
  // w and w + 16
  auto copy_rows = [&](int j) {
    float* const to = ring + (j % kStages) * kChunk * cols;
    const int* const e = epos + (j % kEntries) * kChunk;
    for (int x = lane; x < 2 * pieces; x += 32) {
      const int t = x >= pieces ? 1 : 0;
      const int p = (x - t * pieces) * kVec;
      const int h = warp + kWarps * t;
      if (j * kChunk + h < hits) {
        const float* from = rows + static_cast<long long>(e[h]) * D + c0 + p;
        float* into = to + h * cols + p;
        if (kVec == 4)
          cp_async16(into, from);
        else
          cp_async4(into, from);
      }
    }
  };

  // the first kStages - 1 chunks' positions now, the next kStages - 1 with
  // the first rows
  for (int i = threadIdx.x; i < (kStages - 1) * kChunk && i < hits; i += kThreads) {
    epos[i] = pos[lo + i];
    esub[i] = sub[lo + i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_chunks) copy_rows(j);
    fetch(j + kStages - 1);
    cp_async_commit();
  }

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kStages - 2>();   // chunk i's rows and chunk i + kStages - 1's
    __syncthreads();                // positions have landed; chunk i - 1 is added
    if (i + kStages - 1 < n_chunks) copy_rows(i + kStages - 1);
    fetch(i + 2 * kStages - 2);
    cp_async_commit();

    // the chunk's hits of this warp's rows, in ascending n
    const int k = hits - i * kChunk < kChunk ? hits - i * kChunk : kChunk;
    const int r = lane < k ? esub[(i % kEntries) * kChunk + lane] : 0;
    const bool hit = lane < k && (r & (kWarps - 1)) == warp;
    unsigned m = __ballot_sync(kFull, hit);
    const float* const from = ring + (i % kStages) * kChunk * cols;
    if (__popc(m) >= kDense) {
      // many hits of one row (a hot row): every staged row in order, each
      // added or, where not this row's, +0.0f, which leaves a sum exactly as
      // it was (a sum from +0.0f is never -0.0f), so no step waits on the
      // next hit's index
      const int g = __shfl_sync(kFull, r, __ffs(m) - 1) / kWarps;
      if (!kGroups || __ballot_sync(kFull, hit && r / kWarps != g) == 0) {
        if (kGroups && g != cur) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int c = lane + 32 * s;
            if (c < cols) {
              sums[(warp + kWarps * cur) * cols + c] = acc[s];
              acc[s] = sums[(warp + kWarps * g) * cols + c];
            }
          }
          cur = g;
        }
#pragma unroll
        for (int h = 0; h < kChunk; ++h) {
          const bool take = (m >> h) & 1u;
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int c = lane + 32 * s;
            float x = c < nc ? from[h * cols + c] : 0.0f;
            if (kBf16) x = round_bf16(x);
            acc[s] += take ? x : 0.0f;
          }
        }
        m = 0;
      }
    }
    while (m) {   // m is the same in every lane
      int h[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        h[u] = m ? __ffs(m) - 1 : -1;
        m &= m - 1;
      }
      float v[kBatch][kSlots];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = lane + 32 * s;
          float x = (h[u] >= 0 && c < nc) ? from[h[u] * cols + c] : 0.0f;
          if (kBf16) x = round_bf16(x);
          v[u][s] = x;
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (h[u] >= 0) {
          if (kGroups) {
            const int g = __shfl_sync(kFull, r, h[u]) / kWarps;
            if (g != cur) {   // the same in every lane
#pragma unroll
              for (int s = 0; s < kSlots; ++s) {
                const int c = lane + 32 * s;
                if (c < cols) {
                  sums[(warp + kWarps * cur) * cols + c] = acc[s];
                  acc[s] = sums[(warp + kWarps * g) * cols + c];
                }
              }
              cur = g;
            }
          }
#pragma unroll
          for (int s = 0; s < kSlots; ++s) acc[s] += v[u][s];
        }
    }
  }

  // this warp's rows, zeros included
  float* const tile = dst + (static_cast<long long>(blockIdx.z) * n_rows + r0) * D + c0;
  if (kGroups) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      if (c < cols) sums[(warp + kWarps * cur) * cols + c] = acc[s];
    }
    for (int row = warp; row < lim; row += kWarps)
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = lane + 32 * s;
        if (c < nc) tile[static_cast<long long>(row) * D + c] = sums[row * cols + c];
      }
  } else if (warp < lim) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      if (c < nc) tile[static_cast<long long>(warp) * D + c] = acc[s];
    }
  }
}

// What the two launchers share: the checked geometry and workspace of a call.
struct Launch {
  dim3 grid;          // the add: row tiles x column tiles x segments
  size_t smem;        // the add's dynamic shared memory
  int segs, row_tiles, tile_rows, nb, n_chunks;
  size_t count_smem, place_smem;   // without the bucket state where it lives in `spill`
  float* dst;         // where the tiles go: the partial tables, or out
  int* counts;        // n_chunks x nb
  int* bstart;        // nb + 1
  int* pos;           // N
  int* sub;           // N
  unsigned char* spill;   // n_chunks x 40 nb bytes, or null
};

// Whether a chunk block's bucket state fits its shared memory beside the
// chunk's cache; where not, it lives in the workspace.
inline bool state_on_chip(long long nb, int chunk) {
  return 13LL * chunk + 40 * nb <= kDynSmem;
}
inline size_t workspace_bytes(int N, long long nb, int chunk, int n_chunks) {
  return 4 * (static_cast<size_t>(n_chunks) * nb + nb + 1 + 2 * static_cast<size_t>(N)) +
         (state_on_chip(nb, chunk) ? 0 : 40 * static_cast<size_t>(nb) * n_chunks);
}

// Fills `launch`; returns cudaSuccess, or cudaErrorInvalidValue for shapes
// the kernels do not take or a workspace too small. `work` holds
// `work_bytes`, which must be at least workspace_bytes(...), and `partial`
// segs * n_rows * D floats when the ids are cut into more than one segment
// (seg_len < N). groups > 1 asks for tiles of 16 * groups rows.
inline cudaError_t plan(int N, int D, long long n_rows, int cols, int seg_len,
                        int groups, int chunk, void* work, size_t work_bytes,
                        float* partial, float* out, Launch* l) {
  if (n_rows < 1 || N < 0 || N > kMaxIds || D < 1 || cols < 1 ||
      cols > kMaxCols || seg_len < 1 || groups < 1 || groups > kMaxGroups ||
      (groups & (groups - 1)) != 0 ||
      chunk < 512 || chunk % 512 != 0 || chunk > kMaxChunkIds)
    return cudaErrorInvalidValue;
  const long long tile_rows = static_cast<long long>(kWarps) * groups;
  const long long row_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const long long col_tiles = (static_cast<long long>(D) + cols - 1) / cols;
  const long long segs = N > 0 ? (static_cast<long long>(N) + seg_len - 1) / seg_len : 1;
  const long long nb = segs * row_tiles;
  const long long n_chunks = N > 0 ? (static_cast<long long>(N) + chunk - 1) / chunk : 1;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535 || segs > 65535 ||
      nb > 0x7ffffffeLL || (segs > 1 && partial == nullptr) ||
      (N > 0 && (work == nullptr ||
                 work_bytes < workspace_bytes(N, nb, chunk,
                                              static_cast<int>(n_chunks)))))
    return cudaErrorInvalidValue;
  l->grid = dim3(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles),
                 static_cast<unsigned>(segs));
  l->smem = sizeof(float) * ((static_cast<size_t>(kStages) * kChunk +
                              (groups > 1 ? tile_rows : 0)) * cols +
                             2 * kEntries * kChunk);
  if (l->smem > kDynSmem) return cudaErrorInvalidValue;
  l->segs = static_cast<int>(segs);
  l->row_tiles = static_cast<int>(row_tiles);
  l->tile_rows = static_cast<int>(tile_rows);
  l->nb = static_cast<int>(nb);
  l->n_chunks = static_cast<int>(n_chunks);
  l->dst = segs > 1 ? partial : out;
  const bool on_chip = state_on_chip(nb, chunk);
  l->place_smem = 13 * static_cast<size_t>(chunk) + (on_chip ? 40 * static_cast<size_t>(nb) : 0);
  l->count_smem = on_chip ? 4 * static_cast<size_t>(nb) : 0;
  unsigned char* w = static_cast<unsigned char*>(work);
  l->counts = reinterpret_cast<int*>(w);
  l->bstart = l->counts + n_chunks * nb;
  l->pos = l->bstart + nb + 1;
  l->sub = l->pos + N;
  l->spill = on_chip ? nullptr : reinterpret_cast<unsigned char*>(l->sub + N);
  return cudaSuccess;
}

// out[i] = partial[0][i] + partial[1][i] + ... in segment order, one thread
// an element
#ifndef STAGED_EMULATION
static __global__ void sum_partials_kernel(const float* __restrict__ partial,
                                           int segs, long long n,
                                           float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = partial[i];
  for (int s = 1; s < segs; ++s) acc += partial[s * n + i];
  out[i] = acc;
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    partition_count(const Id* __restrict__ ids, int N, long long n_rows,
                    int tile_rows, int row_tiles, int seg_len, int nb, int chunk,
                    int* __restrict__ counts, int on_chip) {
  extern __shared__ __align__(16) unsigned char part_smem[];
  int* hist = on_chip ? reinterpret_cast<int*>(part_smem)
                      : counts + static_cast<long long>(blockIdx.x) * nb;
  count_body(ids, N, n_rows, tile_rows, row_tiles, seg_len, nb, chunk, counts,
             hist);
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    partition_place(const Id* __restrict__ ids, int N, long long n_rows,
                    int tile_rows, int row_tiles, int seg_len, int nb, int chunk,
                    int n_chunks, const int* __restrict__ counts,
                    int* __restrict__ bstart, int* __restrict__ pos,
                    int* __restrict__ sub, unsigned char* spill) {
  extern __shared__ __align__(16) unsigned char part_smem[];
  unsigned char* state = spill ? spill + 40 * static_cast<long long>(nb) * blockIdx.x
                               : part_smem + 13 * static_cast<long long>(chunk);
  place_body(ids, N, n_rows, tile_rows, row_tiles, seg_len, nb, chunk, n_chunks,
             counts, bstart, pos, sub, part_smem, state);
}

// cudaFuncSetAttribute(kDynSmem) for a kernel, once a device (`ready` is the
// caller's own flags, one a device).
inline cudaError_t allow_smem(const void* kernel, bool* ready) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDynSmem);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

// The partition of a call's ids (two launches, one for a single chunk):
// l.pos, l.sub, l.bstart.
// Static, so that each library that includes this header keeps flags of its
// own for its own kernels.
template <typename Id>
static cudaError_t partition(const Launch& l, const void* ids_ptr, int N,
                      long long n_rows, int seg_len, int chunk,
                      cudaStream_t stream) {
  static bool count_ready[64], place_ready[64];
  cudaError_t err = allow_smem((const void*)partition_count<Id>, count_ready);
  if (err == cudaSuccess)
    err = allow_smem((const void*)partition_place<Id>, place_ready);
  if (err != cudaSuccess) return err;
  const Id* ids = static_cast<const Id*>(ids_ptr);
  if (l.n_chunks > 1)   // one chunk counts its own
    partition_count<Id><<<l.n_chunks, kThreads, l.count_smem, stream>>>(
        ids, N, n_rows, l.tile_rows, l.row_tiles, seg_len, l.nb, chunk,
        l.counts, l.count_smem > 0);
  partition_place<Id><<<l.n_chunks, kThreads, l.place_smem, stream>>>(
      ids, N, n_rows, l.tile_rows, l.row_tiles, seg_len, l.nb, chunk,
      l.n_chunks, l.counts, l.bstart, l.pos, l.sub, l.spill);
  return cudaGetLastError();
}

// Launches `kernel` (an add of this header's kind) over l.grid, after its
// shared-memory attribute, once a device (`ready`: the kernel's own flags).
template <typename... Params, typename... Args>
cudaError_t launch_add(void (*kernel)(Params...), bool* ready, const Launch& l,
                       cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem((const void*)kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<l.grid, kThreads, l.smem, stream>>>(args...);
  return cudaGetLastError();
}

// After the tiles: the partial tables added in segment order, if there are any.
inline cudaError_t finish(const Launch& l, long long n_rows, int D, float* out,
                          cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || l.segs == 1) return err;
  const long long n = n_rows * D;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      l.dst, l.segs, n, out);
  return cudaGetLastError();
}

// A whole call: out (n_rows, D) = zeros, then rows (N, D) added at ids (N,)
// in ascending n within each segment of seg_len ids, the segments' tables
// added in order. ids are int32, or int64 when ids_int64 is set; vec is 4
// (rows 16-byte aligned, D a multiple of 4) or 1; `work` holds `work_bytes`
// bytes, and a call whose workspace_bytes(...) exceed them launches
// nothing. `add(l, stream, rows, D,
// n_rows, cols, groups, vec)` launches the caller's add kernel. Returns the
// cudaError_t of the launches (0 on success); never synchronises.
template <typename AddFn>
int ordered_add(const void* ids, int ids_int64, const float* rows, int N, int D,
                long long n_rows, int cols, int seg_len, int groups, int chunk,
                int vec, void* work, long long work_bytes, float* partial,
                float* out, void* stream_ptr, AddFn add) {
  Launch l;
  cudaError_t err = plan(N, D, n_rows, cols, seg_len, groups, chunk, work,
                         work_bytes < 0 ? 0 : static_cast<size_t>(work_bytes),
                         partial, out, &l);
  if (err == cudaSuccess && !(vec == 1 || (vec == 4 && D % 4 == 0 &&
                                           reinterpret_cast<size_t>(rows) % 16 == 0)))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(float) * n_rows * D, stream));
  err = ids_int64 ? partition<long long>(l, ids, N, n_rows, seg_len, chunk, stream)
                  : partition<int>(l, ids, N, n_rows, seg_len, chunk, stream);
  if (err == cudaSuccess) err = add(l, stream, rows, D, n_rows, cols, groups, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(l, n_rows, D, out, stream));
}
#endif

}  // namespace staged
