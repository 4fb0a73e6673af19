// The scan form of the ordered add of staged_add.cuh, for sm_90a: the same
// function in the same order of additions, for calls whose ids are few (at
// most PART_MIN_IDS a segment, in tiles of at most 64 rows), where the
// partition's two kernels would cost more than they save.
// - Scan. A block takes its ids a span at a time (the whole segment at
//   first). Each of its 16 warps reads a contiguous sixteenth of the span,
//   eight coalesced loads in flight, and writes the ids that fall in the
//   block's rows to a list of its own in ascending n (a ballot gives each hit
//   its place). If a list overflows (a tile of popular rows), the block
//   halves the span and scans it again; at 2048 ids a span no list can
//   overflow.
// - Add. The lists are walked in order, 32 hits a chunk. All 16 warps load
//   the chunk's source rows into shared memory, two rows a warp, whoever owns
//   them. The loads of chunk i + 1 are in flight, in registers, while chunk i
//   is added from the other of two buffers. Then each warp adds the chunk's
//   hits of its row from shared memory, four at a time, in order.
// - Sparse tiles (groups > 1): a block owns 16 * groups rows, warp w the rows
//   w, w + 16, ...; after the scan each warp walks the lists once to see
//   which of its rows have hits, then once per such row, adding that row's
//   hits straight from device memory in ascending n (four loads in flight).
// Every block scans all ids of its segment: ceil(n_rows / 16) * ceil(D /
// cols) * N compares in all, which is why larger calls take the partition.
#pragma once
#include "staged_add.cuh"

namespace staged {

constexpr int kListCap = 128;           // hits one warp's list holds
constexpr int kMinSpan = kWarps * kListCap;  // no list overflows at this span
constexpr int kUnroll = 8;              // id loads a lane keeps in flight
constexpr int kPerWarp = kChunk / kWarps;    // rows a warp stages a chunk

__device__ __forceinline__ int round_up_512(int x) { return (x + 511) & ~511; }

// The block's tile (rows blockIdx.x * 16 * groups.., columns blockIdx.y *
// cols..) of segment blockIdx.z of the ids, ids [z * seg_len, min(N, (z + 1) *
// seg_len)), written to dst + z * n_rows * D. kSlots: the columns a lane
// owns, so a block owns at most 32 * kSlots; kBf16: round every value to
// bf16 first; kSparse: the sparse-tile form, else groups is 1.
template <typename Id, int kSlots, bool kBf16, bool kSparse>
__device__ __forceinline__ void scan_add_tile(const Id* __restrict__ ids,
                                         const float* __restrict__ rows, int N,
                                         int D, long long n_rows, int cols,
                                         int seg_len, int groups,
                                         float* __restrict__ dst) {
  extern __shared__ float stage[];                 // [2][kChunk][cols]
  __shared__ int hit_n[kWarps][kListCap];          // source row of a hit
  __shared__ unsigned char hit_r[kWarps][kListCap];  // its local output row
  __shared__ int hit_cnt[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int owned = kSparse ? kWarps * groups : kWarps;   // at most 256
  const long long r0 = (long long)blockIdx.x * owned;
  const long long lim = n_rows - r0 < owned ? n_rows - r0 : owned;
  const int c0 = blockIdx.y * cols;
  const int nc = D - c0 < cols ? D - c0 : cols;    // real columns owned
  const long long lo = (long long)blockIdx.z * seg_len;
  const int end = lo + seg_len < N ? (int)(lo + seg_len) : N;

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.0f;

  int base = lo < N ? (int)lo : N;
  int span = round_up_512(end - base);
  float* const tile = dst + ((long long)blockIdx.z * n_rows + r0) * D + c0;
  bool first_span = true;   // kSparse: no row of the tile is written yet
  while (base < end) {
    // 1. scan: this warp's sixteenth of the span, hits in ascending n
    const int sub = span / kWarps;                 // a multiple of 32
    const int first = base + warp * sub + lane;
    int cnt = 0;
    for (int q0 = 0; q0 < sub; q0 += 32 * kUnroll) {
      Id v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * 32;
        const int n = first + q;
        v[u] = (q < sub && n < end) ? ids[n] : static_cast<Id>(-1);  // no hit
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long local = (long long)v[u] - r0;
        const bool hit = local >= 0 && local < lim;
        const unsigned mask = __ballot_sync(kFull, hit);
        if (hit) {
          const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
          if (pos < kListCap) {
            hit_n[warp][pos] = first + q0 + u * 32;
            hit_r[warp][pos] = (unsigned char)local;
          }
        }
        cnt += __popc(mask);
      }
    }
    if (lane == 0) hit_cnt[warp] = cnt;
    if (__syncthreads_or(cnt > kListCap)) {
      // a list overflowed: the same ids again, half as many
      const int half = round_up_512(span / 2);
      span = half > kMinSpan ? half : kMinSpan;
      continue;
    }

    if (kSparse) {
      // 2. add, sparse tiles. First one walk of the lists for the rows of
      // this warp that have a hit in this span (bit g: row warp + 16 g) ...
      unsigned present = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int n_hits = hit_cnt[w];
        for (int j = lane; j < n_hits; j += 32) {
          const int r = hit_r[w][j];
          if ((r & (kWarps - 1)) == warp) present |= 1u << (r / kWarps);
        }
      }
      present = __reduce_or_sync(kFull, present);
      // ... then once per such row, the lists in order, the row's hits
      // straight from device memory, four loads in flight
      for (int mine = warp; mine < lim; mine += kWarps) {
        const bool has = (present >> (mine / kWarps)) & 1u;
        if (!has && !first_span) continue;   // written before, no new hit
        float* to = tile + (long long)mine * D;
        if (!first_span) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int c = lane + 32 * s;
            acc[s] = c < nc ? to[c] : 0.0f;
          }
        }
        for (int w = 0; has && w < kWarps; ++w) {
          const int n_hits = hit_cnt[w];
          for (int j0 = 0; j0 < n_hits; j0 += 32) {
            const int r = j0 + lane < n_hits ? hit_r[w][j0 + lane] : -1;
            unsigned m = __ballot_sync(kFull, r == mine);
            while (m) {  // m is the same in every lane
              int j[kBatch];
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                j[u] = m ? j0 + __ffs(m) - 1 : -1;
                m &= m - 1;
              }
              float v[kBatch][kSlots];
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                const float* src =
                    j[u] >= 0 ? rows + (long long)hit_n[w][j[u]] * D + c0
                              : nullptr;
#pragma unroll
                for (int s = 0; s < kSlots; ++s) {
                  const int c = lane + 32 * s;
                  float x = (j[u] >= 0 && c < nc) ? src[c] : 0.0f;
                  if (kBf16) x = __bfloat162float(__float2bfloat16_rn(x));
                  v[u][s] = x;
                }
              }
#pragma unroll
              for (int u = 0; u < kBatch; ++u)
                if (j[u] >= 0) {
#pragma unroll
                  for (int s = 0; s < kSlots; ++s) acc[s] += v[u][s];
                }
            }
          }
        }
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = lane + 32 * s;
          if (c < nc) to[c] = acc[s];
          acc[s] = 0.0f;
        }
      }
      first_span = false;
      base += span;
      __syncthreads();   // the lists are free again
      continue;
    }

    // 2. add: the lists in order, a chunk of at most 32 hits at a time (a
    // chunk does not cross lists). Every thread walks the same chunks.
    int next_w = 0, next_j = 0;   // where the next chunk starts
    int cur_w = 0, cur_j = 0, cur_k = 0;   // the chunk being added
    int pre_w = 0, pre_j = 0, pre_k = 0;   // the chunk being loaded
    float pre[kPerWarp][kSlots];
    int buf = 0;

    // finds the next chunk; k = 0 when the lists are used up
    auto advance = [&](int& w, int& j, int& k) {
      while (next_w < kWarps && next_j >= hit_cnt[next_w]) {
        ++next_w;
        next_j = 0;
      }
      if (next_w == kWarps) {
        k = 0;
        return;
      }
      const int left = hit_cnt[next_w] - next_j;
      w = next_w;
      j = next_j;
      k = left < kChunk ? left : kChunk;
      next_j += k;
    };
    // this warp's rows of a chunk, from device memory into registers
    auto load = [&](int w, int j, int k) {
#pragma unroll
      for (int t = 0; t < kPerWarp; ++t) {
        const int h = warp + t * kWarps;
        const float* src =
            h < k ? rows + (long long)hit_n[w][j + h] * D + c0 : nullptr;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = lane + 32 * s;
          float x = (h < k && c < nc) ? src[c] : 0.0f;
          if (kBf16) x = __bfloat162float(__float2bfloat16_rn(x));
          pre[t][s] = x;
        }
      }
    };
    auto store = [&](int b, int k) {
#pragma unroll
      for (int t = 0; t < kPerWarp; ++t) {
        const int h = warp + t * kWarps;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int c = lane + 32 * s;
          if (h < k && c < nc) stage[(b * kChunk + h) * cols + c] = pre[t][s];
        }
      }
    };

    advance(pre_w, pre_j, pre_k);
    if (pre_k > 0) {
      load(pre_w, pre_j, pre_k);
      store(buf, pre_k);
    }
    __syncthreads();
    while (pre_k > 0) {
      cur_w = pre_w;
      cur_j = pre_j;
      cur_k = pre_k;
      advance(pre_w, pre_j, pre_k);
      if (pre_k > 0) load(pre_w, pre_j, pre_k);  // in flight during the adds

      // the chunk's hits of this warp's row, in ascending n
      const int r = lane < cur_k ? hit_r[cur_w][cur_j + lane] : 255;
      unsigned m = __ballot_sync(kFull, r == warp);
      const float* from = stage + buf * kChunk * cols;
      while (m) {  // m is the same in every lane
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
            v[u][s] = (h[u] >= 0 && c < nc) ? from[h[u] * cols + c] : 0.0f;
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (h[u] >= 0) {
#pragma unroll
            for (int s = 0; s < kSlots; ++s) acc[s] += v[u][s];
          }
      }

      buf ^= 1;
      if (pre_k > 0) store(buf, pre_k);
      __syncthreads();
    }
    base += span;
    // the lists are free again only when every warp has walked them
    __syncthreads();
  }

  // 3. this warp's row, zeros included (sparse tiles: written above, unless
  // there was no id at all)
  if (kSparse && !first_span) return;
  for (int mine = warp; mine < lim; mine += kWarps) {
    float* to = tile + (long long)mine * D;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = lane + 32 * s;
      if (c < nc) to[c] = acc[s];
    }
  }
}

// Fills `launch`; returns cudaSuccess, or cudaErrorInvalidValue for shapes
// the kernels do not take. `partial` must hold segs * n_rows * D floats when
// the ids are cut into more than one segment (seg_len < N). groups > 1 asks
// for sparse tiles of 16 * groups rows.
inline cudaError_t plan_scan(int N, int D, long long n_rows, int cols,
                             int seg_len, int groups, float* partial,
                             float* out, Launch* launch) {
  if (n_rows < 1 || N < 0 || N > kMaxIds || D < 1 || cols < 1 ||
      cols > kMaxCols || seg_len < 1 || groups < 1 || groups > kMaxGroups)
    return cudaErrorInvalidValue;
  const long long owned = (long long)kWarps * groups;
  const long long row_tiles = (n_rows + owned - 1) / owned;
  const long long col_tiles = ((long long)D + cols - 1) / cols;
  const long long segs = N > 0 ? ((long long)N + seg_len - 1) / seg_len : 1;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535 || segs > 65535 ||
      (segs > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  launch->grid = dim3((unsigned)row_tiles, (unsigned)col_tiles, (unsigned)segs);
  launch->smem = sizeof(float) * 2 * kChunk * (size_t)cols;
  launch->segs = (int)segs;
  launch->dst = segs > 1 ? partial : out;
  return cudaSuccess;
}

}  // namespace staged
