// The bodies of Swing's pair pass (csrc/swing.cu launches them; the CPU
// emulation in tests/staged_emulation/ runs them through cuda_names.h).
//
// For every user pair u < v whose item sets share c >= 2 items, the pass
// adds w = 1 / (alpha + c), computed in float32 and kept as the 64-bit
// fixed-point term round(w * 2^32), to score[a, b] for every ordered pair
// a != b of the shared items, over the rows [row_begin, row_end). Three
// kernels:
//
//   walk<false>  once a call: each user's pairs (c >= 2, a shared
//                item among the rows) and their shared items counted, and
//                for each of the user's items among the rows the pairs that
//                hold it (its bucket entries) and their adds;
//   walk<true>   once a chunk of users: the same walk, writing each pair's
//                shared items into one list and, into the bucket of each
//                row among them, the pair's (c, first entry);
//   rows         once a chunk: a block a row (or a column tile of it, or a
//                slice of a hot row's bucket) sums the row in shared memory
//                and writes it once.
//
// Every body runs kThreads threads a block and takes its shared memory as a
// pointer (the dynamic shared memory of the launch).
#pragma once

namespace swing {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// a user's running cursor: pairs above bit 40, shared items below
constexpr int kEntryBits = 40;
constexpr unsigned long long kEntryMask = (1ull << kEntryBits) - 1ull;
// the rows kernel's task: row (of the call's), first column, columns, bucket
// slice [k0, k1), and whether it combines by atomics (a slice of a hot row)
constexpr int kTaskInts = 6;

// the fixed-point term of a pair of c shared items, w computed in float32
// as the C++ computes it
__device__ __forceinline__ unsigned long long fixed_weight(float alpha, int c) {
  const float w = 1.0f / (alpha + (float)c);
  return (unsigned long long)__double2ll_rn((double)w * 4294967296.0);
}

// First index of the sorted a[0, n) whose value is >= key, found by the
// whole warp: each round the lanes probe 32 evenly spaced entries and keep
// the stretch between the last probe below the key and the next, so a list
// of n entries takes about log32(n) + 1 dependent loads. Every lane of the
// warp calls it and gets the same answer.
__device__ __forceinline__ int warp_lower_bound(const int* a, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int at = lo + lane * step;
    const int k = __popc(__ballot_sync(kFull, at < hi && a[at] < key));
    if (k == 0) return lo;
    if (k < 32) hi = min(hi, lo + k * step);
    lo += (k - 1) * step + 1;
  }
  return lo + __popc(__ballot_sync(kFull, lo + lane < hi && a[lo + lane] < key));
}

struct WalkArgs {
  const long long* user_indptr;
  const int* user_items;
  int n_users;
  const long long* item_indptr;
  const int* item_users;
  int row_begin, row_end;   // the rows summed
  int u0, u1;               // the users walked
  int tile;                 // partners counted at once (shared memory)
  // walk<false>, zeros before: per user its pairs and shared items; per
  // interaction (user_items' order) its bucket entries and their adds
  long long* user_pairs;
  long long* user_entries;
  int* ui_count;
  unsigned long long* ui_adds;
  // walk<true>: per user the first entry of its lists (exclusive sums of
  // user_entries, n_users + 1; the chunk's lists start at u0's)
  const long long* entry_base;
  int* entries;
  int* row_cursor;          // per row: its bucket's next slot
  unsigned long long* bucket;
};

// Shared memory of a walk: a cursor and a queue length, then per partner of
// the tile its count, its fill cursor, its first entry and its queue slot.
__host__ __device__ inline long long walk_smem(int tile) { return 16 + 16ll * tile; }

// A block walks users u0 + blockIdx.x, then every gridDim.x-th. For a user
// u it takes the partners v > u a tile at a time.
// - Count: a warp an item i of u, its lanes over i's users in the tile
//   (found by warp_lower_bound), each adding one to the partner's count in
//   shared memory; the first to reach a partner queues it.
// - Pairs: a lane a queued partner; c >= 2 with a shared item among the rows
//   is a pair, and the warp reserves its pairs and their entries with one
//   atomic on the user's packed cursor.
// - Then the count's loop again, a warp an item i: the count walk adds up,
//   for i among the rows, the pairs that hold i and their c - 1 adds; the
//   write walk writes i into each pair's list at the pair's fill cursor
//   and, for i among the rows, reserves a run of i's bucket for the warp's
//   pairs with one atomic and writes them there, in lane order.
// A pair's list is its shared items in no particular order.
template <bool kWrite>
__device__ void walk_body(const WalkArgs& a, unsigned char* smem) {
  unsigned long long* cursor = reinterpret_cast<unsigned long long*>(smem);
  int* n_queued = reinterpret_cast<int*>(smem + 8);
  int* count = reinterpret_cast<int*>(smem + 16);   // shared items with v
  int* fill = count + a.tile;    // a shared item among the rows; then the
                                 // fill cursor of a pair, -1 for no pair
  int* first = fill + a.tile;    // a pair's first entry
  int* queue = first + a.tile;
  const int rows = a.row_end - a.row_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int j = threadIdx.x; j < 2 * a.tile; j += kThreads) count[j] = 0;

  for (int u = a.u0 + blockIdx.x; u < a.u1; u += gridDim.x) {
    const long long ub = a.user_indptr[u];
    const int lu = (int)(a.user_indptr[u + 1] - ub);
    if (lu < 2) continue;  // the same u for the whole block
    const int* items_u = a.user_items + ub;
    if (threadIdx.x == 0) *cursor = 0;
    for (int v0 = u + 1; v0 < a.n_users; v0 += a.tile) {
      const int v1 = min(v0 + a.tile, a.n_users);
      if (threadIdx.x == 0) *n_queued = 0;
      __syncthreads();
      for (int p = warp; p < lu; p += kWarps) {
        const int i = items_u[p];
        const bool in_rows = (unsigned)(i - a.row_begin) < (unsigned)rows;
        const int* users = a.item_users + a.item_indptr[i];
        const int n = (int)(a.item_indptr[i + 1] - a.item_indptr[i]);
        for (int q = warp_lower_bound(users, n, v0); q < n; q += 32) {
          const int v = q + lane < n ? users[q + lane] : a.n_users;
          if (v < v1) {
            if (in_rows) fill[v - v0] = 1;
            if (atomicAdd(&count[v - v0], 1) == 0) queue[atomicAdd(n_queued, 1)] = v - v0;
          }
          if (__ballot_sync(kFull, v >= v1)) break;
        }
      }
      __syncthreads();
      const int nq = *n_queued;
      for (int t0 = 32 * warp; t0 < nq; t0 += kThreads) {
        const int j = t0 + lane < nq ? queue[t0 + lane] : -1;
        const int c = j >= 0 ? count[j] : 0;
        const bool pair = c >= 2 && fill[j] != 0;
        const unsigned mask = __ballot_sync(kFull, pair);
        int before = pair ? c : 0;   // entries of this and the lower lanes' pairs
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, before, o);
          if (lane >= o) before += y;
        }
        const int total = __shfl_sync(kFull, before, 31);
        before -= pair ? c : 0;
        unsigned long long old = 0;
        if (lane == 0 && mask)
          old = atomicAdd(cursor, ((unsigned long long)__popc(mask) << kEntryBits) |
                                      (unsigned long long)(unsigned)total);
        old = __shfl_sync(kFull, old, 0);
        if (j < 0) continue;
        int start = 0;
        if (kWrite && pair)
          start = (int)(a.entry_base[u] - a.entry_base[a.u0] +
                        (long long)(old & kEntryMask) + before);
        fill[j] = pair ? start : -1;
        first[j] = start;
      }
      __syncthreads();
      for (int p = warp; p < lu; p += kWarps) {
        const int i = items_u[p];
        const bool in_rows = (unsigned)(i - a.row_begin) < (unsigned)rows;
        if (!kWrite && !in_rows) continue;
        const int* users = a.item_users + a.item_indptr[i];
        const int n = (int)(a.item_indptr[i + 1] - a.item_indptr[i]);
        unsigned placed = 0;
        unsigned long long adds = 0;
        for (int q = warp_lower_bound(users, n, v0); q < n; q += 32) {
          const int v = q + lane < n ? users[q + lane] : a.n_users;
          const int j = v - v0;
          const bool pair = v < v1 && fill[j] >= 0;
          if (kWrite) {
            if (pair) a.entries[atomicAdd(&fill[j], 1)] = i;
            const unsigned mask = __ballot_sync(kFull, pair && in_rows);
            if (mask) {
              int base = 0;
              if (lane == 0) base = atomicAdd(&a.row_cursor[i - a.row_begin], __popc(mask));
              base = __shfl_sync(kFull, base, 0);
              if (pair)
                a.bucket[base + __popc(mask & below)] =
                    (unsigned long long)count[j] << 32 | (unsigned)first[j];
            }
          } else if (pair) {
            placed += 1;
            adds += (unsigned long long)(count[j] - 1);
          }
          if (__ballot_sync(kFull, v >= v1)) break;
        }
        if (!kWrite) {
          placed = __reduce_add_sync(kFull, placed);
          for (int o = 16; o > 0; o >>= 1) adds += __shfl_xor_sync(kFull, adds, o);
          if (lane == 0 && placed) {
            a.ui_count[ub + p] += (int)placed;
            a.ui_adds[ub + p] += adds;
          }
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < nq; t += kThreads) {
        const int j = queue[t];
        count[j] = 0;
        fill[j] = 0;
      }
    }
    __syncthreads();  // the tile's counts are clear; the cursor is complete
    if (!kWrite && threadIdx.x == 0) {
      a.user_pairs[u] = (long long)(*cursor >> kEntryBits);
      a.user_entries[u] = (long long)(*cursor & kEntryMask);
    }
  }
}

struct RowsArgs {
  const int* tasks;   // kTaskInts a block
  const unsigned long long* bucket;
  const int* entries;
  float alpha;
  int row_begin;      // the first row summed (item id of task row 0)
  int n_items;
  unsigned long long* out;   // the rows summed, n_items a row
};

// the tile: the low words of a row's sums, then their high words
__host__ __device__ inline long long rows_smem(int cols) { return 8ll * cols; }

// Adds the 64-bit term t to column j of the tile as two 32-bit shared
// atomics (a 64-bit shared add is a compare-and-swap loop on sm_90a): the
// low word, then the high word with the low word's carry. Exact modulo 2^64
// whatever the order the lanes and warps land in.
__device__ __forceinline__ void tile_add(unsigned* lo, unsigned* hi, unsigned j,
                                         unsigned long long t) {
  const unsigned l = (unsigned)t;
  const unsigned old = atomicAdd(&lo[j], l);
  const unsigned h = (unsigned)(t >> 32) + ((unsigned)(old + l) < old ? 1u : 0u);
  if (h) atomicAdd(&hi[j], h);
}

// A block sums one task's row over its column tile in shared memory. Its
// warps take the bucket slice 32 pairs at a time and add each pair's term
// at every column b != row of its list that lies in the tile, the batch's
// lists laid end to end over the lanes, 32 entries a step: the lane of flat
// position f finds its pair from a ballot of the lists' ends (distinct, as
// every list but the batch's unused tail lanes holds two or more entries).
// A pair's columns are distinct, so one pair's lanes never meet on a cell.
// The block writes the tile once: added to the output, or, for a slice of a
// hot row, one 64-bit atomic a nonzero column.
__device__ void rows_body(const RowsArgs& a, unsigned char* smem) {
  constexpr int U = 4;   // entry loads a lane has in flight
  const int* t = a.tasks + (long long)blockIdx.x * kTaskInts;
  const int row = t[0], col0 = t[1], cols = t[2], k0 = t[3], k1 = t[4], hot = t[5];
  unsigned* lo = reinterpret_cast<unsigned*>(smem);
  unsigned* hi = lo + cols;
  const int item = a.row_begin + row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < 2 * cols; j += kThreads) lo[j] = 0;
  __syncthreads();
  auto add = [&](unsigned long long w, int x) {
    const unsigned j = (unsigned)(x - col0);
    if (x != item && j < (unsigned)cols) tile_add(lo, hi, j, w);
  };
  for (int kb = k0 + 32 * warp; kb < k1; kb += 32 * kWarps) {
    int start = 0, c = 0;
    unsigned long long w = 0;
    if (kb + lane < k1) {
      const unsigned long long pair = a.bucket[kb + lane];
      start = (int)(unsigned)pair;
      c = (int)(pair >> 32);
      w = fixed_weight(a.alpha, c);
    }
    // the batch's lists laid end to end over the lanes
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int base = start - (incl - c);   // entry of flat position f: base_i + f
    for (int f0 = 0; f0 < total; f0 += 32 * U) {
      int x[U];
      unsigned long long wf[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int f = f0 + 32 * k;
        // the pair of flat position f + lane: the pairs ending at or before it
        const int d = incl - f;
        const unsigned ended = __ballot_sync(kFull, d <= 0);
        const unsigned ends = __reduce_or_sync(kFull, (d > 0 && d < 32) ? 1u << d : 0u);
        const int src = (__popc(ended) + __popc(ends & ((2u << lane) - 1u))) & 31;
        const int at = __shfl_sync(kFull, base, src) + f + lane;
        wf[k] = __shfl_sync(kFull, w, src);
        x[k] = f + lane < total ? a.entries[at] : -1;
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (x[k] >= 0) add(wf[k], x[k]);
    }
  }
  __syncthreads();
  unsigned long long* dst = a.out + (long long)row * a.n_items + col0;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const unsigned long long v = (unsigned long long)hi[j] << 32 | lo[j];
    if (!hot) dst[j] += v;
    else if (v) atomicAdd(&dst[j], v);
  }
}

}  // namespace swing
