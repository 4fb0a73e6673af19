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
// bytes bound (~78 us at 3.35 TB/s), so the scoring loop is what matters
// there. At a served request (U=1, N=3706) both bounds are below a
// microsecond and the time is latency: the scoring loop's dependent tile
// loads, and the selection's barrier stages.
//
// Design:
// - Blocks run in no order, so nothing is carried across blocks. Pass 1 runs
//   a grid of (user tiles x item chunks). Each block scores its chunk for R
//   user rows and keeps, per row, the k best candidates in shared memory; it
//   writes them to a (U, n_chunks, k) workspace. Pass 2 selects the k best
//   of the n_chunks * k candidates of each row, one row a block. With one
//   chunk, pass 1 writes the result directly and pass 2 is not launched. A
//   chunk may hold fewer than k items (the host's plan allows it while a
//   row's candidates stay few); its list is padded with key 0.
// - Scoring: a block holds its R user rows in shared memory and streams item
//   tiles of 128 rows x 32 columns through shared memory. A thread owns 2
//   items x R/4 rows of accumulators and reads float4s, so a step of 4
//   columns costs 2 + R/4 shared loads for 8 * R/4 FMAs. Each score is one
//   f32 FMA chain over d = 0..D-1 in order (zero padding adds exact zeros),
//   so it does not depend on the tiling. Any D: columns are padded to 4.
//   Item slices are staged through registers so that the next slice's global
//   loads overlap the current slice's FMAs.
// - Keys: a candidate is one 64-bit key, the order-preserving bits of its
//   score (-0.0 taken as +0.0) above ~id, so that keys compare as the kernel's
//   total order: the greater score first, on a tie the lower id. Key 0 lies
//   below every real candidate and pads short lists.
// - Selection: per row a buffer of P = pow2 >= k + 192 keys, a count and a
//   threshold, the row's current k-th key. A key enters the buffer only if
//   it beats the threshold (one compare), which after the first few tiles
//   drops almost every candidate. When a buffer could overflow on the next
//   tile, the block runs a radix select over each row holding more than k
//   keys: 8 key bits a round from the top, counts in shared memory (a warp
//   adds its equal buckets with one atomic; counts do not depend on the order
//   of the atomics, so the result is deterministic), a prefix sum from the top
//   bucket to find the bucket that holds the k-th key, until that bucket holds
//   only keys to keep (exact ties share all 32 score bits, so they take
//   rounds over the id bits too); the k kept keys are compacted into [0, k)
//   unsorted, and the least
//   of them is the new threshold. Why: the design this replaces sorted the
//   whole buffer at every overflow, a bitonic sort of 55 barrier stages at
//   P = 1024, five or six of them in series in pass 2's one block at a served
//   request, which was most of that request's device time. Now the only sort
//   is one bitonic sort of next_pow2(k) keys before the result is written.
// - Pass 2, when a row's n_chunks * k candidates fit in shared memory (up to
//   kPass2AllMax keys), loads them all at once, selects once and gathers the
//   k kept keys with every thread into a second buffer, which it sorts.
//   Otherwise it offers them chunk by chunk through a buffer of P; pass 1 then
//   sorts each chunk's list, the threshold only rises, and once a tile of a
//   chunk offers nothing the rest of that chunk is skipped.
// - The ragged edge: items at or past the chunk end or n_items are never
//   loaded (zeros) and never offered; user rows past U are zero and skipped.
#include <cuda_runtime.h>

namespace {

using Key = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;    // items per tile: 64 item lanes x 2
constexpr int kTileD = 32;     // columns per shared item slice
constexpr int kTileDP = 36;    // padded slice stride: float4 reads without bank conflicts
constexpr int kSmemLimit = 232448;    // bytes of shared memory a Hopper block may use
constexpr int kPass2AllMax = 16384;   // pass 2 loads a row's candidates at once up to this
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kHistWords = kBins / 2;  // two 16-bit counts a word: a row holds < 65536 keys
constexpr unsigned kFullMask = 0xffffffffu;

// Per row, in shared memory beside the row's buffer of keys.
struct RowState {
  Key thr;     // the row's k-th key once it has held k keys, else 0
  Key prefix;  // select: the k-th key's bits resolved so far
  int cnt;     // keys in the buffer
  int krem;    // select: rank of the k-th key among the keys matching prefix
  int lo;      // select: 64 open, the lowest resolved bit once resolved,
               // -1 for a row with at most k keys (nothing to select)
  int kept;    // pass 2, all candidates held: keys gathered so far
};
constexpr int kRowBytes = sizeof(RowState) + kHistWords * 4;

__device__ __forceinline__ Key make_key(float s, int id) {
  unsigned b = s == 0.f ? 0u : __float_as_uint(s);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((Key)b << 32) | (unsigned)~id;
}

__device__ __forceinline__ float key_score(Key key) {
  const unsigned b = (unsigned)(key >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ int key_id(Key key) { return (int)~(unsigned)key; }

__device__ __forceinline__ int next_pow2(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// Find, in each of the first `rows` rows of `buf` (row stride P) that holds
// more than k keys, which keys are its k greatest: those whose bits at and
// above st.lo are at least st.prefix (st.lo = -1 for a row with at most k
// keys). Radix select from the top, 8 bits a round: each round counts the
// keys that match the bits resolved so far by their next 8 bits (a warp adds
// its equal buckets at once, since keys of one row share few buckets in the
// first rounds), and a prefix sum from the top bucket finds the bucket that
// holds the k-th key; a row is resolved once that bucket holds only keys to
// keep. Rows past U are never filled, so `rows` is the count of real rows in
// the block. Called by every thread with the same arguments; returns whether
// any row had more than k keys.
__device__ int find_kth(const Key* buf, RowState* st, unsigned* hist, int rows,
                        int P, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int open = 0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    st[r].prefix = 0;
    st[r].krem = k;
    st[r].lo = st[r].cnt > k ? 64 : -1;
    open |= st[r].cnt > k;
  }
  if (!__syncthreads_or(open)) return 0;
  for (int shift = 64 - kRadixBits; shift >= 0; shift -= kRadixBits) {
    for (int t = threadIdx.x; t < rows * kHistWords; t += kThreads) hist[t] = 0;
    __syncthreads();
    // the bits resolved in earlier rounds
    const Key high = shift + kRadixBits >= 64 ? 0 : ~0ull << (shift + kRadixBits);
    for (int r = 0; r < rows; ++r) {
      if (st[r].lo != 64) continue;
      const int n = st[r].cnt;
      const Key prefix = st[r].prefix;
      const Key* row = buf + (size_t)r * P;
      unsigned* h = hist + r * kHistWords;
      // each lane loads its next key before it counts the current one
      Key next = warp * 32 + lane < n ? row[warp * 32 + lane] : 0;
      for (int i0 = warp * 32; i0 < n; i0 += kThreads) {
        const int i = i0 + lane;
        const Key key = next;
        if (i + kThreads < n) next = row[i + kThreads];
        const int d = i < n && (key & high) == prefix
                          ? (int)((unsigned)(key >> shift) & (kBins - 1))
                          : -1;
        const unsigned peers = __match_any_sync(kFullMask, d);
        if (d >= 0 && lane == __ffs(peers) - 1) {
          atomicAdd(&h[d >> 1], (unsigned)__popc(peers) << ((d & 1) * 16));
        }
      }
    }
    __syncthreads();
    // one warp a row: lane l holds buckets kBins-1-8l .. kBins-8-8l, so a
    // prefix sum over the lanes counts keys from the top bucket down
    open = 0;
    for (int r = warp; r < rows; r += kWarps) {
      if (st[r].lo != 64) continue;
      const unsigned krem = st[r].krem;
      const Key prefix = st[r].prefix;
      unsigned c[8];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = kBins - 1 - 8 * lane - j;
        c[j] = (hist[r * kHistWords + (b >> 1)] >> ((b & 1) * 16)) & 0xffffu;
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned above = incl - sum;
      bool resolved = false;
      __syncwarp();  // every lane has read the row's state
      if (above < krem && krem <= incl) {  // this lane holds the k-th key's bucket
        int bin = -1;
        unsigned in_bin = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (bin < 0) {
            if (above + c[j] >= krem) {
              bin = kBins - 1 - 8 * lane - j;
              in_bin = c[j];
            } else {
              above += c[j];
            }
          }
        }
        st[r].prefix = prefix | (Key)bin << shift;
        st[r].krem = krem - above;
        // every key of the bucket is kept: the kept keys are known
        resolved = krem - above == in_bin;
        if (resolved) st[r].lo = shift;
      }
      open |= !__any_sync(kFullMask, resolved);
    }
    if (!__syncthreads_or(open)) break;
  }
  return 1;
}

// After find_kth: move each selected row's k kept keys to [0, k), in buffer
// order (one warp a row: a kept key moves to a position at or before its
// own, and a warp reads its 32 keys before it writes), set the row's count
// to k and its threshold to the least kept key.
__device__ void compact_rows(Key* buf, RowState* st, int rows, int P, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const int lo = st[r].lo;
    if (lo < 0) continue;
    const Key mask = ~0ull << lo;
    const Key prefix = st[r].prefix;
    const int n = st[r].cnt;
    Key* row = buf + (size_t)r * P;
    int base = 0;
    Key least = ~0ull;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const Key key = i < n ? row[i] : 0;
      const Key m = key & mask;
      const bool keep = i < n && m >= prefix;
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      if (keep) {
        row[base + __popc(ballot & ((1u << lane) - 1))] = key;
        if (m == prefix && key < least) least = key;
      }
      base += __popc(ballot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Key o = __shfl_xor_sync(kFullMask, least, off);
      if (o < least) least = o;
    }
    if (lane == 0) {
      st[r].cnt = k;
      st[r].thr = least;
    }
  }
  __syncthreads();
}

// Keep in each row that holds more than k keys its k greatest, unsorted, in
// [0, k); its count becomes k and its threshold the least of them.
__device__ void select_rows(Key* buf, RowState* st, unsigned* hist, int rows,
                            int P, int k) {
  if (find_kth(buf, st, hist, rows, P, k)) compact_rows(buf, st, rows, P, k);
}

// Sort [0, K) of each of the first `rows` rows greatest key first, after
// padding [cnt, K) with key 0. K is a power of two >= every row's count.
__device__ void sort_rows(Key* buf, const RowState* st, int rows, int P, int K) {
  for (int t = threadIdx.x; t < rows * K; t += kThreads) {
    const int r = t / K;
    const int i = t - r * K;
    if (i >= st[r].cnt) buf[(size_t)r * P + i] = 0;
  }
  __syncthreads();
  const int half = K >> 1;
  if (half == 0) return;
  const int log_half = __ffs(half) - 1;
  for (int size = 2; size <= K; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < rows * half; t += kThreads) {
        const int r = t >> log_half;
        const int i = t & (half - 1);
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        Key* row = buf + (size_t)r * P;
        const Key a = row[lo], b = row[hi];
        if ((b > a) == ((lo & size) == 0)) {
          row[lo] = b;
          row[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

constexpr int kQueued = 1;  // offer() result bits
constexpr int kFull = 2;    // the row's buffer could overflow on the next tile

// Put `key` in row r's buffer if it beats the row's threshold. Returns 0, or
// kQueued with kFull set when fewer than kTileN slots are left. Callers OR
// the results of a tile and decide with __syncthreads_or, which also keeps
// the next tile's offers from racing the select.
__device__ __forceinline__ int offer(Key* buf, RowState* st, int P, int r,
                                     Key key) {
  if (key <= st[r].thr) return 0;
  const int n = atomicAdd(&st[r].cnt, 1) + 1;
  buf[(size_t)r * P + n - 1] = key;
  return n > P - kTileN ? kQueued | kFull : kQueued;
}

// Shared memory: users [R][d_pad] f32 | items [kTileN][kTileDP] f32 |
//                keys [R][P] | row states [R] | radix counts [R][kHistWords]
// Writes scores and ids (n_chunks == 1) or keys to the workspace, sorted best
// first when `sorted` (pass 2 then breaks early in a chunk).
template <int TR>
__global__ void __launch_bounds__(kThreads, 2)
topk_pass1(const float* __restrict__ users, const float* __restrict__ items,
           int U, int n_items, int D, int d_pad, int k, int P, int chunk,
           int n_chunks, int sorted, float* __restrict__ out_s,
           int* __restrict__ out_i, Key* __restrict__ ws) {
  constexpr int R = 4 * TR;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);
  float* is = us + R * d_pad;
  Key* buf = reinterpret_cast<Key*>(is + kTileN * kTileDP);
  RowState* st = reinterpret_cast<RowState*>(buf + R * P);
  unsigned* hist = reinterpret_cast<unsigned*>(st + R);

  const int row0 = blockIdx.x * R;
  const int rows = min(R, U - row0);
  const int c = blockIdx.y;
  const int j_begin = c * chunk;
  const int j_end = min(n_items, j_begin + chunk);

  for (int t = threadIdx.x; t < R; t += kThreads) {
    st[t].cnt = 0;
    st[t].thr = 0;
  }
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
        if (j < j_end) flags |= offer(buf, st, P, r, make_key(acc[q][h], j));
      }
    }
    if (__syncthreads_or(flags & kFull)) select_rows(buf, st, hist, rows, P, k);
  }
  __syncthreads();
  select_rows(buf, st, hist, rows, P, k);
  if (sorted) sort_rows(buf, st, rows, P, next_pow2(k));
  for (int t = threadIdx.x; t < rows * k; t += kThreads) {
    const int r = t / k;
    const int p = t - r * k;
    // a chunk shorter than k pads its list with key 0
    const Key key = p < st[r].cnt ? buf[(size_t)r * P + p] : 0;
    if (n_chunks == 1) {
      out_s[(size_t)(row0 + r) * k + p] = key_score(key);
      out_i[(size_t)(row0 + r) * k + p] = key_id(key);
    } else {
      ws[((size_t)(row0 + r) * n_chunks + c) * k + p] = key;
    }
  }
}

// The k best of the n_chunks * k candidates of one row a block. With
// n_chunks * k <= P they are all loaded at once, selected once, and the kept
// keys gathered by every thread into a second buffer of next_pow2(k) keys;
// otherwise P is the buffer of pass 1's plan and the chunks, each sorted
// best first, are offered tile by tile.
// Shared memory: keys [P] | kept keys [next_pow2(k)], with all candidates
//                held | row state | radix counts [kHistWords]
__global__ void __launch_bounds__(kThreads)
topk_pass2(const Key* __restrict__ ws, int n_chunks, int k, int P,
           float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  Key* buf = reinterpret_cast<Key*>(smem4);
  const size_t row = blockIdx.x;
  const int n = n_chunks * k;
  const int K = next_pow2(k);
  const bool all = n <= P;
  Key* kept = buf + P;
  RowState* st = reinterpret_cast<RowState*>(all ? kept + K : kept);
  unsigned* hist = reinterpret_cast<unsigned*>(st + 1);
  const Key* cand = ws + row * n;

  if (all) {
#pragma unroll 8
    for (int t = threadIdx.x; t < n; t += kThreads) buf[t] = cand[t];
    if (threadIdx.x == 0) {
      st->cnt = n;
      st->kept = 0;
    }
    __syncthreads();
    // n >= 2k: some row of more than k keys, so find_kth resolves it
    find_kth(buf, st, hist, 1, P, k);
    const Key mask = ~0ull << st->lo;
    const Key prefix = st->prefix;
    const int lane = threadIdx.x & 31;
    for (int t0 = threadIdx.x & ~31; t0 < n; t0 += kThreads) {
      const int t = t0 + lane;
      const Key key = t < n ? buf[t] : 0;
      const bool keep = t < n && (key & mask) >= prefix;
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      int base = 0;
      if (lane == 0 && ballot) base = atomicAdd(&st->kept, __popc(ballot));
      base = __shfl_sync(kFullMask, base, 0);
      if (keep) kept[base + __popc(ballot & ((1u << lane) - 1))] = key;
    }
    if (threadIdx.x == 0) st->cnt = k;
    __syncthreads();
    sort_rows(kept, st, 1, K, K);
    for (int p = threadIdx.x; p < k; p += kThreads) {
      const Key key = kept[p];
      out_s[row * k + p] = key_score(key);
      out_i[row * k + p] = key_id(key);
    }
    return;
  }
  if (threadIdx.x == 0) {
    st->cnt = 0;
    st->thr = 0;
  }
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    for (int p0 = 0; p0 < k; p0 += kTileN) {
      const int p = p0 + threadIdx.x;
      int flags = 0;
      if (threadIdx.x < kTileN && p < k) {
        flags = offer(buf, st, P, 0, cand[(size_t)c * k + p]);
      }
      if (__syncthreads_or(flags & kFull)) select_rows(buf, st, hist, 1, P, k);
      if (!__syncthreads_or(flags & kQueued)) break;
    }
  }
  select_rows(buf, st, hist, 1, P, k);
  sort_rows(buf, st, 1, P, K);
  for (int p = threadIdx.x; p < k; p += kThreads) {
    const Key key = buf[p];
    out_s[row * k + p] = key_score(key);
    out_i[row * k + p] = key_id(key);
  }
}

// Let every kernel use a block's whole shared memory, once per device.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  const void* kernels[] = {(const void*)topk_pass1<1>, (const void*)topk_pass1<4>,
                           (const void*)topk_pass1<8>, (const void*)topk_pass2};
  for (const void* f : kernels) {
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) ready[dev] = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch the top-k of users (U, D) x items (n_items, D), both row-major f32 on
// the device. rows (R: 4, 16 or 32), P, chunk and n_chunks come from the
// host's plan. ws is a (U, n_chunks, k) workspace of 64-bit keys, unused and
// may be null with n_chunks == 1. Returns the cudaError_t of the launches (0
// on success); never synchronises.
int streaming_topk(const float* users, const float* items, int U, int n_items,
                   int D, int k, int rows, int P, int chunk, int n_chunks,
                   void* ws, float* out_s, int* out_i, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (U < 1 || n_items < 1 || D < 1 || k < 1 || k > n_items || P < k + kTileN ||
      (P & (P - 1)) != 0 || chunk < 1 || n_chunks < 1 ||
      (long long)chunk * n_chunks < n_items || (n_chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const int d_pad = (D + 3) / 4 * 4;
  const size_t smem1 = ((size_t)rows * d_pad + (size_t)kTileN * kTileDP) * 4 +
                       (size_t)rows * P * 8 + (size_t)rows * kRowBytes;
  const bool direct = n_chunks == 1;
  const bool all2 = (long long)n_chunks * k <= kPass2AllMax;
  Key* keys = static_cast<Key*>(ws);
  // pass 2 breaks early in a chunk only when the chunk is sorted
  const int sorted = direct || !all2;
  const dim3 grid1((U + rows - 1) / rows, n_chunks);
  switch (rows) {
    case 4:
      topk_pass1<1><<<grid1, kThreads, smem1, stream>>>(
          users, items, U, n_items, D, d_pad, k, P, chunk, n_chunks, sorted,
          out_s, out_i, keys);
      break;
    case 16:
      topk_pass1<4><<<grid1, kThreads, smem1, stream>>>(
          users, items, U, n_items, D, d_pad, k, P, chunk, n_chunks, sorted,
          out_s, out_i, keys);
      break;
    case 32:
      topk_pass1<8><<<grid1, kThreads, smem1, stream>>>(
          users, items, U, n_items, D, d_pad, k, P, chunk, n_chunks, sorted,
          out_s, out_i, keys);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  int K = 1;
  while (K < k) K <<= 1;
  const int P2 = all2 ? n_chunks * k : P;
  const size_t smem2 = ((size_t)P2 + (all2 ? K : 0)) * 8 + kRowBytes;
  topk_pass2<<<U, kThreads, smem2, stream>>>(keys, n_chunks, k, P2, out_s,
                                             out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
