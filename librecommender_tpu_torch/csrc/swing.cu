// Swing's pair pass, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs this pass on the host, in
// C++ with OpenMP (`swing_topk`, librecommender_tpu/native/similarities.cpp:
// 396). For every user pair u < v whose item sets share c >= 2 items, it
// adds w = 1 / (alpha + c), computed in float32, to score[i, j] for every
// ordered pair i != j of the shared items. The wrapper
// (ops/swing.py) picks each item's top-k from the scores afterwards.
//
// What bounds it on an H100: operations, and among them the atomic adds.
// The pass makes sum over pairs of c * (c - 1) adds into an n_items x
// n_items table (a row block of it per launch), plus a sorted-list
// intersection per pair; it moves little more than the interaction lists,
// which stay in L2.
//
// Design.
// - A block owns a user u at a time (grid-stride over users). Its warps walk
//   u's items and, for each, the item's user list; a partner v > u is
//   claimed once per u through a stamp array of the block's own
//   (stamp[v] == u + 1: already claimed), as the C++'s per-thread stamp
//   does, and queued.
// - A warp takes a queued partner v: its lanes test v's sorted items against
//   u's sorted list by binary search and compact the hits, in ascending
//   order, into the warp's buffer with a ballot. c = |I_u n I_v|.
// - The lanes then add w to every ordered pair (a, b), a != b, of the
//   buffer whose row a lies in the launch's row block [row_begin, row_end):
//   a contiguous run of the sorted buffer, found by binary search.
// - Determinism: w is added as a 64-bit fixed-point integer (w * 2^32,
//   rounded to nearest) with integer atomics. Integer addition is
//   associative, so the sums, and two fits on the card, are bit-identical
//   whatever order the atomics land in. A score up to 2^31 is exact to
//   2^-32 a term (the float32 C++ sums round at 2^-24 of the running sum).
// - Scratch is bounded by the row block: the wrapper launches once per
//   block of rows, each launch re-walking the pairs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    swing_pairs_kernel(const long long* __restrict__ user_indptr,
                       const int* __restrict__ user_items, int n_users,
                       const long long* __restrict__ item_indptr,
                       const int* __restrict__ item_users, float alpha,
                       int row_begin, int row_end, int n_items,
                       int* __restrict__ stamp, int* __restrict__ partners,
                       int* __restrict__ inter, int max_len,
                       unsigned long long* __restrict__ acc) {
  __shared__ int n_partners;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* my_stamp = stamp + (long long)blockIdx.x * n_users;
  int* my_partners = partners + (long long)blockIdx.x * n_users;
  int* buf = inter + ((long long)blockIdx.x * kWarps + warp) * max_len;

  for (int u = blockIdx.x; u < n_users; u += gridDim.x) {
    const long long ub = user_indptr[u];
    const int lu = (int)(user_indptr[u + 1] - ub);
    if (lu < 2) continue;  // the same u for the whole block
    const int* items_u = user_items + ub;
    if (threadIdx.x == 0) n_partners = 0;
    __syncthreads();
    for (int p = warp; p < lu; p += kWarps) {
      const int i = items_u[p];
      const long long e = item_indptr[i + 1];
      for (long long q = item_indptr[i] + lane; q < e; q += 32) {
        const int v = item_users[q];
        if (v > u && atomicExch(&my_stamp[v], u + 1) != u + 1)
          my_partners[atomicAdd(&n_partners, 1)] = v;
      }
    }
    __syncthreads();
    const int np = n_partners;
    for (int t = warp; t < np; t += kWarps) {
      const int v = my_partners[t];
      const long long vb = user_indptr[v];
      const int lv = (int)(user_indptr[v + 1] - vb);
      int c = 0;
      for (int base = 0; base < lv; base += 32) {
        const int idx = base + lane;
        int x = 0;
        bool hit = false;
        if (idx < lv) {
          x = user_items[vb + idx];
          const int at = lower_bound(items_u, lu, x);
          hit = at < lu && items_u[at] == x;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) buf[c + __popc(mask & ((1u << lane) - 1u))] = x;
        c += __popc(mask);
      }
      __syncwarp();
      if (c >= 2) {
        const float w = 1.0f / (alpha + (float)c);
        const unsigned long long wf =
            (unsigned long long)__double2ll_rn((double)w * 4294967296.0);
        const int a0 = lower_bound(buf, c, row_begin);
        const int a1 = lower_bound(buf, c, row_end);
        const long long n_adds = (long long)(a1 - a0) * c;
        for (long long s = lane; s < n_adds; s += 32) {
          const int a = a0 + (int)(s / c);
          const int b = (int)(s % c);
          if (a == b) continue;
          atomicAdd(&acc[(long long)(buf[a] - row_begin) * n_items + buf[b]], wf);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the queue and its count are reused by the next u
  }
}

}  // namespace

extern "C" int swing_pairs(const long long* user_indptr, const int* user_items,
                           int n_users, const long long* item_indptr,
                           const int* item_users, float alpha, int row_begin,
                           int row_end, int n_items, int* stamp, int* partners,
                           int* inter, int max_len, int grid,
                           unsigned long long* acc, void* stream) {
  if (grid < 1 || n_users < 1 || row_end <= row_begin) return 0;
  swing_pairs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      user_indptr, user_items, n_users, item_indptr, item_users, alpha,
      row_begin, row_end, n_items, stamp, partners, inter, max_len, acc);
  return (int)cudaGetLastError();
}

extern "C" int swing_threads() { return kThreads; }
extern "C" int swing_warps() { return kWarps; }
