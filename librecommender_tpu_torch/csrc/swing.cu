// Swing's pair pass, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs this pass on the host, in
// C++ with OpenMP (`swing_topk`, librecommender_tpu/native/similarities.cpp:
// 396). For every user pair u < v whose item sets share c >= 2 items, it
// adds w = 1 / (alpha + c), computed in float32, to score[i, j] for every
// ordered pair i != j of the shared items. The wrapper (ops/swing.py) picks
// each item's top-k from the scores afterwards.
//
// What bounds it on an H100: the adds, sum over pairs of c (c - 1): 8.3e9 at
// ML-1M's size (6040 users, 3706 items, 790,000 rows), 99% of item pairs
// touched, so the scores are a dense 3706 x 3706 table. The first port of
// this pass made every add a 64-bit global atomic into that table (110 MB of
// int64, more than twice the 50 MB L2), where the adds queued at about 35 G
// a second. Here no add goes to device memory (csrc/swing_pass.cuh):
//
// - walk, twice (count, then write): a block a user; its partners v > u
//   counted a tile at a time in shared memory, a warp an item of u and its
//   lanes over the item's users; a partner sharing c >= 2 items is a pair.
//   The write walk puts each pair's shared items into one list and the
//   pair's (c, first entry) into the bucket of each row among them, a warp
//   reserving its run of a bucket with one atomic. The count walk's per-user
//   and per-interaction counts size the lists and the buckets beforehand.
// - rows: a block owns a row (or a column tile of a wide catalog's row, or a
//   slice of a hot row's bucket) as a shared-memory tile of 64-bit sums; its
//   warps add each bucket pair's term at the pair's columns, the lists of a
//   batch of 32 pairs laid end to end over the lanes (so short lists fill
//   them), and the block writes the tile once. Slices of a hot row combine
//   with one 64-bit atomic a nonzero column.
//
// What bounds the rows pass now is reading each list once for every row it
// holds (sum of c^2 entries, 34 GB of int32 at ML-1M's size), not its adds.
//
// Exactness: every term is round(w * 2^32) as a 64-bit integer and integer
// addition is associative, so the sums equal the first port's bit for bit
// and two fits are bit-identical. A 64-bit shared-memory add compiles to a
// compare-and-swap loop on sm_90a, so the tile adds a term as two native
// 32-bit atomics (low word, then high word with the carry).
// Scratch: the wrapper cuts the users into chunks whose lists and buckets
// fit its budget; each chunk's rows pass adds into the output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "swing_pass.cuh"

namespace {

__global__ void __launch_bounds__(swing::kThreads)
    swing_walk_count_kernel(swing::WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  swing::walk_body<false>(a, smem);
}

__global__ void __launch_bounds__(swing::kThreads)
    swing_walk_write_kernel(swing::WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  swing::walk_body<true>(a, smem);
}

__global__ void __launch_bounds__(swing::kThreads)
    swing_rows_kernel(swing::RowsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  swing::rows_body(a, smem);
}

// launches kernel<<<grid, kThreads, smem>>>(args), raising the kernel's
// dynamic shared-memory limit where smem needs it
template <class A>
int launch(void (*kernel)(A), int grid, long long smem, void* stream, const A& args) {
  if (grid < 1) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, swing::kThreads, (size_t)smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// The walk over users [u0, u1) for the rows [row_begin, row_end). With
// write 0 it counts each user's pairs and shared items and each
// interaction's bucket entries and adds; with write 1 it writes the users'
// lists (their first entry at entry_base[u0]) and bucket entries.
extern "C" int swing_walk(int write, const long long* user_indptr,
                          const int* user_items, int n_users,
                          const long long* item_indptr, const int* item_users,
                          int row_begin, int row_end, int u0, int u1, int tile,
                          long long* user_pairs, long long* user_entries,
                          int* ui_count, unsigned long long* ui_adds,
                          const long long* entry_base, int* entries,
                          int* row_cursor, unsigned long long* bucket, int grid,
                          void* stream) {
  const swing::WalkArgs a{user_indptr, user_items, n_users, item_indptr,
                          item_users, row_begin, row_end, u0, u1, tile,
                          user_pairs, user_entries, ui_count, ui_adds,
                          entry_base, entries, row_cursor, bucket};
  const long long smem = swing::walk_smem(tile);
  return write ? launch(swing_walk_write_kernel, grid, smem, stream, a)
               : launch(swing_walk_count_kernel, grid, smem, stream, a);
}

// The rows pass: n_tasks blocks, each with a tile of up to max_cols columns.
extern "C" int swing_rows(const int* tasks, int n_tasks,
                          const unsigned long long* bucket, const int* entries,
                          float alpha, int row_begin, int n_items, int max_cols,
                          unsigned long long* out, void* stream) {
  const swing::RowsArgs a{tasks, bucket, entries, alpha, row_begin, n_items, out};
  return launch(swing_rows_kernel, n_tasks, swing::rows_smem(max_cols), stream, a);
}

extern "C" int swing_threads() { return swing::kThreads; }
