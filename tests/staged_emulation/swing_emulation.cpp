// Runs the bodies of librecommender_tpu_torch/csrc/swing_pass.cuh on the CPU
// (cuda_names.h) behind the same C interface as csrc/swing.cu, so that
// ops/swing.py's pipeline can drive them on CPU tensors, for
// tests/test_torch_swing_emulation.py. The stream argument is ignored.
//
// Build: g++ -std=c++20 -O2 -pthread -shared -fPIC
//        -I librecommender_tpu_torch/csrc tests/staged_emulation/swing_emulation.cpp
//        -o libswing_emulation.so
#include "cuda_names.h"
#include "swing_pass.cuh"

namespace {

template <class Body>
int run(int grid, long long smem, Body body) {
  if (grid < 1) return 0;
  emu::launch(dim3(grid), (size_t)smem, [&](unsigned char* sm) { body(sm); },
              swing::kThreads);
  return 0;
}

}  // namespace

extern "C" int swing_walk(int write, const long long* user_indptr,
                          const int* user_items, int n_users,
                          const long long* item_indptr, const int* item_users,
                          int row_begin, int row_end, int u0, int u1, int tile,
                          long long* user_pairs, long long* user_entries,
                          int* ui_count, unsigned long long* ui_adds,
                          const long long* entry_base, int* entries,
                          int* row_cursor, unsigned long long* bucket, int grid,
                          void*) {
  const swing::WalkArgs a{user_indptr, user_items, n_users, item_indptr,
                          item_users, row_begin, row_end, u0, u1, tile,
                          user_pairs, user_entries, ui_count, ui_adds,
                          entry_base, entries, row_cursor, bucket};
  const long long smem = swing::walk_smem(tile);
  if (write) return run(grid, smem, [&](unsigned char* sm) { swing::walk_body<true>(a, sm); });
  return run(grid, smem, [&](unsigned char* sm) { swing::walk_body<false>(a, sm); });
}

extern "C" int swing_rows(const int* tasks, int n_tasks,
                          const unsigned long long* bucket, const int* entries,
                          float alpha, int row_begin, int n_items, int max_cols,
                          unsigned long long* out, void*) {
  const swing::RowsArgs a{tasks, bucket, entries, alpha, row_begin, n_items, out};
  return run(n_tasks, swing::rows_smem(max_cols),
             [&](unsigned char* sm) { swing::rows_body(a, sm); });
}

extern "C" int swing_threads() { return swing::kThreads; }
