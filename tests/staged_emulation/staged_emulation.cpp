// Runs the partition and the add of librecommender_tpu_torch/csrc/
// staged_add.cuh on the CPU (cuda_names.h), for tests/test_torch_staged_emulation.py.
//
//   staged_emulation plan < queries
//     each line "N D n_rows cols seg_len groups chunk work_bytes" gives one
//     line "rc smem place_smem count_smem spill workspace_bytes nb n_chunks"
//     from staged::plan (rc 0, or the cudaError it returns).
//   staged_emulation run DIR N D n_rows cols seg_len groups chunk vec bf16
//                    ids_int64 work_bytes misalign
//     reads DIR/ids.bin (int32, or int64 with ids_int64) and DIR/rows.bin (N
//     x D float32), runs the launches of staged::ordered_add (the count
//     kernel where there is more than one chunk, the place kernel, the add,
//     the partial tables summed in segment order) and writes DIR/pos.bin,
//     DIR/sub.bin, DIR/bstart.bin (int32) and DIR/out.bin (n_rows x D
//     float32); prints "rc nb n_chunks". misalign 1 starts the rows one float
//     past a 16-byte boundary (the 4-byte copies of rows only 4-byte aligned).
//
// Build: g++ -std=c++20 -O2 -pthread -I librecommender_tpu_torch/csrc
//        tests/staged_emulation/staged_emulation.cpp -o staged_emulation
#include "cuda_names.h"
#include "staged_add.cuh"

#include <cmath>
#include <fstream>
#include <iostream>
#include <string>
#include <type_traits>

using namespace staged;

namespace {

template <class T>
std::vector<T> read(const std::string& path, size_t n) {
  std::vector<T> v(n);
  std::ifstream f(path, std::ios::binary);
  f.read(reinterpret_cast<char*>(v.data()), static_cast<std::streamsize>(n * sizeof(T)));
  if (!f && n) {
    std::fprintf(stderr, "cannot read %zu values from %s\n", n, path.c_str());
    std::exit(2);
  }
  return v;
}

template <class T>
void write(const std::string& path, const T* v, size_t n) {
  std::ofstream f(path, std::ios::binary);
  f.write(reinterpret_cast<const char*>(v), static_cast<std::streamsize>(n * sizeof(T)));
}

template <int S, bool B, bool G, int V>
void add(const Launch& l, const float* rows, int D, long long n_rows, int cols,
         int groups) {
  emu::launch(l.grid, l.smem, [&](unsigned char* sm) {
    add_body<S, B, G, V>(rows, l.pos, l.sub, l.bstart, D, n_rows, cols, groups,
                         l.row_tiles, l.dst, sm);
  });
}

template <bool B, bool G, int V>
void add_by_cols(const Launch& l, const float* rows, int D, long long n_rows,
                 int cols, int groups) {
  if (cols <= 32)
    add<1, B, G, V>(l, rows, D, n_rows, cols, groups);
  else if (cols <= 64)
    add<2, B, G, V>(l, rows, D, n_rows, cols, groups);
  else
    add<4, B, G, V>(l, rows, D, n_rows, cols, groups);
}

template <class Id>
int run(const std::string& dir, int N, int D, long long n_rows, int cols,
        int seg_len, int groups, int chunk, int vec, bool bf16,
        long long work_bytes, bool misalign) {
  const std::vector<Id> ids = read<Id>(dir + "/ids.bin", N);
  std::vector<float> storage(static_cast<size_t>(N) * D + 8);
  float* rows = storage.data() +
                (16 - reinterpret_cast<uintptr_t>(storage.data()) % 16) % 16 / 4 +
                (misalign ? 1 : 0);
  const std::vector<float> in = read<float>(dir + "/rows.bin", static_cast<size_t>(N) * D);
  std::copy(in.begin(), in.end(), rows);
  const long long segs = N > 0 ? (static_cast<long long>(N) + seg_len - 1) / seg_len : 1;
  std::vector<unsigned char> work(work_bytes > 0 ? work_bytes : 1, 0xff);
  std::vector<float> out(static_cast<size_t>(n_rows) * D, NAN);
  std::vector<float> partial(segs > 1 ? segs * out.size() : 1, NAN);
  Launch l;
  int rc = plan(N, D, n_rows, cols, seg_len, groups, chunk, work.data(),
                static_cast<size_t>(work_bytes), partial.data(), out.data(), &l);
  if (rc == cudaSuccess && vec == 4 &&
      (D % 4 || reinterpret_cast<uintptr_t>(rows) % 16))
    rc = cudaErrorInvalidValue;   // as ordered_add
  if (rc != cudaSuccess || N == 0) {
    if (rc == cudaSuccess) std::fill(out.begin(), out.end(), 0.0f);
    write(dir + "/out.bin", out.data(), out.size());
    std::printf("%d 0 0\n", rc);
    return 0;
  }
  if (l.n_chunks > 1)
    emu::launch(dim3(l.n_chunks), l.count_smem, [&](unsigned char* sm) {
      int* hist = l.count_smem ? reinterpret_cast<int*>(sm)
                               : l.counts + static_cast<long long>(blockIdx.x) * l.nb;
      count_body(ids.data(), N, n_rows, l.tile_rows, l.row_tiles, seg_len, l.nb,
                 chunk, l.counts, hist);
    });
  emu::launch(dim3(l.n_chunks), l.place_smem, [&](unsigned char* sm) {
    unsigned char* state = l.spill ? l.spill + 40LL * l.nb * blockIdx.x
                                   : sm + 13LL * chunk;
    place_body(ids.data(), N, n_rows, l.tile_rows, l.row_tiles, seg_len, l.nb,
               chunk, l.n_chunks, l.counts, l.bstart, l.pos, l.sub, sm, state);
  });
  const bool grouped = groups > 1;
  if (bf16 && grouped)
    vec == 4 ? add_by_cols<true, true, 4>(l, rows, D, n_rows, cols, groups)
             : add_by_cols<true, true, 1>(l, rows, D, n_rows, cols, groups);
  else if (bf16)
    vec == 4 ? add_by_cols<true, false, 4>(l, rows, D, n_rows, cols, groups)
             : add_by_cols<true, false, 1>(l, rows, D, n_rows, cols, groups);
  else if (grouped)
    vec == 4 ? add_by_cols<false, true, 4>(l, rows, D, n_rows, cols, groups)
             : add_by_cols<false, true, 1>(l, rows, D, n_rows, cols, groups);
  else
    vec == 4 ? add_by_cols<false, false, 4>(l, rows, D, n_rows, cols, groups)
             : add_by_cols<false, false, 1>(l, rows, D, n_rows, cols, groups);
  if (l.segs > 1) {   // sum_partials_kernel
    const size_t n = out.size();
    for (size_t i = 0; i < n; ++i) {
      float acc = partial[i];
      for (int s = 1; s < l.segs; ++s) acc += partial[s * n + i];
      out[i] = acc;
    }
  }
  const int n_valid = l.bstart[l.nb];
  write(dir + "/pos.bin", l.pos, n_valid);
  write(dir + "/sub.bin", l.sub, n_valid);
  write(dir + "/bstart.bin", l.bstart, static_cast<size_t>(l.nb) + 1);
  write(dir + "/out.bin", out.data(), out.size());
  std::printf("%d %d %d\n", rc, l.nb, l.n_chunks);
  return 0;
}

int plans() {
  long long N, D, n_rows, cols, seg_len, groups, chunk, work_bytes;
  while (std::cin >> N >> D >> n_rows >> cols >> seg_len >> groups >> chunk >> work_bytes) {
    static float partial, out;
    Launch l{};
    const int rc = plan(static_cast<int>(N), static_cast<int>(D), n_rows,
                        static_cast<int>(cols), static_cast<int>(seg_len),
                        static_cast<int>(groups), static_cast<int>(chunk),
                        &partial, static_cast<size_t>(work_bytes), &partial, &out, &l);
    const size_t ws = rc == cudaSuccess && N > 0
                          ? workspace_bytes(static_cast<int>(N), l.nb, static_cast<int>(chunk), l.n_chunks)
                          : 0;
    std::printf("%d %zu %zu %zu %d %zu %d %d\n", rc, rc ? 0 : l.smem,
                rc ? 0 : l.place_smem, rc ? 0 : l.count_smem,
                rc == cudaSuccess && l.spill != nullptr ? 1 : 0, ws,
                rc ? 0 : l.nb, rc ? 0 : l.n_chunks);
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const std::string mode = argc > 1 ? argv[1] : "";
  if (mode == "plan") return plans();
  if (mode != "run" || argc != 15) {
    std::fprintf(stderr, "usage: staged_emulation plan | run DIR N D n_rows cols "
                         "seg_len groups chunk vec bf16 ids_int64 work_bytes misalign\n");
    return 2;
  }
  const std::string dir = argv[2];
  const int N = std::stoi(argv[3]), D = std::stoi(argv[4]);
  const long long n_rows = std::stoll(argv[5]);
  const int cols = std::stoi(argv[6]), seg_len = std::stoi(argv[7]);
  const int groups = std::stoi(argv[8]), chunk = std::stoi(argv[9]);
  const int vec = std::stoi(argv[10]);
  const bool bf16 = std::stoi(argv[11]) != 0, i64 = std::stoi(argv[12]) != 0;
  const long long work_bytes = std::stoll(argv[13]);
  const bool misalign = std::stoi(argv[14]) != 0;
  return i64 ? run<long long>(dir, N, D, n_rows, cols, seg_len, groups, chunk, vec,
                              bf16, work_bytes, misalign)
             : run<int>(dir, N, D, n_rows, cols, seg_len, groups, chunk, vec, bf16,
                        work_bytes, misalign);
}
