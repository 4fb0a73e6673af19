// Runs the table gather's body of librecommender_tpu_torch/csrc/gather_rows.cuh
// on the CPU (cuda_names.h), for tests/test_torch_gather_emulation.py.
//
//   gather_emulation plan < queries
//     each line "R B D sms" gives one line "rc grid vectors tail batch" from
//     gather::plan (rc 0, or the cudaError it returns).
//   gather_emulation run DIR R B D sms ids_int64 misalign
//     reads DIR/ids.bin (B int32, or int64 with ids_int64) and DIR/table.bin
//     (R x D float32), runs gather_kernel's launch (gather::plan on a card of
//     `sms` multiprocessors, then the body in every block) and writes
//     DIR/out.bin (B x D float32); prints "rc grid form batch". misalign 1
//     starts the table one float past a 16-byte boundary (4-byte loads at
//     any D).
//
// Build: g++ -std=c++20 -O2 -pthread -I librecommender_tpu_torch/csrc
//        tests/staged_emulation/gather_emulation.cpp -o gather_emulation
#include "cuda_names.h"
#include "gather_rows.cuh"

#include <cmath>
#include <fstream>
#include <iostream>
#include <string>

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

// a float buffer of n values starting `shift` floats past a 16-byte boundary
struct Floats {
  std::vector<float> storage;
  float* data;
  Floats(size_t n, int shift, float fill) : storage(n + 8, fill) {
    data = storage.data() +
           (16 - reinterpret_cast<uintptr_t>(storage.data()) % 16) % 16 / 4 + shift;
  }
};

template <class Id, int kIn>
void body_of(const gather::Launch& l, const float* table, const Id* ids,
             long long R, int D, float* out) {
  if (l.form == gather::kRow16)
    gather::body<Id, gather::kRow16, kIn>(table, ids, R, D, l, out);
  else if (l.form == gather::kTwoRows)
    gather::body<Id, gather::kTwoRows, kIn>(table, ids, R, D, l, out);
  else
    gather::body<Id, gather::kFourRows, kIn>(table, ids, R, D, l, out);
}

template <class Id>
int run(const std::string& dir, long long R, int B, int D, int sms, bool misalign) {
  const std::vector<Id> ids = read<Id>(dir + "/ids.bin", B);
  const std::vector<float> in = read<float>(dir + "/table.bin", static_cast<size_t>(R) * D);
  Floats table(in.size(), misalign ? 1 : 0, 0.0f);
  std::copy(in.begin(), in.end(), table.data);
  Floats out(static_cast<size_t>(B) * D, 0, NAN);
  gather::Launch l;
  const int rc = gather::plan(R, B, D, table.data, out.data, sms, &l);
  if (rc == cudaSuccess && B > 0)
    emu::launch(
        dim3(l.grid), 0,
        [&](unsigned char*) {
          if (l.batch == 1) body_of<Id, 1>(l, table.data, ids.data(), R, D, out.data);
          else body_of<Id, gather::kBatch>(l, table.data, ids.data(), R, D, out.data);
        },
        gather::kThreads);
  std::ofstream f(dir + "/out.bin", std::ios::binary);
  f.write(reinterpret_cast<const char*>(out.data),
          static_cast<std::streamsize>(static_cast<size_t>(B) * D * sizeof(float)));
  std::printf("%d %u %d %d\n", rc, l.grid, l.form, l.batch);
  return 0;
}

int plans() {
  long long R, B, D, sms;
  alignas(16) static float table[4], out[4];
  while (std::cin >> R >> B >> D >> sms) {
    gather::Launch l;
    const int rc = gather::plan(R, static_cast<int>(B), static_cast<int>(D), table,
                                out, static_cast<int>(sms), &l);
    std::printf("%d %u %u %d %d\n", rc, rc ? 0 : l.grid, rc ? 0 : l.vectors,
                rc ? 0 : l.tail, rc ? 0 : l.batch);
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const std::string mode = argc > 1 ? argv[1] : "";
  if (mode == "plan") return plans();
  if (mode != "run" || argc != 9) {
    std::fprintf(stderr, "usage: gather_emulation plan | run DIR R B D sms "
                         "ids_int64 misalign\n");
    return 2;
  }
  const std::string dir = argv[2];
  const long long R = std::stoll(argv[3]);
  const int B = std::stoi(argv[4]), D = std::stoi(argv[5]), sms = std::stoi(argv[6]);
  const bool i64 = std::stoi(argv[7]) != 0, misalign = std::stoi(argv[8]) != 0;
  return i64 ? run<long long>(dir, R, B, D, sms, misalign)
             : run<int>(dir, R, B, D, sms, misalign);
}
