// interp_cli — command-line runner of the native jaxpr interpreter.
//
// Usage: interp_cli <program.json> <blob.bin> <io_dir>
//
// The port's copy of the JAX package's
// librecommender_tpu/serving/native_server/interp_cli.cpp, kept in step
// with it.
//
// Reads io_dir/input_<k>.bin (raw little-endian arrays matching the
// program's input decls: f32 for float inputs, i32 for int inputs) and
// writes io_dir/output_<k>.bin (f32 for float outputs, i64 otherwise)
// plus io_dir/outputs.json with shapes/dtypes. serving/native_server's
// run_program calls it; the tests hold its outputs to the port's models and
// to the JAX package's programs.
#include <chrono>
#include <cstdio>
#include <fstream>

#include "jaxpr_interp.hpp"

int main(int argc, char** argv) {
  if (argc != 4 && argc != 5) {
    std::fprintf(stderr,
                 "usage: interp_cli <program.json> <blob.bin> <io_dir> [reps]\n");
    return 2;
  }
  const int reps = argc == 5 ? std::atoi(argv[4]) : 1;
  try {
    jxi::Program prog = jxi::load_program(argv[1], argv[2]);
    const std::string io = argv[3];

    std::vector<jxi::Tensor> inputs;
    for (size_t k = 0; k < prog.main.inputs.size(); ++k) {
      const auto& d = prog.main.inputs[k];
      jxi::Tensor t;
      t.dt = d.dt;
      t.shape = d.shape;
      const std::string raw =
          jxi::read_file(io + "/input_" + std::to_string(k) + ".bin");
      const int64_t n = t.numel();
      if (t.isf()) {
        if (int64_t(raw.size()) != n * 4)
          throw std::runtime_error("input size mismatch (want f32)");
        t.f.resize(n);
        std::memcpy(t.f.data(), raw.data(), raw.size());
      } else {
        if (int64_t(raw.size()) != n * 4)
          throw std::runtime_error("input size mismatch (want i32)");
        t.i.resize(n);
        const int32_t* s = reinterpret_cast<const int32_t*>(raw.data());
        for (int64_t j = 0; j < n; ++j) t.i[j] = s[j];
      }
      inputs.push_back(std::move(t));
    }

    jxi::Executor ex(prog);
    std::vector<jxi::Tensor> outs;
    const auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r) {
      std::vector<jxi::Tensor> args = inputs;  // fresh copy per exec
      outs = ex.run(std::move(args));
    }
    if (reps > 1) {
      const double us = std::chrono::duration<double, std::micro>(
                            std::chrono::steady_clock::now() - t0)
                            .count() / reps;
      std::fprintf(stderr, "exec_us_per_rep %.1f\n", us);
    }
    if (jxi::Executor::prof_enabled()) ex.dump_profile(stderr);

    std::string meta = "[";
    for (size_t k = 0; k < outs.size(); ++k) {
      const auto& t = outs[k];
      std::ofstream f(io + "/output_" + std::to_string(k) + ".bin",
                      std::ios::binary);
      if (t.isf())
        f.write(reinterpret_cast<const char*>(t.f.data()), t.f.size() * 4);
      else
        f.write(reinterpret_cast<const char*>(t.i.data()), t.i.size() * 8);
      meta += std::string(k ? "," : "") + "{\"dtype\":\"" +
              (t.isf() ? "f32" : "i64") + "\",\"shape\":[";
      for (size_t d = 0; d < t.shape.size(); ++d)
        meta += (d ? "," : "") + std::to_string(t.shape[d]);
      meta += "]}";
    }
    meta += "]";
    std::ofstream(io + "/outputs.json") << meta;
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "interp_cli error: %s\n", e.what());
    return 1;
  }
}
