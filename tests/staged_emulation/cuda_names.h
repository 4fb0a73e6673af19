// Host stand-ins for the CUDA names that librecommender_tpu_torch/csrc/
// staged_add.cuh uses, so that its partition and add bodies build with g++
// (-std=c++20 -pthread) and run on the CPU: one std::thread per CUDA thread,
// a std::barrier for __syncthreads and one a warp for the warp collectives.
// A cp.async copy lands at the wait that covers its group (the latest a
// card may land it), so a read of shared memory that races a copy reads
// stale bytes here as it could there. Include this before the header.
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define STAGED_EMULATION
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
inline thread_local dim3 threadIdx, blockIdx;

namespace emu {
constexpr int kThreads = 512;   // staged::kThreads
struct Warp {
  std::barrier<> bar{32};
  int64_t v[32];
};
inline std::unique_ptr<std::barrier<>> block;
inline std::vector<std::unique_ptr<Warp>> warps;
inline Warp& warp() { return *warps[threadIdx.x / 32]; }
inline int lane() { return threadIdx.x % 32; }
// every lane's value of v in turn, then lane src's
template <class T>
inline T exchange(T v, int src) {
  Warp& w = warp();
  int64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  w.v[lane()] = raw;
  w.bar.arrive_and_wait();
  const int64_t got = w.v[src];
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
// the lanes whose value equals f(lane's value) (warp-wide, same in every lane)
template <class F>
inline unsigned lanes_where(int64_t v, F f) {
  Warp& w = warp();
  w.v[lane()] = v;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (f(w.v[i])) m |= 1u << i;
  w.bar.arrive_and_wait();
  return m;
}
struct Copy {
  void* to;
  const void* from;
  int bytes;
};
inline thread_local std::vector<std::vector<Copy>> groups;
inline thread_local std::vector<Copy> open;
inline void copy(void* to, const void* from, int bytes) {
  if (reinterpret_cast<uintptr_t>(to) % bytes || reinterpret_cast<uintptr_t>(from) % bytes) {
    std::fprintf(stderr, "misaligned %d-byte cp.async\n", bytes);
    std::abort();
  }
  open.push_back({to, from, bytes});
}

// body(shared memory) for every block of grid, kThreads threads each, with
// `smem_bytes` of shared memory filled with 0xff before each block
inline void launch(dim3 grid, size_t smem_bytes,
                   const std::function<void(unsigned char*)>& body) {
  block = std::make_unique<std::barrier<>>(kThreads);
  warps.clear();
  for (int i = 0; i < kThreads / 32; ++i) warps.push_back(std::make_unique<Warp>());
  std::vector<unsigned char> smem(smem_bytes + 16);
  unsigned char* base = smem.data() + (16 - reinterpret_cast<uintptr_t>(smem.data()) % 16) % 16;
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = dim3(x, y, z);
            if (t == 0) std::memset(base, 0xff, smem_bytes);
            block->arrive_and_wait();
            body(base);
            if (!open.empty()) {
              std::fprintf(stderr, "cp.async copies never committed\n");
              std::abort();
            }
            for (auto& g : groups)
              for (auto& c : g) std::memcpy(c.to, c.from, c.bytes);
            groups.clear();
            block->arrive_and_wait();
          }
    });
  for (auto& t : threads) t.join();
}
}  // namespace emu

inline void __syncthreads() { emu::block->arrive_and_wait(); }
inline void __syncwarp() { emu::warp().bar.arrive_and_wait(); }
template <class T>
inline T __shfl_sync(unsigned, T v, int src) { return emu::exchange(v, src & 31); }
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  const int src = emu::lane() - d;
  const T got = emu::exchange(v, src < 0 ? emu::lane() : src);
  return src < 0 ? v : got;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return emu::lanes_where(pred ? 1 : 0, [](int64_t x) { return x != 0; });
}
inline unsigned __match_any_sync(unsigned, int v) {
  return emu::lanes_where(v, [v](int64_t x) { return x == v; });
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}

namespace staged {
// bf16 round to nearest even, as __float2bfloat16_rn (NaN stays NaN)
inline float round_bf16(float x) {
  uint32_t b;
  std::memcpy(&b, &x, 4);
  if ((b & 0x7f800000u) == 0x7f800000u)
    b = (b & 0xffff0000u) | ((b & 0x7fffffu) ? 0x400000u : 0u);
  else
    b = (b + 0x7fffu + ((b >> 16) & 1u)) & 0xffff0000u;
  float r;
  std::memcpy(&r, &b, 4);
  return r;
}
inline void cp_async16(void* to, const void* from) { emu::copy(to, from, 16); }
inline void cp_async4(void* to, const void* from) { emu::copy(to, from, 4); }
inline void cp_async_commit() {
  emu::groups.push_back(std::move(emu::open));
  emu::open.clear();
}
// every group but the newest kPending has landed
template <int kPending>
inline void cp_async_wait() {
  while (static_cast<int>(emu::groups.size()) > kPending) {
    for (auto& c : emu::groups.front()) std::memcpy(c.to, c.from, c.bytes);
    emu::groups.erase(emu::groups.begin());
  }
}
}  // namespace staged
