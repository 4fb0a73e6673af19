// The table gather's body, for sm_90a: out (B, D) = table (R, D) rows at ids
// (B,), exact, a zero row for an id outside [0, R). `gather_kernel`
// (table_gather.cu) runs it; it replaces
// librecommender_tpu/ops/mxu_gather.py `_gather_kernel`.
//
// What bounds it on an H100: bytes in principle (it reads B ids and the
// table rows they touch and writes B * D floats, with no arithmetic), but at
// the training paths' shapes (2-8 MB of output) the grid's launch, the
// latency of two dependent memory round trips (a row is read only after its
// id has arrived) and the instructions issued before the first store. The
// first body ran one warp an output row: a grid of B / 8 blocks (an empty
// kernel at DIN's 4096 blocks alone takes 71% of that body's time), a
// round trip for each 32 columns of a row, and 4-byte accesses.
//
// Design:
// - The output is one contiguous (B, D) array whose every 4 rows start on a
//   16-byte boundary, whatever D. So a thread takes whole 16-byte vectors of
//   it, vector v = floats 4v .. 4v + 3, and writes each with one 16-byte
//   store; neighbouring threads write neighbouring vectors, for D = 65 as
//   for D = 64.
// - The grid is sized to the card: one block of kThreads for each kThreads
//   vectors, at most kBlocksPerSm blocks a multiprocessor, which stride over
//   the rest (BPR's 8192 x 65 lookup: one vector a thread in 520 blocks;
//   DIN's 32,768 x 64: four a thread in 528, on 132 SMs).
// - A thread has one vector or kBatch in flight and issues their accesses
//   by kind: every id first, then every table load, then every store, so
//   each value waits on two round trips in all.
// - Few instructions a vector: a thread finds its first vector's row and
//   column with one division and moves on by the grid's step (rows and
//   columns, from the host's plan).
// - Where D % 4 == 0 and the table is 16-byte aligned (DIN's D = 64) a
//   vector is 16 bytes of one table row, read with one 16-byte load; else
//   (BPR's D = 65, a view one float past a boundary) with four 4-byte
//   loads from at most two rows (D >= 4), or from up to four (D < 4).
// - An id outside [0, R) loads nothing and gives zeros. The B * D % 4 floats
//   after the last whole vector are written by block 0, one a thread, after
//   its vectors.
// A table small enough for shared memory (DIN's 16 x 64) is read through L1
// like any other: its values wait on the id's round trip either way.
//
// A host build of the body (a CPU emulation that runs one thread per CUDA
// thread) defines STAGED_EMULATION and supplies the device names and the
// 16-byte accesses, which abort there on an address that is not 16-byte
// aligned.
#pragma once
#ifndef STAGED_EMULATION
#include <cstdint>
#include <cuda_runtime.h>
#endif

namespace gather {

constexpr int kThreads = 256;     // a block's threads
constexpr int kBatch = 4;         // vectors a thread has in flight, where it has more than one
constexpr int kBlocksPerSm = 4;   // the grid's blocks a multiprocessor, at most

// How a vector's table values are read: one 16-byte load (D % 4 == 0, the
// table 16-byte aligned); four 4-byte loads from at most two rows (D >= 4);
// four from up to four rows (D < 4).
enum Form { kRow16 = 0, kTwoRows = 1, kFourRows = 2 };

#ifndef STAGED_EMULATION
__device__ __forceinline__ float4 load16(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store16(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
#endif

struct Launch {
  unsigned grid = 0;       // blocks of kThreads
  int batch = 1;           // vectors a thread has in flight: 1 or kBatch
  int form = kRow16;
  unsigned vectors = 0;    // whole 16-byte vectors of output, B * D / 4
  int tail = 0;            // floats after them, B * D % 4
  unsigned unit = 0;       // a row's vectors (kRow16), else its floats
  unsigned q = 0, r = 0;   // the grid's step over the output in rows and units
};

// The launch of a gather of B ids into an (R, D) table on a card of `sms`
// multiprocessors (ops/table_gather.gather_plan mirrors it): the output
// must be 16-byte aligned and hold fewer than 2^31 vectors, a row fewer
// than 2^29 floats (the body's indices are 32-bit).
inline cudaError_t plan(long long R, int B, int D, const void* table,
                        const void* out, int sms, Launch* l) {
  if (R < 1 || B < 0 || D < 1 || D >= (1 << 29) || sms < 1)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(B) * D;
  if (n / 4 >= (1LL << 31) || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  l->vectors = static_cast<unsigned>(n / 4);
  l->tail = static_cast<int>(n % 4);
  l->form = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
                ? kRow16
                : (D >= 4 ? kTwoRows : kFourRows);
  const long long want = (static_cast<long long>(l->vectors) + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  l->grid = static_cast<unsigned>(want < 1 ? 1 : (want < most ? want : most));
  const unsigned stride = l->grid * kThreads;
  l->batch = l->vectors > stride ? kBatch : 1;
  l->unit = l->form == kRow16 ? D / 4 : D;
  const unsigned step = l->form == kRow16 ? stride : 4 * stride;
  l->q = step / l->unit;
  l->r = step % l->unit;
  return cudaSuccess;
}

// (b, c) moved on by the grid's step: q rows and r units
__device__ __forceinline__ void advance(unsigned& b, unsigned& c, const Launch& l) {
  b += l.q;
  c += l.r;
  if (c >= l.unit) {
    c -= l.unit;
    ++b;
  }
}

__device__ __forceinline__ bool in_table(long long id, long long R) {
  return static_cast<unsigned long long>(id) < static_cast<unsigned long long>(R);
}

// The ids of the vector whose first float is row b, column c (in vectors
// for kRow16, else in floats) of the output: its row's (lo), and the next
// row's where the vector runs into it (hi; kTwoRows). -1 where the vector
// is past the output (`in` false). kFourRows loads its ids with its values.
template <typename Id, int kForm>
__device__ __forceinline__ void ids_of(const Id* __restrict__ ids, int D,
                                       unsigned b, unsigned c, bool in,
                                       long long* lo, long long* hi) {
  *lo = in && kForm != kFourRows ? static_cast<long long>(ids[b]) : -1;
  *hi = kForm == kTwoRows && in && c + 3 >= static_cast<unsigned>(D)
            ? static_cast<long long>(ids[b + 1]) : *lo;
}

// The vector's values from its ids (zeros for an id outside [0, R)).
template <typename Id, int kForm>
__device__ __forceinline__ float4 values_of(const float* __restrict__ table,
                                            const Id* __restrict__ ids,
                                            long long R, int D, unsigned b,
                                            unsigned c, bool in, long long lo,
                                            long long hi) {
  if (kForm == kRow16)
    return in_table(lo, R) ? load16(table + lo * D + 4 * c)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float x[4];
  if (kForm == kTwoRows) {
    const bool ok_lo = in_table(lo, R), ok_hi = in_table(hi, R);
    const float* p_lo = table + (ok_lo ? lo : 0) * D + c;
    const float* p_hi = table + (ok_hi ? hi : 0) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = c + j < static_cast<unsigned>(D) ? (ok_lo ? p_lo[j] : 0.0f)
                                               : (ok_hi ? p_hi[c + j - D] : 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned row = b, col = c + j;
      while (col >= static_cast<unsigned>(D)) {
        col -= D;
        ++row;
      }
      const long long id = in ? static_cast<long long>(ids[row]) : -1;
      x[j] = in_table(id, R) ? table[id * D + col] : 0.0f;
    }
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

template <typename Id, int kForm, int kIn>
__device__ __forceinline__ void body(const float* __restrict__ table,
                                     const Id* __restrict__ ids, long long R,
                                     int D, Launch l,
                                     float* __restrict__ out) {
  const unsigned stride = gridDim.x * kThreads;
  unsigned v0 = blockIdx.x * kThreads + threadIdx.x;
  // row and column of the thread's first vector: one division a thread
  const unsigned e0 = kForm == kRow16 ? v0 : 4 * v0;
  unsigned b = e0 / l.unit, c = e0 - b * l.unit;
  for (; v0 < l.vectors; v0 += kIn * stride) {
    unsigned bk[kIn], ck[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      bk[k] = b;
      ck[k] = c;
      advance(b, c, l);
    }
    long long lo[kIn], hi[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k)   // every id first
      ids_of<Id, kForm>(ids, D, bk[k], ck[k], v0 + k * stride < l.vectors,
                        &lo[k], &hi[k]);
    float4 val[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k)   // then every table value
      val[k] = values_of<Id, kForm>(table, ids, R, D, bk[k], ck[k],
                                    v0 + k * stride < l.vectors, lo[k], hi[k]);
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      if (v0 + k * stride < l.vectors)
        store16(out + 4 * static_cast<size_t>(v0 + k * stride), val[k]);
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < l.tail) {
    const long long e = 4LL * l.vectors + threadIdx.x;
    const long long row = e / D;
    const long long id = static_cast<long long>(ids[row]);
    out[e] = in_table(id, R) ? table[id * D + (e - row * D)] : 0.0f;
  }
}

}  // namespace gather
