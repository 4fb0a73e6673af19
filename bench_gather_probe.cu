// Probe kernels for `bench_torch_staged.py --gather`, which builds this file
// with nvcc (sm_90a) and times each probe by torch.profiler beside the
// table gather of librecommender_tpu_torch (csrc/table_gather.cu):
// - probe_empty: an empty kernel at the gather's grid, the floor that the
//   launch and the grid's ramp set;
// - probe_fill: the gather's (B, D) output written with 16-byte stores at
//   the gather's grid and nothing read, the floor that its stores set;
// - probe_parent_copy, probe_parent_loads_first, probe_parent_no_id: the
//   first gather's body (one warp an output row, 8 warps a block) as it was,
//   with each row's loads all issued before its stores (one round trip for
//   the row after the one for its id), and with the id taken as b % R
//   instead of loaded (no id round trip). They split the first body's time
//   along its chain of dependent memory accesses. D <= 128.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void probe_empty() {}

__global__ void probe_fill(float4* __restrict__ out, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride)
    out[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void zero_row(float* dst, int D, int lane) {
  for (int d = lane; d < D; d += 32) dst[d] = 0.0f;
}

__global__ void __launch_bounds__(256)
    probe_parent_copy(const float* __restrict__ table, const int* __restrict__ ids,
                      long long R, int B, int D, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const long long id = ids[b];
  float* dst = out + b * D;
  if (id < 0 || id >= R) return zero_row(dst, D, lane);
  const float* src = table + id * D;
  for (int d = lane; d < D; d += 32) dst[d] = src[d];
}

template <bool kLoadId>
__device__ __forceinline__ void loads_first(const float* __restrict__ table,
                                            const int* __restrict__ ids,
                                            long long R, int B, int D,
                                            float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const long long id = kLoadId ? (long long)ids[b] : b % R;
  float* dst = out + b * D;
  if (id < 0 || id >= R) return zero_row(dst, D, lane);
  const float* src = table + id * D;
  float v[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) v[p] = lane + 32 * p < D ? src[lane + 32 * p] : 0.0f;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (lane + 32 * p < D) dst[lane + 32 * p] = v[p];
}

__global__ void __launch_bounds__(256)
    probe_parent_loads_first(const float* __restrict__ table,
                             const int* __restrict__ ids, long long R, int B,
                             int D, float* __restrict__ out) {
  loads_first<true>(table, ids, R, B, D, out);
}

__global__ void __launch_bounds__(256)
    probe_parent_no_id(const float* __restrict__ table, const int* __restrict__ ids,
                       long long R, int B, int D, float* __restrict__ out) {
  loads_first<false>(table, ids, R, B, D, out);
}

}  // namespace

extern "C" {

// kind 0: probe_empty at (grid, threads); 1: probe_fill of out's B x D
// floats at (grid, threads); 2, 3, 4: probe_parent_copy, _loads_first,
// _no_id over int32 ids at the first body's grid (grid and threads unused;
// D <= 128). Returns the launch's cudaError_t.
int probe_launch(int kind, int grid, int threads, const float* table,
                 const int* ids, long long R, int B, int D, float* out,
                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int parent_grid = (B + kWarps - 1) / kWarps;
  switch (kind) {
    case 0:
      probe_empty<<<grid, threads, 0, stream>>>();
      break;
    case 1:
      probe_fill<<<grid, threads, 0, stream>>>(reinterpret_cast<float4*>(out),
                                               (long long)B * D / 4);
      break;
    case 2:
      probe_parent_copy<<<parent_grid, 256, 0, stream>>>(table, ids, R, B, D, out);
      break;
    case 3:
      probe_parent_loads_first<<<parent_grid, 256, 0, stream>>>(table, ids, R, B, D, out);
      break;
    case 4:
      probe_parent_no_id<<<parent_grid, 256, 0, stream>>>(table, ids, R, B, D, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
