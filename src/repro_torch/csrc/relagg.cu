// Fused filter + grouped sum/count for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/relagg/relagg.py::_relagg_kernel
// (launched by relagg_pallas): for rows r with mask[r] and 0 <= gid[r] < G,
//     out[gid[r], j] += vals[r, j]   (j < k)
//     out[gid[r], k] += 1
// into a zero-initialised (G, k+1) float32 output.  Masked rows and rows
// whose group id lies outside [0, G) add nothing, as on the TPU where such a
// row hits no one-hot column.  The TPU's one-hot (rows x G) product on the
// MXU and its 1024-row padding are not carried over: here each row adds
// into its own group's slot directly.
//
// Bound: memory, and it depends on the data.  Every mask byte is read
// (n bytes); gid only where the mask is set, vals only for selected rows
// (mask set and gid in range): n + m * 4 + s * 4k bytes read for m set
// mask bytes and s selected rows, plus G * (k+1) * 4 written.  The work is
// s * (k + 1) additions, far below the card's operations-per-byte balance.
// The kernel tests the mask before it loads gid, so a masked-off row costs
// its mask byte alone (and whatever else shares its 32-byte sectors).
//
// Design: each block zeroes a G x (k+1) accumulator in shared memory, walks
// its rows in a grid-stride loop adding with shared-memory atomics, and
// flushes every non-zero slot with one global atomicAdd.  Where the
// accumulator does not fit the shared-memory budget (high-cardinality keys,
// e.g. c_name's 150,000 codes at TPC-H SF 1), relagg_global adds straight
// into the output with global atomics.  At small G many threads hit the
// same few shared slots, so shared-atomic contention is the expected
// bottleneck; pre-aggregating within a warp before the atomics is the
// planned remedy.
//
// Counts add exact 1.0f values, so they are exact in any order below 2^24
// per group.  Value sums depend on the order the atomics land in and are
// compared with a tolerance.
//
// Plain C interface, bound with ctypes: every entry returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void relagg_shared_kernel(const int32_t* __restrict__ gid,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ vals,
                                     float* __restrict__ out,
                                     long long n, int k, int groups) {
  extern __shared__ float acc[];
  const int width = k + 1;
  const int slots = groups * width;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!mask[r]) continue;  // before gid: masked rows cost one byte
    const int g = gid[r];
    // the range guard comes before any indexing by g
    if (g >= 0 && g < groups) {
      float* slot = acc + (long long)g * width;
      const float* v = vals + r * k;
      for (int j = 0; j < k; ++j) atomicAdd(slot + j, v[j]);
      atomicAdd(slot + k, 1.0f);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const float a = acc[i];
    if (a != 0.0f) atomicAdd(out + i, a);
  }
}

__global__ void relagg_global_kernel(const int32_t* __restrict__ gid,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ vals,
                                     float* __restrict__ out,
                                     long long n, int k, int groups) {
  const int width = k + 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!mask[r]) continue;
    const int g = gid[r];
    if (g >= 0 && g < groups) {
      float* slot = out + (long long)g * width;
      const float* v = vals + r * k;
      for (int j = 0; j < k; ++j) atomicAdd(slot + j, v[j]);
      atomicAdd(slot + k, 1.0f);
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&value, attr, dev) != cudaSuccess) return 0;
  return value;
}

// Enough blocks to fill every SM `per_sm` times, and no more blocks than
// the rows need.
int grid_for(long long n, int per_sm) {
  const long long need = (n + kThreads - 1) / kThreads;
  const long long fill =
      (long long)device_attr(cudaDevAttrMultiProcessorCount) * per_sm;
  long long grid = need < fill ? need : fill;
  return grid < 1 ? 1 : (int)grid;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt in to, in bytes.
int relagg_smem_budget() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

const char* relagg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int relagg_shared(const void* gid, const void* mask, const void* vals,
                  void* out, long long n, int k, int groups, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)groups * (k + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      relagg_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, relagg_shared_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  relagg_shared_kernel<<<grid_for(n, per_sm < 1 ? 1 : per_sm), kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const uint8_t*)mask, (const float*)vals,
      (float*)out, n, k, groups);
  return (int)cudaGetLastError();
}

int relagg_global(const void* gid, const void* mask, const void* vals,
                  void* out, long long n, int k, int groups, void* stream) {
  if (n <= 0) return 0;
  relagg_global_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const uint8_t*)mask, (const float*)vals,
      (float*)out, n, k, groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
