// Forward attention with an online softmax for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas).  For q (B, Hq, Sq, D) and k, v
// (B, Hk, Sk, D), query row i of head h at absolute position
// qpos = q_offset + i attends to the keys kpos of KV head h / n_rep with
//     kpos < Sk,  kpos <= qpos (causal),  kpos > qpos - window (window),
// scores scaled by sm_scale, softmax and value product in float32, and
// the output written in q's dtype.  A row with no valid key writes 0.
// Masked scores are -1e30, as on the TPU, and their probabilities are set
// to 0 explicitly, so a tile that masks a whole row adds nothing and never
// forms exp(-inf - -inf).
//
// Bound: at the serving path's shapes (granite-3-2b prefill: D = 64, up to
// 2048 keys, bf16) the work is 4 * D operations per (query, key) pair the
// mask lets through against 2 * D * 2 bytes of q and o per query row and
// the same per key, so it is far above the card's operations-per-byte
// balance: bound by operations (989 TFLOP/s on the bf16 tensor cores).
// This first kernel does its products with float32 FMAs on the CUDA cores
// (67 TFLOP/s), so it cannot come near that bound; mma/wgmma is the next
// step.
//
// Design: one block of 256 threads per (query tile of 64 rows, query head,
// batch).  The Q tile (pre-scaled) sits in shared memory as float32; the
// block walks the 64-key tiles that some row of its tile can see (the
// causal and window limits give the first and last tile, so tiles the
// mask covers wholly are never loaded, as _flash_kernel skips them with
// pl.when), staging K and V in shared memory.  Threads form a 16 x 16
// grid: row group ty owns 4 query rows, lane tx owns key columns
// tx + 16 j of the scores and value columns tx + 16 j of the output, so
// the running max m, denominator l and the (4 x D/16) accumulator of each
// thread live in registers, and a row's max and sum reduce over the 16
// lanes of a half-warp with shuffles.  The probabilities go through
// shared memory to the value product.  Shared rows are padded by one
// float so the strided reads do not collide in banks.  GQA maps the query
// head to its KV head by index; nothing is repeated.
//
// Plain C interface, bound with ctypes: the entry returns the cudaError_t
// of its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 row groups x 16 lanes
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hk, Sq, Sk, n_rep;
  int causal, has_window, window, q_offset;
  float sm_scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int DP = D + 1;    // padded row stride of the Q and K tiles
  constexpr int PP = kBK + 1;  // padded row stride of the P tile
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // kBQ x DP
  float* Ks = Qs + kBQ * DP;   // kBK x DP
  float* Vs = Ks + kBK * DP;   // kBK x D
  float* Ps = Vs + kBK * D;    // kBQ x PP

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.n_rep;
  const int q0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, a.Sq - q0);

  const T* q = (const T*)a.q + ((size_t)(b * a.Hq + h) * a.Sq + q0) * D;
  const T* k = (const T*)a.k + (size_t)(b * a.Hk + kvh) * a.Sk * D;
  const T* v = (const T*)a.v + (size_t)(b * a.Hk + kvh) * a.Sk * D;
  T* o = (T*)a.o + ((size_t)(b * a.Hq + h) * a.Sq + q0) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[r * DP + d] = r < rows ? to_f32(q[(size_t)r * D + d]) * a.sm_scale : 0.f;
  }

  // the keys that some valid row of this tile may see
  const int qpos_first = a.q_offset + q0;
  const int qpos_last = a.q_offset + q0 + rows - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, qpos_last + 1);
  int k_begin = 0;
  if (a.has_window) k_begin = max(0, qpos_first - a.window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Qs written; the last tile's Ks, Vs, Ps read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < a.Sk;
      Ks[r * DP + d] = in ? to_f32(k[(size_t)(k0 + r) * D + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(v[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = a.q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool valid = kpos < a.Sk;
        if (a.causal) valid = valid && kpos <= qpos;
        if (a.has_window) valid = valid && kpos > qpos - a.window;
        ok[j] = valid;
        if (!valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(o + (size_t)r * D + tx + 16 * j, acc[i][j] / safe_l);
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike); D: 16, 64 or 128
// (granite-3-2b's 64, MLA's padded 128, and the smoke configs' 16).
// All four tensors are contiguous.  window is read only when has_window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hk, int Sq, int Sk, int D,
                        int dtype, int causal, int has_window, int window,
                        int q_offset, float sm_scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hk <= 0 || Hq % Hk != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, Hq, Hk, Sq, Sk, Hq / Hk,
         causal, has_window, window, q_offset, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype * 1000 + D) {
    case 16: return launch<float, 16>(a, B, s);
    case 64: return launch<float, 64>(a, B, s);
    case 128: return launch<float, 128>(a, B, s);
    case 1016: return launch<__nv_bfloat16, 16>(a, B, s);
    case 1064: return launch<__nv_bfloat16, 64>(a, B, s);
    case 1128: return launch<__nv_bfloat16, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
