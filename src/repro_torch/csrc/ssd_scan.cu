// Mamba-2 SSD scan by chunks for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel
// (launched by ssd_scan_pallas).  Per head bh, with its B and C read from
// group g = bh / n_rep, it computes the recurrence
//     S_t = exp(dtA_t) S_{t-1} + B_t (x) xdt_t,      y_t = C_t . S_t
// chunk by chunk (chunk length Q, cum = inclusive cumsum of dtA in the
// chunk):
//     y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//            + exp(cum_i) C_i . S
//     S   <- exp(cum_end) S + sum_j B_j (x) xdt_j exp(cum_end - cum_j)
// with S the (N, P) float32 state carried from chunk to chunk.  Every
// exponent is <= 0 (A < 0, dt > 0), and the kernel keeps the
// exp(cum_i - cum_j) form: exp(cum_i) / exp(cum_j) would under- and
// overflow.  The function is the same for any chunk length up to
// rounding, so the kernel takes its own, Q = 64: the reference's Q = 128
// needs ~265 KB of shared memory at N = 128, P = 64, over the 227 KB a
// block may opt in to, while Q = 64 fits every config in the repo
// (jamba's P = N = 128 at ~181 KB; ssd_scan_smem_bytes).  L need not be a
// multiple of Q: rows past L load as zeros (dtA = 0 leaves cum_end at the
// last real row) and are not written.
//
// Bound: the least work the function needs is that of the per-step
// recurrence (chunk 1), ~4 N P operations per row of a head; a chunk of Q
// adds its lower triangle, ~(Q + 1) (P + N / n_rep) per row (C B^T depends
// on the group, not the head).  Against that, 2 P + 1 floats of xdt, dtA
// and y per row (B and C once per group).  At the serving path's shapes
// (mamba2-370m prefill: N = 128, P = 64, one group for 32 heads, 1,819
// rows) that is 7.66 GFLOP against 128 MB: operations, at the float32 rate
// of the CUDA cores (67 TFLOP/s; the reference's float32 tolerance rules
// out TF32), 0.114 ms.  This kernel's chunk of 64 does ~1.1x that work.
//
// Design: one block of 256 threads per head bh (B * H blocks), walking its
// chunks in order, since chunk c needs the state after chunk c - 1 (the
// TPU kernel's sequential grid axis becomes this loop).  The state, the
// chunk's xdt, B, C, cum and the masked (C B^T o decay) scores all sit in
// shared memory; each phase (scores, outputs, state update) gives every
// thread independent output elements, so no atomics.  B and C rows are
// padded by one float so the column walks do not collide in banks.  Only
// the lower triangle of the scores is computed, but each of the n_rep
// heads of a group computes the same C B^T again (32 heads at
// mamba2-370m, ~1.2x the operations the function needs there).
//
// Plain C interface, bound with ctypes: the entry returns the cudaError_t
// of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;

size_t smem_bytes(int P, int N) {
  const size_t Q = kChunk;
  return sizeof(float) * ((size_t)N * P + Q * P + 2 * Q * (N + 1) +
                          Q * (Q + 1) + 2 * Q);
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ dtA,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ y, int L, int P, int N, int n_rep,
                    int Q) {
  // Q (always kChunk) is an argument, not a constant: compiled with a
  // constant Q the kernel ran ~1.4x slower on the H100 (PERF.md)
  extern __shared__ float smem[];
  const int NP = N + 1;
  const int QP = Q + 1;
  float* S = smem;           // N x P, the carried state
  float* X = S + N * P;      // Q x P
  float* Bs = X + Q * P;     // Q x NP
  float* Cs = Bs + Q * NP;   // Q x NP
  float* G = Cs + Q * NP;    // Q x QP, (C B^T o decay), lower triangle
  float* cum = G + Q * QP;   // Q
  float* w = cum + Q;        // Q, exp(cum_end - cum_j)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int g = bh / n_rep;
  const float* x = xdt + (size_t)bh * L * P;
  const float* a = dtA + (size_t)bh * L;
  const float* Bg = Bm + (size_t)g * L * N;
  const float* Cg = Cm + (size_t)g * L * N;
  float* yo = y + (size_t)bh * L * P;

  for (int e = tid; e < N * P; e += kThreads) S[e] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);
    __syncthreads();  // the last chunk's reads of X, Bs, Cs, G, cum, w done
    for (int e = tid; e < Q * P; e += kThreads) {
      const int r = e / P;
      X[e] = r < rows ? x[(size_t)c0 * P + e] : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int r = e / N, n = e % N;
      const bool in = r < rows;
      Bs[r * NP + n] = in ? Bg[(size_t)(c0 + r) * N + n] : 0.f;
      Cs[r * NP + n] = in ? Cg[(size_t)(c0 + r) * N + n] : 0.f;
    }
    if (tid < 32) {
      // inclusive prefix sum of dtA over the chunk: each lane sums a run of
      // consecutive entries, then the lanes scan their run totals
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += c0 + i < L ? a[c0 + i] : 0.f;
        cum[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += base;
    }
    __syncthreads();

    const float cend = cum[Q - 1];
    for (int e = tid; e < Q; e += kThreads) w[e] = expf(cend - cum[e]);
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e % Q;
      float s = 0.f;
      if (j <= i && i < rows) {
        for (int n = 0; n < N; ++n) s = fmaf(Cs[i * NP + n], Bs[j * NP + n], s);
        s *= expf(cum[i] - cum[j]);
      }
      G[i * QP + j] = s;
    }
    __syncthreads();

    for (int e = tid; e < rows * P; e += kThreads) {
      const int i = e / P, p = e % P;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(G[i * QP + j], X[j * P + p], acc);
      float st = 0.f;
      for (int n = 0; n < N; ++n) st = fmaf(Cs[i * NP + n], S[n * P + p], st);
      yo[(size_t)(c0 + i) * P + p] = acc + expf(cum[i]) * st;
    }
    __syncthreads();  // every read of S for this chunk's outputs done

    if (c0 + Q < L) {
      const float dend = expf(cend);
      for (int e = tid; e < N * P; e += kThreads) {
        const int n = e / P, p = e % P;
        float acc = 0.f;
        for (int j = 0; j < rows; ++j)
          acc = fmaf(Bs[j * NP + n], X[j * P + p] * w[j], acc);
        S[e] = dend * S[e] + acc;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The chunk length the kernel takes; the shared memory a block needs at
// head dim P and state dim N; the most a block may opt in to on the
// current device (0 if it cannot be read).
int ssd_scan_chunk() { return kChunk; }
size_t ssd_scan_smem_bytes(int P, int N) { return smem_bytes(P, N); }
int ssd_scan_smem_optin() {
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return value;
}

// xdt (BH, L, P), dtA (BH, L), B and C (BG, L, N), y (BH, L, P): float32,
// contiguous; BH == BG * n_rep.
int ssd_scan_fwd(const void* xdt, const void* dtA, const void* B, const void* C,
                 void* y, int BH, int L, int P, int N, int n_rep,
                 void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  if (P <= 0 || N <= 0 || n_rep <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<BH, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xdt, (const float*)dtA, (const float*)B, (const float*)C,
      (float*)y, L, P, N, n_rep, kChunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
