// Mamba-2 SSD scan for Hopper (sm_90a), as the chunk-parallel SSD
// algorithm of the Mamba-2 paper (arXiv 2405.21060, the hardware-efficient
// SSD algorithm: intra-chunk outputs, chunk states, state passing,
// state-to-output).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel
// (launched by ssd_scan_pallas).  Per head bh, with its B and C read from
// group g = bh / n_rep, the function is the recurrence
//     S_t = exp(dtA_t) S_{t-1} + B_t (x) xdt_t,      y_t = C_t . S_t
// with S an (N, P) float32 state.  Cut into chunks of Q = 64 rows, with cum
// the inclusive cumsum of dtA restarted at every chunk,
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//           + exp(cum_i) C_i . S_in[c]
//     S_in[c+1] = exp(cum_end) S_in[c] + sum_j B_j (x) xdt_j exp(cum_end - cum_j)
// Every exponent is <= 0 (A < 0, dt > 0) and stays a difference, as in
// the reference: exp(cum_i) / exp(cum_j) would under- and overflow.  L need
// not be a multiple of Q: rows past L load as zeros and are not written.
//
// Four kernels, launched in order on one stream by the binding, which
// allocates every scratch buffer (the kernels allocate nothing).  The
// grid's x axis walks the chunks (or a head's state tiles) fastest and then
// the heads (or groups), x = c + n_chunks * bh, so that any number of heads
// runs (the y and z axes stop at 65,535 blocks):
//   1. ssd_chunk_cb, grid (n_chunks x BG): the lower triangle of C_c B_c^T,
//      once per (batch x group, chunk), not once per head, into
//      cbt (BG, n_chunks, Q, Q), stored transposed ([j][i]) for pass 4.
//   2. ssd_chunk_state, grid ((n_chunks - 1) x BH, N/64 x P/64 tiles): each
//      chunk's own end state sum_j B_j (x) xdt_j exp(cum_end - cum_j) into
//      states (BH, n_chunks - 1, N, P), and its decay exp(cum_end) into
//      decay (BH, n_chunks - 1).  The last chunk's state is never read.
//   3. ssd_state_pass, grid (N P / 1024 x BH): walks the chunks in order,
//      4 state elements a thread, and rewrites states in place with the
//      state after each chunk: S <- decay_c S + states[c]; states[c] <- S.
//   4. ssd_chunk_out, grid (n_chunks x BH, P/64): y_c = (CB o exp(cum_i -
//      cum_j) o tri) xdt_c + (exp(cum_i) C_c) S_in[c], one product of K =
//      Q + N; chunk 0 has no state term.
// Passes 2 and 4 recompute their chunk's 64-entry cumsum from dtA (one warp,
// 256 bytes) instead of reading one back: the same cost, and no (BH, L)
// buffer.  Passes 3 and 4 stay apart: fused, the blocks of a head would
// walk its chunks in order, 128 blocks for 132 SMs at mamba2-370m's
// prefill.
//
// Inside passes 1, 2 and 4, a block of 256 threads computes a 64 x 64
// output tile from two 64 x 64 operand tiles in shared memory, both laid
// out k-major, each thread a 4 x 4 register tile: one float4 of each
// operand feeds 16 FMAs, and a warp's 4 x 8 threads read 4 and 8 distinct
// float4s, so shared memory does not set the pace.  Global loads are
// float4 (P and N multiples of 4); where a block loops over K (pass 1's N,
// pass 4's scores then state) the next tile's loads are issued into
// registers before the current tile's products.  Float32 FFMA on the CUDA
// cores: the reference's float32 tolerance (3e-4 of max|y|) rules out
// plain TF32.
//
// Q = 64 fixes the tiles (two 16 KB operand tiles a block, ~33 KB of
// static shared memory whatever P and N are, so no shape needs more than a
// block may have) and the chunk-local work.  A Q of 128 would halve the
// state scratch but double the triangle and need 128-row tiles.
//
// Scratch at mamba2-370m's first prefill batch (BH 128, BG 4, L 1,819,
// P 64, N 128; 29 chunks): states 4 x 128 x 28 x 128 x 64 B = 117.4 MB,
// written by pass 2, read and rewritten by pass 3, read by pass 4 (470 MB
// of traffic the bound does not count); cbt 1.9 MB, which stays in L2.
//
// Bound: the least work the function needs is the per-step recurrence's,
// ~4 N P operations a row of a head; 7.66 GFLOP at that batch, 0.114 ms at
// the CUDA cores' float32 rate of 67 TFLOP/s (chip_smoke.py, ssd_bound).
// These passes do ~8.9 GFLOP (the chunks' triangles, skipped by warp
// above the diagonal) and move ~0.6 GB (~0.18 ms at 3.35 TB/s).  What holds
// them above that on the H100 (chip_smoke.py's split by pass, PERF.md):
// passes 2 and 4, whose products run at a third to two fifths of the float32
// rate, and pass 3, which runs near the memory rate.  Thread tiles of 8 x 8
// and of 16 x 8, and a cp.async pipeline through persistent blocks, were
// tried for passes 2 and 4 and gained at most a few per cent: not kept.
// Tensor cores (3xTF32, to keep float32 accuracy) are the next step.
//
// Plain C interface, bound with ctypes: each entry returns the cudaError_t
// of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // Q
constexpr int kTile = 64;   // the edge of a block's output and operand tiles
constexpr int kStateDepth = 8;  // loads in flight a thread in pass 3
static_assert(kChunk == 2 * 32, "one warp scans a chunk, two entries a lane");
static_assert(kChunk == kTile, "a chunk is one operand tile deep");

// A thread's place in a 64 x 64 output tile: 16 x 16 threads of 4 x 4
// outputs; warp w covers rows 16 (w / 2) .. + 15 and columns 32 (w % 2) ..
// + 31 (4 x 8 threads).
__device__ __forceinline__ int tile_row(int tid) {
  return ((tid >> 5) >> 1) * 4 + ((tid & 31) >> 3);
}
__device__ __forceinline__ int tile_col(int tid) {
  return ((tid >> 5) & 1) * 8 + (tid & 7);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[a][b] += sum_{k < k_end} As[k][4 tm + a] * Bs[k][4 tn + b]
__device__ __forceinline__ void tile_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs, int k_end,
                                         int tm, int tn, float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < k_end; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * kTile + 4 * tm);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * kTile + 4 * tn);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A k-major operand tile [k][c] from rows of a row-major array (row k at
// src + k * ld), zeros where k >= k_valid or c >= c_valid: 4 float4 a
// thread, 16 threads a row.
__device__ __forceinline__ void fetch_rows(float4 (&v)[4], const float* __restrict__ src,
                                           size_t ld, int k_valid, int c_valid) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int k = e >> 4, c = (e & 15) * 4;
    v[r] = k < k_valid && c < c_valid ? load4(src + (size_t)k * ld + c) : zero4();
  }
}

// Stores what fetch_rows fetched, each row k times row_scale[k] if given.
__device__ __forceinline__ void store_rows(float* dst, const float4 (&v)[4],
                                           const float* row_scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int k = e >> 4, c = (e & 15) * 4;
    float4 x = v[r];
    if (row_scale != nullptr) {
      const float s = row_scale[k];
      x = make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
    }
    *reinterpret_cast<float4*>(dst + k * kTile + c) = x;
  }
}

// A k-major operand tile [k][m] from the rows m of a row-major array (row m
// at src + m * ld, k along it), zeros where m >= m_valid or k >= k_valid:
// consecutive lanes take consecutive m, so the transposed stores below do
// not collide in banks.
__device__ __forceinline__ void fetch_cols(float4 (&v)[4], const float* __restrict__ src,
                                           size_t ld, int m_valid, int k_valid) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int m = e & (kTile - 1), k = (e >> 6) * 4;
    v[r] = m < m_valid && k < k_valid ? load4(src + (size_t)m * ld + k) : zero4();
  }
}

// Stores what fetch_cols fetched, column m times col_scale[m] if given.
__device__ __forceinline__ void store_cols(float* dst, const float4 (&v)[4],
                                           const float* col_scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int m = e & (kTile - 1), k = (e >> 6) * 4;
    const float s = col_scale != nullptr ? col_scale[m] : 1.f;
    dst[(k + 0) * kTile + m] = v[r].x * s;
    dst[(k + 1) * kTile + m] = v[r].y * s;
    dst[(k + 2) * kTile + m] = v[r].z * s;
    dst[(k + 3) * kTile + m] = v[r].w * s;
  }
}

// Inclusive cumsum of a[c0 .. c0 + Q) into cum (shared), zeros past L, by
// warp 0: each lane sums two entries, then the lanes scan.  The caller
// synchronises before reading cum.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a, int c0, int L,
                                             float* cum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, i = c0 + 2 * lane;
  const float a0 = i < L ? a[i] : 0.f;
  const float a1 = i + 1 < L ? a[i + 1] : 0.f;
  float incl = a0 + a1;
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum[2 * lane] = excl + a0;
  cum[2 * lane + 1] = incl;
}

// Pass 1: cbt[g][c][j][i] = C_i . B_j for the tiles holding some j <= i.
// Wholly upper tiles are never written, and pass 4 never reads them.
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ cbt, int L, int N, int n_chunks) {
  __shared__ __align__(16) float Cs[kTile * kTile];  // [n][i]
  __shared__ __align__(16) float Bs[kTile * kTile];  // [n][j]
  const int c = blockIdx.x % n_chunks, g = blockIdx.x / n_chunks, c0 = c * kChunk;
  const int rows = min(kChunk, L - c0);
  const int tm = tile_row(threadIdx.x), tn = tile_col(threadIdx.x);
  const float* Cg = Cm + ((size_t)g * L + c0) * N;
  const float* Bg = Bm + ((size_t)g * L + c0) * N;

  float acc[4][4] = {};
  float4 vc[4], vb[4];
  fetch_cols(vc, Cg, N, rows, N);
  fetch_cols(vb, Bg, N, rows, N);
  for (int n0 = 0; n0 < N; n0 += kTile) {
    __syncthreads();  // the last tile's products are done
    store_cols(Cs, vc, nullptr);
    store_cols(Bs, vb, nullptr);
    __syncthreads();
    if (n0 + kTile < N) {
      fetch_cols(vc, Cg + n0 + kTile, N, rows, N - n0 - kTile);
      fetch_cols(vb, Bg + n0 + kTile, N, rows, N - n0 - kTile);
    }
    tile_fma(Cs, Bs, min(kTile, N - n0), tm, tn, acc);
  }
  if (tn <= tm) {
    float* out = cbt + ((size_t)g * n_chunks + c) * kChunk * kChunk;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float4*>(out + (4 * tn + b) * kChunk + 4 * tm) =
          make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
  }
}

// Pass 2: states[bh][c][n][p] = sum_j B_j[n] xdt_j[p] exp(cum_end - cum_j)
// for the (n, p) tile blockIdx.y, and decay[bh][c] = exp(cum_end).  Only
// chunks c < n_chunks - 1, all of whose rows lie in [0, L).
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state(const float* __restrict__ xdt, const float* __restrict__ dtA,
                    const float* __restrict__ Bm, float* __restrict__ states,
                    float* __restrict__ decay, int L, int P, int N, int n_rep,
                    int n_states, int n_tiles_n) {
  __shared__ __align__(16) float Bs[kTile * kTile];  // [j][n]
  __shared__ __align__(16) float Xs[kTile * kTile];  // [j][p], times w_j
  __shared__ float cum[kChunk];
  __shared__ float w[kChunk];  // exp(cum_end - cum_j)
  const int c = blockIdx.x % n_states, bh = blockIdx.x / n_states, c0 = c * kChunk;
  const int n0 = (blockIdx.y % n_tiles_n) * kTile, p0 = (blockIdx.y / n_tiles_n) * kTile;
  const int g = bh / n_rep;
  const int tid = threadIdx.x, tm = tile_row(tid), tn = tile_col(tid);

  float4 vb[4], vx[4];
  fetch_rows(vb, Bm + ((size_t)g * L + c0) * N + n0, N, kChunk, N - n0);
  fetch_rows(vx, xdt + ((size_t)bh * L + c0) * P + p0, P, kChunk, P - p0);
  chunk_cumsum(dtA + (size_t)bh * L, c0, L, cum);
  store_rows(Bs, vb, nullptr);
  __syncthreads();
  const float cend = cum[kChunk - 1];
  if (tid < kChunk) w[tid] = expf(cend - cum[tid]);
  if (blockIdx.y == 0 && tid == 0) decay[(size_t)bh * n_states + c] = expf(cend);
  __syncthreads();
  store_rows(Xs, vx, w);
  __syncthreads();

  float acc[4][4] = {};
  tile_fma(Bs, Xs, kChunk, tm, tn, acc);
  float* out = states + (((size_t)bh * n_states + c) * N + n0) * P + p0;
  const int p = 4 * tn;
  if (p0 + p < P) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = 4 * tm + a;
      if (n0 + n < N)
        *reinterpret_cast<float4*>(out + (size_t)n * P + p) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
}

// Pass 3: in place, states[bh][c] becomes the state after chunk c, which is
// the state entering chunk c + 1.
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay, int NP4,
                   int n_states) {
  const int tiles = (NP4 + kThreads - 1) / kThreads;
  const int e = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (e >= NP4) return;
  const int bh = blockIdx.x / tiles;
  float4* s = reinterpret_cast<float4*>(states) + (size_t)bh * n_states * NP4 + e;
  const float* d = decay + (size_t)bh * n_states;
  float4 run = zero4();
  for (int k0 = 0; k0 < n_states; k0 += kStateDepth) {
    float4 v[kStateDepth];
    float dk[kStateDepth];
#pragma unroll
    for (int u = 0; u < kStateDepth; ++u) {
      const bool in = k0 + u < n_states;
      v[u] = in ? s[(size_t)(k0 + u) * NP4] : zero4();
      dk[u] = in ? d[k0 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStateDepth; ++u) {
      if (k0 + u < n_states) {
        run = make_float4(fmaf(dk[u], run.x, v[u].x), fmaf(dk[u], run.y, v[u].y),
                          fmaf(dk[u], run.z, v[u].z), fmaf(dk[u], run.w, v[u].w));
        s[(size_t)(k0 + u) * NP4] = run;
      }
    }
  }
}

// The scores tile [j][i] from what fetch_rows fetched of cbt:
// C_i . B_j exp(cum_i - cum_j) where j <= i < rows, else 0 (a select, not
// a product: the upper tiles of cbt hold whatever the buffer held).
__device__ __forceinline__ void store_scores(float* dst, const float4 (&v)[4],
                                             const float* cum, int rows) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int j = e >> 4, i = (e & 15) * 4;
    const float x[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = j <= i + q && i + q < rows ? x[q] * expf(cum[i + q] - cum[j]) : 0.f;
    *reinterpret_cast<float4*>(dst + j * kTile + i) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Pass 4: y[bh][c0 + i][p0 + p] for the chunk's rows and the P tile
// blockIdx.y: the scores' product with xdt, then, past chunk 0, the state
// term as N / 64 more tiles of K.
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_out(const float* __restrict__ xdt, const float* __restrict__ dtA,
                  const float* __restrict__ Cm, const float* __restrict__ cbt,
                  const float* __restrict__ states, float* __restrict__ y, int L, int P,
                  int N, int n_rep, int n_chunks) {
  __shared__ __align__(16) float As[kTile * kTile];  // [j][i] scores, then [n][i] C
  __shared__ __align__(16) float Bs[kTile * kTile];  // [j][p] xdt, then [n][p] state
  __shared__ float cum[kChunk];
  __shared__ float ecum[kChunk];  // exp(cum_i)
  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks, p0 = blockIdx.y * kTile;
  const int g = bh / n_rep, c0 = c * kChunk, rows = min(kChunk, L - c0);
  const int tid = threadIdx.x, tm = tile_row(tid), tn = tile_col(tid);
  const float* Cg = Cm + ((size_t)g * L + c0) * N;
  const float* S = c > 0 ? states + ((size_t)bh * (n_chunks - 1) + c - 1) * N * P + p0
                         : nullptr;
  const int n_tiles = 1 + (c > 0 ? (N + kTile - 1) / kTile : 0);
  // the triangle: warp w's rows end at 16 (w / 2) + 15, so its scores
  // need no j past that
  const int tri_end = 16 * ((tid >> 5) >> 1) + 16;

  float4 va[4], vb[4];
  fetch_rows(va, cbt + ((size_t)g * n_chunks + c) * kChunk * kChunk, kChunk, kChunk, kChunk);
  fetch_rows(vb, xdt + ((size_t)bh * L + c0) * P + p0, P, rows, P - p0);
  chunk_cumsum(dtA + (size_t)bh * L, c0, L, cum);
  __syncthreads();
  if (tid < kChunk) ecum[tid] = expf(cum[tid]);  // read from tile 1 on

  float acc[4][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    if (t == 0)
      store_scores(As, va, cum, rows);
    else
      store_cols(As, va, ecum);
    store_rows(Bs, vb, nullptr);
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int n0 = t * kTile;  // the next tile's first n
      fetch_cols(va, Cg + n0, N, rows, N - n0);
      fetch_rows(vb, S + (size_t)n0 * P, P, N - n0, P - p0);
    }
    tile_fma(As, Bs, t == 0 ? tri_end : min(kTile, N - (t - 1) * kTile), tm, tn, acc);
    __syncthreads();  // the products are done before the next tile's stores
  }

  const int p = p0 + 4 * tn;
  if (p < P) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * tm + a;
      if (i < rows)
        *reinterpret_cast<float4*>(y + ((size_t)bh * L + c0 + i) * P + p) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
}

int n_chunks_of(int L) { return (L + kChunk - 1) / kChunk; }
int tiles_of(int d) { return (d + kTile - 1) / kTile; }

// x = per_head * heads blocks, or 0 if that passes the grid's x limit
unsigned grid_x(int per_head, int heads) {
  const long long x = (long long)per_head * heads;
  return x <= 0x7fffffff ? (unsigned)x : 0u;
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The chunk length the kernels take.
int ssd_scan_chunk() { return kChunk; }

// All arrays float32, contiguous, 16-byte aligned; P and N multiples of 4.
// xdt (BH, L, P), dtA (BH, L), B and C (BG, L, N), y (BH, L, P) with
// BH == BG * n_rep; cbt (BG, n_chunks, Q, Q); states (BH, n_chunks - 1, N,
// P); decay (BH, n_chunks - 1).

int ssd_chunk_cb_launch(const void* B, const void* C, void* cbt, int BG, int L, int N,
                        void* stream) {
  if (BG <= 0 || L <= 0) return 0;
  const int nc = n_chunks_of(L);
  const unsigned x = grid_x(nc, BG);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_cb<<<x, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)B, (const float*)C, (float*)cbt, L, N, nc);
  return (int)cudaGetLastError();
}

int ssd_chunk_state_launch(const void* xdt, const void* dtA, const void* B, void* states,
                           void* decay, int BH, int L, int P, int N, int n_rep,
                           void* stream) {
  const int ns = n_chunks_of(L) - 1;
  if (BH <= 0 || ns <= 0) return 0;
  const int tn = tiles_of(N);
  const unsigned x = grid_x(ns, BH);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_state<<<dim3(x, tn * tiles_of(P)), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xdt, (const float*)dtA, (const float*)B, (float*)states,
      (float*)decay, L, P, N, n_rep, ns, tn);
  return (int)cudaGetLastError();
}

int ssd_state_pass_launch(void* states, const void* decay, int BH, int L, int P, int N,
                          void* stream) {
  const int ns = n_chunks_of(L) - 1;
  if (BH <= 0 || ns <= 0) return 0;
  const int np4 = N * P / 4;
  const unsigned x = grid_x((np4 + kThreads - 1) / kThreads, BH);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  ssd_state_pass<<<x, kThreads, 0, (cudaStream_t)stream>>>((float*)states,
                                                           (const float*)decay, np4, ns);
  return (int)cudaGetLastError();
}

int ssd_chunk_out_launch(const void* xdt, const void* dtA, const void* C, const void* cbt,
                         const void* states, void* y, int BH, int L, int P, int N,
                         int n_rep, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  const int nc = n_chunks_of(L);
  const unsigned x = grid_x(nc, BH);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_out<<<dim3(x, tiles_of(P)), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xdt, (const float*)dtA, (const float*)C, (const float*)cbt,
      (const float*)states, (float*)y, L, P, N, n_rep, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
