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
// Tensor cores (3xTF32, to keep float32 accuracy, as the backward's
// products below) are the next step.
//
// The backward (dxdt, ddtA, dB, dC against dy; no TPU counterpart: the
// reference differentiates its plain forms) mirrors the four passes, with
// the chain of the Mamba-2 paper's SSD algorithm (arXiv 2405.21060, section
// 6) and of state-spaces/mamba's _mamba_chunk_scan_combined_bwd.  With
// S_in[c] the state entering chunk c (the forward's states after pass 3),
// g_c the gradient of chunk c's end state from the chunks after it, and
// D_ij = (dy_i . xdt_j) exp(cum_i - cum_j) on the triangle:
//   1. ssd_bwd_dstate, grid ((n_chunks - 1) x BH, N/64 x P/64), mirror of
//      pass 2: dS_in[c] = sum_i exp(cum_i) C_i (x) dy_i for c >= 1, into
//      gstates (BH, n_chunks - 1, N, P) at c - 1.
//   2. ssd_bwd_state_pass, grid (N P / 1024 x BH), mirror of pass 3:
//      walks the chunks from last to first and rewrites gstates in place
//      with g_c = dS_in[c + 1] + exp(cum_end[c + 1]) g_{c+1}; each warp
//      writes its share of <g_c, S_in[c + 1]> to ddp (BH, n_chunks - 1, 8
//      x the pass's blocks a head).
//   3. ssd_bwd_chunk_dx, grid (n_chunks x BH, P/64), mirror of pass 4:
//      dxdt_j = sum_{i>=j} (C_i . B_j) exp(cum_i - cum_j) dy_i +
//      (exp(cum_end - cum_j) B_j) g_c, the scores being pass 1's cbt read
//      transposed; its epilogue writes each row's dy_t . y_t - xdt_t .
//      dxdt_t over its P tile (y the forward's output) to rowterm.
//   4. ssd_bwd_chunk_dbc, grid (n_chunks x slices x BG): a block takes a
//      (group, chunk) and a slice of up to kSliceHeads = 8 of the group's
//      heads.  Per head only the head's own products: D, and the state
//      terms exp(cum_i) dy_i S_in^T of dC and exp(cum_end - cum_j) xdt_j
//      g_c^T of dB, summed over the slice in one accumulator each; once a
//      slice, D_sum = the slice's D summed, against B and C: dC_i = sum_j
//      D_sum,ij B_j + ..., dB_j = sum_i D_sum,ij C_i + ... (B and C are
//      the group's, so the product of the sum replaces a product a head).
//      Each slice's share goes to parts (2, BG, slices, L, N).  Its
//      exponents come from a float64 chunk cumsum (dB and dC feed nothing
//      else); ssd_bwd_chunk_dx keeps the forward's float32 ones, which ddtA's
//      row terms need (see there).
//   5. ssd_bwd_dbc_sum: dB and dC, the slices' shares summed in order.
//   6. ssd_bwd_ddtA, grid BH: <G_t, S_t> (G_t the gradient of the state
//      after row t) is both ddtA_t + xdt_t . dxdt_t and dy_t . y_t +
//      ddtA_{t+1}, so ddtA_t = sum_{s >= t} (dy_s . y_s - xdt_s . dxdt_s),
//      and ddtA at chunk c + 1's first row is <g_c, S_in[c + 1]>: within
//      each chunk the reverse cumsum of the row terms, plus that carry
//      from ddp, in float64.  No product of its own.
// The products of 3 and 4 run on the tensor cores as 3xTF32: each operand
// split into a TF32 hi part (cvt.rna) and the rest rounded again, hi.hi +
// hi.lo + lo.hi summed in float32 by mma.sync m16n8k8 (about float32's
// accuracy; plain TF32 keeps three digits and is ruled out as above).  A
// block of 8 warps computes a 64 x 64 output tile, each warp 16 x 32 of it;
// operand tiles arrive through a two-stage cp.async ring (zeros past L, P
// and N), so the next tile's loads run under the current products; the
// exponentials, masks and sums stay float32 on the CUDA cores.  They take
// 110,336 and 108,544 bytes of dynamic shared memory: two blocks an SM,
// 128 registers a thread at most, no spills.  Tried for b4 and not kept,
// each no faster on the H100 (PERF.md): 16 warps a block covering 128 of N
// a walk (each operand read once), each stage split into hi and lo once a
// block, the twelve products of a k step issued term by term or with the
// small terms in an accumulator of their own, three or four ring stages.
// No atomics: every sum has one owner and a fixed order, so the gradients
// are the same bits from run to run, whatever the number of blocks in
// flight.
//
// Grids and scratch at mamba2-370m's training inputs (a microbatch of B =
// 2 x L = 4,096: BH 64, BG 2, P 64, N 128, 64 chunks): b1 8,064 blocks, b2
// 512, b3 4,096, b4 512 (4 slices of 8 heads).  The forward's states
// (132.1 MB), decay, cbt (2.1 MB) and y (67.1 MB) are kept for the
// backward; it adds gstates (132.1 MB), parts (33.6 MB) and rowterm (1.0
// MB).

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
// one warp (chunk_cumsum: warp 0): each lane sums two entries, then the
// lanes scan.  The caller synchronises before reading cum.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ a, int c0, int L,
                                            float* cum) {
  const int lane = threadIdx.x & 31, i = c0 + 2 * lane;
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
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a, int c0, int L,
                                             float* cum) {
  if (threadIdx.x < 32) warp_cumsum(a, c0, L, cum);
}

// The same in float64, by the calling warp, for ssd_bwd_chunk_dbc: its
// products take exp(cum_i - cum_j) where both are large (a chunk of strong
// decays ends near -3,000) and their difference small; in float32 that
// difference is off by ~1e-4 and so is the exp, in float64 it is exact to
// well under float32's rounding.
__device__ __forceinline__ void warp_cumsum64(const float* __restrict__ a, int c0, int L,
                                              double* cum) {
  const int lane = threadIdx.x & 31, i = c0 + 2 * lane;
  const double a0 = i < L ? a[i] : 0.0;
  const double a1 = i + 1 < L ? a[i + 1] : 0.0;
  double incl = a0 + a1;
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  cum[2 * lane] = excl + a0;
  cum[2 * lane + 1] = incl;
}

// exp(x - y) of two float64 chunk cumsums
__device__ __forceinline__ float exp_diff(double x, double y) { return expf((float)(x - y)); }

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


// ---------------------------------------------------------------------------
// The backward: dxdt, ddtA, dB and dC against dy (see the header).
// ---------------------------------------------------------------------------

constexpr int kKs = 32;                 // the depth of a ring stage's operand tiles
constexpr int kLdk = kKs + 4;           // row stride of a [row][k] ring tile
constexpr int kLdd = kTile + 4;         // row stride of a 64 x 64 [m][k] tile
constexpr int kLdn = kTile + 8;         // row stride of a [k][n] tile, 64 wide
constexpr int kTileK = kTile * kLdk;    // floats of a [64][kLdk] tile
constexpr int kEdge = kTile * kLdn;     // floats of a [64][kLdn] tile
constexpr int kSliceHeads = 8;          // heads a ssd_bwd_chunk_dbc block sums over
constexpr int kTileD = kTile * kLdd;    // floats of a [64][kLdd] tile
constexpr int kDbcK = 64;               // the P depth of a ssd_bwd_chunk_dbc ring stage
constexpr int kDbcStages = 2;           // its ring's stages, one loading under the products
constexpr int kLdq = kDbcK + 4;         // row stride of its ring tiles
constexpr int kDbcTile = kTile * kLdq;  // floats of one
constexpr int kDbcStage = 2 * kDbcTile;  // a head's 64 rows of two operands
constexpr int kDxStage = kTileK + kKs * kLdn;  // B [j][n] and g [n][p], kKs n each
constexpr int kSumBlocks = 4096;        // the most blocks of ssd_bwd_dbc_sum's grid
static_assert(kSliceHeads <= kThreads / 32, "one warp scans each head's chunk cumsum");
static_assert(kEdge <= kDbcStages * kDbcStage, "B's or C's tile fits the dbc ring");

// cp.async of 16 bytes, or 16 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kRows x kCols floats of a row-major array (row r at src + r * ld) into dst
// (row r at dst + r * kLd) by cp.async, zeros where r >= r_valid or the
// column >= c_valid.  The caller commits.
template <int kRows, int kCols, int kLd>
__device__ __forceinline__ void cp_tile(float* dst, const float* __restrict__ src, size_t ld,
                                        int r_valid, int c_valid) {
  constexpr int kPerRow = kCols / 4;
  for (int e = threadIdx.x; e < kRows * kPerRow; e += kThreads) {
    const int r = e / kPerRow, q = (e % kPerRow) * 4;
    const bool ok = r < r_valid && q < c_valid;
    cp_async16(dst + r * kLd + q, ok ? src + (size_t)r * ld + q : src, ok);
  }
}

// The 3xTF32 split: hi = x rounded to TF32, lo = x - hi rounded again.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a b on the tensor cores: one m16n8k8 TF32 product, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 x 32 share of a 64 x 64 output tile: acc[f][q] at row m0 +
// lane / 4 + 8 (q / 2), column n0 + 8 f + 2 (lane % 4) + q % 2, += the sum
// over k0 <= k < k1 (multiples of 8) of s_m A[m][k] B[k][n], in 3xTF32
// (lo.hi + hi.lo + hi.hi, the small terms first; lo.lo dropped).  A is
// stored [m][k] at row stride lda, row m0 + lane / 4 scaled by s0 and the
// row 8 below by s1; B is stored [n][k] (kNK) or [k][n] at row stride ldb.
// The strides keep the fragment loads free of bank conflicts (lda and an
// [n][k] ldb = 4 mod 32, a [k][n] ldb = 8 mod 32).
template <bool kNK>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const float* __restrict__ A, int lda,
                                         const float* __restrict__ Bs, int ldb, int m0, int n0,
                                         int k0, int k1, float s0, float s1) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const float* a0 = A + (m0 + gr) * lda + tq;
  const float* a1 = a0 + 8 * lda;
#pragma unroll 1
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a0[k] * s0, ah[0], al[0]);
    split_tf32(a1[k] * s1, ah[1], al[1]);
    split_tf32(a0[k + 4] * s0, ah[2], al[2]);
    split_tf32(a1[k + 4] * s1, ah[3], al[3]);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int n = n0 + 8 * f + gr;
      const float b0 = kNK ? Bs[n * ldb + k + tq] : Bs[(k + tq) * ldb + n];
      const float b1 = kNK ? Bs[n * ldb + k + tq + 4] : Bs[(k + tq + 4) * ldb + n];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(acc[f], al, bh0, bh1);
      mma_tf32(acc[f], ah, bl0, bl1);
      mma_tf32(acc[f], ah, bh0, bh1);
    }
  }
}

// b1: dstates[bh][s][n][p] = sum_i exp(cum_i) C_i[n] dy_i[p] for chunk
// c = s + 1 (the gradient of y through the state entering chunk c), for the
// (n, p) tile blockIdx.y.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dstate(const float* __restrict__ dy, const float* __restrict__ dtA,
                   const float* __restrict__ Cm, float* __restrict__ dstates, int L, int P,
                   int N, int n_rep, int n_states, int n_tiles_n) {
  __shared__ __align__(16) float Cs[kTile * kTile];  // [i][n], times exp(cum_i)
  __shared__ __align__(16) float Ys[kTile * kTile];  // [i][p]
  __shared__ float cum[kChunk];
  __shared__ float ecum[kChunk];
  const int s = blockIdx.x % n_states, bh = blockIdx.x / n_states;
  const int c0 = (s + 1) * kChunk, rows = min(kChunk, L - c0);
  const int n0 = (blockIdx.y % n_tiles_n) * kTile, p0 = (blockIdx.y / n_tiles_n) * kTile;
  const int g = bh / n_rep;
  const int tid = threadIdx.x, tm = tile_row(tid), tn = tile_col(tid);

  float4 vc[4], vy[4];
  fetch_rows(vc, Cm + ((size_t)g * L + c0) * N + n0, N, rows, N - n0);
  fetch_rows(vy, dy + ((size_t)bh * L + c0) * P + p0, P, rows, P - p0);
  chunk_cumsum(dtA + (size_t)bh * L, c0, L, cum);
  store_rows(Ys, vy, nullptr);
  __syncthreads();
  if (tid < kChunk) ecum[tid] = expf(cum[tid]);
  __syncthreads();
  store_rows(Cs, vc, ecum);
  __syncthreads();

  float acc[4][4] = {};
  tile_fma(Cs, Ys, rows, tm, tn, acc);
  float* out = dstates + (((size_t)bh * n_states + s) * N + n0) * P + p0;
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

// b2: walks the chunks from last to first, 4 state elements a thread, and
// rewrites gs in place: gs[c] holds dS_in[c + 1] and becomes g_c =
// dS_in[c + 1] + decay_{c+1} g_{c+1}, the gradient of chunk c's end state
// from the chunks after it.  Each warp also writes its share of <g_c,
// S_in[c + 1]> (S_in[c + 1] = states[c]), which is ddtA at chunk c + 1's
// first row, to ddp[bh][c][blockIdx.x's tile][warp]; b6 sums them in order.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_pass(float* __restrict__ gs, const float* __restrict__ decay,
                       const float* __restrict__ states, float* __restrict__ ddp, int NP4,
                       int n_states) {
  constexpr int kWarps = kThreads / 32;
  const int tiles = (NP4 + kThreads - 1) / kThreads;
  const int tile = blockIdx.x % tiles, bh = blockIdx.x / tiles;
  const int e = tile * kThreads + threadIdx.x;
  const bool in = e < NP4;
  float4* gp = reinterpret_cast<float4*>(gs) + (size_t)bh * n_states * NP4 + e;
  const float4* sp = reinterpret_cast<const float4*>(states) + (size_t)bh * n_states * NP4 + e;
  const float* d = decay + (size_t)bh * n_states;
  float* parts = ddp + ((size_t)bh * n_states * tiles + tile) * kWarps + threadIdx.x / 32;
  const size_t part_stride = (size_t)tiles * kWarps;  // from one chunk to the next
  float4 run = zero4();
  for (int k0 = n_states - 1; k0 >= 0; k0 -= kStateDepth) {
    float4 v[kStateDepth], sv[kStateDepth];
    float dk[kStateDepth];
#pragma unroll
    for (int u = 0; u < kStateDepth; ++u) {
      const int c = k0 - u;
      v[u] = in && c >= 0 ? gp[(size_t)c * NP4] : zero4();
      sv[u] = in && c >= 0 ? sp[(size_t)c * NP4] : zero4();
      dk[u] = c >= 0 && c + 1 < n_states ? d[c + 1] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStateDepth; ++u) {
      const int c = k0 - u;
      if (c < 0) break;
      run = make_float4(fmaf(dk[u], run.x, v[u].x), fmaf(dk[u], run.y, v[u].y),
                        fmaf(dk[u], run.z, v[u].z), fmaf(dk[u], run.w, v[u].w));
      if (in) gp[(size_t)c * NP4] = run;
      float part = run.x * sv[u].x + run.y * sv[u].y + run.z * sv[u].z + run.w * sv[u].w;
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if ((threadIdx.x & 31) == 0) parts[(size_t)c * part_stride] = part;
    }
  }
}

// b3: dxdt[bh][c0 + j][p0 + p] for the chunk's rows and the P tile
// blockIdx.y, on the tensor cores: the transposed scores against dy (K = the
// triangle's i >= j), then, before the last chunk, (exp(cum_end - cum_j)
// B_j) . g_c, kKs of N at a time through a two-stage cp.async ring.  Its
// epilogue writes ddtA's row terms, sum over the tile's p of dy y - xdt
// dxdt, to rowterm[blockIdx.y][bh][c0 + j], from y's and xdt's tiles that
// arrive under the products.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_chunk_dx(const float* __restrict__ dy, const float* __restrict__ xdt,
                     const float* __restrict__ y, const float* __restrict__ dtA,
                     const float* __restrict__ Bm, const float* __restrict__ cbt,
                     const float* __restrict__ gs, float* __restrict__ dx,
                     float* __restrict__ rowterm, int L, int P, int N, int n_rep, int n_chunks,
                     int BH) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;                 // the transposed scores [j][i]
  float* Ys = St + kTile * kLdd;    // dy [i][p]
  float* Yo = Ys + kEdge;           // the forward's y [j][p]
  float* Xs = Yo + kEdge;           // xdt [j][p]
  float* ring = Xs + kEdge;         // 2 stages of B [j][n] and g [n][p]
  float* cum = ring + 2 * kDxStage;
  float* red = cum + kChunk;        // [j][2]: each column half's row term
  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks, p0 = blockIdx.y * kTile;
  const int g = bh / n_rep, c0 = c * kChunk, rows = min(kChunk, L - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
  const bool state_out = c + 1 < n_chunks;  // only the last chunk is ragged
  const int n_nk = state_out ? (N + kKs - 1) / kKs : 0;
  const float* Bg = Bm + ((size_t)g * L + c0) * N;
  const float* G = state_out ? gs + ((size_t)bh * (n_chunks - 1) + c) * N * P + p0 : nullptr;
  auto issue = [&](int nk, float* st) {
    const int k0 = nk * kKs;
    cp_tile<kTile, kKs, kLdk>(st, Bg + k0, N, rows, N - k0);
    cp_tile<kKs, kTile, kLdn>(st + kTileK, G + (size_t)k0 * P, P, N - k0, P - p0);
    cp_commit();
  };

  cp_tile<kTile, kTile, kLdd>(St, cbt + ((size_t)g * n_chunks + c) * kChunk * kChunk, kChunk,
                              kChunk, kChunk);
  const size_t base = ((size_t)bh * L + c0) * P;
  cp_tile<kTile, kTile, kLdn>(Ys, dy + base + p0, P, rows, P - p0);
  // y and xdt are read last: in the first ring stage's group, if there is one
  if (n_nk == 0) {
    cp_tile<kTile, kTile, kLdn>(Yo, y + base + p0, P, rows, P - p0);
    cp_tile<kTile, kTile, kLdn>(Xs, xdt + base + p0, P, rows, P - p0);
  }
  cp_commit();
  if (n_nk > 0) {
    cp_tile<kTile, kTile, kLdn>(Yo, y + base + p0, P, rows, P - p0);
    cp_tile<kTile, kTile, kLdn>(Xs, xdt + base + p0, P, rows, P - p0);
    issue(0, ring);
  }
  chunk_cumsum(dtA + (size_t)bh * L, c0, L, cum);
  if (n_nk > 0)
    cp_wait<1>();
  else
    cp_wait<0>();
  __syncthreads();
  // C_i . B_j exp(cum_i - cum_j) where j <= i < rows, else 0 (a select:
  // cbt's upper tiles are never written).  The exponents are the forward's
  // own float32 ones (its cumsum, pass 4's scores, pass 2's weights): ddtA's
  // row terms pair xdt . dxdt with dy . y, and their rounding cancels only
  // where both come from the same exponents.
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int j = e >> 6, i = e & (kTile - 1);
    float* s = St + j * kLdd + i;
    *s = j <= i && i < rows ? *s * expf(cum[i] - cum[j]) : 0.f;
  }
  __syncthreads();

  float acc[4][4] = {};
  warp_mma<false>(acc, St, kLdd, Ys, kLdn, m0, n0, m0, kTile, 1.f, 1.f);  // i >= j
  const float cend = cum[kChunk - 1];
  const float w0 = expf(cend - cum[m0 + gr]), w1 = expf(cend - cum[m0 + gr + 8]);
  for (int nk = 0; nk < n_nk; ++nk) {
    if (nk + 1 < n_nk) {
      issue(nk + 1, ring + ((nk + 1) & 1) * kDxStage);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* st = ring + (nk & 1) * kDxStage;
    warp_mma<false>(acc, st, kLdk, st + kTileK, kLdn, m0, n0, 0, kKs, w0, w1);
    __syncthreads();  // the stage is read before it is loaded again
  }

  // dxdt, and each row's dy . y - xdt . dxdt over the tile: the 4 lanes of
  // a row, then the two warps of its column halves, in a fixed order
  float term[2] = {0.f, 0.f};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int col = n0 + 8 * f + 2 * tq, p = p0 + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = m0 + gr + 8 * h;
      if (p < P && j < rows) {
        const float2 d = make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
        *reinterpret_cast<float2*>(dx + base + (size_t)j * P + p) = d;
        const int at = j * kLdn + col;
        term[h] += Ys[at] * Yo[at] + Ys[at + 1] * Yo[at + 1] - (Xs[at] * d.x + Xs[at + 1] * d.y);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    term[h] += __shfl_xor_sync(0xffffffffu, term[h], 1);
    term[h] += __shfl_xor_sync(0xffffffffu, term[h], 2);
  }
  if (tq == 0) {
    red[(m0 + gr) * 2 + (warp & 1)] = term[0];
    red[(m0 + gr + 8) * 2 + (warp & 1)] = term[1];
  }
  __syncthreads();
  if (tid < rows)
    rowterm[((size_t)blockIdx.y * BH + bh) * L + c0 + tid] = red[2 * tid] + red[2 * tid + 1];
}

// b4: per (batch x group, chunk, slice of up to kSliceHeads of the group's
// heads), the slice's share of dC and dB of the chunk's rows, on the tensor
// cores, into parts (2, BG, n_slices, L, N): dC's at 0, dB's at 1.  Walks
// over the slice's heads and their P in steps of kDbcK, each through a
// kDbcStages-stage cp.async ring of two operand tiles: (D) each head's D = (dy
// xdt^T) o exp(cum_i - cum_j) on the triangle, summed over the slice in
// shared memory, heads in order; then per 64 wide tile of N, (E) dC's state
// term (exp(cum_i) dy) S_in^T summed over the heads in one accumulator,
// then D_sum B; (F) dB's, (exp(cum_end - cum_j) xdt) g^T, then D_sum^T C.
// Apart, the walks keep 16 accumulators a thread live: two blocks an SM
// without spills.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_chunk_dbc(const float* __restrict__ xdt, const float* __restrict__ dy,
                      const float* __restrict__ dtA, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const float* __restrict__ states,
                      const float* __restrict__ gs, float* __restrict__ parts, int L, int P,
                      int N, int n_rep, int n_chunks, int n_slices, int BG) {
  enum Walk { kD, kE, kF };
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                           // kDbcStages stages of kDbcStage
  float* Dn = ring + kDbcStages * kDbcStage;    // D summed over the slice, [i][j]
  float* Dt = Dn + kTileD;            // the same, [j][i]
  double* cums = reinterpret_cast<double*>(Dt + kTileD);  // the heads' chunk cumsums

  const int c = blockIdx.x % n_chunks, rest = blockIdx.x / n_chunks;
  const int slice = rest % n_slices, g = rest / n_slices;
  const int nh = min(kSliceHeads, n_rep - slice * kSliceHeads);
  const int h0 = g * n_rep + slice * kSliceHeads;
  const int c0 = c * kChunk, rows = min(kChunk, L - c0);
  const bool state_in = c > 0, state_out = c + 1 < n_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
  const int n_kp = (P + kDbcK - 1) / kDbcK, steps = nh * n_kp;

  for (int e = tid; e < kTileD; e += kThreads) Dn[e] = 0.f;
  if (warp < nh) warp_cumsum64(dtA + (size_t)(h0 + warp) * L, c0, L, cums + warp * kChunk);

  // step r of a walk: head r / n_kp, P from (r % n_kp) kDbcK; the first tile
  // holds the chunk's rows of dy (D, E) or xdt (F), the second xdt's (D) or
  // the 64 rows of N from nb of S_in (E) or g (F)
  auto issue = [&](Walk w, int nb, int r, float* st) {
    const int bh = h0 + r / n_kp, k0 = (r % n_kp) * kDbcK;
    const size_t row = ((size_t)bh * L + c0) * P + k0;
    cp_tile<kTile, kDbcK, kLdq>(st, (w == kF ? xdt : dy) + row, P, rows, P - k0);
    if (w == kD)
      cp_tile<kTile, kDbcK, kLdq>(st + kDbcTile, xdt + row, P, rows, P - k0);
    else
      cp_tile<kTile, kDbcK, kLdq>(
          st + kDbcTile,
          (w == kE ? states + ((size_t)bh * (n_chunks - 1) + c - 1) * N * P
                   : gs + ((size_t)bh * (n_chunks - 1) + c) * N * P) + (size_t)nb * P + k0,
          P, N - nb, P - k0);
    cp_commit();
  };
  // a walk's steps through the ring: step(r, stage) once the stage landed,
  // the next kDbcStages - 1 stages loading meanwhile (one commit group a
  // step, empty past the last, so that one wait count fits every step)
  auto walk = [&](Walk w, int nb, auto&& step) {
    for (int r = 0; r < kDbcStages - 1; ++r) {
      if (r < steps)
        issue(w, nb, r, ring + r * kDbcStage);
      else
        cp_commit();
    }
    for (int r = 0; r < steps; ++r) {
      const int ahead = r + kDbcStages - 1;  // into the stage step r - 1 read
      if (ahead < steps)
        issue(w, nb, ahead, ring + (ahead % kDbcStages) * kDbcStage);
      else
        cp_commit();
      cp_wait<kDbcStages - 1>();
      __syncthreads();
      step(r, ring + (r % kDbcStages) * kDbcStage);
      __syncthreads();  // the stage is read before it is loaded again
    }
  };
  // the slice's D against the group's B or C (a [k][n] tile of 64 rows of
  // the chunk and 64 of N from nb, loaded into the ring): acc += Dn B for
  // dC (j <= i), Dt C for dB (i >= j); then acc to the slice's part
  auto finish = [&](const float* M, const float* D, float* out, int nb, float (&acc)[4][4]) {
    cp_tile<kTile, kTile, kLdn>(ring, M + ((size_t)g * L + c0) * N + nb, N, rows, N - nb);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (D == Dn)
      warp_mma<false>(acc, Dn, kLdd, ring, kLdn, m0, n0, 0, m0 + 16, 1.f, 1.f);
    else
      warp_mma<false>(acc, Dt, kLdd, ring, kLdn, m0, n0, m0, kTile, 1.f, 1.f);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int n = nb + n0 + 8 * f + 2 * tq;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + gr + 8 * h;
        if (i < rows)
          *reinterpret_cast<float2*>(out + (size_t)i * N + n) =
              make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
      }
    }
    __syncthreads();  // the tile is read before the ring is loaded again
  };

  {
    float accD[4][4] = {};
    walk(kD, 0, [&](int r, const float* st) {
      warp_mma<true>(accD, st, kLdq, st + kDbcTile, kLdq, m0, n0, 0, kDbcK, 1.f, 1.f);
      if (r % n_kp == n_kp - 1) {
        // the head's D, selected onto the triangle, into the slice's sum
        const double* cum = cums + (r / n_kp) * kChunk;
#pragma unroll 1
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = m0 + gr + 8 * (q >> 1), j = n0 + 8 * f + 2 * tq + (q & 1);
            Dn[i * kLdd + j] += j <= i && i < rows ? accD[f][q] * exp_diff(cum[i], cum[j]) : 0.f;
            accD[f][q] = 0.f;
          }
      }
    });
  }
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int i = e >> 6, j = e & (kTile - 1);
    Dt[j * kLdd + i] = Dn[i * kLdd + j];
  }  // read after finish's barrier

  float* out_c = parts + (((size_t)g * n_slices + slice) * L + c0) * N;
  float* out_b = parts + ((((size_t)BG + g) * n_slices + slice) * L + c0) * N;
  for (int nb = 0; nb < N; nb += kTile) {
    {
      float acc[4][4] = {};
      if (state_in)
        walk(kE, nb, [&](int r, const float* st) {
          const double* cum = cums + (r / n_kp) * kChunk;
          warp_mma<true>(acc, st, kLdq, st + kDbcTile, kLdq, m0, n0, 0, kDbcK,
                         exp_diff(cum[m0 + gr], 0.0), exp_diff(cum[m0 + gr + 8], 0.0));
        });
      finish(Bm, Dn, out_c, nb, acc);
    }
    {
      float acc[4][4] = {};
      if (state_out)
        walk(kF, nb, [&](int r, const float* st) {
          const double* cum = cums + (r / n_kp) * kChunk;
          const double cend = cum[kChunk - 1];
          warp_mma<true>(acc, st, kLdq, st + kDbcTile, kLdq, m0, n0, 0, kDbcK,
                         exp_diff(cend, cum[m0 + gr]), exp_diff(cend, cum[m0 + gr + 8]));
        });
      finish(Cm, Dt, out_b, nb, acc);
    }
  }
}

// b5: dC and dB, each the sum of its slices' parts in slice order.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dbc_sum(const float4* __restrict__ parts, float4* __restrict__ dB,
                    float4* __restrict__ dC, long long per_group, int BG, int n_slices) {
  const long long total = 2LL * BG * per_group;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const long long which = e / ((long long)BG * per_group), rest = e % ((long long)BG * per_group);
    const long long g = rest / per_group, at = rest % per_group;
    const float4* p = parts + (which * BG + g) * n_slices * per_group + at;
    float4 s = p[0];
    for (int k = 1; k < n_slices; ++k) {
      const float4 v = p[(size_t)k * per_group];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    (which == 0 ? dC : dB)[rest] = s;
  }
}

// b6: ddtA of head blockIdx.x, a chunk a warp: with r_s the row terms
// summed over the P tiles in order, ddtA_t = sum_{t <= s < the chunk's end}
// r_s + ddtA at the next chunk's first row, <g_c, S_in[c + 1]> (the state
// pass's parts, summed in order; 0 after the last chunk).  Summing the row
// terms of the whole sequence instead would reach the same value, but their
// float32 rounding would add up along it, and so bias sums of ddtA over a
// sequence such as A's gradient.  In float64, every sum in a fixed order.
// ddtA_0 = exp(dtA_0) <G_0, S_-1> is 0, the scan starting from a zero state:
// it is written as 0, not as the sum, of which only rounding would be left.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_ddtA(const float* __restrict__ rowterm, const float* __restrict__ ddp,
                 float* __restrict__ ddtA, int L, int BH, int n_ptiles, int n_parts) {
  constexpr int kWarps = kThreads / 32;
  const int bh = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  auto row = [&](int t) {
    double r = 0.0;
    if (t < L)
      for (int pt = 0; pt < n_ptiles; ++pt) r += (double)rowterm[((size_t)pt * BH + bh) * L + t];
    return r;
  };
  for (int c = warp; c < n_chunks; c += kWarps) {
    double carry = 0.0;
    if (c + 1 < n_chunks) {
      const float* parts = ddp + ((size_t)bh * (n_chunks - 1) + c) * n_parts;
      for (int q = lane; q < n_parts; q += 32) carry += (double)parts[q];
      for (int off = 16; off > 0; off >>= 1) carry += __shfl_xor_sync(0xffffffffu, carry, off);
    }
    const int t = c * kChunk + 2 * lane;
    const double s1 = row(t + 1), s0 = row(t) + s1;  // the lane's own suffix sums
    double incl = s0;  // the lanes from this one up
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    double above = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) above = 0.0;
    const double base = carry + above;
    float* out = ddtA + (size_t)bh * L;
    if (t < L) out[t] = t > 0 ? (float)(base + s0) : 0.f;
    if (t + 1 < L) out[t + 1] = (float)(base + s1);
  }
}

int n_chunks_of(int L) { return (L + kChunk - 1) / kChunk; }
int tiles_of(int d) { return (d + kTile - 1) / kTile; }

// x = per_head * heads blocks, or 0 if that passes the grid's x limit
unsigned grid_x(int per_head, int heads) {
  const long long x = (long long)per_head * heads;
  return x <= 0x7fffffff ? (unsigned)x : 0u;
}

// Lets the kernel take `bytes` of dynamic shared memory, with the largest
// shared-memory carveout (two blocks an SM).  The attributes are the
// function's, for the current device: setting them again costs little and
// keeps several devices right.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
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

// The backward.  dy and y (BH, L, P) float32, y the forward's output;
// states, cbt and decay as the forward left them; scratch gs (BH, n_chunks
// - 1, N, P), ddp (BH, n_chunks - 1, ssd_bwd_parts(P, N)), rowterm
// (ceil(P / 64), BH, L) and parts (2, BG, ssd_bwd_slices(n_rep), L, N);
// outputs dxdt (BH, L, P), ddtA (BH, L), dB and dC (BG, L, N).

// The slices of a group's heads that ssd_bwd_chunk_dbc sums apart.
int ssd_bwd_slices(int n_rep) { return (n_rep + kSliceHeads - 1) / kSliceHeads; }

// The partial sums of <g_c, S_in[c + 1]> a (head, chunk) that b2 writes.
int ssd_bwd_parts(int P, int N) {
  return ((N * P / 4 + kThreads - 1) / kThreads) * (kThreads / 32);
}

// The dynamic shared memory, in bytes, of ssd_bwd_chunk_dx and _dbc.
int ssd_bwd_dx_smem() {
  return (int)sizeof(float) * (kTile * kLdd + 3 * kEdge + 2 * kDxStage + 3 * kChunk);
}
int ssd_bwd_dbc_smem() {
  return (int)sizeof(float) *
         (kDbcStages * kDbcStage + 2 * kTileD + 2 * kSliceHeads * kChunk);
}

int ssd_bwd_dstate_launch(const void* dy, const void* dtA, const void* C, void* gs, int BH,
                          int L, int P, int N, int n_rep, void* stream) {
  const int ns = n_chunks_of(L) - 1;
  if (BH <= 0 || ns <= 0) return 0;
  const int tn = tiles_of(N);
  const unsigned x = grid_x(ns, BH);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  ssd_bwd_dstate<<<dim3(x, tn * tiles_of(P)), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dy, (const float*)dtA, (const float*)C, (float*)gs, L, P, N, n_rep, ns, tn);
  return (int)cudaGetLastError();
}

int ssd_bwd_state_pass_launch(void* gs, const void* decay, const void* states, void* ddp,
                              int BH, int L, int P, int N, void* stream) {
  const int ns = n_chunks_of(L) - 1;
  if (BH <= 0 || ns <= 0) return 0;
  const int np4 = N * P / 4;
  const unsigned x = grid_x((np4 + kThreads - 1) / kThreads, BH);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  ssd_bwd_state_pass<<<x, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)gs, (const float*)decay, (const float*)states, (float*)ddp, np4, ns);
  return (int)cudaGetLastError();
}

int ssd_bwd_chunk_dx_launch(const void* dy, const void* xdt, const void* y, const void* dtA,
                            const void* B, const void* cbt, const void* gs, void* dx,
                            void* rowterm, int BH, int L, int P, int N, int n_rep,
                            void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  const int nc = n_chunks_of(L);
  const unsigned x = grid_x(nc, BH);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = ssd_bwd_dx_smem();
  const cudaError_t err = allow_smem(ssd_bwd_chunk_dx, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_dx<<<dim3(x, tiles_of(P)), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)dy, (const float*)xdt, (const float*)y, (const float*)dtA, (const float*)B,
      (const float*)cbt, (const float*)gs, (float*)dx, (float*)rowterm, L, P, N, n_rep, nc, BH);
  return (int)cudaGetLastError();
}

int ssd_bwd_chunk_dbc_launch(const void* xdt, const void* dy, const void* dtA, const void* B,
                             const void* C, const void* states, const void* gs, void* parts,
                             int BG, int L, int P, int N, int n_rep, void* stream) {
  if (BG <= 0 || L <= 0) return 0;
  const int nc = n_chunks_of(L), ns = ssd_bwd_slices(n_rep);
  const unsigned x = grid_x(nc * ns, BG);
  if (x == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = ssd_bwd_dbc_smem();
  const cudaError_t err = allow_smem(ssd_bwd_chunk_dbc, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_dbc<<<x, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xdt, (const float*)dy, (const float*)dtA, (const float*)B, (const float*)C,
      (const float*)states, (const float*)gs, (float*)parts, L, P, N, n_rep, nc, ns, BG);
  return (int)cudaGetLastError();
}

int ssd_bwd_dbc_sum_launch(const void* parts, void* dB, void* dC, int BG, int L, int N,
                           int n_rep, void* stream) {
  if (BG <= 0 || L <= 0) return 0;
  const long long per_group = (long long)L * N / 4;
  const long long blocks = (2 * BG * per_group + kThreads - 1) / kThreads;
  ssd_bwd_dbc_sum<<<(unsigned)(blocks < kSumBlocks ? blocks : kSumBlocks), kThreads, 0,
                    (cudaStream_t)stream>>>((const float4*)parts, (float4*)dB, (float4*)dC,
                                            per_group, BG, ssd_bwd_slices(n_rep));
  return (int)cudaGetLastError();
}

int ssd_bwd_ddtA_launch(const void* rowterm, const void* ddp, void* ddtA, int BH, int L, int P,
                        int N, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  ssd_bwd_ddtA<<<(unsigned)BH, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rowterm, (const float*)ddp, (float*)ddtA, L, BH, tiles_of(P),
      ssd_bwd_parts(P, N));
  return (int)cudaGetLastError();
}

}  // extern "C"
