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
// Bound: at the serving path's shapes (prefill of granite-3-2b at D = 64,
// phi3-mini-3.8b at D = 96, gemma3-12b at D = 256 with 1,024-key windows on
// 40 of its 48 layers; up to 2048 keys, bf16) the work is 4 * D operations
// per (query, key) pair the mask lets through against 2 * D * 2 bytes of q
// and o per query row and the same per key, so it is far above the card's
// operations-per-byte balance: bound by operations, at 989 TFLOP/s on the
// bf16 tensor cores.
//
// Two kernels share the tiling (a block per 64-row query tile, 128 rows
// at bf16 D = 96 and 256, query head and batch; K/V tiles of 64 keys; key
// tiles that the causal or window mask covers wholly are never visited,
// as _flash_kernel skips them with pl.when; GQA maps the query head to its
// KV head by index, nothing is repeated):
//
// bf16, flash_fwd_bf16<D> (D = 16, 64, 96, 128, 256), on the tensor cores.
// The serving path sends bf16 only.
//  * One warpgroup (128 threads) per block, two at D = 96 and 256
//    (below).  Q's tile is copied once into shared memory.  K and V tiles
//    go through a ring of two stages filled with cp.async, 16 bytes a
//    thread and zero-filled past Sk, so that tile t + 1 loads while tile t
//    is multiplied.  Every tile is stored as wgmma's descriptors read it:
//    rows of 128 bytes in the 128-byte swizzle for D >= 64, in column
//    blocks of 64 (two at D = 96 and 128, four at 256), rows of 32 bytes in
//    the 32-byte swizzle for D = 16.  At D = 96 the second block's last 32
//    columns are left empty: 16 KB a tile in place of 12 KB, for the one
//    swizzle and descriptor layout that D = 64 and 128 use, rather than
//    the 32-byte swizzle in six 16-column blocks.
//  * S = Q K^T is wgmma.mma_async m64n64k16, both operands read by
//    descriptor from shared memory, float32 accumulators in registers.
//    O += P V takes P from registers as the A operand, rounded to bf16
//    only there, and V by descriptor with the transpose bit (V stays
//    [key][d] in shared memory): m64n64k16 per column block of D, or
//    m64n16k16 at D = 16, and at D = 96 one m64n96k16 whose descriptor's
//    leading byte offset steps from the first column block to the second.
//  * D = 96 and 256 take two warpgroups a block, each with its own 64 rows
//    of a 128-row query tile and the whole head dim (at D = 256 a 64 x 256
//    float32 accumulator, 128 registers a thread).  They share the K/V
//    ring, so a copied tile feeds twice the rows (one warpgroup a block at
//    D = 96 ran a third slower at phi3-mini-3.8b's prefill: PERF.md), and
//    exchange nothing; a key tile that only the other warpgroup's rows see
//    (the causal diagonal, the window's edge) is loaded for it and skipped
//    here.  They issue the next key tile's copies after S's products, so
//    that the issue runs under the tensor cores, and the barrier at the top
//    of a key tile is their only one: it orders the last reads of a stage
//    before its refill.  Shared memory: at D = 96 Q 2 x 16 KB + 2 stages x
//    (K 16 + V 16) KB + 1 KB = 97 KB, two blocks an SM; at D = 256 Q 2 x
//    32 KB + 2 stages x (K 32 + V 32) KB + 1 KB = 193 KB, one block (8
//    warps) an SM.
//  * The online softmax runs on the accumulator fragments.  A thread
//    holds two rows; row max and row sum reduce over the four threads
//    that share a row by shuffles.  sm_scale * log2(e) scales the float32
//    scores and exp2f takes the exponentials.  Only the tiles that the
//    diagonal, the window edge or Sk cut are masked elementwise.  Every
//    head dim computes the same softmax.
//  * The last query tiles, which see the most keys under the causal mask,
//    are scheduled first.
//  Left out, for later: warp specialisation (a TMA producer warp and two
//  consumer warpgroups in ping-pong, so that one's softmax overlaps the
//  other's products; ordering the two warpgroups' products with named
//  barriers alone, without the producer, gained nothing at D = 256 and
//  lost at D = 96), a persistent grid, fp8.
//
// float32, flash_fwd_kernel<float, D> (the same five D), on the CUDA cores
// (products as float32 FMAs at 67 TFLOP/s at most; TF32 tensor-core
// products would break the 2e-5 agreement float32 is held to).  One block
// of 256 threads.  The Q tile (pre-scaled) sits in shared memory as
// float32, K and V are staged there tile by tile.  Threads form a 16 x 16
// grid: row group ty owns 4 query rows, lane tx owns key columns tx + 16 j
// of the scores and value columns tx + 16 j of the output, so the running
// max m, denominator l and the (4 x D/16) accumulator of each thread live
// in registers, and a row's max and sum reduce over the 16 lanes of a
// half-warp with shuffles.  The probabilities go through shared memory to
// the value product.  Shared rows are padded by one float so the strided
// reads do not collide in banks.  Its shared memory grows with D: 209 KB at
// D = 256, under the 227 KB a block may opt in to.
//
// Plain C interface, bound with ctypes: the entry returns the cudaError_t
// of its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block (per warpgroup in bf16)
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // float32 kernel: 16 row groups x 16 lanes
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hk, Sq, Sk, n_rep;
  int causal, has_window, window, q_offset;
  float sm_scale;
  float* lse;  // (B, Hq, Sq) log-sum-exp of the scaled scores, or null
};

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
    // the scores were scaled with Q: lse is m + log l, -inf with no valid key
    if (a.lse != nullptr && tx == 0)
      a.lse[(size_t)(b * a.Hq + h) * a.Sq + q0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // K/V ring
constexpr float kLog2e = 1.4426950408889634f;

// Warpgroups a block: two at D = 96 and 256, each with its own 64 query
// rows of a 128-row tile and the whole head dim, sharing the K/V ring; one
// otherwise.
template <int D>
__host__ __device__ constexpr int warpgroups() { return D == 96 || D == 256 ? 2 : 1; }

// A 64-row tile of bf16 rows of D values in shared memory, laid out as
// wgmma's descriptors read it: column blocks of kRowBytes-byte rows (one
// block at D = 16 and 64, two at 96 and 128, four at 256), in each block
// the 16-byte chunks of row r XOR-swizzled by the address bits above the
// row (r % 8 for 128-byte rows, (r / 4) % 2 for 32-byte rows), which is
// what the hardware undoes when the block starts at a 1024-byte boundary.
// At D = 96 the second block's last 32 columns are never written or read.
template <int D>
struct Tile {
  static_assert(D == 16 || D == 64 || D == 96 || D == 128 || D == 256,
                "head dims 16, 64, 96, 128, 256");
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;
  static constexpr int kBlockCols = kRowBytes / 2;  // bf16 per row of a block
  static constexpr int kBlocks = (D + kBlockCols - 1) / kBlockCols;
  static constexpr int kChunks = kRowBytes / 16;    // 16-byte chunks per row
  static constexpr int kBlockBytes = 64 * kRowBytes;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  // descriptor swizzle mode: 1 = 128 bytes, 3 = 32 bytes
  static constexpr uint64_t kMode = D >= 64 ? 1 : 3;

  // byte offset of chunk c (values 8c .. 8c + 7 of the row) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const int blk = c / kChunks, cc = c % kChunks;
    const int sw = ((r * kRowBytes) >> 7) & (kChunks - 1);
    return blk * kBlockBytes + r * kRowBytes + ((cc ^ sw) << 4);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  // bytes < 16 zero-fills the rest of the 16 (0: all of them, src unread)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// makes this thread's writes to shared memory (generic proxy, cp.async
// included) visible to wgmma's reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses to wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Tile load: rows at or past `valid` are zero-filled (their source is
// not read).  Every one of the block's NT threads issues 64 * D / 8 / NT
// copies of 16 bytes, neighbouring threads on neighbouring chunks of a row.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int valid,
                                          int tid) {
  constexpr int kRowChunks = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * kRowChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / kRowChunks, c = idx % kRowChunks;
    const bool in = r < valid;
    cp_async16(dst + Tile<D>::offset(r, c), src + (size_t)(in ? r : 0) * D + c * 8,
               in ? 16 : 0);
  }
}

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand (Q as A, K as B of S = Q K^T): values 16 kk .. 16 kk + 15
// of every row; 8-row groups lie 8 rows apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  using T = Tile<D>;
  const int col = 16 * kk;
  return smem_desc(tile + (col / T::kBlockCols) * T::kBlockBytes + (col % T::kBlockCols) * 2,
                   16, 8 * T::kRowBytes, T::kMode);
}

// V as the B operand of O = P V, read transposed (N = d contiguous): keys
// 16 kk .. 16 kk + 15 from column block blk on; 8-key groups lie 8 rows
// apart, column blocks a block apart (the leading byte offset, which a
// product wider than one block steps by).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int blk, int kk) {
  using T = Tile<D>;
  return smem_desc(tile + blk * T::kBlockBytes + 16 * kk * T::kRowBytes,
                   T::kBlockBytes, 8 * T::kRowBytes, T::kMode);
}

// D(64x64, f32) (+)= A(64x16, smem) B(64x16, smem)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64x64, f32) += A(64x16, registers) B, B read transposed from smem
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64x16, f32) += A(64x16, registers) B, B read transposed from smem
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64x96, f32) += A(64x16, registers) B, B read transposed from smem
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V at head dim D: kCount products of N = kN columns each for every
// 16 keys, product i from column i kN on.  One per 64-column block at
// D = 64, 128 and 256 (m64n64k16), one m64n16k16 at D = 16, one
// m64n96k16 at D = 96, reading both of its column blocks.
template <int D>
struct Pv {
  static constexpr int kN = D == 96 ? 96 : Tile<D>::kBlockCols;
  static constexpr int kCount = D / kN;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of an m64nN product: thread (warp w, lane) holds,
// for each 8 columns j, elements 4j + e at row 16 w + lane / 4 + 8 (e / 2)
// and column 8 j + 2 (lane % 4) + e % 2.  The online softmax on the scores
// s of one key tile: scales and masks them, updates the running max m and
// this thread's share of the denominator l for its two rows, rescales the
// output accumulator and leaves the probabilities in p as bf16 pairs, in
// the register layout of wgmma's A operand (4 registers per 16 keys),
// which is the accumulator's order.
template <bool kMask, int NACC, int NBLK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t (&p)[16],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[NBLK][NACC], float scale,
                                             int kpos0, int qpos0, const Args& a) {
  float mx[2] = {m[0], m[1]};
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * scale;
    if (kMask) {
      const int kpos = kpos0 + 8 * (i >> 2) + (i & 1);
      const int qpos = qpos0 + 8 * ((i >> 1) & 1);
      bool ok = kpos < a.Sk;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.has_window) ok = ok && kpos > qpos - a.window;
      if (ok) valid |= 1u << i;
      else x = kNegInf;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float e = exp2f(s[i] - mx[(i >> 1) & 1]);
    if (kMask && !((valid >> i) & 1u)) e = 0.f;
    l[(i >> 1) & 1] += e;
    s[i] = e;
  }
#pragma unroll
  for (int b = 0; b < NBLK; ++b)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[b][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads * warpgroups<D>()) flash_fwd_bf16(Args a) {
  using T = Tile<D>;
  constexpr int kWg = warpgroups<D>();
  constexpr int kPvN = Pv<D>::kN;
  constexpr int kAcc = kPvN / 2;  // accumulator floats per product of O += P V
  // the two-warpgroup instances (D = 96, 256) issue the next key tile's
  // copies after S's products, so that the issue hides under the tensor
  // cores; the others keep the order they were first ported with
  constexpr bool kLate = kWg > 1;
  extern __shared__ uint8_t smem[];
  // tiles start at 1024-byte boundaries, where the swizzle pattern does;
  // a Q tile per warpgroup, then the K/V ring
  const uint32_t sQ = ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + kWg * T::kBytes;  // stage s: K at + 2 s kBytes, V after it

  const int tid = threadIdx.x;
  // this thread's warpgroup and warp in it (with one warpgroup, 0 and
  // tid >> 5 as constants fold them); the warpgroup is broadcast from lane
  // 0 so that the compiler sees it uniform across the warp, and a branch
  // on it around wgmma does not serialise the products
  const int wg = kWg == 1 ? 0 : __shfl_sync(0xffffffffu, tid / kThreads, 0);
  const int warp = (kWg == 1 ? tid : tid % kThreads) >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * (kBQ * kWg);
  const int kvh = h / a.n_rep;
  const int rows = min(kBQ * kWg, a.Sq - q0);

  const bf16* q = (const bf16*)a.q + ((size_t)(b * a.Hq + h) * a.Sq + q0) * D;
  const bf16* k = (const bf16*)a.k + (size_t)(b * a.Hk + kvh) * a.Sk * D;
  const bf16* v = (const bf16*)a.v + (size_t)(b * a.Hk + kvh) * a.Sk * D;
  bf16* o = (bf16*)a.o + ((size_t)(b * a.Hq + h) * a.Sq + q0) * D;

  // the keys that some valid row of this tile may see
  const int qpos_first = a.q_offset + q0;
  const int qpos_last = a.q_offset + q0 + rows - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, qpos_last + 1);
  int k_begin = 0;
  if (a.has_window) k_begin = max(0, qpos_first - a.window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  if (t_begin < t_end) {  // else nothing to load: the block writes zeros
    const int k0 = t_begin * kBK;
#pragma unroll
    for (int w = 0; w < kWg; ++w)
      load_tile<D, kThreads * kWg>(sQ + w * T::kBytes, q + (size_t)w * kBQ * D,
                                   rows - w * kBQ, tid);
    load_tile<D, kThreads * kWg>(sKV, k + (size_t)k0 * D, a.Sk - k0, tid);
    load_tile<D, kThreads * kWg>(sKV + T::kBytes, v + (size_t)k0 * D, a.Sk - k0, tid);
  }
  cp_async_commit();

  // this warpgroup's 64 rows (the block's, with one warpgroup) and the key
  // tiles they see: with two, a tile that only the other warpgroup's rows
  // see is loaded but not multiplied here
  const int qw = q0 + wg * kBQ;
  const int rows_w = kWg == 1 ? rows : min(kBQ, a.Sq - qw);
  const uint32_t sQw = sQ + wg * T::kBytes;
  const int qpos_first_w = a.q_offset + qw;
  const int qpos_last_w = a.q_offset + qw + rows_w - 1;
  int t_begin_w = t_begin, t_end_w = t_end;
  if constexpr (kWg > 1) {
    int ke = rows_w > 0 ? a.Sk : 0;
    if (a.causal) ke = min(ke, qpos_last_w + 1);
    t_begin_w = a.has_window ? max(0, qpos_first_w - a.window + 1) / kBK : 0;
    t_end_w = ke > 0 ? (ke + kBK - 1) / kBK : 0;
  }

  const float scale = a.sm_scale * kLog2e;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and columns c0, c0 + 1 of each 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[Pv<D>::kCount][kAcc];
#pragma unroll
  for (int i = 0; i < Pv<D>::kCount; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const uint32_t sK = sKV + 2 * ((t - t_begin) & 1) * T::kBytes;
    const uint32_t sV = sK + T::kBytes;
    const auto load_next = [&] {  // the next tile into the other stage
      const uint32_t nK = sKV + 2 * ((t + 1 - t_begin) & 1) * T::kBytes;
      const int k1 = (t + 1) * kBK;
      load_tile<D, kThreads * kWg>(nK, k + (size_t)k1 * D, a.Sk - k1, tid);
      load_tile<D, kThreads * kWg>(nK + T::kBytes, v + (size_t)k1 * D, a.Sk - k1, tid);
      cp_async_commit();
    };
    if (kLate) {
      cp_async_wait<0>();
    } else if (t + 1 < t_end) {
      load_next();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // every thread's copies of this tile (and Q) landed

    const bool active = kWg == 1 || (t >= t_begin_w && t < t_end_w);
    float s[32];
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_k_major<D>(sQw, kk), desc_k_major<D>(sK, kk), kk > 0);
      wgmma_commit();
    }
    // every thread issues its share of the copies, active or not; the
    // stage they fill was last read in the previous tile, which every
    // thread finished before this tile's barrier
    if (kLate && t + 1 < t_end) load_next();
    if (active) {
      wgmma_wait_all();
      reg_fence(s);

      const int k0 = t * kBK;
      const bool edge = k0 + kBK > a.Sk || (a.causal && k0 + kBK - 1 > qpos_first_w) ||
                        (a.has_window && k0 <= qpos_last_w - a.window);
      uint32_t p[16];
      if (edge)
        softmax_tile<true>(s, p, m, l, acc, scale, k0 + c0, qpos_first_w + r0, a);
      else
        softmax_tile<false>(s, p, m, l, acc, scale, k0 + c0, qpos_first_w + r0, a);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < Pv<D>::kCount; ++i)
          wgmma_rs(acc[i], p + 4 * kk, desc_mn_major<D>(sV, i * kPvN / T::kBlockCols, kk));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < Pv<D>::kCount; ++i) reg_fence(acc[i]);
    }
    // the next iteration refills this stage: before its own barrier unless
    // kLate, so a barrier must close this tile; after it when kLate
    if (!kLate) __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: acc is 0, writes 0
  }
#pragma unroll
  for (int i = 0; i < Pv<D>::kCount; ++i)
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < rows_w)
          *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(wg * kBQ + row) * D + i * kPvN +
                                             8 * j + c0) =
              __floats2bfloat162_rn(acc[i][4 * j + 2 * r] * inv[r],
                                    acc[i][4 * j + 2 * r + 1] * inv[r]);
      }
  // m is in log2 units (the scores were scaled by sm_scale log2 e): lse
  // = (m + log2 l) ln 2, -inf with no valid key
  if (a.lse != nullptr && (lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < rows_w)
        a.lse[(size_t)(b * a.Hq + h) * a.Sq + qw + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.69314718055994531f : -INFINITY;
    }
}

}  // namespace tc

template <int D>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  constexpr int kWg = tc::warpgroups<D>();
  // a Q tile per warpgroup, then kStages pairs of K and V tiles, and room
  // to align to 1024 bytes
  const size_t smem = (size_t)tc::Tile<D>::kBytes * (kWg + 2 * tc::kStages) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq, B, (a.Sq + kBQ * kWg - 1) / (kBQ * kWg));
  tc::flash_fwd_bf16<D><<<grid, tc::kThreads * kWg, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward: flash_bwd_preprocess, flash_bwd_dkdv, flash_bwd_dq
// ---------------------------------------------------------------------------
//
// The reference has no backward kernel: it trains by autodiff of its plain
// attention.  These three exist so that training through the forward
// kernel has a gradient on the card.  With P = exp(S sm_scale - lse) (S =
// Q K^T, lse from the forward), dO the output's gradient and
// delta = rowsum(dO o O):
//     dV = P^T dO,  dS = P o (dO V^T - delta),
//     dK = sm_scale dS^T Q,  dQ = sm_scale dS K,
// each sum over the key or query pairs the mask lets through, GQA's query
// heads summed into their KV head.  A row with no valid key (lse = -inf)
// contributes nothing and gets dQ = 0.
//
// Bound: 5 products of 2 D flops per valid (query, key) pair, at 989
// TFLOP/s on the bf16 tensor cores.  The kernels do 7: dkdv computes S and
// dP for its key tile, and dq computes both again for its query tile, so
// that dQ has a pass of its own and every sum one owner (no atomics: dQ,
// dK and dV are the same bits from run to run).  Three launches in order:
//  * flash_bwd_preprocess: one warp a row, delta in float32.
//  * dK and dV: a block owns a 64-key tile of one KV head of one batch
//    item and loops over its group's n_rep query heads and, within each,
//    over the 64-row query tiles the mask lets see the tile, in that fixed
//    order.
//  * dQ: a block owns a 64-row query tile of one query head and loops
//    over the key tiles its rows can see.
//
// bf16, flash_bwd_dkdv_bf16<D> and flash_bwd_dq_bf16<D> (the five D), on
// the tensor cores (the training path's bf16 inputs: granite-3-2b's D = 64,
// phi3-mini-3.8b's 96, gemma3-12b's 256, the smoke configs' 16).  One
// warpgroup a block (two at D = 256, below), the forward's parts:
// swizzled Tile<D> shared memory, wgmma with float32 accumulators in
// registers, the cp.async ring of two stages.
//  * dkdv keeps K and V resident.  Q, dO, lse and delta of the next query
//    tile load into the other stage while this one is multiplied.  It
//    computes the transposes S^T = K Q^T and dP^T = V dO^T (both operands
//    K-major, M = keys, N = query rows), so that P^T = exp2(S^T sm_scale
//    log2 e - lse log2 e) and dS^T = P^T o (dP^T - delta) come out in the
//    accumulator layout, which is wgmma's A-operand layout once packed to
//    bf16 (as the forward packs P).  dV += P^T dO and dK += dS^T Q then
//    read P^T and dS^T from registers and dO and Q MN-major, as the forward
//    reads V: 4 products a query tile, nothing of P or dS through shared
//    memory.  A thread's rows are keys and its columns query positions, so
//    the mask's predicate is taken with the roles swapped and lse and
//    delta are read for the 16 query columns it holds.
//  * dq loads Q and dO once and K/V tiles through the ring, as the
//    forward: S = Q K^T and dP = dO V^T (both K-major), P and dS in
//    registers, dQ += dS K with K read MN-major: 3 products a key tile.
//    The last query tiles, which see the most keys under the causal mask,
//    are scheduled first; in dkdv the first key tiles are.
//  * P and dS are rounded to bf16 only where they enter a product (the
//    plain version's round_to_bf16 repeats that).  A row with no valid
//    key (lse = -inf) is read as lse = +inf, so its P is exp2(-inf) = 0;
//    rows and keys past Sq and Sk load as zeros (their delta and lse as 0),
//    so they add nothing; only the tiles that the diagonal, the window's
//    edge or Sk cut are masked elementwise.  dK is scaled by sm_scale in
//    float32 at write-out.
//  * Registers: dK and dV take D floats a thread together, S^T and dP^T
//    64, dQ D / 2.  At D = 256 that is too many for one warpgroup, so both
//    kernels take two there, each holding half of D's columns of dK and dV
//    (dQ) and each computing the whole of S and dP from the shared tiles:
//    6 products a query tile in dkdv in place of 4, 5 a key tile in dq in
//    place of 3.  dkdv at D = 256 also takes a query tile's S^T and dP^T in
//    two halves of 32 rows (m64n32), 32 registers in place of 64.
//  * Shared memory: dkdv K, V + 2 stages x (Q, dO) tiles + 1 KB of lse and
//    delta, 50 KB at D = 64, 98 KB at D = 96 and 128, 194 KB at 256; dq
//    the same tiles without the lse stages.
//  Left out, for later: warp specialisation with a TMA producer, a single
//  pass (dQ by atomics would lose the fixed order).
//
// float32, flash_bwd_dkdv<D> and flash_bwd_dq<D> (the five
// D), on the CUDA cores (float32 FMAs at 67 TFLOP/s at most; TF32 products
// would break float32's 2e-5 agreement).
//  * flash_bwd_dkdv: one block of 256 threads, 32-row query tiles.  K
//    and V stay in shared memory; each query tile brings Q, dO, lse and
//    delta.  Thread (ty, tx) of a 16 x 16 grid computes S and dP for rows
//    2 ty, 2 ty + 1 and keys tx + 16 j, P and dS go through shared memory,
//    and it accumulates dK and dV for keys 4 ty .. 4 ty + 3 and columns
//    tx + 16 j in registers.
//  * flash_bwd_dq: one block per 32-row query tile, query head and batch
//    item; dQ for rows 2 ty, 2 ty + 1 and columns tx + 16 j in registers.
//  Shared rows are padded by one float, as in the forward's float32
//  kernel: 209 KB (dkdv) and 201 KB (dq) at D = 256.

namespace bwd {

constexpr int kKeys = 64;   // keys per tile
constexpr int kRows = 32;   // query rows per tile
constexpr int kThreads = 256;
constexpr int kPS = kKeys + 1;  // padded row stride of the P and dS tiles

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int Hq, Hk, Sq, Sk, n_rep;
  int causal, has_window, window, q_offset;
  float sm_scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// delta[row] = sum_d dO[row, d] O[row, d] over the B Hq Sq rows
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_preprocess(BwdArgs a, long rows) {
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = (const T*)a.o + row * D;
  const T* g = (const T*)a.dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(ld(g + d), ld(o + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// may query position qpos see key position kpos
__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos, int kpos) {
  bool ok = kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.has_window) ok = ok && kpos > qpos - a.window;
  return ok;
}

// rows r < valid of a (rows x D) tile from src into shared dst (row stride
// D + 1), zero past valid
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows, int valid, int tid) {
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < valid ? ld(src + (size_t)r * D + d) : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * (size_t)kKeys * (D + 1) + 2 * (size_t)kRows * (D + 1) +
                          2 * (size_t)kRows * kPS + 2 * kRows);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(BwdArgs a) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // kKeys x DP
  float* Vs = Ks + kKeys * DP;   // kKeys x DP
  float* Qs = Vs + kKeys * DP;   // kRows x DP
  float* Gs = Qs + kRows * DP;   // kRows x DP (dO)
  float* Ps = Gs + kRows * DP;   // kRows x kPS
  float* dSs = Ps + kRows * kPS; // kRows x kPS
  float* Ls = dSs + kRows * kPS; // kRows lse
  float* Es = Ls + kRows;        // kRows delta

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kKeys;
  const int keys = min(kKeys, a.Sk - k0);
  const size_t kv_off = ((size_t)(b * a.Hk + kvh) * a.Sk + k0) * D;
  stage<D>(Ks, (const float*)a.k + kv_off, kKeys, keys, tid);
  stage<D>(Vs, (const float*)a.v + kv_off, kKeys, keys, tid);

  // the query rows that may see some key of this tile
  const int k_last = k0 + keys - 1;
  int i_begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  int i_end = a.Sq;
  if (a.has_window) i_end = min(i_end, max(0, k_last + a.window - a.q_offset));
  const int t_begin = i_begin / kRows;
  const int t_end = i_end > i_begin ? (i_end + kRows - 1) / kRows : t_begin;

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int r = 0; r < a.n_rep; ++r) {
    const int h = kvh * a.n_rep + r;
    const size_t row0 = (size_t)(b * a.Hq + h) * a.Sq;
    for (int t = t_begin; t < t_end; ++t) {
      const int i0 = t * kRows;
      const int rows = min(kRows, a.Sq - i0);
      __syncthreads();  // the last tile's Qs, Gs, Ps, dSs read (and Ks, Vs written)
      stage<D>(Qs, (const float*)a.q + (row0 + i0) * D, kRows, rows, tid);
      stage<D>(Gs, (const float*)a.dout + (row0 + i0) * D, kRows, rows, tid);
      if (tid < kRows) {
        Ls[tid] = tid < rows ? a.lse[row0 + i0 + tid] : -INFINITY;
        Es[tid] = tid < rows ? a.delta[row0 + i0 + tid] : 0.f;
      }
      __syncthreads();

      // S and dP for rows 2 ty + i, keys tx + 16 j
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[2], gv[2], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          qv[i] = Qs[(2 * ty + i) * DP + d];
          gv[i] = Gs[(2 * ty + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Ks[(tx + 16 * j) * DP + d];
          vv[j] = Vs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = 2 * ty + i;
        const int qpos = a.q_offset + i0 + qi;
        const float lse = Ls[qi], delta = Es[qi];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = tx + 16 * j;
          const bool ok = qi < rows && lse != -INFINITY && visible(a, qpos, k0 + kk);
          const float p = ok ? expf(s[i][j] * a.sm_scale - lse) : 0.f;
          Ps[qi * kPS + kk] = p;
          dSs[qi * kPS + kk] = p * (dp[i][j] - delta);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q for keys 4 ty + i, columns tx + 16 j
#pragma unroll 4
      for (int qi = 0; qi < kRows; ++qi) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[qi * kPS + 4 * ty + i];
          ds[i] = dSs[qi * kPS + 4 * ty + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float g = Gs[qi * DP + tx + 16 * j];
          const float qq = Qs[qi * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(p[i], g, dv[i][j]);
            dk[i][j] = fmaf(ds[i], qq, dk[i][j]);
          }
        }
      }
    }
  }

  float* dk_out = (float*)a.dk + kv_off;
  float* dv_out = (float*)a.dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = 4 * ty + i;
    if (kk >= keys) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[(size_t)kk * D + tx + 16 * j] = dk[i][j] * a.sm_scale;
      dv_out[(size_t)kk * D + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (size_t)kKeys * (D + 1) + 2 * (size_t)kRows * (D + 1) +
                          (size_t)kRows * kPS + 2 * kRows);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(BwdArgs a) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // kRows x DP
  float* Gs = Qs + kRows * DP;   // kRows x DP (dO)
  float* Ks = Gs + kRows * DP;   // kKeys x DP
  float* Vs = Ks + kKeys * DP;   // kKeys x DP
  float* dSs = Vs + kKeys * DP;  // kRows x kPS
  float* Ls = dSs + kRows * kPS; // kRows lse
  float* Es = Ls + kRows;        // kRows delta

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.n_rep;
  const int i0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.Sq - i0);
  const size_t row0 = (size_t)(b * a.Hq + h) * a.Sq + i0;
  stage<D>(Qs, (const float*)a.q + row0 * D, kRows, rows, tid);
  stage<D>(Gs, (const float*)a.dout + row0 * D, kRows, rows, tid);
  if (tid < kRows) {
    Ls[tid] = tid < rows ? a.lse[row0 + tid] : -INFINITY;
    Es[tid] = tid < rows ? a.delta[row0 + tid] : 0.f;
  }

  // the keys that some row of this tile may see
  const int qpos_first = a.q_offset + i0, qpos_last = a.q_offset + i0 + rows - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, qpos_last + 1);
  const int k_begin = a.has_window ? max(0, qpos_first - a.window + 1) : 0;
  const int t_begin = k_begin / kKeys;
  const int t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;
  const float* kb = (const float*)a.k + (size_t)(b * a.Hk + kvh) * a.Sk * D;
  const float* vb = (const float*)a.v + (size_t)(b * a.Hk + kvh) * a.Sk * D;

  float dq[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // Qs, Gs, Ls, Es written; the last tile's Ks, dSs read
    stage<D>(Ks, kb + (size_t)k0 * D, kKeys, a.Sk - k0, tid);
    stage<D>(Vs, vb + (size_t)k0 * D, kKeys, a.Sk - k0, tid);
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[2], gv[2], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qv[i] = Qs[(2 * ty + i) * DP + d];
        gv[i] = Gs[(2 * ty + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = 2 * ty + i;
      const int qpos = a.q_offset + i0 + qi;
      const float lse = Ls[qi], delta = Es[qi];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const bool ok = qi < rows && lse != -INFINITY && visible(a, qpos, k0 + kk);
        const float p = ok ? expf(s[i][j] * a.sm_scale - lse) : 0.f;
        dSs[qi * kPS + kk] = p * (dp[i][j] - delta);
      }
    }
    __syncthreads();

    // dQ += dS K for rows 2 ty + i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      const float ds0 = dSs[(2 * ty) * kPS + kk], ds1 = dSs[(2 * ty + 1) * kPS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[kk * DP + tx + 16 * j];
        dq[0][j] = fmaf(ds0, kv, dq[0][j]);
        dq[1][j] = fmaf(ds1, kv, dq[1][j]);
      }
    }
  }

  float* out = (float*)a.dq + row0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = 2 * ty + i;
    if (qi >= rows) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[(size_t)qi * D + tx + 16 * j] = dq[i][j] * a.sm_scale;
  }
}

// flash_bwd_dkdv and flash_bwd_dq on the CUDA cores
template <int D>
int launch_bwd_cuda_cores(const BwdArgs& a, int B, int passes, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if ((passes & 2) && a.Sk > 0) {
    const size_t smem_kv = dkdv_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_kv((a.Sk + kKeys - 1) / kKeys, a.Hk, B);
    flash_bwd_dkdv<D><<<grid_kv, kThreads, smem_kv, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!(passes & 4)) return 0;
  const size_t smem_q = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((a.Sq + kRows - 1) / kRows, a.Hq, B);
  flash_bwd_dq<D><<<grid_q, kThreads, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// Warpgroups a block: two at D = 256, each holding dK and dV (dQ) for half
// of D's columns, each computing the whole of S and dP; one otherwise.
template <int D>
__host__ __device__ constexpr int bwd_warpgroups() { return D == 256 ? 2 : 1; }

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  // bytes 0 zero-fills the 4 (src unread)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// D(64x32, f32) (+)= A(64x16, smem) B(32x16, smem)^T
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N) = A B^T over D, N = 64 or 32 rows of B, both operands K-major
// in Tile<D> shared memory (b the address of B's first row): D / 16
// products of k16, issued (not committed) on this warpgroup
template <int D, int NACC>
__device__ __forceinline__ void products_k_major(float (&d)[NACC], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (NACC == 32)
      tc::wgmma_ss_n64(d, tc::desc_k_major<D>(a, kk), tc::desc_k_major<D>(b, kk), kk > 0);
    else
      wgmma_ss_n32(d, tc::desc_k_major<D>(a, kk), tc::desc_k_major<D>(b, kk), kk > 0);
  }
}

// lse in log2 units for exp2; a row with no valid key (-inf) as +inf, so
// that exp2(s - lse) is 0 there and never inf
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * tc::kLog2e;
}

// K, V, then kStages stages of (Q, dO), then kStages stages of 64 lse and
// 64 delta, and room to align to 1024 bytes
template <int D>
constexpr size_t dkdv_bf16_smem() {
  return (size_t)tc::Tile<D>::kBytes * (2 + 2 * tc::kStages) +
         tc::kStages * 2 * kKeys * sizeof(float) + 1024;
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads * bwd_warpgroups<D>())
    flash_bwd_dkdv_bf16(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using Tl = tc::Tile<D>;
  constexpr int kWg = bwd_warpgroups<D>();
  constexpr int kNT = tc::kThreads * kWg;
  constexpr int kCols = D / kWg;     // columns of dK and dV a warpgroup holds
  constexpr int kN = tc::Pv<D>::kN;  // columns of D one dK or dV product covers
  constexpr int kCount = kCols / kN;
  constexpr int kAcc = kN / 2;
  constexpr int kQ = 64;             // query rows a tile
  // query rows S^T and dP^T cover at once: at D = 256 a tile's two halves
  // in turn, so that S^T and dP^T take 32 registers a thread, not 64
  constexpr int kHalves = D == 256 ? 2 : 1;
  constexpr int kP = kQ / kHalves;
  extern __shared__ uint8_t tc_smem[];  // (smem is the CUDA-core kernels' float array)
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(tc_smem);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + Tl::kBytes;
  const uint32_t sRing = sV + Tl::kBytes;  // stage s: Q at + 2 s kBytes, dO after it
  const uint32_t sLD = sRing + 2 * tc::kStages * Tl::kBytes;  // stage s: lse, delta
  const float* lse_delta = reinterpret_cast<const float*>(tc_smem + (sLD - base));

  const int tid = threadIdx.x, lane = tid & 31;
  // this thread's warpgroup (broadcast from lane 0, so the compiler sees it
  // uniform across the warp) and its warp in it
  const int wg = kWg == 1 ? 0 : __shfl_sync(0xffffffffu, tid / tc::kThreads, 0);
  const int warp = (tid % tc::kThreads) >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;
  const int keys = min(kKeys, a.Sk - k0);
  const size_t kv_off = ((size_t)(b * a.Hk + kvh) * a.Sk + k0) * D;
  const bf16* q = (const bf16*)a.q;
  const bf16* g = (const bf16*)a.dout;

  // the query rows that may see some key of this tile, in 64-row tiles;
  // the block walks (query head, query tile) pairs, head by head
  const int k_last = k0 + keys - 1;
  const int i_begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  int i_end = a.Sq;
  if (a.has_window) i_end = min(i_end, max(0, k_last + a.window - a.q_offset));
  const int t_begin = i_begin / kQ;
  const int nt = i_end > i_begin ? (i_end + kQ - 1) / kQ - t_begin : 0;
  const int n_it = a.n_rep * nt;

  // Q, dO, lse and delta of step it into stage it % 2, one commit group
  const auto load_step = [&](int it) {
    const int st = it & 1;
    const int i0 = (t_begin + it % nt) * kQ;
    const size_t row0 = (size_t)(b * a.Hq + kvh * a.n_rep + it / nt) * a.Sq + i0;
    const uint32_t sQ = sRing + 2 * st * Tl::kBytes;
    tc::load_tile<D, kNT>(sQ, q + row0 * D, a.Sq - i0, tid);
    tc::load_tile<D, kNT>(sQ + Tl::kBytes, g + row0 * D, a.Sq - i0, tid);
    if (tid < 2 * kQ) {
      const int c = tid & (kQ - 1);
      const bool in = i0 + c < a.Sq;
      const float* src = tid < kQ ? a.lse : a.delta;
      cp_async4(sLD + st * 2 * kQ * sizeof(float) + tid * sizeof(float),
                src + row0 + (in ? c : 0), in ? 4 : 0);
    }
    tc::cp_async_commit();
  };

  float dk[kCount][kAcc], dv[kCount][kAcc];
#pragma unroll
  for (int i = 0; i < kCount; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (n_it > 0) {  // else nothing to load: the block writes zeros
    tc::load_tile<D, kNT>(sK, (const bf16*)a.k + kv_off, keys, tid);
    tc::load_tile<D, kNT>(sV, (const bf16*)a.v + kv_off, keys, tid);
    load_step(0);  // K and V in step 0's group
  }

  const float scale = a.sm_scale * tc::kLog2e;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and query columns c0, c0 + 1 of each 8
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_step(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();  // every thread's copies of this step (and K, V) landed

    const int st = it & 1;
    const uint32_t sQ = sRing + 2 * st * Tl::kBytes;
    const uint32_t sG = sQ + Tl::kBytes;
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      // S^T and dP^T: rows keys, columns the query rows kP hf .. of the tile
      float s[kP / 2], dp[kP / 2];
      tc::wgmma_fence();
      products_k_major<D>(s, sK, sQ + kP * hf * Tl::kRowBytes);
      products_k_major<D>(dp, sV, sG + kP * hf * Tl::kRowBytes);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::reg_fence(s);
      tc::reg_fence(dp);

      const int qpos0 = a.q_offset + (t_begin + it % nt) * kQ + kP * hf;
      const bool edge = k0 + kKeys > a.Sk || (a.causal && k0 + kKeys - 1 > qpos0) ||
                        (a.has_window && k0 <= qpos0 + kP - 1 - a.window);
      const float* L = lse_delta + st * 2 * kQ + kP * hf;  // lse, then delta at + kQ
      uint32_t pp[kP / 4], pd[kP / 4];  // P^T and dS^T as bf16 A operands
#pragma unroll
      for (int j = 0; j < kP / 8; ++j) {
        const float2 lse = *reinterpret_cast<const float2*>(L + 8 * j + c0);
        const float2 del = *reinterpret_cast<const float2*>(L + kQ + 8 * j + c0);
        const float l2[2] = {lse_log2(lse.x), lse_log2(lse.y)};
        const float dl[2] = {del.x, del.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = exp2f(fmaf(s[i], scale, -l2[e & 1]));
          if (edge && !visible(a, qpos0 + 8 * j + c0 + (e & 1), k0 + r0 + 8 * (e >> 1)))
            p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl[e & 1]);
        }
        pp[2 * j] = tc::pack_bf16(s[4 * j], s[4 * j + 1]);
        pp[2 * j + 1] = tc::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        pd[2 * j] = tc::pack_bf16(dp[4 * j], dp[4 * j + 1]);
        pd[2 * j + 1] = tc::pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }

      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
#pragma unroll
        for (int i = 0; i < kCount; ++i) {
          const int blk = (wg * kCols + i * kN) / Tl::kBlockCols;
          const int rows16 = kP / 16 * hf + kk;  // 16-row group of the tile
          tc::wgmma_rs(dv[i], pp + 4 * kk, tc::desc_mn_major<D>(sG, blk, rows16));
          tc::wgmma_rs(dk[i], pd + 4 * kk, tc::desc_mn_major<D>(sQ, blk, rows16));
        }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < kCount; ++i) {
        tc::reg_fence(dv[i]);
        tc::reg_fence(dk[i]);
      }
    }
    __syncthreads();  // this stage is read: the next step refills it
  }

  bf16* dk_out = (bf16*)a.dk + kv_off;
  bf16* dv_out = (bf16*)a.dv + kv_off;
#pragma unroll
  for (int i = 0; i < kCount; ++i)
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = r0 + 8 * r;
        if (key >= keys) continue;
        const size_t at = (size_t)key * D + wg * kCols + i * kN + 8 * j + c0;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(
            dk[i][4 * j + 2 * r] * a.sm_scale, dk[i][4 * j + 2 * r + 1] * a.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
            __floats2bfloat162_rn(dv[i][4 * j + 2 * r], dv[i][4 * j + 2 * r + 1]);
      }
}

// Q, dO, then kStages stages of (K, V), and room to align to 1024 bytes
template <int D>
constexpr size_t dq_bf16_smem() {
  return (size_t)tc::Tile<D>::kBytes * (2 + 2 * tc::kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads * bwd_warpgroups<D>())
    flash_bwd_dq_bf16(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using Tl = tc::Tile<D>;
  constexpr int kWg = bwd_warpgroups<D>();
  constexpr int kNT = tc::kThreads * kWg;
  constexpr int kCols = D / kWg;  // columns of dQ a warpgroup holds
  constexpr int kN = tc::Pv<D>::kN;
  constexpr int kCount = kCols / kN;
  constexpr int kAcc = kN / 2;
  constexpr int kQ = 64;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t sQ = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023u) & ~1023u;
  const uint32_t sG = sQ + Tl::kBytes;
  const uint32_t sKV = sG + Tl::kBytes;  // stage s: K at + 2 s kBytes, V after it

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = kWg == 1 ? 0 : __shfl_sync(0xffffffffu, tid / tc::kThreads, 0);
  const int warp = (tid % tc::kThreads) >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kQ;
  const int kvh = h / a.n_rep;
  const int rows = min(kQ, a.Sq - i0);
  const size_t row0 = (size_t)(b * a.Hq + h) * a.Sq + i0;
  const bf16* k = (const bf16*)a.k + (size_t)(b * a.Hk + kvh) * a.Sk * D;
  const bf16* v = (const bf16*)a.v + (size_t)(b * a.Hk + kvh) * a.Sk * D;

  // the keys that some row of this tile may see
  const int qpos_first = a.q_offset + i0, qpos_last = a.q_offset + i0 + rows - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, qpos_last + 1);
  const int k_begin = a.has_window ? max(0, qpos_first - a.window + 1) : 0;
  const int t_begin = k_begin / kKeys;
  const int t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;

  if (t_begin < t_end) {  // else nothing to load: the block writes zeros
    const int k1 = t_begin * kKeys;
    tc::load_tile<D, kNT>(sQ, (const bf16*)a.q + row0 * D, rows, tid);
    tc::load_tile<D, kNT>(sG, (const bf16*)a.dout + row0 * D, rows, tid);
    tc::load_tile<D, kNT>(sKV, k + (size_t)k1 * D, a.Sk - k1, tid);
    tc::load_tile<D, kNT>(sKV + Tl::kBytes, v + (size_t)k1 * D, a.Sk - k1, tid);
  }
  tc::cp_async_commit();

  const float scale = a.sm_scale * tc::kLog2e;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and key columns c0, c0 + 1 of each 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = r0 + 8 * r < rows;
    l2[r] = in ? lse_log2(a.lse[row0 + r0 + 8 * r]) : 0.f;
    dl[r] = in ? a.delta[row0 + r0 + 8 * r] : 0.f;
  }
  float dq[kCount][kAcc];
#pragma unroll
  for (int i = 0; i < kCount; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) dq[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const uint32_t sK = sKV + 2 * ((t - t_begin) & 1) * Tl::kBytes;
    const uint32_t sV = sK + Tl::kBytes;
    if (t + 1 < t_end) {  // the next tile into the other stage
      const uint32_t nK = sKV + 2 * ((t + 1 - t_begin) & 1) * Tl::kBytes;
      const int k1 = (t + 1) * kKeys;
      tc::load_tile<D, kNT>(nK, k + (size_t)k1 * D, a.Sk - k1, tid);
      tc::load_tile<D, kNT>(nK + Tl::kBytes, v + (size_t)k1 * D, a.Sk - k1, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();  // every thread's copies of this tile (and Q, dO) landed

    float s[32], dp[32];
    tc::wgmma_fence();
    products_k_major<D>(s, sQ, sK);
    products_k_major<D>(dp, sG, sV);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::reg_fence(s);
    tc::reg_fence(dp);

    const int k0 = t * kKeys;
    const bool edge = k0 + kKeys > a.Sk || (a.causal && k0 + kKeys - 1 > qpos_first) ||
                      (a.has_window && k0 <= qpos_last - a.window);
    uint32_t pd[16];  // dS as bf16 A operands
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], scale, -l2[r]));
      if (edge && !visible(a, qpos_first + r0 + 8 * r, k0 + 8 * (i >> 2) + c0 + (i & 1)))
        p = 0.f;
      dp[i] = p * (dp[i] - dl[r]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pd[i] = tc::pack_bf16(dp[2 * i], dp[2 * i + 1]);

    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int i = 0; i < kCount; ++i)
        tc::wgmma_rs(dq[i], pd + 4 * kk,
                     tc::desc_mn_major<D>(sK, (wg * kCols + i * kN) / Tl::kBlockCols, kk));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < kCount; ++i) tc::reg_fence(dq[i]);
    __syncthreads();  // this stage is read: the tile after next refills it
  }

  bf16* out = (bf16*)a.dq + row0 * D;
#pragma unroll
  for (int i = 0; i < kCount; ++i)
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + wg * kCols + i * kN +
                                             8 * j + c0) =
              __floats2bfloat162_rn(dq[i][4 * j + 2 * r] * a.sm_scale,
                                    dq[i][4 * j + 2 * r + 1] * a.sm_scale);
      }
}

// passes: a bit mask of the launches to make, in order: 1 preprocess,
// 2 dkdv, 4 dq (7 for the whole backward; one at a time to time each).
// bf16 takes the tensor-core kernels, float32 the CUDA-core ones.
template <typename T, int D>
int launch_bwd(const BwdArgs& a, int B, int passes, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    const long rows = (long)B * a.Hq * a.Sq;
    flash_bwd_preprocess<T, D><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                                 kThreads, 0, stream>>>(a, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (sizeof(T) == 2) {
    if ((passes & 2) && a.Sk > 0) {
      const size_t smem_kv = dkdv_bf16_smem<D>();
      err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
      if (err != cudaSuccess) return (int)err;
      // key tiles slowest, so that the first ones (the most query rows
      // under the causal mask) go first
      const dim3 grid_kv(a.Hk, B, (a.Sk + kKeys - 1) / kKeys);
      flash_bwd_dkdv_bf16<D>
          <<<grid_kv, tc::kThreads * bwd_warpgroups<D>(), smem_kv, stream>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (!(passes & 4)) return 0;
    const size_t smem_q = dq_bf16_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_q);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid_q(a.Hq, B, (a.Sq + 63) / 64);
    flash_bwd_dq_bf16<D><<<grid_q, tc::kThreads * bwd_warpgroups<D>(), smem_q, stream>>>(a);
    return (int)cudaGetLastError();
  } else {
    return launch_bwd_cuda_cores<D>(a, B, passes, stream);
  }
}

}  // namespace bwd

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike); D: 16, 64, 96, 128
// or 256 (the smoke configs' 16, granite-3-2b's 64, phi3-mini-3.8b's 96,
// which MLA also takes, its v padded to its qk head dim, and gemma3-12b's
// 256); any other D returns cudaErrorInvalidValue.
// All four tensors are contiguous; bf16 ones start at a 16-byte boundary.
// window is read only when has_window.  lse, where not null, receives the
// float32 (B, Hq, Sq) log-sum-exp of each row's scaled scores (-inf for a
// row with no valid key), for the backward; null leaves the outputs as
// they were without it.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hk, int Sq, int Sk, int D,
                        int dtype, int causal, int has_window, int window,
                        int q_offset, float sm_scale, void* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hk <= 0 || Hq % Hk != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, Hq, Hk, Sq, Sk, Hq / Hk,
         causal, has_window, window, q_offset, sm_scale, (float*)lse};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype * 1000 + D) {
    case 16: return launch<float, 16>(a, B, s);
    case 64: return launch<float, 64>(a, B, s);
    case 96: return launch<float, 96>(a, B, s);
    case 128: return launch<float, 128>(a, B, s);
    case 256: return launch<float, 256>(a, B, s);
    case 1016: return launch_bf16<16>(a, B, s);
    case 1064: return launch_bf16<64>(a, B, s);
    case 1096: return launch_bf16<96>(a, B, s);
    case 1128: return launch_bf16<128>(a, B, s);
    case 1256: return launch_bf16<256>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of flash_attention_fwd: delta (B, Hq, Sq, float32 scratch)
// = rowsum(dout o o), then dk, dv (B, Hk, Sk, D) and dq (B, Hq, Sq, D),
// written whole (every element, zeros where no valid pair reaches it).
// q, k, v, o, dout, dq, dk, dv share one dtype (0 float32, 1 bfloat16) and
// are contiguous; lse is the forward's.  The same head dims as the forward.
// passes: 7 for the whole backward, or the bits of the launches to make
// (1 preprocess, 2 dkdv, 4 dq), which run in that order and hand on delta.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq,
                        void* dk, void* dv, int B, int Hq, int Hk, int Sq, int Sk, int D,
                        int dtype, int causal, int has_window, int window, int q_offset,
                        float sm_scale, int passes, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hk <= 0 || Hq % Hk != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  bwd::BwdArgs a{q, k, v, o, dout, (const float*)lse, (float*)delta, dq, dk, dv,
                 Hq, Hk, Sq, Sk, Hq / Hk, causal, has_window, window, q_offset, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype * 1000 + D) {
    case 16: return bwd::launch_bwd<float, 16>(a, B, passes, s);
    case 64: return bwd::launch_bwd<float, 64>(a, B, passes, s);
    case 96: return bwd::launch_bwd<float, 96>(a, B, passes, s);
    case 128: return bwd::launch_bwd<float, 128>(a, B, passes, s);
    case 256: return bwd::launch_bwd<float, 256>(a, B, passes, s);
    case 1016: return bwd::launch_bwd<__nv_bfloat16, 16>(a, B, passes, s);
    case 1064: return bwd::launch_bwd<__nv_bfloat16, 64>(a, B, passes, s);
    case 1096: return bwd::launch_bwd<__nv_bfloat16, 96>(a, B, passes, s);
    case 1128: return bwd::launch_bwd<__nv_bfloat16, 128>(a, B, passes, s);
    case 1256: return bwd::launch_bwd<__nv_bfloat16, 256>(a, B, passes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
