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
// window is read only when has_window.
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

}  // extern "C"
