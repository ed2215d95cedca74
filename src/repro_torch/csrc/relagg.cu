// Fused filter + grouped sum/count for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/relagg/relagg.py::_relagg_kernel
// (launched by relagg_pallas): for rows r with mask[r] and 0 <= gid[r] < G,
//     out[gid[r], j] += vals[r, j]   (j < k)
//     out[gid[r], k] += 1
// into a (G, k+1) float32 output, every slot of which the kernel writes.
// Masked rows and rows whose group id lies outside [0, G) add nothing, as
// on the TPU where such a row hits no one-hot column.  The TPU's one-hot
// (rows x G) product on the MXU and its 1024-row padding are not carried
// over: here each selected row adds into its own group's slots.
//
// Bound: memory, and it depends on the data.  Every mask byte is read
// (n bytes); gid only where the mask is set, vals only for selected rows
// (mask set and gid in range): n + m * 4 + s * 4k bytes read for m set
// mask bytes and s selected rows, plus G * (k+1) * 4 written.  The work is
// s * (k + 1) additions, far below the card's operations-per-byte balance.
// At the TPC-H main path's selectivities (0.1-1% of 6,000,000 rows) nearly
// all of it is the mask scan.
//
// Design, shared-memory path (relagg_shared_kernel; G * (k+1) float64
// slots a warp fit the shared memory a block may opt in to):
// - Fixed row partition: the binding fixes the grid from the device's SM
//   count and n, and block b owns rows [b * per_block, (b+1) * per_block).
//   The same inputs on the same card always meet the same order.
// - Vectorised mask scan: each lane loads kUnroll 16-byte mask words
//   (uint4) before it looks at any; a warp whose words are all zero moves
//   on at once.  The head of a block's range up to the first 16-byte
//   aligned mask address and the tail after its last whole word are read
//   one byte a lane, so a mask with any storage offset works.
// - Candidate list: each warp lists the set bytes it meets in shared
//   memory, in a fixed order (word, then lane, then byte), and loads gid
//   only for those and vals only for the selected ones, 32 rows at a time,
//   once its list is full or its range is done.  At low selectivity a warp
//   waits on one gid load and one vals load in all, not on a pair for each
//   word.
// - Pre-aggregation without atomics, in float64: of the 32 rows in hand,
//   the lanes that hold a selected row stage its vals in their warp's
//   shared memory and the lanes of one group find each other
//   (__match_any_sync).  Each (group, column) slot in hand then goes to
//   one lane, which sums that group's staged values of that column in
//   lane order and adds the sum to its warp's own float64 slot, so a
//   warp's chain of dependent adds is one group's rows long, not rows x k.
//   Only that warp writes those slots, so the order is fixed.  The block
//   then sums its warps' slots in warp order into its own float64 partial
//   in device memory.
// - Cross-block sum in the same launch, in block order at two levels: the
//   blocks fall in groups of kGroup consecutive ones; the last block of a
//   group to finish (a barrier, one thread's __threadfence and an atomic
//   ticket, which it resets for the next call) sums its group's partials
//   in block order, and the
//   last group to finish sums the groups' sums in group order, rounds once
//   to float32 and writes every output slot.  Most groups' sums overlap
//   other blocks' scans, so the tail after the slowest block is two short
//   sums, not one over every block.  The output needs no fill, and a call
//   is one launch.
// This path is bit-deterministic: a call on the same inputs and the same
// card gives the same bits every time.
//
// Global path (relagg_global_kernel, then relagg_round_kernel; high-
// cardinality keys, e.g. c_name's 150,000 codes at TPC-H SF 1): the same
// scan and lists, each selected row adding straight into a float64
// accumulator in device memory with atomics; the second kernel rounds it
// once to float32 into the output and zeroes it for the next call.  Counts
// add exact 1.0s; the sums' float64 atomics land in a run-dependent order,
// so the last bit of a float32 sum may differ from call to call, as with
// the executor's float64 segment sums.
//
// Plain C interface, bound with ctypes: every entry returns the
// cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // 16-byte mask words a lane loads before it looks at them
constexpr int kList = 512;  // candidate rows a warp's list holds: 32 lanes x 16 bytes
constexpr int kGroup = 12;  // blocks whose partials one block sums
constexpr int kChunk = 16;  // partials a thread loads at a time
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* gid;
  const uint8_t* mask;
  const float* vals;
  float* out;
  double* scratch;     // shared path: the blocks' partials; global: the accumulator
  unsigned* ticket;    // shared path: groups finished, then blocks finished in each group
  long long n;
  long long per_block;
  int k;
  int groups;
};

// Bits 0-3: which of the four bytes of x are non-zero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  const unsigned t = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) | ((t >> 28) & 8u);
}

__device__ __forceinline__ unsigned set_bytes(uint4 w) {
  return nonzero_bytes(w.x) | (nonzero_bytes(w.y) << 4) | (nonzero_bytes(w.z) << 8) |
         (nonzero_bytes(w.w) << 12);
}

// One warp's candidate rows (set mask bytes) and where it adds them.  Every
// lane of the warp calls every member.  Rows are listed in the order the
// warp meets them and added in list order, 32 at a time: shared path into
// the warp's own float64 slots `acc` without atomics, global path into the
// accumulator with atomics.
template <bool kShared>
struct WarpRows {
  const Args& a;
  long long lo;  // the block's first row: list entries are offsets from it
  int* list;     // kList entries
  double* acc;
  float* stage;  // shared path: (k, 32) vals of the rows in hand
  int* group_id;          // shared path: the groups in hand ...
  unsigned* group_peers;  // ... and the lanes that hold each one's rows
  int lane;
  int count;     // entries listed, the same in every lane

  // Adds the listed rows whose gid lies in [0, G), and empties the list.
  __device__ __forceinline__ void flush() {
    const int k = a.k;
    const long long width = k + 1;
    for (int j0 = 0; j0 < count; j0 += 32) {
      int g = -1;
      long long r = 0;
      if (j0 + lane < count) {
        r = lo + list[j0 + lane];
        g = __ldg(a.gid + r);
      }
      const bool sel = g >= 0 && g < a.groups;  // the range guard comes before any indexing by g
      if constexpr (kShared) {
        if (sel) {
          for (int c = 0; c < k; ++c) stage[c * 32 + lane] = __ldg(a.vals + r * k + c);
        }
        const unsigned selected = __ballot_sync(kFull, sel);
        unsigned peers = 0u;
        if (sel) peers = __match_any_sync(selected, g);
        // the groups in hand, each by its lowest lane, numbered in lane order
        const unsigned leaders = __ballot_sync(kFull, sel && __ffs(peers) - 1 == lane);
        if (sel && __ffs(peers) - 1 == lane) {
          const int i = __popc(leaders & ((1u << lane) - 1u));
          group_id[i] = g;
          group_peers[i] = peers;
        }
        __syncwarp();
        // one (group, column) slot a lane: the group's rows in lane order
        for (int p = lane; p < __popc(leaders) * width; p += 32) {
          const int i = p / (int)width, c = p - i * (int)width;
          const unsigned rows_of = group_peers[i];
          double x = 0.0;
          if (c < k) {
            for (unsigned q = rows_of; q; q &= q - 1u) x += (double)stage[c * 32 + __ffs(q) - 1];
          } else {
            x = (double)__popc(rows_of);
          }
          acc[group_id[i] * width + c] += x;
        }
      } else if (sel) {
        double* slot = acc + g * width;
        for (int c = 0; c < k; ++c) atomicAdd(slot + c, (double)__ldg(a.vals + r * k + c));
        atomicAdd(slot + k, 1.0);
      }
      __syncwarp();  // the stage and the list are free again
    }
    count = 0;
  }

  // Lists the rows lo + offset + j for the set bits j of each lane's `bits`,
  // lowest lane first and, within a lane, lowest bit first.
  __device__ __forceinline__ void append(int offset, unsigned bits) {
    if (!__ballot_sync(kFull, bits != 0u)) return;  // nearly every word at low selectivity
    const int mine = __popc(bits);
    int upto = mine;  // inclusive prefix count over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += y;
    }
    const int total = __shfl_sync(kFull, upto, 31);
    if (count + total > kList) flush();
    int at = count + upto - mine;
    for (; bits; bits &= bits - 1u) list[at++] = offset + __ffs(bits) - 1;
    count += total;
    __syncwarp();
  }
};

// Every block: list and add its rows [lo, hi).  The head of the range, up
// to the first 16-byte aligned mask address, and its tail after the last
// whole word are read one byte a lane (lanes of warp 0), then every lane
// loads kUnroll words of the range before it looks at any.
template <bool kShared>
__device__ __forceinline__ void scan(const Args& a, WarpRows<kShared>& rows) {
  const int lane = rows.lane;
  const long long lo = rows.lo;
  const long long hi = min(a.n, lo + a.per_block);
  const uintptr_t address = reinterpret_cast<uintptr_t>(a.mask + lo);
  const long long first = lo + min((long long)((16u - (address & 15u)) & 15u), hi - lo);
  const long long words = (hi - first) >> 4;
  const long long tail = first + (words << 4);
  const int n_head = (int)(first - lo), n_tail = (int)(hi - tail);  // each below 16

  if (threadIdx.x < 32) {
    long long row = lo + lane;
    if (lane >= n_head) row = tail + (lane - n_head);
    const bool mine = lane < n_head + n_tail;
    rows.append((int)(row - lo), mine && a.mask[row] != 0 ? 1u : 0u);
  }

  const uint4* w = reinterpret_cast<const uint4*>(a.mask + first);
  for (long long i0 = 0; i0 < words; i0 += (long long)kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads + threadIdx.x;
      v[u] = i < words ? __ldg(w + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads + threadIdx.x;
      rows.append((int)(first - lo + 16 * i), set_bytes(v[u]));
    }
  }
  rows.flush();
}

// Whether this block is the last of `count` to arrive at `ticket`, after
// its writes are visible to the others; the last one resets the ticket for
// the next call.  Every thread of the block calls it.  One thread fences
// for the block, after the barrier that orders the block's writes before
// it, as cooperative groups' grid sync does.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, int count) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)count - 1u;
    if (last) {
      *ticket = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  return last;
}

// Rows [b0, b1) of column s of the (rows, slots) float64 array p, added
// in row order, kChunk loads in flight at a time.
__device__ __forceinline__ double ordered_sum(const double* p, int slots, int s, int b0,
                                              int b1) {
  double x = 0.0;
  for (; b0 < b1; b0 += kChunk) {
    double v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      v[u] = b0 + u < b1 ? __ldcg(p + (long long)(b0 + u) * slots + s) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) x += v[u];  // + 0.0 past b1 leaves x as it is
  }
  return x;
}

__device__ __forceinline__ long long block_lo(const Args& a) {
  return min(a.n, (long long)blockIdx.x * a.per_block);
}

// One block an SM (the binding's grid), so a thread may take 128 registers.
__global__ void __launch_bounds__(kThreads, 1) relagg_shared_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = a.groups * (a.k + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* warp_slots = reinterpret_cast<double*>(smem);  // (kWarps, slots)
  int* lists = reinterpret_cast<int*>(warp_slots + (long long)kWarps * slots);
  int* group_ids = lists + kWarps * kList;                                // (kWarps, 32)
  unsigned* group_peers = reinterpret_cast<unsigned*>(group_ids + kWarps * 32);  // (kWarps, 32)
  float* stages = reinterpret_cast<float*>(group_peers + kWarps * 32);
  for (int i = threadIdx.x; i < kWarps * slots; i += kThreads) warp_slots[i] = 0.0;
  __syncthreads();

  WarpRows<true> rows{a,
                      block_lo(a),
                      lists + warp * kList,
                      warp_slots + (long long)warp * slots,
                      stages + warp * 32 * a.k,
                      group_ids + warp * 32,
                      group_peers + warp * 32,
                      lane,
                      0};
  scan<true>(a, rows);
  __syncthreads();

  // the block's partial: its warps' slots summed in warp order
  double* partial = a.scratch + (long long)blockIdx.x * slots;
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    double x = 0.0;
    for (int v = 0; v < kWarps; ++v) x += warp_slots[v * slots + s];
    partial[s] = x;
  }
  // blocks in groups of kGroup consecutive ones: the last of a group to
  // finish sums the group's partials in block order, and the last group to
  // finish sums the groups' sums in group order and rounds once
  const int blocks = gridDim.x, group = blockIdx.x / kGroup;
  const int n_groups = (blocks + kGroup - 1) / kGroup;
  const int g0 = group * kGroup, g1 = min(blocks, g0 + kGroup);
  if (!last_to_arrive(a.ticket + 1 + group, g1 - g0)) return;
  double* group_sums = a.scratch + (long long)blocks * slots;  // (n_groups, slots)
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    group_sums[(long long)group * slots + s] = ordered_sum(a.scratch, slots, s, g0, g1);
  }
  if (!last_to_arrive(a.ticket, n_groups)) return;
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    a.out[s] = (float)ordered_sum(group_sums, slots, s, 0, n_groups);  // rounded once
  }
}

__global__ void __launch_bounds__(kThreads) relagg_global_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpRows<false> rows{a,       block_lo(a), reinterpret_cast<int*>(smem) + warp * kList,
                       a.scratch, nullptr,     nullptr, nullptr, lane, 0};
  scan<false>(a, rows);
}

// The accumulator rounded once into the output, and zeroed again.
__global__ void relagg_round_kernel(double* acc, float* out, long long slots) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < slots;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = (float)acc[i];
    acc[i] = 0.0;
  }
}

}  // namespace

extern "C" {

// The device's SM count, and the dynamic shared memory a block of
// relagg_shared_kernel may opt in to there: the device's opt-in limit less
// the kernel's static shared memory, in bytes.
int relagg_device_info(int device, int* sm_count, int* smem_budget) {
  cudaError_t err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, relagg_shared_kernel);
  if (err != cudaSuccess) return (int)err;
  *smem_budget = optin - (int)attr.sharedSizeBytes;
  return 0;
}

// Lets relagg_shared_kernel take `bytes` of dynamic shared memory on the
// current device; the binding calls it once per device and larger size.
int relagg_reserve_smem(int bytes) {
  return (int)cudaFuncSetAttribute(relagg_shared_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

const char* relagg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch.  `scratch` holds (grid + ceil(grid / kGroup)) * G * (k+1)
// doubles, `ticket` 1 + ceil(grid / kGroup) unsigneds that are 0 between
// calls; `out` needs no fill.
int relagg_shared(const void* gid, const void* mask, const void* vals, void* out,
                  void* scratch, void* ticket, long long n, long long per_block, int k,
                  int groups, int grid, int smem, void* stream) {
  const Args a{(const int32_t*)gid, (const uint8_t*)mask, (const float*)vals, (float*)out,
               (double*)scratch, (unsigned*)ticket, n, per_block, k, groups};
  relagg_shared_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Two launches.  `scratch` holds G * (k+1) doubles that are 0 between
// calls; `out` needs no fill.
int relagg_global(const void* gid, const void* mask, const void* vals, void* out,
                  void* scratch, long long n, long long per_block, int k, int groups,
                  int grid, int smem, void* stream) {
  const Args a{(const int32_t*)gid, (const uint8_t*)mask, (const float*)vals, (float*)out,
               (double*)scratch, nullptr, n, per_block, k, groups};
  relagg_global_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)groups * (k + 1);
  const long long need = (slots + 255) / 256;
  const int round_grid = (int)(need < 4096 ? (need < 1 ? 1 : need) : 4096);
  relagg_round_kernel<<<round_grid, 256, 0, (cudaStream_t)stream>>>((double*)scratch,
                                                                   (float*)out, slots);
  return (int)cudaGetLastError();
}

}  // extern "C"
