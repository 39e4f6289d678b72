// Rank-wire tree-ensemble kernel for Hopper (sm_90a): per record, the sum
// over trees of the hit leaf's f32[C] row.
//
// Replaces the Pallas TPU kernels of flink_jpmml_tpu/compile/qtrees_pallas.py:
//   - `_kernel` (grid form) and `_kernel_mega` (fused group loop): the
//     f32[N] ensemble sum, before Targets, of a regression forest — here
//     C = 1, the row being the leaf value;
//   - `_kernel_cls` (grid form) and `_kernel_mega_cls` (fused group loop):
//     the f32[N, C] vote shares of a majorityVote / weightedMajorityVote
//     classification forest — the row being the leaf's class row.
// All four share the front half `_leaf_hits`; here that is the pair of
// __device__ functions go_mask / leaf_hit below. On Hopper the tree loop
// runs inside each thread block, so the grid-versus-loop split of the TPU
// kernels does not exist, and since each tree hits exactly one leaf, the
// sum is the vote kernel at C = 1: one kernel serves all four.
//
// What it computes. Per record and tree, every split's go-left bit is
//     missing (code == sentinel) ? dleft : code[feat] <= qthr
// (the missing test first, as qtrees.py orders it), packed into a 64-bit
// mask `go`. Leaf l is hit iff (go & on[l]) == left[l], where on[l] holds
// the splits on the leaf's path and left[l] those the path takes to the
// left: that is the TPU kernel's `sign @ P == count` test, because count
// is the number of nonzero P entries on the path (trees.py pack_ensemble)
// and the sum reaches it only when every sign agrees. Padded leaves carry
// on = 0, left = 1 and never match; padded split slots lie on no path.
// The hit leaf's row is added to a per-record f32[C] accumulator, one add
// per class per tree, in ascending tree order. A row is f32(hi) + f32(lo)
// of the JAX package's bf16 pair (vhi / vlo with the aggregate
// coefficients folded in; phi / plo: the tree's normalised weight on the
// leaf's label, 0 elsewhere), built on the host: exact in f32, since lo
// lies below hi's last bit and the pair spans at most 17 significant bits.
// No product touches the rows (the TPU kernels' bf16 dots are selections
// of one row by a one-hot), so the tensor-core truncation that made the
// TPU kernel keep the pair apart does not arise here; a version that
// moves the rows onto wgmma must go back to the hi/lo pair. Equal addends
// give equal partial sums, so a record whose classes tie on vote count
// gets exactly equal shares for them.
//
// What bounds it on an H100. Per record it moves F = 32 bytes of codes in
// and 4 C bytes out (9.4 MB for the 262,144-record GBM batch, 11.5 MB for
// a 3-class vote forest), plus about 0.8 MB of tables: about 3 us at
// 3.35 TB/s. What the inputs need is, per record and tree, one integer
// step for each split on the hit leaf's path (6 for a complete depth-6
// tree) and C f32 adds: 7.9e8 integer steps for the 500-tree batch, 47 us
// at the 1.67e13/s issue rate of the INT32 pipe (132 SMs x 64 lanes x
// 1.98 GHz). So the floor is set by operations, not bytes, and no
// tensor-core instruction applies (the work is integer compares).
//
// What the design does about it. Not much yet: this first version
// executes every split and tests every leaf, T * (S + L) = 63.5k steps
// per record for 500 depth-6 trees (about 10 instructions per split and 5
// per leaf), some 20 times what the path needs, so it runs far above its
// floor. One thread scores one record, so every lane of a warp walks the
// same tree and split at the same time: the split and leaf tables are read
// with warp-uniform addresses (one broadcast load per warp, served from
// L1/L2; the 500-tree tables are under 1 MB and stay resident in the
// 50 MB L2). The block's codes are staged once in shared memory with an
// odd word stride per row, so the data-dependent gather code[feat] is
// free of bank conflicts. The split loop is branch-free; the leaf loop is
// a branch-free select over all L leaves, so no lane diverges. Each split
// is one packed 32-bit word (feat | qthr << 16 | dleft << 24). The f32[C]
// accumulator lives in registers (C <= kMaxClasses; the class loop is
// unrolled to kMaxClasses with a uniform early exit, so every index is a
// compile-time constant) and only the hit leaf's row is read, a per-lane
// gather of C words. Walking only the path (complete-tree leaf indexing),
// tables in shared memory and several records per thread are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// Must equal qtrees_cuda.MAX_CLASSES: the accumulator's registers.
constexpr int kMaxClasses = 16;

// Copies the block's rows of codes into the shared tile (row_stride bytes
// per row) and returns how many rows the block holds.
__device__ __forceinline__ int stage_codes(const uint8_t* __restrict__ codes,
                                       long long n_rows, int n_fields,
                                       int row_stride, uint8_t* tile) {
  const long long row0 = (long long)blockIdx.x * kThreads;
  const long long left_rows = n_rows - row0;
  const int rows = left_rows < kThreads ? (int)left_rows : kThreads;
  const int n_bytes = rows * n_fields;
  const uint8_t* src = codes + row0 * n_fields;
  for (int i = threadIdx.x; i < n_bytes; i += kThreads) {
    const int r = i / n_fields;
    tile[r * row_stride + (i - r * n_fields)] = src[i];
  }
  __syncthreads();
  return rows;
}

// Front half, part 1: the tree's 64-bit go-left mask for one record.
__device__ __forceinline__ unsigned long long go_mask(
    const uint8_t* x, const uint32_t* __restrict__ sp, int n_splits,
    unsigned sentinel) {
  unsigned long long go = 0ull;
  for (int s = 0; s < n_splits; ++s) {
    const uint32_t w = __ldg(sp + s);
    const unsigned c = x[w & 0xFFFFu];
    const unsigned thr = (w >> 16) & 0xFFu;
    const unsigned dl = (w >> 24) & 1u;
    const unsigned bit = (c == sentinel) ? dl : (unsigned)(c <= thr);
    go |= (unsigned long long)bit << s;
  }
  return go;
}

// Front half, part 2: is leaf `i` (flat index into the mask tables) hit.
__device__ __forceinline__ bool leaf_hit(
    unsigned long long go, const unsigned long long* __restrict__ on_mask,
    const unsigned long long* __restrict__ left_mask, size_t i) {
  return (go & __ldg(on_mask + i)) == __ldg(left_mask + i);
}

__global__ void __launch_bounds__(kThreads)
leaf_rows_kernel(const uint8_t* __restrict__ codes,
                 long long n_rows,
                 int n_fields,
                 int row_stride,
                 const uint32_t* __restrict__ split,
                 const unsigned long long* __restrict__ on_mask,
                 const unsigned long long* __restrict__ left_mask,
                 const float* __restrict__ rows,  // [T, L, C]
                 int n_trees,
                 int n_splits,
                 int n_leaves,
                 int n_classes,
                 unsigned sentinel,
                 float* __restrict__ out) {  // [N, C]
  extern __shared__ uint8_t tile[];  // [kThreads, row_stride] codes
  const int staged = stage_codes(codes, n_rows, n_fields, row_stride, tile);
  if ((int)threadIdx.x >= staged) return;

  const uint8_t* x = tile + threadIdx.x * row_stride;
  float acc[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const unsigned long long go =
        go_mask(x, split + (size_t)t * n_splits, n_splits, sentinel);
    const size_t base = (size_t)t * n_leaves;
    // the last hit leaf (a tree has exactly one; none adds nothing)
    int hit = -1;
    for (int l = 0; l < n_leaves; ++l) {
      hit = leaf_hit(go, on_mask, left_mask, base + l) ? l : hit;
    }
    if (hit >= 0) {
      const float* row = rows + (base + hit) * n_classes;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c >= n_classes) break;
        acc[c] += __ldg(row + c);
      }
    }
  }
  float* dst = out + ((long long)blockIdx.x * kThreads + threadIdx.x) *
                       n_classes;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    if (c >= n_classes) break;
    dst[c] = acc[c];
  }
}

// Odd number of 4-byte words per staged row: rows of neighbouring threads
// start in different shared-memory banks.
int staged_row_stride(int n_fields) {
  int words = (n_fields + 3) / 4;
  if (words % 2 == 0) words += 1;
  return 4 * words;
}

}  // namespace

// C interface, loaded with ctypes (flink_jpmml_tpu_torch/compile/
// qtrees_cuda.py). Launches on `stream` and returns cudaGetLastError().
extern "C" int qtrees_leaf_rows(const void* codes,
                                long long n_rows,
                                int n_fields,
                                const void* split,
                                const void* on_mask,
                                const void* left_mask,
                                const void* rows,
                                int n_trees,
                                int n_splits,
                                int n_leaves,
                                int n_classes,
                                int sentinel,
                                void* out,
                                void* stream) {
  if (n_classes < 1 || n_classes > kMaxClasses) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int row_stride = staged_row_stride(n_fields);
  const size_t smem = (size_t)kThreads * row_stride;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  leaf_rows_kernel<<<(unsigned)blocks, kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n_rows, n_fields, row_stride,
      (const uint32_t*)split, (const unsigned long long*)on_mask,
      (const unsigned long long*)left_mask, (const float*)rows, n_trees,
      n_splits, n_leaves, n_classes, (unsigned)sentinel, (float*)out);
  return (int)cudaGetLastError();
}
