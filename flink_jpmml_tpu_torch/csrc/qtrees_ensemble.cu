// Rank-wire tree-ensemble sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels flink_jpmml_tpu/compile/qtrees_pallas.py
// `_kernel` (grid form) and `_kernel_mega` (fused group loop): the f32[N]
// ensemble sum, before Targets, of a regression forest over uint8
// threshold-rank codes. On Hopper the tree loop runs inside each thread
// block, so the grid-versus-loop split of the two TPU kernels does not
// exist and one kernel serves both.
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
// The hit leaves' f32 values (vhi + vlo with the aggregate coefficients
// folded in, qtrees.py) are summed per tree, and the per-tree values are
// accumulated in f32 in ascending tree order for each record.
//
// What bounds it on an H100. Per record it moves F = 32 bytes of codes in
// and 4 bytes of score out: 9.4 MB for a 262,144-record batch, 2.8 us at
// 3.35 TB/s. It does T * (S + L) = 500 * (63 + 64) = 63.5k integer
// compare-and-select steps per record (1.66e10 for the batch): 1.0 ms at
// the 1.67e13/s issue rate of the INT32 pipe (132 SMs x 64 lanes x 1.98
// GHz), with each step at least one instruction. So it is bound by
// operations, not bytes, and no tensor-core instruction applies (the
// work is integer compares, not products).
//
// What the design does about it. One thread scores one record, so every
// lane of a warp walks the same tree and split at the same time: the
// split and leaf tables are read with warp-uniform addresses (one
// broadcast load per warp, served from L1/L2; the 500-tree tables are
// 0.7 MB and stay resident in the 50 MB L2). The block's codes are staged
// once in shared memory with an odd word stride per row, so the
// data-dependent gather code[feat] is free of bank conflicts. The split
// loop is branch-free; the leaf loop is a branch-free select over all L
// leaves, so no lane diverges. Each split is one packed 32-bit word
// (feat | qthr << 16 | dleft << 24). This first version keeps the whole
// per-record instruction stream (about 10 instructions per split and 5
// per leaf); cutting it (complete-tree leaf indexing, tables in shared
// memory, several records per thread) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ensemble_sum_kernel(const uint8_t* __restrict__ codes,
                    long long n_rows,
                    int n_fields,
                    int row_stride,
                    const uint32_t* __restrict__ split,
                    const unsigned long long* __restrict__ on_mask,
                    const unsigned long long* __restrict__ left_mask,
                    const float* __restrict__ vals,
                    int n_trees,
                    int n_splits,
                    int n_leaves,
                    unsigned sentinel,
                    float* __restrict__ out) {
  extern __shared__ uint8_t tile[];  // [kThreads, row_stride] codes
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
  if ((int)threadIdx.x >= rows) return;

  const uint8_t* x = tile + threadIdx.x * row_stride;
  float acc = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const uint32_t* sp = split + (size_t)t * n_splits;
    unsigned long long go = 0ull;
    for (int s = 0; s < n_splits; ++s) {
      const uint32_t w = __ldg(sp + s);
      const unsigned c = x[w & 0xFFFFu];
      const unsigned thr = (w >> 16) & 0xFFu;
      const unsigned dl = (w >> 24) & 1u;
      const unsigned bit = (c == sentinel) ? dl : (unsigned)(c <= thr);
      go |= (unsigned long long)bit << s;
    }
    const size_t base = (size_t)t * n_leaves;
    float tree_value = 0.0f;
    for (int l = 0; l < n_leaves; ++l) {
      const bool hit =
          (go & __ldg(on_mask + base + l)) == __ldg(left_mask + base + l);
      tree_value += hit ? __ldg(vals + base + l) : 0.0f;
    }
    acc += tree_value;
  }
  out[row0 + threadIdx.x] = acc;
}

}  // namespace

// C interface, loaded with ctypes (flink_jpmml_tpu_torch/compile/
// qtrees_cuda.py). Launches on `stream` and returns cudaGetLastError().
extern "C" int qtrees_ensemble_sum(const void* codes,
                                   long long n_rows,
                                   int n_fields,
                                   const void* split,
                                   const void* on_mask,
                                   const void* left_mask,
                                   const void* vals,
                                   int n_trees,
                                   int n_splits,
                                   int n_leaves,
                                   int sentinel,
                                   void* out,
                                   void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  // odd number of 4-byte words per staged row: rows of neighbouring
  // threads start in different shared-memory banks
  int words = (n_fields + 3) / 4;
  if (words % 2 == 0) words += 1;
  const int row_stride = 4 * words;
  const size_t smem = (size_t)kThreads * row_stride;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  ensemble_sum_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n_rows, n_fields, row_stride,
      (const uint32_t*)split, (const unsigned long long*)on_mask,
      (const unsigned long long*)left_mask, (const float*)vals, n_trees,
      n_splits, n_leaves, (unsigned)sentinel, (float*)out);
  return (int)cudaGetLastError();
}
