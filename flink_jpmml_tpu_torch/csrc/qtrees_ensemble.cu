// Rank-wire tree-ensemble kernel for Hopper (sm_90a): per record, the sum
// over trees of the hit leaf's f32[C] row, found by walking each tree from
// its root to the hit leaf.
//
// Replaces the Pallas TPU kernels of flink_jpmml_tpu/compile/qtrees_pallas.py:
//   - `_leaf_hits` (:150), the front half the four bodies share: here the
//     walk in `walk_kernel`;
//   - `_kernel` (:170, grid form) and `_kernel_mega` (:218, fused group
//     loop): the f32[N] ensemble sum, before Targets, of a regression
//     forest -- here C = 1, the row being the leaf value;
//   - `_kernel_cls` (:187, grid form) and `_kernel_mega_cls` (:238, fused
//     group loop): the f32[N, C] vote shares of a majorityVote /
//     weightedMajorityVote classification forest -- the row being the
//     leaf's class row.
// On Hopper the tree loop runs inside each thread block, so the grid-
// versus-loop split of the TPU kernels does not exist, and since each tree
// hits exactly one leaf, the sum is the vote kernel at C = 1: one kernel
// serves all four.
//
// What it computes. Per record and tree, from the tree's root, `depth`
// steps of: read the node word, read the record's code for the node's
// feature, go left iff
//     code == sentinel ? dleft : code <= qthr
// (the missing test first, as qtrees.py orders it), move to that child. A
// leaf names itself as both children, so a record that reaches its leaf
// before the tree's depth stays there, and the loop has no divergent exit.
// The leaf's f32[C] row is then added to a per-record f32[C] accumulator,
// one add per class per tree, in ascending tree order: the same adds in
// the same order as the plain version (qtrees_cuda.leaf_rows_reference,
// the mask form of the JAX package's `sign @ P == count`), so the two agree
// bit for bit, and a record whose classes tie on vote count gets exactly
// equal shares for them. A row is f32(hi) + f32(lo) of the JAX package's
// bf16 pair, built on the host: exact in f32, since lo lies below hi's last
// bit and the pair spans at most 17 significant bits. No product touches
// the rows (the TPU kernels' bf16 dots are selections of one row by a
// one-hot), so the tensor-core truncation that made the TPU kernel keep
// the pair apart does not arise; a version that moves the rows onto wgmma
// must go back to the hi/lo pair.
//
// The table (qtrees_cuda.pack_tables, `walk`, i64[T, W]): per tree a slice
// of W words, W even so that a slice is a multiple of 16 bytes: word 0 the
// header root | depth << 8; word 1 + s split slot s, as
// feat | qthr << 8 | dleft << 16 | left << 32 | right << 40 (children are
// node numbers, 8 bits each: S <= 64 splits allow 65 leaves); word
// 1 + S + l leaf slot l, naming itself as both children; then the tree's
// L x C f32 rows. `depth` is the tree's longest path, so every lane of a
// warp takes the same number of steps.
//
// What bounds it on an H100. Per record it moves F = 32 bytes of codes in
// and 4 C bytes out (9.4 MB for the 262,144-record GBM batch, 11.5 MB for a
// 3-class vote forest), plus under 1 MB of tables: about 3 us at 3.35 TB/s.
// What the inputs need is, per record and tree, one integer step for each
// split on the hit leaf's path (6 for a complete depth-6 tree) and C f32
// adds: 7.9e8 integer steps for the 500-tree batch, 47 us at the 1.67e13/s
// issue rate of the INT32 pipe (132 SMs x 64 lanes x 1.98 GHz). So the
// floor is set by operations, not bytes. No tensor-core instruction
// applies: the work is integer compares along a data-dependent path, which
// is no product, so wgmma has nothing to do here.
//
// What the design does about it.
//   - The walk executes depth[t] steps per record and tree, what the path
//     needs when the tree is complete (the earlier version ran all S splits
//     and tested all L leaves, T (S + L) = 63.5k steps per record for 500
//     depth-6 trees, 20 times the path).
//   - The tables stream through shared memory in chunks of whole trees,
//     double buffered: one thread issues a cp.async.bulk copy of the next
//     chunk but one, completing on an mbarrier, while the block walks the
//     current one. Each block reads each tree's table once from L2, and the
//     data-dependent node and row reads hit shared memory. A chunk holds as
//     many trees as fit kChunkBytes (19 depth-6 trees at C = 1, 13 at
//     C = 3, 4 at C = 16 with 64 splits).
//   - The block's codes are staged once in shared memory with an odd word
//     stride per row, so the gather code[feat] spreads over banks.
//   - Each thread carries kRecordsPerThread records, whose walks are
//     independent chains of dependent shared-memory loads (node, then code,
//     then the next node): they hide each other's latency. The f32[C]
//     accumulators live in registers; the class count is a template bucket
//     (1, 4 or 16) and the class loop is unrolled with a uniform early exit,
//     so every index is a compile-time constant. __launch_bounds__ caps the
//     registers for two 256-thread blocks per SM; ptxas must report no
//     spills.
//   - Every thread reaches every barrier: the ragged tail's records walk
//     zeroed codes and their stores are masked.
//
// What is left. A warp's lanes read different node words of one tree, so
// 8-byte node reads meet a few-way bank conflict at the deeper levels; a
// lane whose leaf lies above the tree's depth idles for the rest of it (no
// cost for complete trees); a batch below ~132 x 2048 records leaves SMs
// idle; with F near 256 the staged codes cut a block to one or two warps.
// The main paths are bound by host encode, not by this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRecordsPerThread = 4;
// Must equal qtrees_cuda.MAX_CLASSES: the accumulator's registers.
constexpr int kMaxClasses = 16;
constexpr int kChunkBytes = 24 * 1024;    // tree tables per buffer
constexpr int kSmemTarget = 112 * 1024;   // two blocks per SM
constexpr int kSmemMax = 232448;          // 227 KB, a block's limit
constexpr int kBarBytes = 16;             // two mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
}

// One thread: announce `bytes` on `bar` and start their copy to `dst`.
__device__ __forceinline__ void bar_copy(uint64_t* bar, void* dst,
                                         const void* src, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies the block's rows of codes into the shared tile (row_stride bytes
// per row); rows past the batch's end are zeroed.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ codes,
                                            long long n_rows, int n_fields,
                                            int row_stride, long long row0,
                                            int records, uint8_t* tile) {
  const long long left_rows = n_rows - row0;
  const int rows = left_rows < records ? (int)left_rows : records;
  if ((n_fields & 3) == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0) {
    const int wpr = n_fields >> 2;
    const int stride = row_stride >> 2;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(codes + row0 * n_fields);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile);
    for (int i = threadIdx.x; i < records * wpr; i += blockDim.x) {
      const int r = i / wpr;
      dst[r * stride + (i - r * wpr)] = r < rows ? __ldg(src + i) : 0u;
    }
  } else {
    const uint8_t* src = codes + row0 * n_fields;
    for (int i = threadIdx.x; i < records * n_fields; i += blockDim.x) {
      const int r = i / n_fields;
      tile[r * row_stride + (i - r * n_fields)] =
          r < rows ? __ldg(src + i) : (uint8_t)0;
    }
  }
  __syncthreads();
}

template <int kC>
__global__ void __launch_bounds__(kMaxThreads, 2)
walk_kernel(const uint8_t* __restrict__ codes,
            long long n_rows,
            int n_fields,
            int row_stride,
            const unsigned long long* __restrict__ walk,  // [T, tree_words]
            int n_trees,
            int tree_words,
            int chunk_trees,
            int leaf_base,  // node number of leaf slot 0: 1 + S
            int row_word,   // word of a slice where its rows start
            int n_classes,
            unsigned sentinel,
            float* __restrict__ out) {  // [N, C]
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int chunk_bytes = chunk_trees * tree_words * 8;
  unsigned char* buf = smem + kBarBytes;     // [2][chunk_bytes] tables
  uint8_t* tile = buf + 2 * chunk_bytes;     // [records][row_stride] codes
  const int n_chunks = (n_trees + chunk_trees - 1) / chunk_trees;
  const int records = blockDim.x * kRecordsPerThread;
  const long long row0 = (long long)blockIdx.x * records;

  // chunk k of trees → buffer k & 1, completing on bar[k & 1]
  auto load_chunk = [&](int k) {
    const int t0 = k * chunk_trees;
    const int nt = min(chunk_trees, n_trees - t0);
    bar_copy(&bar[k & 1], buf + (k & 1) * chunk_bytes,
             walk + (size_t)t0 * tree_words, (uint32_t)(nt * tree_words * 8));
  };
  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_chunk(0);
    if (n_chunks > 1) load_chunk(1);
  }
  stage_codes(codes, n_rows, n_fields, row_stride, row0, records, tile);

  unsigned xoff[kRecordsPerThread];
  float acc[kRecordsPerThread][kC];
#pragma unroll
  for (int j = 0; j < kRecordsPerThread; ++j) {
    xoff[j] = (threadIdx.x + j * blockDim.x) * row_stride;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[j][c] = 0.0f;
  }

  for (int k = 0; k < n_chunks; ++k) {
    bar_wait(&bar[k & 1], (k >> 1) & 1);
    const unsigned char* chunk = buf + (k & 1) * chunk_bytes;
    const int nt = min(chunk_trees, n_trees - k * chunk_trees);
    for (int i = 0; i < nt; ++i) {
      const uint2* node =
          reinterpret_cast<const uint2*>(chunk + i * tree_words * 8);
      const uint2 head = node[0];
      const unsigned depth = (head.x >> 8) & 0xFFu;
      unsigned at[kRecordsPerThread];
#pragma unroll
      for (int j = 0; j < kRecordsPerThread; ++j) at[j] = head.x & 0xFFu;
      for (unsigned d = 0; d < depth; ++d) {
#pragma unroll
        for (int j = 0; j < kRecordsPerThread; ++j) {
          const uint2 w = node[at[j]];
          const unsigned c = tile[xoff[j] + (w.x & 0xFFu)];
          const unsigned go_left = c == sentinel
                                       ? (w.x >> 16) & 1u
                                       : (unsigned)(c <= ((w.x >> 8) & 0xFFu));
          at[j] = go_left ? (w.y & 0xFFu) : ((w.y >> 8) & 0xFFu);
        }
      }
      const float* rows = reinterpret_cast<const float*>(node + row_word);
#pragma unroll
      for (int j = 0; j < kRecordsPerThread; ++j) {
        const float* row = rows + (int)(at[j] - leaf_base) * n_classes;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (c >= n_classes) break;
          acc[j][c] += row[c];
        }
      }
    }
    __syncthreads();  // every thread is done with buffer k & 1
    if (threadIdx.x == 0 && k + 2 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_chunk(k + 2);
    }
  }

#pragma unroll
  for (int j = 0; j < kRecordsPerThread; ++j) {
    const long long rec = row0 + threadIdx.x + j * blockDim.x;
    if (rec < n_rows) {
      float* dst = out + rec * n_classes;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= n_classes) break;
        dst[c] = acc[j][c];
      }
    }
  }
}

// Odd number of 4-byte words per staged row: rows of neighbouring threads
// start in different shared-memory banks.
int staged_row_stride(int n_fields) {
  int words = (n_fields + 3) / 4;
  if (words % 2 == 0) words += 1;
  return 4 * words;
}

template <int kC>
cudaError_t launch(const void* codes, long long n_rows, int n_fields,
                   const void* walk, int n_trees, int tree_words,
                   int leaf_base, int row_word, int n_classes,
                   unsigned sentinel, void* out, cudaStream_t stream) {
  const int row_stride = staged_row_stride(n_fields);
  const size_t tree_bytes = (size_t)tree_words * 8;
  int chunk_trees = (int)(kChunkBytes / tree_bytes);
  if (chunk_trees < 1) chunk_trees = 1;
  if (chunk_trees > n_trees) chunk_trees = n_trees;
  const size_t tables = kBarBytes + 2 * chunk_trees * tree_bytes;
  int threads = kMaxThreads;
  while (threads > 32 &&
         tables + (size_t)threads * kRecordsPerThread * row_stride >
             (size_t)kSmemTarget) {
    threads /= 2;
  }
  const size_t smem =
      tables + (size_t)threads * kRecordsPerThread * row_stride;
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long per_block = (long long)threads * kRecordsPerThread;
  const long long blocks = (n_rows + per_block - 1) / per_block;
  walk_kernel<kC><<<(unsigned)blocks, threads, smem, stream>>>(
      (const uint8_t*)codes, n_rows, n_fields, row_stride,
      (const unsigned long long*)walk, n_trees, tree_words, chunk_trees,
      leaf_base, row_word, n_classes, sentinel, (float*)out);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes (flink_jpmml_tpu_torch/compile/
// qtrees_cuda.py). `walk` is the i64[n_trees, tree_words] table of
// qtrees_cuda.pack_tables for S = n_splits split and L = n_leaves leaf
// slots. Launches on `stream` and returns cudaGetLastError(), or the error
// of a refused argument or attribute.
extern "C" int qtrees_leaf_rows(const void* codes,
                                long long n_rows,
                                int n_fields,
                                const void* walk,
                                int n_trees,
                                int tree_words,
                                int n_splits,
                                int n_leaves,
                                int n_classes,
                                int sentinel,
                                void* out,
                                void* stream) {
  const int row_word = 1 + n_splits + n_leaves;
  if (n_classes < 1 || n_classes > kMaxClasses || n_trees < 1 ||
      n_fields < 1 || row_word > 256 || tree_words % 2 != 0 ||
      tree_words < row_word + (n_leaves * n_classes + 1) / 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(walk) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int leaf_base = 1 + n_splits;
  const unsigned sent = (unsigned)sentinel;
  cudaError_t err;
  if (n_classes == 1) {
    err = launch<1>(codes, n_rows, n_fields, walk, n_trees, tree_words,
                    leaf_base, row_word, n_classes, sent, out, s);
  } else if (n_classes <= 4) {
    err = launch<4>(codes, n_rows, n_fields, walk, n_trees, tree_words,
                    leaf_base, row_word, n_classes, sent, out, s);
  } else {
    err = launch<kMaxClasses>(codes, n_rows, n_fields, walk, n_trees,
                              tree_words, leaf_base, row_word, n_classes,
                              sent, out, s);
  }
  return (int)err;
}
