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
//     many trees as the launch shape gives it (qtrees_cuda.launch_shape;
//     by default as fit 24 KB: 19 depth-6 trees at C = 1, 13 at C = 3, 4
//     at C = 16 with 64 splits).
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
//
// The packed launch (qtrees_leaf_rows_packed, walk_packed_kernel): one
// launch scores the members of a cross-model pack (compile/packs.py), each
// member its own codes through its own table. A block of the grid is a
// (member, row tile) pair: it finds its member by a binary search over the
// descriptors' first blocks and runs the body a solo block runs
// (walk_block) with the member's own chunk of trees and tile stride. The
// sums do not depend on the launch shape (each record adds its trees' rows
// in ascending order, whatever the tile, the chunking or the trees walked
// side by side), so a member's sums are its solo launch's bit for bit.
//
// What bounds it. A record's walk is a chain of dependent shared-memory
// loads, node then code then node. A pack of small or mid-size members
// leaves the SMs lightly loaded, so its time is the chain a thread walks
// one step after another: eight of config 2's 500-tree GBMs at 4,096 rows
// took 0.115-0.118 ms back to back at one record a thread, 0.165-0.169 at
// two and 0.282-0.293 at four, whatever the block (the same walks in
// flight a thread; chip_smoke.py --packed-sweep, NVIDIA H100 80GB HBM3,
// 700.00 W). A pack of many rows (the same eight at 16,384 rows) loads
// every SM, and then, as for the solo launch, the SM's shared-memory pipe
// (the node and code loads' bank conflicts) sets the rate: 256 to 1,024
// blocks at one or two records a thread ran within 3% of each other
// (0.376-0.386 ms), as each gives the busiest SM 1,024 rows. The solo
// block (256 threads x 4 records, 1,024 rows, two table buffers) does not
// fit a pack: it gives the eight GBMs at 16,384 rows one block an SM, each
// thread four 3,000-step chains, and a zoo member of 256 rows 75% dead
// lanes.
//
// What the design does about it.
//   - The tile is the pack's: threads (32 to 256) times kR records a
//     thread (1, 2 or 4), chosen by qtrees_cuda.packed_shape from the
//     members' row counts and tables.
//   - A thread keeps kWalks = 4 walks in flight whatever kR: kR records,
//     each walking kWalks / kR trees of the chunk side by side
//     (walk_group; the group walks its deepest tree's depth, a leaf naming
//     itself as both children, and the chunk's last trees form one
//     smaller group, so no walk is wasted) and adding their rows in
//     ascending tree order. At kR = 1 a thread's chain is a quarter of
//     the solo thread's.
//   - The rule: of the blocks whose shared memory fits and that leave a
//     member of 64 rows or more at least half of its lanes live, those
//     whose waves (blocks over resident slots, rounded up) times kR are
//     fewest, the chains a thread slot walks one after another; of those
//     the largest tile whose grid fills every resident slot, else the
//     largest with a block for every SM, else the smallest. Smaller tiles
//     fill the card but re-read their member's tables from L2 once a
//     block: eight of the 500-tree GBMs at 16,384 rows take 256 x 1
//     (512 blocks, three an SM, 328 MB from L2 a launch), the fastest of
//     the twelve blocks in the sweep above, and 1,024 blocks of 128 x 1
//     were 3% slower, so L2 does not set the pace there and the rule does
//     not trade blocks for traffic (no thread-block clusters either). 16
//     zoo members of 256 rows take 32 x 1 (128 one-warp blocks, every
//     lane live); such a launch waits on the host, not the walk.
//   - A member whose table is one chunk (every zoo member) takes one
//     table buffer, and the codes tile is sized by the pack's tile, so
//     more blocks share an SM; the instances' __launch_bounds__ let
//     registers allow as many blocks as threads do (packed_min_blocks),
//     and the launch asks for the largest shared-memory carveout.
//   - The descriptor table travels as a __grid_constant__ kernel
//     parameter, so a launch copies nothing to the card first and a block
//     reads its member's words from the constant bank.
//   - Every block reaches every barrier; the ragged tail of a member's
//     last block walks zeroed codes and its stores are masked.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// qtrees_cuda.launch_shape chooses the launch shape from kMaxThreads,
// kRecordsPerThread, kSmemMax and kBarBytes: keep them equal to its
// constants.
constexpr int kMaxThreads = 256;
constexpr int kRecordsPerThread = 4;
// Walks a thread of a packed launch keeps in flight: kR records times the
// trees it walks side by side (kWalks / kR), as many as a solo thread's.
constexpr int kWalks = 4;
// Must equal qtrees_cuda.MAX_CLASSES: the accumulator's registers.
constexpr int kMaxClasses = 16;
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
// per row); rows past the batch's end are zeroed. Row r of the codes starts
// src_stride bytes after row r - 1 (n_fields for a solo launch, the packed
// buffer's width for a member of a packed one); the first n_fields bytes of
// a row are the record's codes.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ codes,
                                            long long n_rows, int n_fields,
                                            int src_stride, int row_stride,
                                            long long row0, int records,
                                            uint8_t* tile) {
  const long long left_rows = n_rows - row0;
  const int rows = left_rows < records ? (int)left_rows : records;
  if ((n_fields & 3) == 0 && (src_stride & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(codes) & 3) == 0) {
    const int wpr = n_fields >> 2;
    const int swords = src_stride >> 2;
    const int stride = row_stride >> 2;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(codes + row0 * src_stride);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile);
    for (int i = threadIdx.x; i < records * wpr; i += blockDim.x) {
      const int r = i / wpr;
      const int c = i - r * wpr;
      dst[r * stride + c] = r < rows ? __ldg(src + r * swords + c) : 0u;
    }
  } else {
    const uint8_t* src = codes + row0 * src_stride;
    for (int i = threadIdx.x; i < records * n_fields; i += blockDim.x) {
      const int r = i / n_fields;
      const int c = i - r * n_fields;
      tile[r * row_stride + c] =
          r < rows ? __ldg(src + r * src_stride + c) : (uint8_t)0;
    }
  }
  __syncthreads();
}

// Trees t .. t + kG - 1 of a chunk walked side by side for this thread's
// kR records (their codes at tile + xoff[j]), each tree's hit row added
// to acc in ascending tree order. The group walks its deepest tree's
// depth: a leaf names itself as both children, so a shallower tree stays
// on its leaf.
template <int kC, int kR, int kG>
__device__ __forceinline__ void walk_group(
    const unsigned char* chunk, int t, int tree_words,
    const uint8_t* tile, const unsigned (&xoff)[kR], unsigned sentinel,
    int leaf_base, int row_word, int n_classes, float (&acc)[kR][kC]) {
  const uint2* node[kG];
  unsigned depth = 0;
  unsigned at[kG][kR];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    node[g] = reinterpret_cast<const uint2*>(chunk + (t + g) * tree_words * 8);
    const uint2 head = node[g][0];
    depth = max(depth, (head.x >> 8) & 0xFFu);
#pragma unroll
    for (int j = 0; j < kR; ++j) at[g][j] = head.x & 0xFFu;
  }
  for (unsigned d = 0; d < depth; ++d) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const uint2 w = node[g][at[g][j]];
        const unsigned c = tile[xoff[j] + (w.x & 0xFFu)];
        const unsigned go_left = c == sentinel
                                     ? (w.x >> 16) & 1u
                                     : (unsigned)(c <= ((w.x >> 8) & 0xFFu));
        at[g][j] = go_left ? (w.y & 0xFFu) : ((w.y >> 8) & 0xFFu);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float* rows = reinterpret_cast<const float*>(node[g] + row_word);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const float* row = rows + (int)(at[g][j] - leaf_base) * n_classes;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= n_classes) break;
        acc[j][c] += row[c];
      }
    }
  }
}

// One block's walk: rows row0 .. row0 + blockDim.x * kR of the codes
// through every tree of `walk`, sums into out[rec * n_classes], kR records
// a thread, kK trees of a chunk walked side by side (walk_group; the
// chunk's last trees in one smaller group), their rows added in ascending
// tree order. The tables take `bufs` buffers of a
// chunk each (2: double buffered; 1 only where one chunk holds every
// tree), the codes tile follows them. The body of both kernels below: a
// solo launch runs it at kR = kRecordsPerThread, kK = 1, two buffers; a
// packed launch at the pack's own kR, kK = kWalks / kR, and buffers.
template <int kC, int kR, int kK>
__device__ __forceinline__ void walk_block(
    const uint8_t* __restrict__ codes, long long n_rows, int n_fields,
    int src_stride, int row_stride,
    const unsigned long long* __restrict__ walk, int n_trees, int tree_words,
    int chunk_trees, int bufs, int leaf_base, int row_word, int n_classes,
    unsigned sentinel, float* __restrict__ out, long long row0,
    unsigned char* smem) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int chunk_bytes = chunk_trees * tree_words * 8;
  unsigned char* buf = smem + kBarBytes;     // [bufs][chunk_bytes] tables
  uint8_t* tile = buf + bufs * chunk_bytes;  // [records][row_stride] codes
  const int n_chunks = (n_trees + chunk_trees - 1) / chunk_trees;
  const int records = blockDim.x * kR;

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
  stage_codes(codes, n_rows, n_fields, src_stride, row_stride, row0,
              records, tile);

  unsigned xoff[kR];
  float acc[kR][kC];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    xoff[j] = (threadIdx.x + j * blockDim.x) * row_stride;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[j][c] = 0.0f;
  }

  for (int k = 0; k < n_chunks; ++k) {
    bar_wait(&bar[k & 1], (k >> 1) & 1);
    const unsigned char* chunk = buf + (k & 1) * chunk_bytes;
    const int nt = min(chunk_trees, n_trees - k * chunk_trees);
    int i = 0;
    for (; i + kK <= nt; i += kK) {
      walk_group<kC, kR, kK>(chunk, i, tree_words, tile, xoff, sentinel,
                             leaf_base, row_word, n_classes, acc);
    }
    // the chunk's last nt % kK trees, side by side: no group walks a tree
    // it does not add
    if constexpr (kK > 3) {
      if (nt - i == 3) {
        walk_group<kC, kR, 3>(chunk, i, tree_words, tile, xoff, sentinel,
                              leaf_base, row_word, n_classes, acc);
      }
    }
    if constexpr (kK > 2) {
      if (nt - i == 2) {
        walk_group<kC, kR, 2>(chunk, i, tree_words, tile, xoff, sentinel,
                              leaf_base, row_word, n_classes, acc);
      }
    }
    if constexpr (kK > 1) {
      if (nt - i == 1) {
        walk_group<kC, kR, 1>(chunk, i, tree_words, tile, xoff, sentinel,
                              leaf_base, row_word, n_classes, acc);
      }
    }
    __syncthreads();  // every thread is done with buffer k & 1
    if (threadIdx.x == 0 && k + 2 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_chunk(k + 2);
    }
  }

#pragma unroll
  for (int j = 0; j < kR; ++j) {
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
  const long long row0 =
      (long long)blockIdx.x * blockDim.x * kRecordsPerThread;
  walk_block<kC, kRecordsPerThread, 1>(codes, n_rows, n_fields, n_fields,
                                       row_stride, walk, n_trees, tree_words,
                                       chunk_trees, 2, leaf_base, row_word,
                                       n_classes, sentinel, out, row0, smem);
}

// One member of a packed launch (qtrees_cuda.leaf_rows_packed): words of
// an i64[n_members, kDescWords] table. Its codes start codes_off bytes
// into the launch's codes, rows src_stride bytes apart; its sums start
// out_off floats into the launch's output; its blocks are block_begin ..
// the next member's block_begin.
enum DescWord {
  kCodesOff = 0, kRows, kSrcStride, kFields, kWalk, kTrees, kTreeWords,
  kChunkTrees, kLeafBase, kRowWord, kClasses, kOutOff, kBlockBegin,
  kRowStride, kDescWords = 16
};

// Members a packed launch takes (qtrees_cuda.MAX_PACK_MEMBERS): the
// descriptor table travels as a kernel parameter, 8 KB at most, so a
// launch copies nothing to the card first.
constexpr int kMaxPackMembers = 64;
struct PackDesc {
  long long w[kMaxPackMembers * kDescWords];
};

// Blocks of kMaxThreads threads a packed instance keeps in registers on
// one SM (its __launch_bounds__): the register cap each instance meets
// without a spill, rounded to what ptxas allocates (ptxas -v for sm_90a:
// C = 1: 26-29 registers, under 32; C = 4: 27 and 30, under 32, and 43 at
// kR = 4, under 48; C = 16: 37 / 54 / 91, under 40 / 64 / 128). Must
// equal qtrees_cuda.packed_min_blocks.
template <int kC, int kR>
constexpr int packed_min_blocks() {
  return kC == kMaxClasses ? (kR == 1 ? 6 : kR == 2 ? 4 : 2)
                           : (kC == 4 && kR == 4 ? 5 : 8);
}

// A block of a packed launch: find its member (the last whose block_begin
// is at most blockIdx.x, by binary search over the descriptors' first
// blocks) and walk that member's rows through that member's own table,
// with that member's own chunking and tile stride, kR records a thread.
// Each member's sums are therefore what its solo launch computes, bit for
// bit. A member whose table is one chunk takes one table buffer.
template <int kC, int kR>
__global__ void __launch_bounds__(kMaxThreads, packed_min_blocks<kC, kR>())
walk_packed_kernel(const uint8_t* __restrict__ codes,
                   const __grid_constant__ PackDesc desc, int n_members,
                   unsigned sentinel, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long block = blockIdx.x;
  int lo = 0, hi = n_members - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc.w[mid * kDescWords + kBlockBegin] <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* d = desc.w + lo * kDescWords;
  const long long row0 = (block - d[kBlockBegin]) * blockDim.x * kR;
  const int n_trees = (int)d[kTrees];
  const int chunk_trees = (int)d[kChunkTrees];
  walk_block<kC, kR, (kWalks > kR ? kWalks / kR : 1)>(
      codes + d[kCodesOff], d[kRows], (int)d[kFields], (int)d[kSrcStride],
      (int)d[kRowStride], reinterpret_cast<const unsigned long long*>(d[kWalk]),
      n_trees, (int)d[kTreeWords], chunk_trees, chunk_trees < n_trees ? 2 : 1,
      (int)d[kLeafBase], (int)d[kRowWord], (int)d[kClasses], sentinel,
      out + d[kOutOff], row0, smem);
}


// Odd number of 4-byte words per staged row: rows of neighbouring threads
// start in different shared-memory banks.
int staged_row_stride(int n_fields) {
  int words = (n_fields + 3) / 4;
  if (words % 2 == 0) words += 1;
  return 4 * words;
}

// The launch shape, chosen by qtrees_cuda.launch_shape: `threads` per
// block and `chunk_trees` whole trees per shared-memory buffer. A shape the
// card cannot take (threads not a multiple of 32 up to kMaxThreads, a chunk
// outside 1..n_trees, shared memory over kSmemMax) returns
// cudaErrorInvalidValue and launches nothing.
template <int kC>
cudaError_t launch(const void* codes, long long n_rows, int n_fields,
                   const void* walk, int n_trees, int tree_words,
                   int leaf_base, int row_word, int n_classes,
                   unsigned sentinel, int threads, int chunk_trees,
                   void* out, cudaStream_t stream) {
  if (threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      chunk_trees < 1 || chunk_trees > n_trees) {
    return cudaErrorInvalidValue;
  }
  const int row_stride = staged_row_stride(n_fields);
  const size_t smem = kBarBytes +
                      2 * (size_t)chunk_trees * tree_words * 8 +
                      (size_t)threads * kRecordsPerThread * row_stride;
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

// The attributes a packed instance launches with: `smem` bytes of dynamic
// shared memory, and the largest shared-memory carveout, so that as many
// blocks share an SM as its 228 KB allow (qtrees_cuda.packed_shape counts
// on that).
template <int kC, int kR>
cudaError_t packed_attributes(long long smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_packed_kernel<kC, kR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(walk_packed_kernel<kC, kR>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A packed launch: n_blocks blocks of `threads` threads, kR records a
// thread, over the n_members members of `desc` (host memory, copied into
// the launch's parameters), `smem` bytes of dynamic shared memory each
// (the largest need among the members, checked on the host). With
// `resident` set it launches nothing and writes there the blocks of this
// shape one SM holds. Refused shapes return cudaErrorInvalidValue and
// launch nothing.
template <int kC, int kR>
cudaError_t launch_packed(const void* codes, const void* desc, int n_members,
                          long long n_blocks, int threads, long long smem,
                          unsigned sentinel, void* out, cudaStream_t stream,
                          int* resident) {
  if (threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      smem < kBarBytes || smem > kSmemMax || n_members < 1 ||
      n_members > kMaxPackMembers || n_blocks > 0x7FFFFFFFLL) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = packed_attributes<kC, kR>(smem);
  if (err != cudaSuccess) return err;
  if (resident != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, walk_packed_kernel<kC, kR>, threads, (size_t)smem);
  }
  PackDesc words;
  memcpy(words.w, desc, sizeof(long long) * kDescWords * n_members);
  walk_packed_kernel<kC, kR><<<(unsigned)n_blocks, threads, (size_t)smem,
                               stream>>>((const uint8_t*)codes, words,
                                         n_members, sentinel, (float*)out);
  return cudaGetLastError();
}

// launch_packed at the records per thread of the launch: 1, 2 or 4.
template <int kC>
cudaError_t launch_packed_r(int records_per_thread, const void* codes,
                            const void* desc, int n_members,
                            long long n_blocks, int threads, long long smem,
                            unsigned sentinel, void* out,
                            cudaStream_t stream, int* resident) {
  switch (records_per_thread) {
    case 1:
      return launch_packed<kC, 1>(codes, desc, n_members, n_blocks, threads,
                                  smem, sentinel, out, stream, resident);
    case 2:
      return launch_packed<kC, 2>(codes, desc, n_members, n_blocks, threads,
                                  smem, sentinel, out, stream, resident);
    case 4:
      return launch_packed<kC, 4>(codes, desc, n_members, n_blocks, threads,
                                  smem, sentinel, out, stream, resident);
    default:
      return cudaErrorInvalidValue;
  }
}

// launch_packed_r at the accumulator bucket of `max_classes`: 1, 4 or 16.
cudaError_t launch_packed_c(int max_classes, int records_per_thread,
                            const void* codes, const void* desc,
                            int n_members, long long n_blocks, int threads,
                            long long smem, unsigned sentinel, void* out,
                            cudaStream_t stream, int* resident) {
  if (max_classes < 1 || max_classes > kMaxClasses) {
    return cudaErrorInvalidValue;
  }
  if (max_classes == 1) {
    return launch_packed_r<1>(records_per_thread, codes, desc, n_members,
                              n_blocks, threads, smem, sentinel, out, stream,
                              resident);
  }
  if (max_classes <= 4) {
    return launch_packed_r<4>(records_per_thread, codes, desc, n_members,
                              n_blocks, threads, smem, sentinel, out, stream,
                              resident);
  }
  return launch_packed_r<kMaxClasses>(records_per_thread, codes, desc,
                                      n_members, n_blocks, threads, smem,
                                      sentinel, out, stream, resident);
}

}  // namespace

// C interface, loaded with ctypes (flink_jpmml_tpu_torch/compile/
// qtrees_cuda.py). `walk` is the i64[n_trees, tree_words] table of
// qtrees_cuda.pack_tables for S = n_splits split and L = n_leaves leaf
// slots; `threads` and `chunk_trees` are the launch shape (see launch).
// Launches on `stream` and returns
// cudaGetLastError(), or the error of a refused argument or attribute.
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
                                int threads,
                                int chunk_trees,
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
                    leaf_base, row_word, n_classes, sent, threads, chunk_trees,
                    out, s);
  } else if (n_classes <= 4) {
    err = launch<4>(codes, n_rows, n_fields, walk, n_trees, tree_words,
                    leaf_base, row_word, n_classes, sent, threads, chunk_trees,
                    out, s);
  } else {
    err = launch<kMaxClasses>(codes, n_rows, n_fields, walk, n_trees,
                              tree_words, leaf_base, row_word, n_classes,
                              sent, threads, chunk_trees, out, s);
  }
  return (int)err;
}

// C interface of the packed launch (qtrees_cuda.leaf_rows_packed): one
// launch of n_blocks blocks of `threads` threads, `records_per_thread`
// records a thread, over the n_members (at most kMaxPackMembers) members
// of `desc`, an i64[n_members, 16] table in host memory that the launch's
// parameters carry to the card (DescWord above: each member's
// codes offset, rows, row stride, fields, walk table, T, tree_words,
// chunk, leaf base, row word, C, output offset, first block and tile
// stride), all checked on the host. `max_classes` picks the accumulator
// bucket, the largest among the members. Launches on `stream` and returns
// cudaGetLastError(), or the error of a refused argument or attribute.
extern "C" int qtrees_leaf_rows_packed(const void* codes,
                                       const void* desc,
                                       int n_members,
                                       long long n_blocks,
                                       int threads,
                                       int records_per_thread,
                                       long long smem,
                                       int max_classes,
                                       int sentinel,
                                       void* out,
                                       void* stream) {
  if (max_classes < 1 || max_classes > kMaxClasses) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_blocks <= 0) return (int)cudaGetLastError();
  return (int)launch_packed_c(max_classes, records_per_thread, codes, desc,
                              n_members, n_blocks, threads, smem,
                              (unsigned)sentinel, out, (cudaStream_t)stream,
                              nullptr);
}

// The blocks of the packed instance for `max_classes` and
// `records_per_thread` that one SM of the current device holds at
// `threads` threads and `smem` bytes of dynamic shared memory, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reads them, into
// *blocks. Returns its error, or that of a refused shape.
extern "C" int qtrees_packed_resident_blocks(int threads,
                                             int records_per_thread,
                                             long long smem,
                                             int max_classes,
                                             int* blocks) {
  *blocks = 0;
  return (int)launch_packed_c(max_classes, records_per_thread, nullptr,
                              nullptr, 1, 0, threads, smem, 0, nullptr,
                              nullptr, blocks);
}
