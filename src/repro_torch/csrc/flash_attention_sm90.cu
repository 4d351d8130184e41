// Flash attention on Hopper's tensor cores: bf16 wgmma fed by TMA, with a
// producer warpgroup and consumer warpgroups of 64 query rows per thread
// block.  GQA, causal masking aligned at the end (delta = Sk - Sq), a
// sliding window and a tanh logit softcap, on q, k [B, H, S, DQK] and
// v [B, H, S, DV] views with (DQK, DV) in {(64, 64), (128, 128),
// (192, 128), (256, 256)}: (192, 128) is DeepSeek's MLA prefill (128 nope
// + 64 rope dims for q and k, 128 for v), (256, 256) recurrentgemma's local
// attention, (64, 64) seamless-m4t-large-v2's.  Three kernels:
// flash_sm90_kernel for the last two pairs, flash_sm90_d64_kernel for
// (64, 64) and flash_sm90_d128_kernel for (128, 128) (each its own design,
// below).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention`
// (`_flash_kernel`), the TPU kernel whose innermost, sequential grid axis
// walks the kv blocks and carries the running max m, sum l and fp32
// accumulator in VMEM scratch.  The CUDA-core kernel of flash_attention.cu
// still takes every call this one does not (fp32, other head dims, views
// that TMA cannot read); kernels/flash_attention/kernel.py::route decides.
//
// Bound on the card: operations.  At the prefill step's shape (B 4, H 32,
// K 8, S 2048, d 128, bf16, causal) the work is about 1.37e11 operations
// on 168 MB of operands and output: 0.139 ms at the bf16 tensor-core rate
// (989 TFLOP/s), 0.050 ms for the bytes.  At MLA's (B 4, H = K 128,
// S 2048, DQK 192, DV 128) it is 2 (DQK + DV) = 640 operations a visible
// (query, key) pair, about 6.87e11 on 1.34 GB: 0.695 ms, 0.40 ms for the
// bytes.  At recurrentgemma's (B 4, H 16, K 1, S 2048, 256, 256) 1.37e11
// on 142 MB: 0.139 ms, 0.042 ms for the bytes.  At seamless's (B 4,
// H = K 16, d 64): the decoder's S 2048 causal 3.44e10 on 33.6 MB, 0.0348
// ms; cross attention's 2048 queries on 512 keys 1.72e10, 0.0174 ms; the
// encoder's 512 on 512 4.3e9 operations on 16.8 MB, 0.0050 ms for the
// bytes.
//
// flash_sm90_kernel, the (192, 128) and (256, 256) instances.  A block
// owns 128 query rows of one (batch, head) and walks the visible keys in
// tiles of BN (the loop bounds skip the fully masked tiles, the TPU
// kernel's `run`): 128 keys, and 64 at (256, 256), where two stages of
// 128-key K and V tiles (256 KB) would not fit beside Q.  The grid takes
// the (batch, head) pairs in groups of eight, each group's heaviest causal
// blocks (the last rows) first, so the blocks in flight read the K and V
// of a few heads, which stay in L2 (see the kernel).
// - Producer warpgroup (setmaxnreg down to 24 registers): one thread loads
//   the Q tile once, and K and V tiles into two rings of two stages by TMA,
//   each stage guarded by a "full" and an "empty" mbarrier (a K stage is
//   free once its Q K^T has retired, a V stage only after its P V, one
//   turn later).  Tensor maps over (d, S, heads, batch) read the model's
//   [B, S, H, d] tensors through their strides; rows past Sq or Sk arrive
//   as zeros (TMA's out-of-bounds fill), so nothing is padded in device
//   memory.  Each tile lies in shared memory as width / 64 chunks of
//   [rows][64 bf16] in the 128-byte swizzle that the wgmma descriptors
//   name (Q 128 rows, K and V BN): Q and K DQK / 64 chunks, V DV / 64.
// - Two consumer warpgroups (setmaxnreg up to 240), 64 query rows each:
//   S = Q K^T is DQK / 16 steps of wgmma m64n{BN}k16 with both operands in
//   shared memory (K stored [keys, DQK] is the K-major B operand), fp32
//   accumulator.  The online softmax runs on the accumulator fragments: a
//   row lives in the 4 threads of a quad, so its max takes two xor
//   shuffles.  Scores are scaled first, then softcap * tanh(s / softcap),
//   then masked with -1e30 (never -inf: a row whose keys so far are all
//   masked takes p = 1 and the first visible key wipes that with
//   alpha = 0), in the log2 domain (exp2 with log2(e) folded into the
//   scale).  Masks are computed only on tiles that cross the causal
//   diagonal, the window edge or the Sk tail.  m, l and the output
//   accumulator stay fp32; l sums the unrounded p; p is rounded to bf16 as
//   it becomes the register A operand of O += P V (wgmma m64n{DV}k16, two
//   m64n128k16 over V's halves at DV 256; V [keys, DV] the MN-major B
//   operand, transposed by the instruction).
//   The two warpgroups take turns at the tensor cores (an mbarrier each):
//   a turn issues the previous tile's P V and the next tile's Q K^T as one
//   group and hands over before waiting for it, so one warpgroup's softmax
//   runs beside the other's products.  The output is acc / l (l == 0
//   divides by 1), rounded to bf16 and stored from registers in q's
//   layout.
// Shared memory at (192, 128): Q 48 KB, two stages of K (48 KB) and V
// (32 KB) 160 KB, 209 KB with the barriers and the alignment slack; at
// (256, 256) with 64-key tiles: Q 64 KB, two stages of K and V (32 KB
// each) 128 KB, 193 KB; each under the 227 KB a block may take (a third
// stage would not fit).  One block per SM.  A consumer's registers: S
// BN / 2 and O DV / 2, so 64 + 64 at (192, 128) and 32 + 128 at
// (256, 256), beside P's BN / 4.
// What is left between it and the bound: inside a warpgroup the softmax
// still waits for both products (running it while the warpgroup's own P V
// is in flight, that P V a group of its own, measured slower on the card),
// and with one block per SM a block's first loads (128 KB at (192, 128))
// and its output stores are not hidden behind another block's work, which
// weighs most on the short causal blocks; the two stages fill shared
// memory at (192, 128) and (256, 256), so a third has no room.  At
// (256, 256), 80-key tiles (224 KB) and one m64n256k16 for P V measured
// within 2% of this design on the card.
//
// flash_sm90_d128_kernel, the (128, 128) instance (qwen3-4b, chatglm3-6b,
// mistral-nemo-12b, gemma2-27b and llava-next-34b: 210 of the serve path's
// prefill launches).  flash_sm90_kernel's design, one block per (batch,
// head, 128-row query tile), left each block's barrier set-up, Q load and
// first K wait in front of its first product and its output stores behind
// its last, on an SM that no other block shares (about 160 KB of shared
// memory); a causal block walks 8.5 key tiles on average, so those fixed
// costs weighed on every block.  So:
// - Persistent: one block per SM (the SM count read at launch) walks the
//   work tiles (a 128-row query tile of one (batch, head)) in
//   work_tile's order, as flash_sm90_d64_kernel does: causal, the next
//   free one from a counter in device memory that the call zeroes (the
//   tiles differ in length), otherwise every gridDim-th.  The producer
//   writes a tile's index beside its Q buffer; two Q buffers let it load
//   the next tile's Q and first K and V while the consumers finish the
//   current one.
// - The turns (flash_sm90_kernel's: a turn issues the pending key tile's
//   P V and the next one's Q K^T as one group) go on across work tiles,
//   and a tile's output leaves by TMA: after its last P V each warpgroup
//   writes its 64 rows, O / l in bf16, into shared memory in the 128-byte
//   swizzle and one thread issues two TMA stores (cp.async.bulk.tensor)
//   through a tensor map over the output; they run beside the next turns
//   and are waited for only before the staging is written again, a work
//   tile later.  Rows past Sq lie outside the map and are not written.
// - The last key tile of a causal work tile, which only the diagonal cuts,
//   is masked by one comparison an element (d128_scores); the other
//   masked tiles take tile_scores.  The softmax is tile_softmax, the
//   (64, 64) kernel's.
// - Branches around wgmma hang on values broadcast from lane 0, one thread
//   a warp arrives on each barrier (as in flash_sm90_d64_kernel).
// Shared memory: Q 2 x 32 KB, two stages of K and V 128 KB, O's staging
// 32 KB: 225 KB with the barriers and the slack.  Registers: producer 24,
// consumers 240 (S 64, O 64, P 32).
// At the prefill step's shape it takes 0.2771 ms (flash_sm90_kernel's
// instance 0.3498), at llava's G = 7 0.5039 (0.6526), against 0.139 and
// 0.243 ms at the tensor-core rate (NVIDIA H100 80GB HBM3, 700 W;
// scripts/torch_flash_ab.py --reps 20, the means of two runs each).
// What is left: one warpgroup's softmax, which runs while the other's
// products do, takes longer than those products.  At the non-causal main
// shape a copy without the softmax takes 0.364 ms and one without the
// products 0.375, the kernel 0.50: with one warp of a warpgroup on each
// SM sub-partition the softmax is bound by its own latency.  gemma2's
// softcap (tanhf on every score) makes its softmax alone 0.87 ms.
// Tried and slower on the card: FlashAttention-3's order inside a
// warpgroup (its Q K^T and P V as two groups, the softmax of the one
// beside the other; six arrangements), which ptxas serialized every time
// (C7514, C7515 or C7517 in its build log), 18-26% slower; taking the
// next work tile from the counter one tile ahead, 7% slower (blocks claim
// tiles while still busy).
//
// flash_sm90_d64_kernel, the (64, 64) instance.  At head dim 64 a 64 x 128
// tile of scores costs the tensor cores half of what it costs at 128, but
// its softmax costs the same: 64 exponentials a thread (the MUFU unit's 16
// a cycle an SM make them as long as the products), the max, P's
// conversion to bf16 and the rescale.  Two consumer warpgroups taking turns
// leave the tensor cores idle for most of each softmax, and blocks that
// walk only 4 key tiles (seamless's encoder and cross attention) spend much
// of their life loading Q and storing O.  So:
// - Persistent: one block per SM (the SM count read at launch), walking the
//   work tiles (a query tile of one (batch, head)) in flash_sm90_kernel's
//   order; a block takes every gridDim-th, or, causal, the next free one
//   from a counter in device memory (the tiles differ in length), zeroed
//   before each launch.  The producer writes a tile's index beside its Q
//   buffer; two Q buffers and four stages of K and V (one full and one
//   empty barrier a stage) let it load the next tile while the consumers
//   finish the current one, and a tile's output is stored from registers
//   while the other warpgroups' products run.
// - Three consumer warpgroups of 64 rows (192-row tiles), turns round-robin,
//   so each warpgroup's softmax runs beside two others' products; two (128-
//   row tiles) when Sq <= 512, where 192-row tiles would leave most SMs idle
//   in a second round (d64_rows).  A turn issues the pending tile's P V,
//   waits for it (at three warpgroups P and S cannot both be held in 160
//   registers), then issues the next Q K^T and hands over.  The turns go
//   on across work tiles, and a warpgroup skips the products of key tiles
//   that none of its rows sees (rows past Sq, the causal edge).
// - Softmax: the row max as a tree, the scale folded into the exponent's
//   fma on unmasked tiles, O rescaled only when a row of the warp has a new
//   max.  At three warpgroups the tensor cores also take the row sums: P V
//   is m64n72k16 over V's 64 columns and 8 of a 16 KB tile of ones, so
//   l = sum of the bf16 P lands in o[32 ..] and is rescaled with O; at two
//   the warpgroup sums the unrounded p (measured faster there).
// - Branches around wgmma hang on values broadcast from lane 0 (__shfl_sync
//   of the warpgroup index and of the work index read from shared memory):
//   where ptxas cannot see a branch to be uniform it serializes every
//   wgmma of the kernel.  One thread a warp arrives on each barrier.
// Shared memory: Q 2 x 24 KB (16 KB at two warpgroups), four stages of K
// and V 128 KB, the ones 16 KB: 193 KB (177 KB).  Registers: producer 32
// and consumers 160 at three warpgroups (65,536 a block), 24 and 240 at
// two; a consumer holds S 64, O 36 (32) and P 32, and the three-warpgroup
// instance spills a few of its other values.
// What is left: a 128-key step still costs a warpgroup its whole chain
// (turn, P V, Q K^T, softmax), and three warps sharing each SM sub-
// partition's issue slot and MUFU unit give back much of the overlap;
// cross attention's 704 tiles of 192 rows leave 88 of the 132 SMs idle
// in the last of six rounds.  Tried and slower on the card: the softmax
// overlapping its own P V (two groups), a quarter of the exponentials on
// the FMA pipe, one P V + Q K^T group at two warpgroups.
//
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so the library needs no -lcuda)
// and passed by value as a __grid_constant__ parameter, which a CUDA graph
// capture keeps.
#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 128;            // query rows per block
constexpr int kChunk = 64;              // bf16 per 128-byte swizzled row
constexpr int kQChunkBytes = kBlockM * 128;  // one chunk of the Q tile
constexpr int kStages = 2;
constexpr int kHeadGroup = 8;           // (batch, head) pairs in a grid group
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Keys per K and V tile of the (DQK, ...) instance: 128, and 64 at head
// dim 256, where two stages of 128-key tiles would not fit beside Q.  The
// TMA boxes of K and V are that many rows, Q's kBlockM
// (kernels/flash_attention/kernel.py::tc_key_tile).
__host__ __device__ constexpr int key_tile(int dqk) {
  return dqk == 256 ? 64 : 128;
}

struct Params {
  CUtensorMap tq, tk, tv;     // boxes of [rows][64 bf16], swizzled
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss; // element strides of the output
  int H, G, Sq, Sk;           // G = H / K query heads per kv head
  float scale_log2;           // scale * log2(e)
  float cap_in, cap_out;      // scale / softcap, softcap * log2(e)
  int softcap, causal, window;
  int BH;                     // B H: the (64, 64) kernel's pairs (last, so
                              // flash_sm90_kernel's fields keep their
                              // offsets)
};

// Shared memory, from a 1024-byte aligned base: Q, then stage s's K and V,
// then the barriers.  Every tile is a whole number of chunks of
// [rows][64 bf16] (16 KB for Q, BN x 128 bytes for K and V), so each starts
// 1024-byte aligned, as the 128-byte swizzle needs.
template <int DQK, int DV, int BN>
struct Layout {
  static_assert(DQK % kChunk == 0 && DV % kChunk == 0, "64-wide chunks");
  static_assert(BN % 16 == 0 && BN <= 128, "16-key steps, n <= 128");
  static constexpr int kQKChunks = DQK / kChunk;
  static constexpr int kVChunks = DV / kChunk;
  static constexpr int kKVChunkBytes = BN * 128;   // one chunk of K or V
  static_assert(kKVChunkBytes % 1024 == 0, "chunks 1024-byte aligned");
  static constexpr int kQTile = kQKChunks * kQChunkBytes;
  static constexpr int kKTile = kQKChunks * kKVChunkBytes;
  static constexpr int kVTile = kVChunks * kKVChunkBytes;
  static constexpr int kStageBytes = kKTile + kVTile;     // one K and V
  static constexpr int kQ = 0;
  __host__ __device__ static constexpr int k(int s) {
    return kQTile + s * kStageBytes;
  }
  __host__ __device__ static constexpr int v(int s) {
    return k(s) + kKTile;
  }
  static constexpr int kBars = kQTile + kStages * kStageBytes;
  // q_full, full_k, full_v, empty_k, empty_v (kStages each), turn[2].
  static constexpr int kBarriers = 3 + 4 * kStages;
  // 1024 bytes of alignment slack.
  static constexpr int kBytes = kBars + 8 * kBarriers + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may take");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// 4 s can only be a fault (a barrier that nothing will complete): it traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint64_t t0 = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void st_shared(uint32_t addr, int x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One TMA box (64 of d by the map's rows, at (c0, c1, c2, c3)) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// One TMA box out of shared memory at `src` into the map's box at (c0, c1,
// c2, c3), in the issuing thread's bulk group; parts of the box outside
// the map's dims are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the thread's TMA stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until the thread's TMA stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Named barrier `id` (1 ..) over the 128 threads of a warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of the operand `bytes` further on (a multiple of 16):
// the start address is the low field, in 16-byte units.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
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

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d[64] (+)= A (shared, K-major) x B (shared, K-major), m64n128k16.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A (shared, K-major) x B (shared, K-major), m64n64k16.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] += A (registers, bf16x2) x B (shared, MN-major), m64n128k16.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A (registers, bf16x2) x B (shared, MN-major), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[36] += A (registers, bf16x2) x B (shared, MN-major), m64n72k16: the
// (64, 64) kernel's P V, whose B is V's 64 columns and 8 columns of ones
// (the row sums of P land in d[32 ..]).
__device__ __forceinline__ void wgmma_rs_n72(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (+)= Q K^T for one 16-wide slice of DQK: m64n{BN}k16, both from
// shared memory.
template <int BN>
__device__ __forceinline__ void qk_product(float* sc, uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(BN == 64 || BN == 128, "Q K^T takes n = 64 or 128");
  if constexpr (BN == 128) {
    wgmma_ss_n128(sc, da, db, scale_d);
  } else {
    wgmma_ss_n64(sc, da, db, scale_d);
  }
}

// O += P V for one 16-key slice: m64n{DV}k16, A = P from registers.  `rows`
// is the address of the slice's 16 rows in V's first chunk; V's 64-wide
// chunks lie `chunk` bytes apart (the descriptor's leading byte offset).
// At DV 256, two m64n128k16 over chunks 0-1 and 2-3: the second's
// accumulators o[64 ..] are the fragments of columns 128 ..
template <int DV>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* a,
                                           uint32_t rows, uint32_t chunk) {
  static_assert(DV == 128 || DV == 256, "P V takes n = 128 or 2 x 128");
  wgmma_rs_n128(o, a, desc_sw128(rows, chunk, 1024));
  if constexpr (DV == 256) {
    wgmma_rs_n128(o + 64, a, desc_sw128(rows + 2 * chunk, chunk, 1024));
  }
}

// Scores of one tile in the log2 domain, in place on the S fragments: scale
// (and softcap), then the masks when kMask; returns the thread's largest
// score of each of its two rows.  Fragment j of a thread holds row
// (j & 2 ? row_b : row_a), key k0 + 8 (j / 4) + col + (j & 1).
template <int BN, bool kCap, bool kMask>
__device__ __forceinline__ void scores(float* sc, const Params& p, int k0,
                                       int row_a, int col, int delta,
                                       float& mx_a, float& mx_b) {
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    float x = kCap ? p.cap_out * tanhf(sc[j] * p.cap_in) : sc[j] * p.scale_log2;
    if (kMask) {
      const int key = k0 + 8 * (j / 4) + col + (j & 1);
      const int row = row_a + ((j & 2) ? 8 : 0);
      bool ok = key < p.Sk;
      if (p.causal) ok = ok && key <= row + delta;
      if (p.window > 0) ok = ok && key > row + delta - p.window;
      x = ok ? x : kNegInf;
    }
    sc[j] = x;
    if (j & 2) {
      mx_b = fmaxf(mx_b, x);
    } else {
      mx_a = fmaxf(mx_a, x);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Grid: one block per (batch, head, query block).  The (batch, head) pairs
// go in groups of kHeadGroup, one group after the other; inside a group the
// query blocks go heaviest first (the last rows, which see the most keys
// under the causal mask), each over the group's pairs.  So the blocks in
// flight read the K and V of one or two groups, which stay in L2 (MLA's K
// and V, 671 MB over its 512 pairs, would otherwise be read from device
// memory by each of a pair's 16 query blocks), and the long blocks of a
// group start before its short ones.  Threads 0..255 are the consumer
// warpgroups, 256..383 the producer.  BN: keys per K and V tile.
template <int DQK, int DV, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ Params p) {
  using L = Layout<DQK, DV, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // Barriers: stage s of each ring at + 8 s; turn[wg] at turn0 + 8 wg.
  const uint32_t q_full = base + L::kBars;
  const uint32_t full_k0 = q_full + 8;
  const uint32_t full_v0 = full_k0 + 8 * kStages;
  const uint32_t empty_k0 = full_v0 + 8 * kStages;
  const uint32_t empty_v0 = empty_k0 + 8 * kStages;
  const uint32_t turn0 = empty_v0 + 8 * kStages;

  const int n_qblocks = (p.Sq + kBlockM - 1) / kBlockM;
  const int n_pairs = gridDim.x / n_qblocks;
  const int group = blockIdx.x / (kHeadGroup * n_qblocks);
  const int in_group = blockIdx.x % (kHeadGroup * n_qblocks);
  const int group_size = min(kHeadGroup, n_pairs - group * kHeadGroup);
  const int bh = group * kHeadGroup + in_group % group_size;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / p.G;
  const int q0 = (n_qblocks - 1 - in_group / group_size) * kBlockM;
  const int delta = p.Sk - p.Sq;

  // Visible keys of this block's rows, in whole tiles of BN.
  const int q_last = min(q0 + kBlockM, p.Sq) - 1;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + delta + 1);
  if (p.window > 0) k_begin = max(0, q0 + delta - p.window + 1);
  const int t_begin = k_begin / BN;
  const int n_tiles = k_end > k_begin ? (k_end + BN - 1) / BN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k0 + 8 * s, 1);
      mbar_init(full_v0 + 8 * s, 1);
      mbar_init(empty_k0 + 8 * s, kConsumers);
      mbar_init(empty_v0 + 8 * s, kConsumers);
    }
    mbar_init(turn0, 128);                   // one warpgroup's threads
    mbar_init(turn0 + 8, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the ring of K and V tiles filled.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      // Every box counts its full bytes, the out-of-bounds fill too.
      mbar_expect_tx(q_full, L::kQTile);
#pragma unroll
      for (int c = 0; c < L::kQKChunks; ++c) {
        tma_load(base + L::kQ + c * kQChunkBytes, &p.tq, q_full, c * kChunk,
                 q0, h, b);
      }
      // K and V have a ring each: a tile's K is free once its Q K^T has
      // retired, its V only after its P V, one turn later.
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int free = ((i / kStages) & 1) ^ 1;
        const int k0 = (t_begin + i) * BN;
        mbar_wait(empty_k0 + 8 * s, free);
        mbar_expect_tx(full_k0 + 8 * s, L::kKTile);
#pragma unroll
        for (int c = 0; c < L::kQKChunks; ++c) {
          tma_load(base + L::k(s) + c * L::kKVChunkBytes, &p.tk,
                   full_k0 + 8 * s, c * kChunk, k0, kvh, b);
        }
        mbar_wait(empty_v0 + 8 * s, free);
        mbar_expect_tx(full_v0 + 8 * s, L::kVTile);
#pragma unroll
        for (int c = 0; c < L::kVChunks; ++c) {
          tma_load(base + L::v(s) + c * L::kKVChunkBytes, &p.tv,
                   full_v0 + 8 * s, c * kChunk, k0, kvh, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows r0 .. r0 + 63.  Of the wgmma
    // fragments, a thread holds rows row_a and row_a + 8 and, of each 8
    // columns, columns col and col + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int r0 = q0 + 64 * wg;
    const int row_a = r0 + 16 * warp + lane / 4;
    const int row_b = row_a + 8;
    const int col = 2 * (lane % 4);
    const uint32_t q_tile = base + L::kQ + wg * 64 * 128;

    float o[DV / 2];
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // running max, log2 domain
    float l_a = 0.f, l_b = 0.f;           // the thread's share of the sum

    // P of the previous tile, as the A registers of its P V: fragments
    // 8 kk .. 8 kk + 7 of the scores are those of keys 16 kk .. 16 kk + 15.
    uint32_t pa[BN / 16][4];
    const uint32_t my_turn = turn0 + 8 * wg;
    const uint32_t other_turn = turn0 + 8 * (wg ^ 1);

    mbar_wait(q_full, 0);
    // The two warpgroups take turns at the tensor cores.  Turn i issues the
    // previous tile's P V and tile i's Q K^T as one group and hands the
    // turn to the other warpgroup before waiting for them, so one
    // warpgroup's softmax runs while the other's products do.  Each takes
    // n_tiles + 1 turns (the last one P V alone); warpgroup 1 opens
    // warpgroup 0's first turn and does not hand over after its last, so
    // every arrival on a turn barrier is waited for.
    if (n_tiles > 0 && wg == 1) mbar_arrive(other_turn);
    for (int i = 0; n_tiles > 0 && i <= n_tiles; ++i) {
      const bool last = i == n_tiles;
      const int s = i % kStages;                     // tile i's stage
      const int sp = (i + kStages - 1) % kStages;    // tile i - 1's
      const int k0 = (t_begin + i) * BN;
      if (!last) mbar_wait(full_k0 + 8 * s, (i / kStages) & 1);
      if (i > 0) mbar_wait(full_v0 + 8 * sp, ((i - 1) / kStages) & 1);
      mbar_wait(my_turn, i & 1);

      // O += P V of tile i - 1: BN / 16 steps of 16 keys; V's rows
      // advance 16 x 128 bytes a step, its 64-wide chunks lie
      // kKVChunkBytes apart.  S = Q K^T of tile i: DQK / 16 steps of 16
      // along DQK; a 64-wide chunk's 128-byte rows advance 32 bytes a step,
      // Q's chunks lie kQChunkBytes apart and K's kKVChunkBytes.
      float sc[BN / 2];
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) fence_reg(o[j]);
      wgmma_fence();
      if (i > 0) {
        const uint32_t v_tile = base + L::v(sp);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pv_product<DV>(o, pa[kk], v_tile + kk * 16 * 128,
                         L::kKVChunkBytes);
        }
      }
      if (!last) {
        const uint32_t k_tile = base + L::k(s);
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
          const uint32_t step = (kk % 4) * 32;
          qk_product<BN>(
              sc,
              desc_sw128(q_tile + (kk / 4) * kQChunkBytes + step, 16, 1024),
              desc_sw128(k_tile + (kk / 4) * L::kKVChunkBytes + step, 16,
                         1024),
              kk > 0);
        }
      }
      wgmma_commit();
      if (wg == 0 || !last) mbar_arrive(other_turn);
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) fence_reg(o[j]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
      }
      if (i > 0) mbar_arrive(empty_v0 + 8 * sp);
      if (last) break;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) fence_reg(sc[j]);
      mbar_arrive(empty_k0 + 8 * s);

      const bool mask =
          k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > r0 + delta) ||
          (p.window > 0 && k0 <= r0 + 63 + delta - p.window);
      float mx_a = kNegInf, mx_b = kNegInf;
      if (p.softcap) {
        if (mask) {
          scores<BN, true, true>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        } else {
          scores<BN, true, false>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        }
      } else {
        if (mask) {
          scores<BN, false, true>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        } else {
          scores<BN, false, false>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = ex2(m_a - mn_a);
      const float alpha_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // p = exp(s - m): l sums it unrounded; the A operand of P V takes it
      // rounded to bf16.
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 2; j += 2) {
        const float m = (j & 2) ? mn_b : mn_a;
        const float e0 = ex2(sc[j] - m);
        const float e1 = ex2(sc[j + 1] - m);
        if (j & 2) {
          ps_b += e0 + e1;
        } else {
          ps_a += e0 + e1;
        }
        pa[j / 8][(j % 8) / 2] = pack_bf16(e0, e1);
      }
      l_a = alpha_a * l_a + ps_a;
      l_b = alpha_b * l_b + ps_b;
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] *= (j & 2) ? alpha_b : alpha_a;
    }

    const float den_a = quad_sum(l_a);
    const float den_b = quad_sum(l_b);
    const float div_a = den_a == 0.f ? 1.f : den_a;
    const float div_b = den_b == 0.f ? 1.f : den_b;
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
    if (row_a < p.Sq) {
      __nv_bfloat16* dst = ob + row_a * p.o_ss + col;
#pragma unroll
      for (int g = 0; g < DV / 8; ++g) {
        *reinterpret_cast<uint32_t*>(dst + 8 * g) =
            pack_bf16(o[4 * g] / div_a, o[4 * g + 1] / div_a);
      }
    }
    if (row_b < p.Sq) {
      __nv_bfloat16* dst = ob + row_b * p.o_ss + col;
#pragma unroll
      for (int g = 0; g < DV / 8; ++g) {
        *reinterpret_cast<uint32_t*>(dst + 8 * g) =
            pack_bf16(o[4 * g + 2] / div_b, o[4 * g + 3] / div_b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The (64, 64) instance: a kernel of its own (see the header).

constexpr int kD64Stages = 4;    // K and V stages of the (64, 64) kernel

// Query rows of a work tile of the (64, 64) kernel, 64 a consumer
// warpgroup: three warpgroups, and two when Sq <= 512, where a third
// would leave many SMs idle in the last round of tiles (seamless's
// encoder: 4 x 16 heads of 512 rows are 256 tiles of 128 on 132 SMs, 192
// of 192).
__host__ __device__ constexpr int d64_rows(int Sq) {
  return Sq <= 512 ? 128 : 192;
}

// Query rows of Q's TMA box, a block's (kBlockM) or, at head dim 64, a
// work tile's (kernels/flash_attention/kernel.py::tc_query_tile).
__host__ __device__ constexpr int query_tile(int dqk, int Sq) {
  return dqk == 64 ? d64_rows(Sq) : kBlockM;
}

// Shared memory of the (64, 64) kernel, from a 1024-byte aligned base: two
// Q buffers of kRows rows (the next work tile's Q loads while the current
// one's last products run), kD64Stages stages of a 128-key K tile and a
// 128-key V tile (16 KB each), a [128][64] tile of ones (at three
// warpgroups P V reads its first 8 columns beside V's 64, so the row sums
// of P come out of the tensor cores), the barriers, then the work index of
// each Q buffer.  Every tile is [rows][64 bf16] in the 128-byte swizzle.
template <int kWGs>
struct D64Layout {
  static constexpr int kRows = 64 * kWGs;
  static constexpr int kQTile = kRows * 128;
  static constexpr int kKVTile = 128 * 128;
  __host__ __device__ static constexpr int q(int buf) { return buf * kQTile; }
  __host__ __device__ static constexpr int k(int s) {
    return 2 * kQTile + 2 * s * kKVTile;
  }
  __host__ __device__ static constexpr int v(int s) { return k(s) + kKVTile; }
  static constexpr int kOnesTile = k(kD64Stages);
  static constexpr int kBars = kOnesTile + kKVTile;
  // q_full[2], q_empty[2], full and empty (kD64Stages each: a stage's K
  // and V fill together and are freed together, after their P V),
  // turn[kWGs].
  static constexpr int kBarriers = 4 + 2 * kD64Stages + kWGs;
  static constexpr int kSlots = kBars + 8 * kBarriers;
  // Two work indices and 1024 bytes of alignment slack.
  static constexpr int kBytes = kSlots + 8 + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may take");
};

// One work tile of the persistent kernels ((64, 64) and (128, 128)): kRows
// query rows from q0 of (batch, head) pair bh = b H + h, and the 128-key
// tiles t_begin .. t_begin + n_tiles - 1 that those rows see (the loop
// bounds of the generic kernel's blocks).
struct WorkTile {
  int bh, q0, t_begin, n_tiles;
};

// Work tile w of n_q query tiles a (batch, head) pair, in the generic
// grid's order: the pairs in groups of kHeadGroup, each group's query
// tiles heaviest first (the last rows), each over the group's pairs.
template <int kRows>
__device__ __forceinline__ WorkTile work_tile(const Params& p, int w,
                                              int n_q) {
  const int per_group = kHeadGroup * n_q;
  const int group = w / per_group;
  const int in_group = w - group * per_group;
  const int group_size = min(kHeadGroup, p.BH - group * kHeadGroup);
  WorkTile t;
  t.bh = group * kHeadGroup + in_group % group_size;
  t.q0 = (n_q - 1 - in_group / group_size) * kRows;
  const int delta = p.Sk - p.Sq;
  const int q_last = min(t.q0 + kRows, p.Sq) - 1;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + delta + 1);
  if (p.window > 0) k_begin = max(0, t.q0 + delta - p.window + 1);
  t.t_begin = k_begin / 128;
  t.n_tiles = k_end > k_begin ? (k_end + 127) / 128 - t.t_begin : 0;
  return t;
}

// Whether any of the 64 rows from r0 sees a key of the 128 from k0; a
// warpgroup skips the products of the tiles that none of its rows sees
// (rows past Sq see none).
__device__ __forceinline__ bool d64_active(const Params& p, int r0, int k0) {
  const int delta = p.Sk - p.Sq;
  if (r0 >= p.Sq) return false;
  if (p.causal && k0 > min(r0 + 63, p.Sq - 1) + delta) return false;
  return p.window <= 0 || k0 + 127 > r0 + delta - p.window;
}

__device__ __forceinline__ float fold(bool max, float x, float y) {
  return max ? fmaxf(x, y) : x + y;
}

// One level of row_reduce's trees: element k with element k + W.
template <bool kMax, int W>
__device__ __forceinline__ void row_fold(float* a, float* b) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    a[k] = fold(kMax, a[k], a[k + W]);
    b[k] = fold(kMax, b[k], b[k + W]);
  }
}

// The largest (!kMax: the sum) of a thread's 32 fragments of each of its
// two rows, fragment j of row (j & 2 ? b : a), as trees of depth 5.
template <bool kMax>
__device__ __forceinline__ void row_reduce(const float* x, float& r_a,
                                           float& r_b) {
  float a[16], b[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    a[k] = fold(kMax, x[4 * k], x[4 * k + 1]);
    b[k] = fold(kMax, x[4 * k + 2], x[4 * k + 3]);
  }
  row_fold<kMax, 8>(a, b);
  row_fold<kMax, 4>(a, b);
  row_fold<kMax, 2>(a, b);
  row_fold<kMax, 1>(a, b);
  r_a = a[0];
  r_b = b[0];
}

// Scores of warpgroup wg's 64 x 128 tile from key k0 of the work tile
// from row q0, in place: scaled, capped and masked where that is needed
// (returns 1), otherwise left raw (returns the scale, which tile_softmax
// folds into the exponent).
__device__ __forceinline__ float tile_scores(float* sc, const Params& p,
                                             int q0, int wg, int row_in,
                                             int col, int k0) {
  const int r0 = q0 + 64 * wg;
  const int delta = p.Sk - p.Sq;
  const bool mask = k0 + 128 > p.Sk || (p.causal && k0 + 127 > r0 + delta) ||
                    (p.window > 0 && k0 <= r0 + 63 + delta - p.window);
  const int row_a = q0 + row_in;
  float mx_a = kNegInf, mx_b = kNegInf;   // unused: row_reduce takes them
  if (p.softcap && mask) {
    scores<128, true, true>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
  } else if (p.softcap) {
    scores<128, true, false>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
  } else if (mask) {
    scores<128, false, true>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
  } else {
    return p.scale_log2;
  }
  return 1.f;
}

// The online softmax of one 64 x 128 tile of scores on its fragments, the
// score of fragment j being sc[j] * mul in the log2 domain: mul is 1 when
// sc holds them scaled (capped, masked), the scale when it holds them raw
// (the scale then rides in the exponent's fma).  Updates the running max
// m, leaves P, rounded to bf16, in pa, and rescales O by alpha =
// 2^(m_old - m_new), but not when no row of the warp has a new max (every
// alpha 1, the product exact).  O is kO fragments: 32 at head dim 64, 64
// at 128.  kOnes (head dim 64): the row sums l of P are O's columns 64 ..
// (o[32 ..], kO 36, rescaled with it); otherwise l is the thread's share
// of them, summed here from the unrounded p.
template <bool kOnes, int kO>
__device__ __forceinline__ void tile_softmax(float* sc, float mul, float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float* o,
                                             uint32_t (*pa)[4]) {
  float mx_a, mx_b;
  row_reduce<true>(sc, mx_a, mx_b);
  const float mn_a = fmaxf(m_a, quad_max(mx_a) * mul);
  const float mn_b = fmaxf(m_b, quad_max(mx_b) * mul);
  const float alpha_a = ex2(m_a - mn_a);
  const float alpha_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const float m = (j & 2) ? mn_b : mn_a;
    const float e0 = ex2(fmaf(sc[j], mul, -m));
    const float e1 = ex2(fmaf(sc[j + 1], mul, -m));
    pa[j / 8][(j % 8) / 2] = pack_bf16(e0, e1);
    if constexpr (!kOnes) {     // kept for the sums
      sc[j] = e0;
      sc[j + 1] = e1;
    }
  }
  if constexpr (!kOnes) {
    float ps_a, ps_b;
    row_reduce<false>(sc, ps_a, ps_b);
    l_a = alpha_a * l_a + ps_a;
    l_b = alpha_b * l_b + ps_b;
  }
  if (__any_sync(0xffffffffu, alpha_a != 1.f || alpha_b != 1.f)) {
#pragma unroll
    for (int j = 0; j < kO; ++j) {
      o[j] *= (j & 2) ? alpha_b : alpha_a;
    }
  }
}

// O / l of a thread's two rows (kOnes: l is o[32] and o[34]; otherwise the
// sum of the quad's shares l_a, l_b; l == 0 divides by 1), rounded to bf16
// and stored through the output's strides; rows past Sq are not stored.
template <bool kOnes>
__device__ __forceinline__ void d64_store(const Params& p, int bh, int row_a,
                                          int col, const float* o, float l_a,
                                          float l_b) {
  const float den_a = kOnes ? o[32] : quad_sum(l_a);
  const float den_b = kOnes ? o[34] : quad_sum(l_b);
  const float inv_a = 1.f / (den_a == 0.f ? 1.f : den_a);
  const float inv_b = 1.f / (den_b == 0.f ? 1.f : den_b);
  const int b = bh / p.H;
  __nv_bfloat16* ob = p.o + b * p.o_sb + (bh - b * p.H) * p.o_sh;
  if (row_a < p.Sq) {
    __nv_bfloat16* dst = ob + row_a * p.o_ss + col;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      *reinterpret_cast<uint32_t*>(dst + 8 * g) =
          pack_bf16(o[4 * g] * inv_a, o[4 * g + 1] * inv_a);
    }
  }
  if (row_a + 8 < p.Sq) {
    __nv_bfloat16* dst = ob + (row_a + 8) * p.o_ss + col;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      *reinterpret_cast<uint32_t*>(dst + 8 * g) =
          pack_bf16(o[4 * g + 2] * inv_b, o[4 * g + 3] * inv_b);
    }
  }
}

// The (64, 64) kernel: persistent, one block per SM, kWGs consumer
// warpgroups of 64 query rows and a producer warpgroup.  The blocks take
// the work tiles in work_tile's order: block i tile i first, then, when
// next_tile is null, every gridDim.x-th after it; otherwise the next one
// that nobody has taken (next_tile counts those past the first gridDim.x,
// from 0 at the launch): the causal tiles differ in length.  The producer
// takes each tile, writes its index beside its Q buffer and loads its Q and
// its K and V tiles; the consumers read the index when the Q buffer fills
// (an index past the last tile ends the block).  The consumers' turns at
// the tensor cores run round-robin and go on across work tiles: turn i
// issues the P V of the warpgroup's previous key tile and, once that has
// retired (P's registers are then free for S), Q K^T of its next one (of
// the next work tile after the last), and hands over; a work tile's output
// is stored while the other warpgroups' products run.
template <int kWGs>
__global__ void __launch_bounds__((kWGs + 1) * 128, 1)
    flash_sm90_d64_kernel(const __grid_constant__ Params p, int* next_tile) {
  using L = D64Layout<kWGs>;
  constexpr int kRows = L::kRows;
  constexpr int kConsumerThreads = kWGs * 128;
  constexpr int kConsumerWarps = kWGs * 4;
  // Three warpgroups (160 registers) have the tensor cores sum P (its
  // products are 12% longer, the softmax 64 adds shorter); two (240) sum
  // it themselves, which measured faster there.
  constexpr bool kOnes = kWGs == 3;
  constexpr int kO = kOnes ? 36 : 32;     // O's fragments (and l's)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t slot0 = base + L::kSlots;    // work index of Q buffer i
  // Barriers: buffer or stage i of each at + 8 i; turn[wg] at turn0 + 8 wg.
  const uint32_t q_full0 = base + L::kBars;
  const uint32_t q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16;
  const uint32_t empty0 = full0 + 8 * kD64Stages;
  const uint32_t turn0 = empty0 + 8 * kD64Stages;
  const int n_q = (p.Sq + kRows - 1) / kRows;
  const int n_work = p.BH * n_q;

  // The ones (bf16 1.0 in every element, so the swizzle does not matter),
  // written through the generic proxy and read by wgmma's async one.
  for (int i = threadIdx.x; kOnes && i < L::kKVTile / 16; i += blockDim.x) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     base + L::kOnesTile + 16 * i),
                 "r"(0x3F803F80u), "r"(0x3F803F80u), "r"(0x3F803F80u),
                 "r"(0x3F803F80u) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, kConsumerWarps);
    }
    for (int s = 0; s < kD64Stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    for (int g = 0; g < kWGs; ++g) mbar_init(turn0 + 8 * g, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer: 512 threads hold 65,536 registers with the consumers at
    // 160 and this warpgroup at 32; 384 with them at 240 and it at 24.
    if constexpr (kWGs == 3) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    if (threadIdx.x == kConsumerThreads) {
      int it = 0;                  // key tiles loaded (the ring's count)
      int w = blockIdx.x;
      for (int n = 0;; ++n) {      // n: work tiles taken (the Q buffers')
        const int qb = n & 1;
        const uint32_t q_full = q_full0 + 8 * qb;
        mbar_wait(q_empty0 + 8 * qb, ((n >> 1) & 1) ^ 1);
        st_shared(slot0 + 4 * qb, w);
        if (w >= n_work) {
          mbar_arrive(q_full);
          break;
        }
        const WorkTile t = work_tile<kRows>(p, w, n_q);
        const int b = t.bh / p.H;
        const int h = t.bh - b * p.H;
        const int kvh = h / p.G;
        if (t.n_tiles == 0) {
          mbar_arrive(q_full);
        } else {
          mbar_expect_tx(q_full, L::kQTile);
          tma_load(base + L::q(qb), &p.tq, q_full, 0, t.q0, h, b);
        }
        for (int i = 0; i < t.n_tiles; ++i, ++it) {
          const int s = it % kD64Stages;
          const int k0 = (t.t_begin + i) * 128;
          mbar_wait(empty0 + 8 * s, ((it / kD64Stages) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, 2 * L::kKVTile);
          tma_load(base + L::k(s), &p.tk, full0 + 8 * s, 0, k0, kvh, b);
          tma_load(base + L::v(s), &p.tv, full0 + 8 * s, 0, k0, kvh, b);
        }
        w = next_tile != nullptr ? gridDim.x + atomicAdd(next_tile, 1)
                                 : w + gridDim.x;
      }
    }
  } else {
    if constexpr (kWGs == 3) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    }
    // Warpgroup wg owns a work tile's rows 64 wg .. 64 wg + 63; of the
    // wgmma fragments, a thread holds rows row_in and row_in + 8 of them
    // and, of each 8 columns, columns col and col + 1.  wg, and the work
    // index read from shared memory, are broadcast from lane 0 so that the
    // compiler sees one value a warp: the products' branches hang on them,
    // and wgmma in a branch it takes for divergent is serialized.
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int row_in = 64 * wg + 16 * ((threadIdx.x % 128) / 32) +
                       (threadIdx.x % 32) / 4;
    const int col = 2 * (threadIdx.x % 4);
    // One thread a warp arrives on a barrier for the warp: after the
    // warp's wgmma.wait_group, its share of the products has retired.
    const bool leader = threadIdx.x % 32 == 0;
    const uint32_t my_turn = turn0 + 8 * wg;
    const uint32_t next_turn = turn0 + 8 * ((wg + 1) % kWGs);
    const float zeros[36] = {};

    // O and, when kOnes, in o[32 ..], the row sums l of P.
    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // running max, log2 domain
    float l_a = 0.f, l_b = 0.f;           // !kOnes: the thread's share of l
    // P of the previous key tile, the A registers of its P V.
    uint32_t pa[8][4];

    int it = 0;      // key tiles taken (the ring's count)
    int n = 0;       // work tiles taken (the Q buffers' count)
    int k0 = 0;      // first key of cur's next key tile
    int left = 0;    // cur's key tiles from that one on
    WorkTile cur;
    // have: a key tile of cur is next; need: take a work tile first.  The
    // pending P V: whether there is one, whether this warpgroup issues it,
    // whether it closes a work tile (whose bh and q0 are out_*).
    bool have = false, need = true;
    bool pend = false, pend_active = false, pend_closes = false;
    int out_bh = 0, out_q0 = 0;
    for (int turn = 0;; ++turn) {
      // The next work tile that has key tiles (an empty one's rows are
      // stored as zeros); none past the last.
      while (need) {
        const int qb = n & 1;
        mbar_wait(q_full0 + 8 * qb, (n >> 1) & 1);
        const int w = __shfl_sync(0xffffffffu, ld_shared(slot0 + 4 * qb), 0);
        need = false;
        if (w >= n_work) break;
        cur = work_tile<kRows>(p, w, n_q);
        k0 = cur.t_begin * 128;
        left = cur.n_tiles;
        have = left > 0;
        if (have) break;
        need = true;
        if (leader) mbar_arrive(q_empty0 + 8 * qb);
        ++n;
        d64_store<kOnes>(p, cur.bh, cur.q0 + row_in, col, zeros, 0.f, 0.f);
      }
      if (!have && !pend) break;
      // The last warpgroup opens the first one's first turn and does not
      // hand over after its last, so every arrival on a turn barrier is
      // waited for.
      if (turn == 0 && wg == kWGs - 1 && leader) mbar_arrive(turn0);
      const int s = it % kD64Stages;                        // this tile's
      const int sp = (it + kD64Stages - 1) % kD64Stages;    // the pending
      const int qb = n & 1;
      const bool active = have && d64_active(p, cur.q0 + 64 * wg, k0);
      const bool closes = have && left == 1;
      // The pending tile's V came with its K, a turn ago.
      if (have) mbar_wait(full0 + 8 * s, (it / kD64Stages) & 1);
      mbar_wait(my_turn, turn & 1);

      // O += P V of the pending tile, one group: 8 steps of 16 keys, V's
      // rows and the ones' advancing 16 x 128 bytes a step (the ones lie
      // a leading byte offset beyond V).  It retires before S = Q K^T
      // issues: 4 steps of 16 along d, 32 bytes a step along the 128-byte
      // rows of Q and K.
#pragma unroll
      for (int i = 0; i < kO; ++i) fence_reg(o[i]);
      wgmma_fence();
      if (pend_active) {
        const uint32_t v_tile = base + L::v(sp);
        const uint64_t dv = desc_sw128(v_tile, L::kOnesTile - L::v(sp), 1024);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if constexpr (kOnes) {
            wgmma_rs_n72(o, pa[kk], desc_add(dv, kk * 16 * 128));
          } else {
            wgmma_rs_n64(o, pa[kk], desc_add(dv, kk * 16 * 128));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      if (pend && leader) mbar_arrive(empty0 + 8 * sp);
#pragma unroll
      for (int i = 0; i < kO; ++i) fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
      }
      float sc[64];
      if (active) {
        const uint64_t dq =
            desc_sw128(base + L::q(qb) + wg * 64 * 128, 16, 1024);
        const uint64_t dk = desc_sw128(base + L::k(s), 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_n128(sc, desc_add(dq, kk * 32), desc_add(dk, kk * 32),
                        kk > 0);
        }
        wgmma_commit();
      }
      if ((have || wg != kWGs - 1) && leader) mbar_arrive(next_turn);
      wgmma_wait_all();
      if (pend_closes) {
        d64_store<kOnes>(p, out_bh, out_q0 + row_in, col, o, l_a, l_b);
#pragma unroll
        for (int i = 0; i < kO; ++i) o[i] = 0.f;
        m_a = m_b = kNegInf;
        l_a = l_b = 0.f;
      }
      if (!have) break;
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(sc[i]);
      if (closes && leader) mbar_arrive(q_empty0 + 8 * qb);
      if (active) {
        const float mul = tile_scores(sc, p, cur.q0, wg, row_in, col, k0);
        tile_softmax<kOnes, kO>(sc, mul, m_a, m_b, l_a, l_b, o, pa);
      }
      pend = true;
      pend_active = active;
      pend_closes = closes;
      ++it;
      if (closes) {
        out_bh = cur.bh;
        out_q0 = cur.q0;
        ++n;
        have = false;
        need = true;
      } else {
        k0 += 128;
        --left;
      }
    }
  }
}

// The grid of a persistent kernel over work tiles of `rows` query rows:
// one block per SM (the count read here), or per tile where there are
// fewer.  A causal call takes its tiles from next_tile, zeroed here on
// the stream; the others take them in a fixed order, and next_tile
// becomes null.
cudaError_t persistent_grid(const Params& p, int rows, int*& next_tile,
                            cudaStream_t stream, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  // Dynamic order for the causal tiles only: the others are of one length.
  if (!p.causal) {
    next_tile = nullptr;
  } else if (next_tile == nullptr) {
    return cudaErrorInvalidValue;
  } else {
    e = cudaMemsetAsync(next_tile, 0, sizeof(int), stream);
    if (e != cudaSuccess) return e;
  }
  const int n_work = p.BH * ((p.Sq + rows - 1) / rows);
  *grid = dim3(n_work < sms ? n_work : sms);
  return cudaSuccess;
}

template <int kWGs>
cudaError_t launch_d64(const Params& p, int* next_tile, cudaStream_t stream) {
  using L = D64Layout<kWGs>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_d64_kernel<kWGs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid;
  const cudaError_t e = persistent_grid(p, L::kRows, next_tile, stream, &grid);
  if (e != cudaSuccess) return e;
  flash_sm90_d64_kernel<kWGs>
      <<<grid, (kWGs + 1) * 128, L::kBytes, stream>>>(p, next_tile);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The (128, 128) instance: a kernel of its own (see the header).

constexpr int kOutRows = 64;    // rows of O's TMA box: one warpgroup's

// Shared memory of the (128, 128) kernel, from a 1024-byte aligned base:
// two Q buffers of 128 rows (the next work tile's Q loads while the
// current one's products run), kStages stages of a 128-key K tile and a
// 128-key V tile, O's staging (each warpgroup's 64 rows as two [64][64]
// chunks, which its TMA stores read), the barriers, then the work index of
// each Q buffer.  Every tile is chunks of [rows][64 bf16] in the 128-byte
// swizzle.
struct D128Layout {
  static constexpr int kQTile = 2 * kQChunkBytes;       // 32 KB
  static constexpr int kKVChunk = 128 * 128;            // [128][64]
  static constexpr int kKVTile = 2 * kKVChunk;          // 32 KB
  static constexpr int kOChunk = kOutRows * 128;        // [64][64]
  __host__ __device__ static constexpr int q(int buf) { return buf * kQTile; }
  __host__ __device__ static constexpr int k(int s) {
    return 2 * kQTile + 2 * s * kKVTile;
  }
  __host__ __device__ static constexpr int v(int s) { return k(s) + kKVTile; }
  __host__ __device__ static constexpr int o(int wg) {
    return k(kStages) + 2 * wg * kOChunk;
  }
  static constexpr int kBars = 2 * kQTile + 2 * kStages * kKVTile +
                               4 * kOChunk;       // o(2)
  // q_full[2], q_empty[2], full_k, full_v, empty_k, empty_v (kStages
  // each), turn[2].
  static constexpr int kBarriers = 4 + 4 * kStages + 2;
  static constexpr int kSlots = kBars + 8 * kBarriers;
  // Two work indices and 1024 bytes of alignment slack.
  static constexpr int kBytes = kSlots + 8 + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may take");
};

// A warpgroup's 64 rows of a work tile's output, from row row0 of (batch,
// head) pair bh: O / l (l the sum of the quad's shares; l == 0 divides by
// 1), rounded to bf16 and written into the warpgroup's staging at `stage`
// in the 128-byte swizzle (conflict-free: a warp's 8 rows of a 16-byte
// column group land in 8 different groups of banks), then stored by two
// TMA stores, one a 64-column chunk, that the warpgroup's first thread
// issues and nobody waits for here: the next call (a work tile later)
// waits until they have read the staging.  Rows past Sq lie outside O's
// tensor map and are not written.
__device__ __forceinline__ void d128_store(const Params& p,
                                           const CUtensorMap* to,
                                           uint32_t stage, int wg, bool first,
                                           int row_w, int col, const float* o,
                                           float l_a, float l_b, int bh,
                                           int row0) {
  const float den_a = quad_sum(l_a);
  const float den_b = quad_sum(l_b);
  const float inv_a = 1.f / (den_a == 0.f ? 1.f : den_a);
  const float inv_b = 1.f / (den_b == 0.f ? 1.f : den_b);
  if (first) bulk_wait_read();
  warpgroup_sync(1 + wg);
  const uint32_t swz = (row_w & 7) << 4;
  const uint32_t at_a = stage + row_w * 128 + 2 * col;
  const uint32_t at_b = at_a + 8 * 128;
#pragma unroll
  for (int g = 0; g < 16; ++g) {
    const uint32_t at = (g / 8) * D128Layout::kOChunk + (((g % 8) << 4) ^ swz);
    st_shared(at_a + at, static_cast<int>(pack_bf16(o[4 * g] * inv_a,
                                                    o[4 * g + 1] * inv_a)));
    st_shared(at_b + at, static_cast<int>(pack_bf16(o[4 * g + 2] * inv_b,
                                                    o[4 * g + 3] * inv_b)));
  }
  // The generic proxy's writes, before the async proxy's reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(1 + wg);
  if (first) {
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    tma_store(to, stage, 0, row0, h, b);
    tma_store(to, stage + D128Layout::kOChunk, kChunk, row0, h, b);
    bulk_commit();
  }
}

// Scores of warpgroup wg's 64 x 128 tile from key k0, as tile_scores
// gives them, with a cheaper mask where only the causal diagonal cuts the
// tile (no Sk tail, no window edge in it), as on each causal work tile's
// last key tile: fragment j holds key k0 + 8 (j / 4) + col + (j & 1) of
// row q0 + row_in (+ 8 when j & 2), which sees it while key <= row +
// delta, so one comparison of a constant against the row's limit masks
// it.
__device__ __forceinline__ float d128_scores(float* sc, const Params& p,
                                             int q0, int wg, int row_in,
                                             int col, int k0) {
  const int r0 = q0 + 64 * wg;
  const int delta = p.Sk - p.Sq;
  const bool diagonal_only =
      p.causal && k0 + 127 > r0 + delta && k0 + 128 <= p.Sk &&
      !(p.window > 0 && k0 <= r0 + 63 + delta - p.window);
  if (!diagonal_only) return tile_scores(sc, p, q0, wg, row_in, col, k0);
  const int lim = q0 + row_in + delta - k0 - col;
  if (p.softcap) {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const float x = p.cap_out * tanhf(sc[j] * p.cap_in);
      sc[j] = 8 * (j / 4) + (j & 1) <= ((j & 2) ? lim + 8 : lim) ? x : kNegInf;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const float x = sc[j] * p.scale_log2;
      sc[j] = 8 * (j / 4) + (j & 1) <= ((j & 2) ? lim + 8 : lim) ? x : kNegInf;
    }
  }
  return 1.f;
}

// The (128, 128) kernel: persistent, one block per SM, two consumer
// warpgroups of 64 query rows and a producer warpgroup, over work tiles of
// 128 query rows in work_tile's order: block i takes tile i first, then,
// when next_tile is null, every gridDim.x-th after it; otherwise the next
// one that nobody has taken (next_tile counts those past the first
// gridDim.x, from 0 at the launch): the causal tiles differ in length.  The
// producer takes each tile, writes its index beside its Q buffer and loads
// its Q and its K and V tiles into rings of their own (a K stage is free
// once its Q K^T has retired, a V stage after its P V, a turn later); the
// consumers read the index when the Q buffer fills (an index past the last
// tile ends the block).  The two warpgroups take turns at the tensor cores
// across work tiles: a turn issues the pending key tile's P V and the next
// key tile's Q K^T (the next work tile's first after a tile's last) as one
// group, hands the turn over and waits for both, so one warpgroup's softmax
// runs beside the other's products; after a work tile's last P V the
// warpgroup writes its output to shared memory, and the TMA store that
// takes it to device memory runs beside the next turns.
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_d128_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ CUtensorMap to,
                           int* next_tile) {
  using L = D128Layout;
  constexpr int kConsumerWarps = kConsumers / 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t slot0 = base + L::kSlots;    // work index of Q buffer i
  // Barriers: buffer or stage i of each at + 8 i; turn[wg] at turn0 + 8 wg.
  const uint32_t q_full0 = base + L::kBars;
  const uint32_t q_empty0 = q_full0 + 16;
  const uint32_t full_k0 = q_empty0 + 16;
  const uint32_t full_v0 = full_k0 + 8 * kStages;
  const uint32_t empty_k0 = full_v0 + 8 * kStages;
  const uint32_t empty_v0 = empty_k0 + 8 * kStages;
  const uint32_t turn0 = empty_v0 + 8 * kStages;
  const int n_q = (p.Sq + kBlockM - 1) / kBlockM;
  const int n_work = p.BH * n_q;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k0 + 8 * s, 1);
      mbar_init(full_v0 + 8 * s, 1);
      mbar_init(empty_k0 + 8 * s, kConsumerWarps);
      mbar_init(empty_v0 + 8 * s, kConsumerWarps);
    }
    mbar_init(turn0, 4);                     // a warpgroup's warps
    mbar_init(turn0 + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int it = 0;                  // key tiles loaded (the rings' count)
      int w = blockIdx.x;
      for (int n = 0;; ++n) {      // n: work tiles taken (the Q buffers')
        const int qb = n & 1;
        const uint32_t q_full = q_full0 + 8 * qb;
        mbar_wait(q_empty0 + 8 * qb, ((n >> 1) & 1) ^ 1);
        st_shared(slot0 + 4 * qb, w);
        if (w >= n_work) {
          mbar_arrive(q_full);
          break;
        }
        const WorkTile t = work_tile<kBlockM>(p, w, n_q);
        const int b = t.bh / p.H;
        const int h = t.bh - b * p.H;
        const int kvh = h / p.G;
        if (t.n_tiles == 0) {
          mbar_arrive(q_full);
        } else {
          // Every box counts its full bytes, the out-of-bounds fill too.
          mbar_expect_tx(q_full, L::kQTile);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tma_load(base + L::q(qb) + c * kQChunkBytes, &p.tq, q_full,
                     c * kChunk, t.q0, h, b);
          }
        }
        for (int i = 0; i < t.n_tiles; ++i, ++it) {
          const int s = it % kStages;
          const int free = ((it / kStages) & 1) ^ 1;
          const int k0 = (t.t_begin + i) * 128;
          mbar_wait(empty_k0 + 8 * s, free);
          mbar_expect_tx(full_k0 + 8 * s, L::kKVTile);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tma_load(base + L::k(s) + c * L::kKVChunk, &p.tk,
                     full_k0 + 8 * s, c * kChunk, k0, kvh, b);
          }
          mbar_wait(empty_v0 + 8 * s, free);
          mbar_expect_tx(full_v0 + 8 * s, L::kKVTile);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tma_load(base + L::v(s) + c * L::kKVChunk, &p.tv,
                     full_v0 + 8 * s, c * kChunk, k0, kvh, b);
          }
        }
        w = next_tile != nullptr ? gridDim.x + atomicAdd(next_tile, 1)
                                 : w + gridDim.x;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Warpgroup wg owns a work tile's rows 64 wg .. 64 wg + 63; of the
    // wgmma fragments, a thread holds rows row_w and row_w + 8 of them and,
    // of each 8 columns, columns col and col + 1.  wg, and the work index
    // read from shared memory, are broadcast from lane 0 so that the
    // compiler sees one value a warp: the products' branches hang on them,
    // and wgmma in a branch it takes for divergent is serialized.
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int row_w = 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
    const int row_in = 64 * wg + row_w;
    const int col = 2 * (threadIdx.x % 4);
    // One thread a warp arrives on a barrier for the warp: after the
    // warp's wgmma.wait_group, its share of the products has retired.
    const bool leader = threadIdx.x % 32 == 0;
    const bool first = threadIdx.x % 128 == 0;   // issues the TMA stores
    const uint32_t my_turn = turn0 + 8 * wg;
    const uint32_t other_turn = turn0 + 8 * (wg ^ 1);
    const uint32_t stage_o = base + L::o(wg);
    const float zeros[64] = {};

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // running max, log2 domain
    float l_a = 0.f, l_b = 0.f;           // the thread's share of the sum
    // P of the pending key tile, as the A registers of its P V: fragments
    // 8 kk .. 8 kk + 7 of the scores are those of keys 16 kk .. 16 kk + 15.
    uint32_t pa[8][4];

    int it = 0;      // key tiles taken (the rings' count)
    int n = 0;       // work tiles taken (the Q buffers' count)
    int k0 = 0;      // first key of cur's next key tile
    int left = 0;    // cur's key tiles from that one on
    WorkTile cur;
    // have: a key tile of cur is next; need: take a work tile first.  The
    // pending P V: whether there is one, whether it closes a work tile
    // (whose bh and q0 are out_*).
    bool have = false, need = true, pend = false, pend_closes = false;
    int out_bh = 0, out_q0 = 0;
    for (int turn = 0;; ++turn) {
      // The next work tile that has key tiles (an empty one's rows are
      // stored as zeros); none past the last.
      while (need) {
        const int qb = n & 1;
        mbar_wait(q_full0 + 8 * qb, (n >> 1) & 1);
        const int w = __shfl_sync(0xffffffffu, ld_shared(slot0 + 4 * qb), 0);
        need = false;
        if (w >= n_work) break;
        cur = work_tile<kBlockM>(p, w, n_q);
        k0 = cur.t_begin * 128;
        left = cur.n_tiles;
        have = left > 0;
        if (have) break;
        need = true;
        if (leader) mbar_arrive(q_empty0 + 8 * qb);
        ++n;
        d128_store(p, &to, stage_o, wg, first, row_w, col, zeros, 0.f, 0.f,
                   cur.bh, cur.q0 + 64 * wg);
      }
      if (!have && !pend) break;
      // Warpgroup 1 opens warpgroup 0's first turn and does not hand over
      // after its last, so every arrival on a turn barrier is waited for.
      if (turn == 0 && wg == 1 && leader) mbar_arrive(turn0);
      const int s = it % kStages;                      // this key tile's
      const int sp = (it + kStages - 1) % kStages;     // the pending one's
      const int qb = n & 1;
      const bool closes = have && left == 1;
      if (have) mbar_wait(full_k0 + 8 * s, (it / kStages) & 1);
      if (pend) mbar_wait(full_v0 + 8 * sp, ((it - 1) / kStages) & 1);
      mbar_wait(my_turn, turn & 1);

      // O += P V of the pending key tile: 8 steps of 16 keys; V's rows
      // advance 16 x 128 bytes a step, its two 64-wide chunks lie kKVChunk
      // apart.  S = Q K^T of this one: 8 steps of 16 along d; a chunk's
      // 128-byte rows advance 32 bytes a step, Q's chunks lie kQChunkBytes
      // apart and K's kKVChunk.
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(o[i]);
      wgmma_fence();
      if (pend) {
        const uint32_t v_tile = base + L::v(sp);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_rs_n128(o, pa[kk],
                        desc_sw128(v_tile + kk * 16 * 128, L::kKVChunk, 1024));
        }
      }
      if (have) {
        const uint32_t q_tile = base + L::q(qb) + wg * 64 * 128;
        const uint32_t k_tile = base + L::k(s);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          static_assert(kQChunkBytes == L::kKVChunk, "one step for both");
          const uint32_t step = (kk / 4) * L::kKVChunk + (kk % 4) * 32;
          wgmma_ss_n128(sc, desc_sw128(q_tile + step, 16, 1024),
                        desc_sw128(k_tile + step, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      if ((have || wg == 0) && leader) mbar_arrive(other_turn);
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
      }
      if (pend && leader) mbar_arrive(empty_v0 + 8 * sp);
      if (pend_closes) {
        d128_store(p, &to, stage_o, wg, first, row_w, col, o, l_a, l_b,
                   out_bh, out_q0 + 64 * wg);
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] = 0.f;
        m_a = m_b = kNegInf;
        l_a = l_b = 0.f;
      }
      if (!have) break;
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(sc[i]);
      if (leader) mbar_arrive(empty_k0 + 8 * s);
      if (closes && leader) mbar_arrive(q_empty0 + 8 * qb);
      const float mul = d128_scores(sc, p, cur.q0, wg, row_in, col, k0);
      tile_softmax<false, 64>(sc, mul, m_a, m_b, l_a, l_b, o, pa);
      pend = true;
      pend_closes = closes;
      ++it;
      if (closes) {
        out_bh = cur.bh;
        out_q0 = cur.q0;
        ++n;
        have = false;
        need = true;
      } else {
        k0 += 128;
        --left;
      }
    }
    // The shared memory stays until the last stores have read it.
    if (first) bulk_wait();
  }
}

cudaError_t launch_d128(const Params& p, const CUtensorMap& to,
                        int* next_tile, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_d128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        D128Layout::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid;
  const cudaError_t e = persistent_grid(p, kBlockM, next_tile, stream, &grid);
  if (e != cudaSuccess) return e;
  flash_sm90_d128_kernel<<<grid, kThreads, D128Layout::kBytes, stream>>>(
      p, to, next_tile);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch(const Params& p, int BH, int Sq, cudaStream_t stream) {
  constexpr int BN = key_tile(DQK);
  constexpr int smem = Layout<DQK, DV, BN>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<DQK, DV, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(BH * ((Sq + kBlockM - 1) / kBlockM));
  flash_sm90_kernel<DQK, DV, BN><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

// g: the map's dims (d, rows, heads, batch), the byte strides of the last
// three, and the box, as kernels/flash_attention/kernel.py::tma_geometry
// gives them; the box must be 64 of d by `rows`.  Returns 0, or -r when
// cuTensorMapEncodeTiled returned r.
int encode(CUtensorMap* map, const void* ptr, const long long* g, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g[0]),
                              static_cast<cuuint64_t>(g[1]),
                              static_cast<cuuint64_t>(g[2]),
                              static_cast<cuuint64_t>(g[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(g[4]),
                                 static_cast<cuuint64_t>(g[5]),
                                 static_cast<cuuint64_t>(g[6])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(g[7]),
                             static_cast<cuuint32_t>(g[8]),
                             static_cast<cuuint32_t>(g[9]),
                             static_cast<cuuint32_t>(g[10])};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (box[0] != kChunk || box[1] != static_cast<cuuint32_t>(rows) ||
      box[2] != 1 || box[3] != 1) {
    return cudaErrorInvalidValue;
  }
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

}  // namespace

// bf16 q [B,H,Sq,d], k [B,K,Sk,d] and v [B,K,Sk,dv], (d, dv) one of (64, 64),
// (128, 128), (192, 128) and (256, 256), read through the tensor maps that
// geom describes (11 values each for q, k, v and o in turn, see encode; q's
// box query_tile(d, Sq) rows, k's and v's key_tile(d), o's kOutRows); o
// [B,H,Sq,dv] written through its tensor map at (128, 128), through its
// element strides (batch, head, seq) otherwise.  scratch: 4 bytes of
// device memory that a causal call at (64, 64) or (128, 128) counts its
// work tiles in (the kernel zeroes them first), unused otherwise.
// Returns the cudaError_t of the launch (0 = cudaSuccess), or -r when
// encoding a tensor map failed with CUresult r.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* geom,
                                          const long long* o_strides, int B,
                                          int H, int K, int Sq, int Sk, int d,
                                          int dv, float scale, float softcap,
                                          int causal, int window,
                                          void* scratch, void* stream) {
  const bool pair = (d == 64 && dv == 64) || (d == 128 && dv == 128) ||
                    (d == 192 && dv == 128) || (d == 256 && dv == 256);
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0 ||
      !pair) {
    return cudaErrorInvalidValue;
  }
  Params p;
  int err = encode(&p.tq, q, geom, query_tile(d, Sq));
  if (err == 0) err = encode(&p.tk, k, geom + 11, key_tile(d));
  if (err == 0) err = encode(&p.tv, v, geom + 22, key_tile(d));
  if (err != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_strides[0];
  p.o_sh = o_strides[1];
  p.o_ss = o_strides[2];
  p.BH = B * H;
  p.H = H;
  p.G = H / K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale_log2 = scale * kLog2e;
  p.softcap = softcap > 0.f;
  p.cap_in = p.softcap ? scale / softcap : 0.f;
  p.cap_out = p.softcap ? softcap * kLog2e : 0.f;
  p.causal = causal;
  p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    int* const next_tile = static_cast<int*>(scratch);
    return d64_rows(Sq) == 192 ? launch_d64<3>(p, next_tile, s)
                               : launch_d64<2>(p, next_tile, s);
  }
  if (d == 128) {
    CUtensorMap to;
    err = encode(&to, o, geom + 33, kOutRows);
    if (err != 0) return err;
    return launch_d128(p, to, static_cast<int*>(scratch), s);
  }
  if (d == 192) return launch<192, 128>(p, B * H, Sq, s);
  return launch<256, 256>(p, B * H, Sq, s);
}
