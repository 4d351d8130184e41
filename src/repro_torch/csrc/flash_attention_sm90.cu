// Flash attention on Hopper's tensor cores: bf16 wgmma fed by TMA, with
// one producer warpgroup and two consumer warpgroups per thread block.
// GQA, causal masking aligned at the end (delta = Sk - Sq), a sliding
// window and a tanh logit softcap, on [B, H, S, d] views with d in {64, 128}.
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
// (989 TFLOP/s), 0.050 ms for the bytes.
//
// Design.  A block owns 128 query rows of one (batch, head) and walks the
// visible keys in tiles of 128 (the loop bounds skip the fully masked
// tiles, the TPU kernel's `run`; the heaviest causal blocks, the last
// rows, are issued first).
// - Producer warpgroup (setmaxnreg down to 24 registers): one thread loads
//   the Q tile once and K and V tiles into a ring of two stages by TMA,
//   each stage guarded by a "full" and an "empty" mbarrier.  Tensor maps
//   over (d, S, heads, batch) read the model's [B, S, H, d] tensors through
//   their strides; rows past Sq or Sk arrive as zeros (TMA's out-of-bounds
//   fill), so nothing is padded in device memory.  Each 128-row tile lies
//   in shared memory as d / 64 chunks of [128 rows][64 bf16] in the
//   128-byte swizzle that the wgmma descriptors name.
// - Consumer warpgroups (setmaxnreg up to 240), 64 query rows each:
//   S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//   (K stored [keys, d] is the K-major B operand), fp32 accumulator.  The
//   online softmax runs on the accumulator fragments: a row lives in the 4
//   threads of a quad, so its max takes two xor shuffles.  Scores are
//   scaled first, then softcap * tanh(s / softcap), then masked with
//   -1e30 (never -inf: a row whose keys so far are all masked takes p = 1
//   and the first visible key wipes that with alpha = 0), in the log2
//   domain (exp2 with log2(e) folded into the scale).  Masks are computed
//   only on tiles that cross the causal diagonal, the window edge or the
//   Sk tail.  m, l and the output accumulator stay fp32; l sums the
//   unrounded p; p is rounded to bf16 as it becomes the register A operand
//   of O += P V (wgmma m64n{d}k16, V [keys, d] the MN-major B operand,
//   transposed by the instruction).  A stage goes back to the producer when
//   both products of both warpgroups have retired.  The output is
//   acc / l (l == 0 divides by 1), rounded to bf16 and stored from
//   registers in q's layout.
// Shared memory at d = 128: Q 32 KB, two stages of K and V 128 KB, so one
// block per SM.
//
// What is left between it and the bound: inside a warpgroup the softmax
// does not overlap the products (the two warpgroups overlap each other's),
// and with one block per SM a block's first loads and its output stores
// are not hidden behind another block's work, which weighs most on the
// short causal blocks.
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
constexpr int kBlockN = 128;            // keys per tile
constexpr int kChunk = 64;              // bf16 per 128-byte swizzled row
constexpr int kChunkBytes = kBlockN * 128;   // one chunk of a 128-row tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockM == kBlockN, "Q, K and V tiles share one TMA box");

struct Params {
  CUtensorMap tq, tk, tv;     // boxes of [128 rows][64 bf16], swizzled
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss; // element strides of the output
  int H, G, Sq, Sk;           // G = H / K query heads per kv head
  float scale_log2;           // scale * log2(e)
  float cap_in, cap_out;      // scale / softcap, softcap * log2(e)
  int softcap, causal, window;
};

// Shared memory, from a 1024-byte aligned base: Q, then stage s's K and V,
// then the barriers.
template <int DP>
struct Layout {
  static constexpr int kTile = (DP / kChunk) * kChunkBytes;
  static constexpr int kQ = 0;
  __host__ __device__ static constexpr int k(int s) {
    return (1 + 2 * s) * kTile;
  }
  __host__ __device__ static constexpr int v(int s) {
    return (2 + 2 * s) * kTile;
  }
  static constexpr int kBars = (1 + 2 * kStages) * kTile;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of alignment slack.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One TMA box (64 x 128 of (d, rows) at (c0, c1, c2, c3)) into shared
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

// wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// O += P V for one 16-key slice: m64n{DP}k16, A = P from registers.
template <int DP>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* a,
                                           uint64_t db) {
  if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

// Scores of one tile in the log2 domain, in place on the S fragments: scale
// (and softcap), then the masks when kMask; returns the thread's largest
// score of each of its two rows.  Fragment j of a thread holds row
// (j & 2 ? row_b : row_a), key k0 + 8 (j / 4) + col + (j & 1).
template <bool kCap, bool kMask>
__device__ __forceinline__ void scores(float* sc, const Params& p, int k0,
                                       int row_a, int col, int delta,
                                       float& mx_a, float& mx_b) {
#pragma unroll
  for (int j = 0; j < kBlockN / 2; ++j) {
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

// Grid: x = batch * head, y = query block, the last rows first.  Threads
// 0..255 are the consumer warpgroups, 256..383 the producer.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ Params p) {
  using L = Layout<DP>;
  constexpr int kChunks = DP / kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;                  // full[s]: + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;        // empty[s]: + 8 s

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int delta = p.Sk - p.Sq;

  // Visible keys of this block's rows, in whole tiles of 128.
  const int q_last = min(q0 + kBlockM, p.Sq) - 1;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + delta + 1);
  if (p.window > 0) k_begin = max(0, q0 + delta - p.window + 1);
  const int t_begin = k_begin / kBlockN;
  const int n_tiles =
      k_end > k_begin ? (k_end + kBlockN - 1) / kBlockN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the ring of K and V tiles filled.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(base + L::kQ + c * kChunkBytes, &p.tq, q_full, c * kChunk,
                 q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::kTile);
        const int k0 = (t_begin + i) * kBlockN;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load(base + L::k(s) + c * kChunkBytes, &p.tk, full0 + 8 * s,
                   c * kChunk, k0, kvh, b);
          tma_load(base + L::v(s) + c * kChunkBytes, &p.tv, full0 + 8 * s,
                   c * kChunk, k0, kvh, b);
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

    float o[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // running max, log2 domain
    float l_a = 0.f, l_b = 0.f;           // the thread's share of the sum

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (t_begin + i) * kBlockN;
      const uint32_t k_tile = base + L::k(s);
      const uint32_t v_tile = base + L::v(s);
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);

      // S = Q K^T: d / 16 steps of 16 along d; a 64-wide chunk's 128-byte
      // rows advance 32 bytes a step.
      float sc[kBlockN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(q_tile + off, 16, 1024),
                      desc_sw128(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < kBlockN / 2; ++j) fence_reg(sc[j]);

      const bool mask =
          k0 + kBlockN > p.Sk ||
          (p.causal && k0 + kBlockN - 1 > r0 + delta) ||
          (p.window > 0 && k0 <= r0 + 63 + delta - p.window);
      float mx_a = kNegInf, mx_b = kNegInf;
      if (p.softcap) {
        if (mask) {
          scores<true, true>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        } else {
          scores<true, false>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        }
      } else {
        if (mask) {
          scores<false, true>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        } else {
          scores<false, false>(sc, p, k0, row_a, col, delta, mx_a, mx_b);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = ex2(m_a - mn_a);
      const float alpha_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // p = exp(s - m): l sums it unrounded; the A operand of P V takes it
      // rounded to bf16.  Fragments 8 kk .. 8 kk + 7 are the A registers of
      // keys 16 kk .. 16 kk + 15, in order.
      uint32_t pa[kBlockN / 16][4];
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockN / 2; j += 2) {
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
      for (int j = 0; j < DP / 2; ++j) o[j] *= (j & 2) ? alpha_b : alpha_a;

      // O += P V: 8 steps of 16 keys; V's rows advance 16 x 128 bytes a
      // step, its 64-wide chunks lie kChunkBytes apart.
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) fence_reg(o[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pv_product<DP>(o, pa[kk],
                       desc_sw128(v_tile + kk * 16 * 128, kChunkBytes, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) fence_reg(o[j]);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    const float den_a = quad_sum(l_a);
    const float den_b = quad_sum(l_b);
    const float div_a = den_a == 0.f ? 1.f : den_a;
    const float div_b = den_b == 0.f ? 1.f : den_b;
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
    if (row_a < p.Sq) {
      __nv_bfloat16* dst = ob + row_a * p.o_ss + col;
#pragma unroll
      for (int g = 0; g < DP / 8; ++g) {
        *reinterpret_cast<uint32_t*>(dst + 8 * g) =
            pack_bf16(o[4 * g] / div_a, o[4 * g + 1] / div_a);
      }
    }
    if (row_b < p.Sq) {
      __nv_bfloat16* dst = ob + row_b * p.o_ss + col;
#pragma unroll
      for (int g = 0; g < DP / 8; ++g) {
        *reinterpret_cast<uint32_t*>(dst + 8 * g) =
            pack_bf16(o[4 * g + 2] / div_b, o[4 * g + 3] / div_b);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int BH, int Sq, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(BH, (Sq + kBlockM - 1) / kBlockM);
  flash_sm90_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
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
// gives them.  Returns 0, or -r when cuTensorMapEncodeTiled returned r.
int encode(CUtensorMap* map, const void* ptr, const long long* g) {
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
  if (box[0] != kChunk || box[1] != kBlockN || box[2] != 1 || box[3] != 1) {
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

// bf16 q [B,H,Sq,d], k and v [B,K,Sk,d] (d = 64 or 128) read through the
// tensor maps that geom describes (11 values each for q, k, v in turn, see
// encode); o written through its element strides (batch, head, seq).
// Returns the cudaError_t of the launch (0 = cudaSuccess), or -r when
// encoding a tensor map failed with CUresult r.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* geom,
                                          const long long* o_strides, int B,
                                          int H, int K, int Sq, int Sk, int d,
                                          float scale, float softcap,
                                          int causal, int window,
                                          void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0 ||
      (d != 64 && d != 128)) {
    return cudaErrorInvalidValue;
  }
  Params p;
  int err = encode(&p.tq, q, geom);
  if (err == 0) err = encode(&p.tk, k, geom + 11);
  if (err == 0) err = encode(&p.tv, v, geom + 22);
  if (err != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_strides[0];
  p.o_sh = o_strides[1];
  p.o_ss = o_strides[2];
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
  return d == 64 ? launch<64>(p, B * H, Sq, s) : launch<128>(p, B * H, Sq, s);
}
