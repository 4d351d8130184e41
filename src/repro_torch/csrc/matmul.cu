// Blocked fp32 matrix product C[M,N] = A[M,K] @ B[K,N], fp32 accumulator.
//
// Replaces: src/repro/kernels/systolic_matmul/kernel.py:42, `matmul`
// (`_mm_kernel`), the TPU kernel whose grid walks K as its innermost,
// sequential axis and carries the sum in fp32 VMEM scratch.  Here that
// axis becomes a loop inside each block over BK-deep slabs of K, and, where
// the output tiles alone leave the card underfilled, a split of K across
// blocks whose partial tiles a second kernel sums in split order.  The CNN
// app runs its 3x3 "same" convolution on it through im2col
// (repro_torch.kernels.systolic_matmul.ops.conv_op).
//
// Bound on the card: 2MKN fp32 operations at 67 TFLOP/s against
// 4(MK + KN + MN) bytes at 3.35 TB/s.  CNN's default product, [1024, 576] x
// [576, 64], needs 75.5 MFLOP (1.127 us) and 2.77 MB (0.83 us); a VGG-16
// conv3 layer, [3136, 2304] x [2304, 256], 3.70 GFLOP (55.2 us) and 34.5 MB
// (10.3 us): both are bound by the operations, on the CUDA cores.  TF32
// tensor cores are not used: they keep about three decimal digits, which
// would break the CNN's 2e-4 tolerance.
//
// Tiled design (N > 16), what each part does about that bound:
// - Register blocking.  A block of BM x BN outputs (128 x 128, 64 x 128 or
//   128 x 64) has BM * BN / 64 threads, each holding an 8 x 8 micro-tile
//   as two 4-row by two 4-column strips (rows ty*4 and ty*4 + BM/2,
//   columns tx*4 and tx*4 + BN/2).  A is stored transposed in shared
//   memory, so for one k a thread reads its 8 values of A and 8 of B as
//   four float4 loads (LDS.128) for 64 FMAs, and loads the next k's while
//   this k's FMAs run.  A warp is 4 x 8 threads: its float4 reads of A hit
//   4 words (a broadcast) and of B 8 consecutive ones, so no two lanes
//   collide on a bank.  __launch_bounds__ keeps a thread at 128 registers,
//   so 65,536 / 128 / (BM * BN / 64) blocks fit an SM.
// - A pipelined K loop.  Two shared-memory buffers of 16-deep slabs and one
//   barrier a slab: B's next slab is in flight by cp.async 16-byte copies
//   (its rows are already the tile's layout), A's next slab by 16-byte
//   global loads into registers, both issued before this slab's FMAs; A is
//   stored transposed after them (cp.async cannot transpose), its rows
//   padded by 4 floats so that the stores collide at most two ways.
//   Operands whose rows are not 16-byte aligned (K % 4 != 0 for A,
//   N % 4 != 0 for B, or a base pointer off 16 bytes) take 4-byte loads
//   (A) and 4-byte cp.async copies (B) in the same kernel (`vec`'s bits,
//   set by the wrapper); what lies past M, N or K loads zeros.
// - A grid that fills the card.  The wrapper's `tiled_plan(M, K, N)`, a
//   pure function of the shape with the H100's 132 SMs as a design
//   constant, picks the tile and the number of K splits s by a modelled
//   time: the FMAs of the SM that runs the most blocks (the last wave's
//   fill), at the rate the warps it holds at once reach, and, for s > 1,
//   the workspace [s, M, N] fp32 written and read back plus the second
//   launch.  Split j takes a contiguous range of whole slabs (the last
//   ends at K) and writes its partial tile to the workspace;
//   matmul_split_sum_kernel adds the s partials in split order.  No
//   atomics: two runs give the same bits.  CNN's default: 8 tiles of
//   128 x 64 would hold 6% of the SMs; split 12 ways (48 of K each) they
//   make 96 blocks, one wave.  VGG conv3: 98 tiles of 64 x 128 (74% of the
//   SMs) split 4 ways make 392 blocks, 2.97 an SM, all held at once, and
//   a 12.8 MB workspace, which stays in the 50 MB L2.  Tiles are numbered
//   row tile fastest on grid.x (up to 2^31 - 1 tiles), splits on grid.y,
//   so every shape the wrapper accepts has a legal grid.
// Each output sums its products in k order with fmaf within a split, and
// the splits in order: the result is fp32 throughout and the same bit for
// bit from run to run.
//
// Narrow design, for N <= 16 (the CNN column's N = 4; the wrapper's
// `route` picks it): 64-wide tiles would give [1024, 576] x [576, 4] 16
// tiles on 132 SMs and mask 15 of every 16 of their columns.  Here one
// warp owns one row of A, 8 warps a block, so M = 1024 makes 128 blocks,
// one wave.  Each block stages B transposed in shared memory (Bt[n][k],
// N padded to NP in {1, 2, 4, 8, 16} with zero columns, 9 KB at N = 4)
// once; each lane reads its slice of the row with coalesced 16-byte loads
// (scalar loads when K % 4 != 0 or A is not 16-byte aligned) and sums it
// for all NP columns in a fixed order, then the lanes reduce with a fixed
// xor-shuffle tree: the result is the same bit for bit from run to run,
// with no atomics.  Bound at [1024, 576] x [576, 4]: the 2.4 MB of A,
// 0.71 us at 3.35 TB/s; at that size the launch and the first wave's
// load latency set the floor.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 16;   // the depth of a K slab

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// One BM x BN tile of C, or of split blockIdx.y's partial in the workspace
// C = W[s, M, N], over that split's range of K: slabs_per_split slabs of
// kBK from blockIdx.y * slabs_per_split * kBK, the last range cut at K.
// vec: bit 0 when A's rows are 16-byte aligned (K % 4 == 0, A aligned),
// bit 1 when B's are (N % 4 == 0, B aligned); C is the wrapper's own
// allocation, so its rows are aligned whenever N % 4 == 0.
template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64, 32768 / (BM * BN))
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int64_t M, int64_t N, int64_t K,
              unsigned tiles_m, int slabs_per_split, int vec) {
  constexpr int kThreads = BM * BN / 64;
  constexpr int kTX = BN / 8;                       // threads along a row
  constexpr int kA4 = BM * kBK / 4 / kThreads;      // A's float4 a thread
  constexpr int kB4 = BN * kBK / 4 / kThreads;      // B's float4 a thread
  static_assert(kA4 >= 1 && kB4 >= 1, "a thread stages whole float4s");
  __shared__ __align__(16) float As[2][kBK][BM + 4];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  // A warp is 4 x 8 threads of the block's (BM / 8) x (BN / 8): its float4
  // reads of A hit 4 words (a broadcast) and of B 8 consecutive ones, one
  // shared-memory wavefront each.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = (warp % (kTX / 8)) * 8 + lane % 8;
  const int ty = (warp / (kTX / 8)) * 4 + lane / 8;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x % tiles_m) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x / tiles_m) * BN;
  const int64_t kbeg = static_cast<int64_t>(blockIdx.y) * slabs_per_split
                       * kBK;
  const int64_t kcap = static_cast<int64_t>(slabs_per_split) * kBK;
  const int klen = static_cast<int>(K - kbeg < kcap ? K - kbeg : kcap);
  const int nslabs = (klen + kBK - 1) / kBK;
  C += static_cast<int64_t>(blockIdx.y) * M * N;
  const bool vec_a = vec & 1, vec_b = vec & 2;

  // A thread's slots in a slab: A's rows a_row + i * kARowStep at column
  // a_col, B's rows b_row + i * kBRowStep at column b_col.  What lies
  // outside A or B is masked: rows and columns once here, k by `kleft`,
  // the k's of the split from this slab on.
  constexpr int kARowStep = kThreads / (kBK / 4);
  constexpr int kBRowStep = kThreads / (BN / 4);
  const int a_row = tid / (kBK / 4), a_col = (tid % (kBK / 4)) * 4;
  const int b_row = tid / (BN / 4), b_col = (tid % (BN / 4)) * 4;
  const float* pa = A + (row0 + a_row) * K + kbeg + a_col;
  const float* pb = B + (kbeg + b_row) * N + col0 + b_col;
  const int64_t a_step = kARowStep * K, b_step = kBRowStep * N;
  unsigned a_live = 0;
#pragma unroll
  for (int i = 0; i < kA4; ++i) {
    if (row0 + a_row + i * kARowStep < M) a_live |= 1u << i;
  }
  const int64_t n_left = N - (col0 + b_col);
  const int b_cols =
      n_left < 0 ? 0 : (n_left > 4 ? 4 : static_cast<int>(n_left));
  int kleft = klen;

  float4 ra[kA4];   // A's next slab, on its way to shared memory
  auto load_a = [&]() {
#pragma unroll
    for (int i = 0; i < kA4; ++i) {
      const float* p = pa + i * a_step;
      const bool live = (a_live >> i) & 1;
      if (vec_a) {
        ra[i] = (live && a_col < kleft)
                    ? __ldg(reinterpret_cast<const float4*>(p))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        ra[i].x = (live && a_col < kleft) ? __ldg(p) : 0.f;
        ra[i].y = (live && a_col + 1 < kleft) ? __ldg(p + 1) : 0.f;
        ra[i].z = (live && a_col + 2 < kleft) ? __ldg(p + 2) : 0.f;
        ra[i].w = (live && a_col + 3 < kleft) ? __ldg(p + 3) : 0.f;
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kA4; ++i) {
      const int r = a_row + i * kARowStep;
      As[buf][a_col][r] = ra[i].x;
      As[buf][a_col + 1][r] = ra[i].y;
      As[buf][a_col + 2][r] = ra[i].z;
      As[buf][a_col + 3][r] = ra[i].w;
    }
  };
  // B's slab straight into shared memory by cp.async: 16-byte copies, or
  // 4-byte ones on the 4-byte path; a copy of 0 bytes fills zeros.
  auto load_b = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kB4; ++i) {
      const float* p = pb + i * b_step;
      const bool live = b_row + i * kBRowStep < kleft;
      float* dst = &Bs[buf][b_row + i * kBRowStep][b_col];
      if (vec_b) {
        const int bytes = live ? 4 * b_cols : 0;
        cp_async16(dst, bytes ? p : B, bytes);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = live && j < b_cols;
          cp_async4(dst + j, ok ? p + j : B, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  auto next_slab = [&]() {
    pa += kBK;
    pb += kBK * N;
    kleft -= kBK;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_b(0);
  load_a();
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < nslabs; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nslabs;
    if (more) {
      next_slab();
      load_b(cur ^ 1);
      load_a();
    }
    // This k's 8 values of A and 8 of B, the next k's loaded meanwhile.
    float4 fa[2][2], fb[2][2];
    auto frag = [&](int f, int kk) {
      const float* a = &As[cur][kk][ty * 4];
      const float* b = &Bs[cur][kk][tx * 4];
      fa[f][0] = *reinterpret_cast<const float4*>(a);
      fa[f][1] = *reinterpret_cast<const float4*>(a + BM / 2);
      fb[f][0] = *reinterpret_cast<const float4*>(b);
      fb[f][1] = *reinterpret_cast<const float4*>(b + BN / 2);
    };
    frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int f = kk & 1;
      if (kk + 1 < kBK) frag(f ^ 1, kk + 1);
      const float a[8] = {fa[f][0].x, fa[f][0].y, fa[f][0].z, fa[f][0].w,
                          fa[f][1].x, fa[f][1].y, fa[f][1].z, fa[f][1].w};
      const float b[8] = {fb[f][0].x, fb[f][0].y, fb[f][0].z, fb[f][0].w,
                          fb[f][1].x, fb[f][1].y, fb[f][1].z, fb[f][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  const bool vec_c = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + ty * 4 + (i & 3) + (i >> 2) * (BM / 2);
    if (r >= M) continue;
    float* crow = C + r * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = col0 + tx * 4 + h * (BN / 2);
      const float* v = &acc[i][h * 4];
      if (vec_c) {
        if (c < N) {
          *reinterpret_cast<float4*>(crow + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < N) crow[c + j] = v[j];
        }
      }
    }
  }
}

constexpr int kSumThreads = 64;
constexpr int kSumBatch = 8;   // partials a thread has in flight

// C[i] = W[0][i] + W[1][i] + ... + W[s-1][i], added in split order; a
// thread takes one float4 of C (one float when M * N % 4 != 0) and loads
// its partials kSumBatch at a time.
template <typename T>
__device__ __forceinline__ void add_to(T& s, const T& p);
template <>
__device__ __forceinline__ void add_to<float>(float& s, const float& p) {
  s += p;
}
template <>
__device__ __forceinline__ void add_to<float4>(float4& s, const float4& p) {
  s.x += p.x;
  s.y += p.y;
  s.z += p.z;
  s.w += p.w;
}

template <typename T>
__device__ __forceinline__ void split_sum(const T* __restrict__ W,
                                          T* __restrict__ C, int64_t n,
                                          int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n; i += stride) {
    T s = __ldg(W + i);
    for (int z0 = 1; z0 < splits; z0 += kSumBatch) {
      T p[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (z0 + u < splits) p[u] = __ldg(W + (z0 + u) * n + i);
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (z0 + u < splits) add_to(s, p[u]);
      }
    }
    C[i] = s;
  }
}

__global__ void __launch_bounds__(kSumThreads)
matmul_split_sum_kernel(const float* __restrict__ W, float* __restrict__ C,
                        int64_t mn, int splits) {
  if ((mn & 3) == 0) {
    split_sum(reinterpret_cast<const float4*>(W),
              reinterpret_cast<float4*>(C), mn / 4, splits);
  } else {
    split_sum(W, C, mn, splits);
  }
}

template <int BM, int BN>
cudaError_t launch_tiled(const float* A, const float* B, float* out,
                         int64_t M, int64_t N, int64_t K, int splits,
                         int slabs_per_split, int vec, cudaStream_t stream) {
  const int64_t tiles_m = (M + BM - 1) / BM;
  const int64_t tiles = tiles_m * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff || splits > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 grid(static_cast<unsigned>(tiles), splits);
  matmul_kernel<BM, BN><<<grid, BM * BN / 64, 0, stream>>>(
      A, B, out, M, N, K, static_cast<unsigned>(tiles_m), slabs_per_split,
      vec);
  return cudaGetLastError();
}

constexpr int kNarrowWarps = 8;
constexpr int kNarrowThreads = 32 * kNarrowWarps;

// One warp per row of A; Bt is B transposed, [NP][KP] with KP = K rounded
// up to 4 (zero padded), so a lane's float4 of a row of Bt lines up with
// its float4 of A.  The first kPre float4 of each lane's slice of A are
// loaded before B is staged, so the two loads overlap.
template <int NP>
__global__ void __launch_bounds__(kNarrowThreads)
matmul_narrow_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K, int vec) {
  constexpr int kPre = 4;
  extern __shared__ float4 bt4[];
  float* Bt = reinterpret_cast<float*>(bt4);
  const int KP = (K + 3) & ~3;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kNarrowWarps + threadIdx.x / 32;
  const bool live = row < M;
  const float* a = A + static_cast<int64_t>(live ? row : 0) * K;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const int K4 = vec ? K / 4 : 0;

  float4 pre[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int k4 = lane + 32 * u;
    pre[u] = (live && k4 < K4) ? a4[k4] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k = threadIdx.x; k < KP; k += kNarrowThreads) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      Bt[n * KP + k] =
          (n < N && k < K) ? B[static_cast<int64_t>(k) * N + n] : 0.0f;
    }
  }
  __syncthreads();
  if (!live) return;

  float acc[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) acc[n] = 0.0f;
  auto fma4 = [&](const float4& x, int k4) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const float4 w = bt4[n * (KP / 4) + k4];
      float t = acc[n];
      t = fmaf(x.x, w.x, t);
      t = fmaf(x.y, w.y, t);
      t = fmaf(x.z, w.z, t);
      acc[n] = fmaf(x.w, w.w, t);
    }
  };
  if (vec) {
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      if (lane + 32 * u < K4) fma4(pre[u], lane + 32 * u);
    }
    for (int k4 = lane + 32 * kPre; k4 < K4; k4 += 32) fma4(a4[k4], k4);
  } else {
    for (int k = lane; k < K; k += 32) {
      const float x = a[k];
#pragma unroll
      for (int n = 0; n < NP; ++n) acc[n] = fmaf(x, Bt[n * KP + k], acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (n < N) C[static_cast<int64_t>(row) * N + n] = acc[n];
    }
  }
}

template <int NP>
cudaError_t launch_narrow(const float* A, const float* B, float* C, int M,
                          int N, int K, int vec, cudaStream_t stream) {
  const int smem = NP * ((K + 3) & ~3) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int blocks = (M + kNarrowWarps - 1) / kNarrowWarps;
  matmul_narrow_kernel<NP><<<blocks, kNarrowThreads, smem, stream>>>(
      A, B, C, M, N, K, vec);
  return cudaGetLastError();
}

}  // namespace

// C = A @ B on the narrow kernel, row-major contiguous fp32; vec = 1 when
// K % 4 == 0 and A is 16-byte aligned.  The wrapper's `route` states which
// products come here; a product it would not send (N > 16, or B too large
// for shared memory) is refused with cudaErrorInvalidValue.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_matmul_narrow_f32(const float* A, const float* B,
                                       float* C, int M, int N, int K, int vec,
                                       void* stream) {
  if (M <= 0 || N <= 0 || N > 16 || K <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 1) return launch_narrow<1>(A, B, C, M, N, K, vec, s);
  if (N == 2) return launch_narrow<2>(A, B, C, M, N, K, vec, s);
  if (N <= 4) return launch_narrow<4>(A, B, C, M, N, K, vec, s);
  if (N <= 8) return launch_narrow<8>(A, B, C, M, N, K, vec, s);
  return launch_narrow<16>(A, B, C, M, N, K, vec, s);
}

// C = A @ B on the tiled kernel, row-major contiguous fp32 A [M,K],
// B [K,N], C [M,N], by the plan of the wrapper's `tiled_plan`: a (bm, bn)
// tile of the three, `splits` ranges of `slabs_per_split` 16-deep slabs
// of K.  With splits > 1, W is a workspace of splits * M * N floats that
// the first kernel fills and the second sums into C; otherwise W is unused.
// vec: bit 0 when K % 4 == 0 and A is 16-byte aligned, bit 1 when
// N % 4 == 0 and B is; C and W must be 16-byte aligned.  Returns the
// cudaError_t of the launches (0 = cudaSuccess).
extern "C" int repro_matmul_f32(const float* A, const float* B, float* C,
                                float* W, int64_t M, int64_t N, int64_t K,
                                int bm, int bn, int splits,
                                int slabs_per_split, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || slabs_per_split <= 0
      || (splits - 1) * static_cast<int64_t>(slabs_per_split) * kBK >= K
      || static_cast<int64_t>(splits) * slabs_per_split * kBK < K
      || slabs_per_split > (1 << 30) / kBK) {
    return cudaErrorInvalidValue;           // an empty or missing range
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? W : C;
  cudaError_t err = cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) {
    err = launch_tiled<128, 128>(A, B, out, M, N, K, splits, slabs_per_split,
                                 vec, s);
  } else if (bm == 64 && bn == 128) {
    err = launch_tiled<64, 128>(A, B, out, M, N, K, splits, slabs_per_split,
                                vec, s);
  } else if (bm == 128 && bn == 64) {
    err = launch_tiled<128, 64>(A, B, out, M, N, K, splits, slabs_per_split,
                                vec, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = M * N;
  const int64_t items = (mn & 3) == 0 ? mn / 4 : mn;
  const int64_t blocks = std::min<int64_t>(
      (items + kSumThreads - 1) / kSumThreads, 132 * 32);
  matmul_split_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                            s>>>(W, C, mn, splits);
  return cudaGetLastError();
}
