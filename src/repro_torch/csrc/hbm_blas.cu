// Memory-bound BLAS kernels of the HBM workload set: axpy, per-block dot
// partials, gemv.  fp32 throughout.
//
// Replaces: src/repro/kernels/hbm_blas/kernel.py, `axpy` (`_axpy_kernel`),
// `dot_partials` (`_dot_partials_kernel`) and `gemv` (`_gemv_kernel`), the
// TPU kernels whose grid steps each take one [block_rows, C] row block,
// the same block the app graphs hand each shard task.
//
// Bound on the card: all three read each operand once and do one or two
// operations per 4-byte element, so device memory bounds them (3.35 TB/s
// on an H100 SXM against 67 TFLOP/s fp32): axpy moves 12 bytes per
// element, dot 8, gemv 4 per element of A.  The designs aim for 16-byte
// loads and enough loads in flight to fill the memory pipe.
//
// The contract that shapes them: an app's shard task runs the op on its
// own [br, C] slice, while the app's reference runs it once over the whole
// [R, C] array with block_rows = br, and the two must agree bit for bit.
// So the value computed for a row block (dot) or a row (gemv) depends only
// on that block's or row's contents: never on the grid, the array's row
// count, the SM count, or any size chosen from the device.  No atomics.
//
// * axpy: out = fmaf(a, x, y), one rounding, as the reference computes it
//   (torch's `a * x + y` rounds twice).  Elementwise, so any grid gives the
//   same bits.  Each block takes one chunk of kAxpyChunk elements: where
//   the three pointers are 16-byte aligned and n % 4 == 0, each thread
//   loads kAxpyBatch float4s of x and of y before its first FMA;
//   otherwise each thread takes 4 * kAxpyBatch scalars.  Measured against
//   the alternatives (1, 2 or 8 float4s a thread, 128 to 1024 threads a
//   block, streaming loads or stores, a grid of whole waves with a
//   grid-stride loop, a scalar tail in the vector kernel, which cost
//   1.6%), it was the fastest (times in PERF.md).
// * dot_partials: two passes.  Pass 1 cuts each row block (block_rows * C
//   contiguous elements) into chunks of kDotChunk elements, a constant of
//   this file; one thread block of kDotThreads sums one chunk: thread t
//   takes the groups of four elements 4 * (k * kDotThreads + t), k in
//   0..kDotVecPerThread-1, and accumulates them in that order with fmaf
//   (float4 loads when aligned, four scalar loads otherwise: the same
//   order either way); then a fixed butterfly over the warp's lanes and a
//   left fold over the warps, written as the chunk's partial.  Pass 2 gives
//   each row block one warp: lane l adds the block's chunk partials l,
//   l + 32, ... in index order, then the same fixed butterfly.
// * gemv: one thread block of kGemvThreads (8 warps) per row.  Thread t
//   takes the groups of four lanes 4 * (t + j * kGemvThreads) in order,
//   accumulating A * x with fmaf; then a warp butterfly and a left fold
//   over the warps.  A row's result depends on the row, x and N only: not
//   on M, the grid or the SM count.  On the vector path (the wrapper's
//   `gemv_vector_loads`: N % 4 == 0, A and x 16-byte aligned) each thread
//   issues kGemvBatch float4 loads of its row before any FMA (`hold`
//   keeps the compiler from interleaving them), so at the main path's
//   N = 8192 a block has its whole 32 KB row in flight at once, and five
//   blocks fit an SM.  A streams past L1 (`ld.global.nc.L1::no_allocate`),
//   so x (32 KB, read by every row) stays there; x is loaded after A's
//   loads are issued.  Otherwise the scalar path takes the same groups in
//   the same order, four 4-byte loads each.  Measured against the
//   alternatives (a warp per row with x staged in shared memory; a
//   persistent grid fed by a TMA bulk-copy ring; persistent blocks; a row
//   split over 1, 2, 4 or 16 warps; 2 to 16 loads in flight), it was the
//   fastest that keeps the row's order fixed (times in PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAxpyThreads = 256;
constexpr int kAxpyBatch = 4;  // float4s of each operand a thread loads
constexpr int kAxpyChunk = 4 * kAxpyThreads * kAxpyBatch;  // elements
constexpr int kDotThreads = 256;
constexpr int kDotVecPerThread = 8;
constexpr int kDotChunk = 4 * kDotThreads * kDotVecPerThread;  // 8192
constexpr int kFoldThreads = 32;
constexpr int kGemvThreads = 256;
constexpr int kGemvBatch = 8;
constexpr int kGemvMinBlocks = 5;  // at most 51 registers: 40 warps an SM
constexpr int64_t kMaxGrid = 2147483647;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of the per-warp values in warp order (thread 0's result).
template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += smem[w];
  return s;
}

// Block b takes elements [b * kAxpyChunk, (b + 1) * kAxpyChunk).
__global__ void __launch_bounds__(kAxpyThreads)
axpy_kernel(float a, const float* __restrict__ x,
            const float* __restrict__ y, float* __restrict__ out,
            int64_t n, bool vec) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kAxpyChunk;
  if (vec) {  // n % 4 == 0
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    float4 xv[kAxpyBatch], yv[kAxpyBatch];
#pragma unroll
    for (int u = 0; u < kAxpyBatch; ++u) {
      const int64_t i = c0 / 4 + u * kAxpyThreads + threadIdx.x;
      if (i < n4) {
        xv[u] = x4[i];
        yv[u] = y4[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kAxpyBatch; ++u) {
      const int64_t i = c0 / 4 + u * kAxpyThreads + threadIdx.x;
      if (i < n4) {
        float4 r;
        r.x = fmaf(a, xv[u].x, yv[u].x);
        r.y = fmaf(a, xv[u].y, yv[u].y);
        r.z = fmaf(a, xv[u].z, yv[u].z);
        r.w = fmaf(a, xv[u].w, yv[u].w);
        o4[i] = r;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4 * kAxpyBatch; ++u) {
      const int64_t i = c0 + u * kAxpyThreads + threadIdx.x;
      if (i < n) out[i] = fmaf(a, x[i], y[i]);
    }
  }
}

// Pass 1: one partial per (row block, chunk), at part[g] for the flat
// block index g = row_block * chunks + chunk.
__global__ void __launch_bounds__(kDotThreads)
dot_chunks_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ part, int64_t block_elems, int chunks,
                  bool vec) {
  __shared__ float smem[kDotThreads / 32];
  const int64_t g = blockIdx.x;
  const int64_t blk = g / chunks, chunk = g % chunks;
  const float* xb = x + blk * block_elems;
  const float* yb = y + blk * block_elems;
  const int64_t c0 = chunk * kDotChunk;
  const int64_t cend = c0 + kDotChunk < block_elems ? c0 + kDotChunk
                                                     : block_elems;
  float acc = 0.0f;
  if (vec) {  // block_elems % 4 == 0: a group is wholly in or out
    float4 xv[kDotVecPerThread], yv[kDotVecPerThread];
#pragma unroll
    for (int k = 0; k < kDotVecPerThread; ++k) {
      const int64_t e = c0 + 4 * (static_cast<int64_t>(k) * kDotThreads +
                                  threadIdx.x);
      if (e < cend) {
        xv[k] = *reinterpret_cast<const float4*>(xb + e);
        yv[k] = *reinterpret_cast<const float4*>(yb + e);
      }
    }
#pragma unroll
    for (int k = 0; k < kDotVecPerThread; ++k) {
      const int64_t e = c0 + 4 * (static_cast<int64_t>(k) * kDotThreads +
                                  threadIdx.x);
      if (e < cend) {
        acc = fmaf(xv[k].x, yv[k].x, acc);
        acc = fmaf(xv[k].y, yv[k].y, acc);
        acc = fmaf(xv[k].z, yv[k].z, acc);
        acc = fmaf(xv[k].w, yv[k].w, acc);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kDotVecPerThread; ++k) {
      const int64_t e = c0 + 4 * (static_cast<int64_t>(k) * kDotThreads +
                                  threadIdx.x);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e + q < cend) acc = fmaf(xb[e + q], yb[e + q], acc);
    }
  }
  const float s = block_sum<kDotThreads / 32>(acc, smem);
  if (threadIdx.x == 0) part[g] = s;
}

// Pass 2: one warp per row block folds its chunk partials.
__global__ void __launch_bounds__(kFoldThreads)
dot_fold_kernel(const float* __restrict__ part, float* __restrict__ out,
                int chunks) {
  const float* p = part + static_cast<int64_t>(blockIdx.x) * chunks;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kFoldThreads) acc += p[c];
  acc = warp_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// A 16-byte load that leaves L1 alone: each element of A is read once.
__device__ __forceinline__ float4 load_streaming(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// Pins v here in the instruction stream: nothing that reads it moves above
// this point, and it stays below the loads issued before it.  Without it
// the compiler may put each FMA right after its load, leaving one load in
// flight per thread (measured 10% slower).
__device__ __forceinline__ void hold(float4& v) {
  asm volatile("" : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w));
}

__global__ void __launch_bounds__(kGemvThreads, kGemvMinBlocks)
gemv_kernel(const float* __restrict__ A, const float* __restrict__ x,
            float* __restrict__ out, int64_t N, bool vec) {
  __shared__ float smem[kGemvThreads / 32];
  const float* a = A + static_cast<int64_t>(blockIdx.x) * N;
  const int64_t groups = (N + 3) / 4;
  float acc = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t g0 = threadIdx.x; g0 < groups;
         g0 += static_cast<int64_t>(kGemvThreads) * kGemvBatch) {
      float4 av[kGemvBatch];
#pragma unroll
      for (int u = 0; u < kGemvBatch; ++u) {
        const int64_t g = g0 + static_cast<int64_t>(u) * kGemvThreads;
        av[u] = g < groups ? load_streaming(a + 4 * g)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kGemvBatch; ++u) hold(av[u]);
#pragma unroll
      for (int u = 0; u < kGemvBatch; ++u) {
        const int64_t g = g0 + static_cast<int64_t>(u) * kGemvThreads;
        if (g < groups) {
          const float4 xv = __ldg(x4 + g);
          acc = fmaf(av[u].x, xv.x, acc);
          acc = fmaf(av[u].y, xv.y, acc);
          acc = fmaf(av[u].z, xv.z, acc);
          acc = fmaf(av[u].w, xv.w, acc);
        }
      }
    }
  } else {
    for (int64_t g = threadIdx.x; g < groups; g += kGemvThreads) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * g + q < N) acc = fmaf(a[4 * g + q], x[4 * g + q], acc);
    }
  }
  const float s = block_sum<kGemvThreads / 32>(acc, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace

// out[i] = fmaf(a, x[i], y[i]) over n contiguous fp32 elements.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_axpy_f32(float a, const float* x, const float* y,
                              float* out, long long n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const bool vec =
      aligned16(x) && aligned16(y) && aligned16(out) && n % 4 == 0;
  const int64_t blocks = (n + kAxpyChunk - 1) / kAxpyChunk;
  if (blocks > kMaxGrid) return cudaErrorInvalidConfiguration;
  axpy_kernel<<<static_cast<unsigned>(blocks), kAxpyThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, x, y, out, n, vec);
  return cudaGetLastError();
}

// Elements per pass-1 chunk (the wrapper sizes the partials buffer).
extern "C" int repro_dot_chunk() { return kDotChunk; }

// out[b] = sum over row block b of x * y, for nblk contiguous row blocks of
// block_elems fp32 elements each; part holds nblk * ceil(block_elems /
// kDotChunk) chunk partials.  Returns the cudaError_t of the launches.
extern "C" int repro_dot_partials_f32(const float* x, const float* y,
                                      float* part, float* out, int nblk,
                                      long long block_elems, void* stream) {
  if (nblk <= 0 || block_elems <= 0) return cudaErrorInvalidValue;
  const int64_t chunks = (block_elems + kDotChunk - 1) / kDotChunk;
  if (chunks * nblk > kMaxGrid) return cudaErrorInvalidConfiguration;
  const bool vec = aligned16(x) && aligned16(y) && block_elems % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dot_chunks_kernel<<<static_cast<unsigned>(chunks * nblk), kDotThreads, 0,
                      s>>>(x, y, part, block_elems,
                           static_cast<int>(chunks), vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dot_fold_kernel<<<nblk, kFoldThreads, 0, s>>>(part, out,
                                                static_cast<int>(chunks));
  return cudaGetLastError();
}

// out[r] = sum_j A[r, j] * x[j] for row-major contiguous A [M, N], x [N].
// vec picks the 16-byte loads (the wrapper's rule); a call whose operands
// cannot take them is refused.  Returns the cudaError_t of the launch.
extern "C" int repro_gemv_f32(const float* A, const float* x, float* out,
                              int M, long long N, int vec, void* stream) {
  if (M <= 0 || N <= 0) return cudaErrorInvalidValue;
  if (vec && !(aligned16(A) && aligned16(x) && N % 4 == 0))
    return cudaErrorInvalidValue;
  gemv_kernel<<<M, kGemvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, x, out, N, vec != 0);
  return cudaGetLastError();
}
