// Blocked fp32 matrix product C[M,N] = A[M,K] @ B[K,N], fp32 accumulator.
//
// Replaces: src/repro/kernels/systolic_matmul/kernel.py, `matmul`
// (`_mm_kernel`), the TPU kernel whose grid walks K as its innermost,
// sequential axis and carries the sum in fp32 VMEM scratch.  The CNN app
// runs its 3x3 "same" convolution on it through im2col
// (repro_torch.kernels.systolic_matmul.ops.conv_op).
//
// Bound on the card: on the CNN path the product is skinny,
// [H*W, 9*Cin] x [9*Cin, cout_per_col] = [1024, 576] x [576, 4], about
// 2 * 4 = 8 operations per byte of A, so reading A from device memory
// bounds it; in full fp32 on the CUDA cores the operation bound is 67
// TFLOP/s.  TF32 tensor cores are not used: they keep about three decimal
// digits, which would break the CNN's 2e-4 tolerance.
//
// Design: a 64 x 64 output tile per thread block of 256 threads, each
// thread holding a 4 x 4 register micro-tile.  The K axis that the Pallas
// grid ran sequentially is a loop inside the block over 16-deep slabs of
// A and B staged in shared memory (A stored transposed, padded by one
// column, so the staging stores do not collide on a bank).  Ragged M, N
// and K are masked at the loads (zeros) and at the store: nothing is
// padded on the host.  Each output sums its K products in order with
// fmaf.
//
// Narrow design, for N <= 16 (the CNN column's N = 4; the wrapper's
// `route` picks it): the tiled kernel gives [1024, 576] x [576, 4] 16
// blocks on 132 SMs and masks 15 of every 16 micro-tile columns.  Here one
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tcol = tid % (kBN / kTN);  // 0..15
  const int trow = tid / (kBN / kTN);  // 0..15
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[static_cast<int64_t>(gr) * K + gc]
                                    : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[static_cast<int64_t>(gr) * N + gc]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][trow * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tcol * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + trow * kTM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tcol * kTN + j;
      if (c < N) C[static_cast<int64_t>(r) * N + c] = acc[i][j];
    }
  }
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

// C = A @ B for row-major contiguous fp32 A [M,K], B [K,N], C [M,N].
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_matmul_f32(const float* A, const float* B, float* C,
                                int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, M, N, K);
  return cudaGetLastError();
}
