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

}  // namespace

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
