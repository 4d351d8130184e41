// One pass of the 13-point diamond dilation (max over |di| + |dj| <= 2).
//
// Replaces: src/repro/kernels/stencil_dilate/kernel.py, `dilate`
// (`_dilate_kernel`), the TPU kernel that brings its 2-row halo in through
// three clamped BlockSpecs (previous, current and next row block).
//
// Bound on the card: device-memory bytes.  A pass reads H*W floats and
// writes H*W floats and does 12 max operations per point, about 1.5
// operations per byte, far below the H100's fp32 ridge point (67 TFLOP/s
// over 3.35 TB/s = 20 operations per byte).
//
// Design: each thread block owns a tile of `tile_rows` x 32 output points.
// It stages the tile plus a 2-cell halo on every side in shared memory
// (bounds-checked; a cell outside the image reads as -FLT_MAX, the
// reference's finfo.min), then every thread takes the max over the 13
// offsets from shared memory.  Each input float is thus read from device
// memory (tile_rows + 4) * 36 / (tile_rows * 32) times, 1.14 at 256 rows,
// and the neighbouring reads of a warp hit consecutive shared-memory
// banks.  Rows of 32 floats keep a warp's global loads and stores
// coalesced into 128-byte lines.  There is no H % tile_rows constraint:
// the last tile is masked.  Only max is used, so the result is bit-exact
// against the plain version.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 32;
constexpr int kThreadRows = 8;
constexpr int kHalo = 2;
constexpr int kSmemCols = kTileCols + 2 * kHalo;

__global__ void dilate_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int H, int W,
                              int tile_rows) {
  extern __shared__ float tile[];  // [(tile_rows + 4) * kSmemCols]
  const int row0 = blockIdx.y * tile_rows;
  const int col0 = blockIdx.x * kTileCols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int smem_rows = tile_rows + 2 * kHalo;

  for (int r = ty; r < smem_rows; r += kThreadRows) {
    const int gi = row0 + r - kHalo;
    for (int c = tx; c < kSmemCols; c += kTileCols) {
      const int gj = col0 + c - kHalo;
      float v = -FLT_MAX;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
        v = in[static_cast<int64_t>(gi) * W + gj];
      }
      tile[r * kSmemCols + c] = v;
    }
  }
  __syncthreads();

  const int j = col0 + tx;
  if (j >= W) return;
  for (int r = ty; r < tile_rows; r += kThreadRows) {
    const int i = row0 + r;
    if (i >= H) break;
    const float* c = tile + (r + kHalo) * kSmemCols + (tx + kHalo);
    float m = -FLT_MAX;
#pragma unroll
    for (int di = -2; di <= 2; ++di) {
      const int reach = 2 - (di < 0 ? -di : di);
#pragma unroll
      for (int dj = -2; dj <= 2; ++dj) {
        if ((dj < 0 ? -dj : dj) <= reach) {
          m = fmaxf(m, c[di * kSmemCols + dj]);
        }
      }
    }
    out[static_cast<int64_t>(i) * W + j] = m;
  }
}

}  // namespace

extern "C" int repro_dilate_smem_bytes(int tile_rows) {
  return (tile_rows + 2 * kHalo) * kSmemCols * static_cast<int>(sizeof(float));
}

// One dilation pass, in -> out (distinct buffers), on `stream`.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_dilate_f32(const float* in, float* out, int H, int W,
                                int tile_rows, void* stream) {
  if (H <= 0 || W <= 0 || tile_rows <= 0) return cudaErrorInvalidValue;
  const int smem = repro_dilate_smem_bytes(tile_rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dilate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kTileCols, kThreadRows);
  const dim3 grid((W + kTileCols - 1) / kTileCols,
                  (H + tile_rows - 1) / tile_rows);
  dilate_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, H, W, tile_rows);
  return cudaGetLastError();
}
