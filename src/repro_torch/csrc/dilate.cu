// One pass of the 13-point diamond dilation (max over |di| + |dj| <= 2).
//
// Replaces: src/repro/kernels/stencil_dilate/kernel.py, `dilate`
// (`_dilate_kernel`), the TPU kernel that brings its 2-row halo in through
// three clamped BlockSpecs (previous, current and next row block).
//
// The maximum is JAX's (`jnp.maximum`): NaN when either operand is NaN,
// -0.0 below +0.0, otherwise the larger.  PTX `max.NaN.f32` computes
// exactly that (`fmaxf` drops a NaN operand).  The operation is
// commutative and associative apart from NaN payloads, so any order of the
// 13 operands, and any reuse of partial maxima, gives the plain version's
// bits.  A cell outside the image reads as -FLT_MAX, and the result is
// never below -FLT_MAX (the reference starts its running maximum there).
//
// Bound on the card: device-memory bytes.  A pass reads H*W floats and
// writes H*W floats; the max work is far below the fp32 rate.
//
// Design: a register window walking down a strip.  The diamond is the
// union of row segments of widths 1, 3, 5, 3, 1, so with h3 and h5 the
// maxima over +-1 and +-2 columns of one input row,
//     out[i] = max(x[i-2], h3[i-1], h5[i], h3[i+1], x[i+2]).
// A thread owns 4 adjacent columns (one float4) of a strip of `strip_rows`
// rows; it forms x, h3 and h5 of each input row once, as the row arrives,
// and keeps the last four rows' in registers.  The columns next to its
// own come from the neighbouring lanes by shuffle; lane 0 and lane 31
// load the two columns beyond each edge of the warp's 128.  Loads of the
// next kGroup rows are issued before the current kGroup rows' max work,
// and the group after them is asked into L2 (`prefetch.global.L2`), so a
// warp has 4 to 8 rows on their way to registers and 4 more to L2.  More
// in flight was slower on the H100, in registers, in a cp.async ring or
// as deeper L2 prefetch, and a copy with the same loads and stores and no
// max work came within 5% of the kernel: what is left is the access pattern.
// The input is read (strip_rows + 4) / strip_rows times, the output
// written once, both as 16-byte accesses when W % 4 == 0 and both
// pointers are 16-byte aligned; otherwise the same arithmetic runs on
// 4-byte accesses (and without the L2 requests).
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;                  // adjacent columns a thread owns
constexpr int kWarpCols = 32 * kCols;
constexpr int kWarps = 4;                 // warps of a block, side by side
constexpr int kGroup = 4;                 // rows whose loads go out together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float jmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float4 jmax4(float4 a, float4 b) {
  return make_float4(jmax(a.x, b.x), jmax(a.y, b.y), jmax(a.z, b.z),
                     jmax(a.w, b.w));
}

// One input row as a thread loads it: its own 4 columns, and for lanes 0
// and 31 the two columns beyond the warp's left or right edge.
struct Row {
  float4 v;
  float2 edge;
};

// One input row's partial maxima over the thread's 4 columns.
struct Seg {
  float4 x, h3, h5;
};

template <bool kVec>
__device__ __forceinline__ Row load_row(const float* __restrict__ in, int i,
                                        int H, int W, int c, int ec,
                                        bool edge_lane) {
  Row r;
  r.v = make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);
  r.edge = make_float2(-FLT_MAX, -FLT_MAX);
  if (i < 0 || i >= H) return r;
  const float* row = in + static_cast<int64_t>(i) * W;
  if (kVec) {
    // W % 4 == 0, so a float4 lies wholly inside or outside the row, and
    // the edge pair (even column) likewise.
    if (c < W) r.v = *reinterpret_cast<const float4*>(row + c);
    if (edge_lane && ec >= 0 && ec < W) {
      r.edge = *reinterpret_cast<const float2*>(row + ec);
    }
  } else {
    if (c < W) r.v.x = row[c];
    if (c + 1 < W) r.v.y = row[c + 1];
    if (c + 2 < W) r.v.z = row[c + 2];
    if (c + 3 < W) r.v.w = row[c + 3];
    if (edge_lane) {
      if (ec >= 0 && ec < W) r.edge.x = row[ec];
      if (ec + 1 >= 0 && ec + 1 < W) r.edge.y = row[ec + 1];
    }
  }
  return r;
}

// x, h3 and h5 of one row.  The whole warp calls it (shuffles).
__device__ __forceinline__ Seg segments(const Row& r, int lane) {
  const float4 v = r.v;
  float l2 = __shfl_up_sync(kFull, v.z, 1);    // column c - 2
  float l1 = __shfl_up_sync(kFull, v.w, 1);    // column c - 1
  float r1 = __shfl_down_sync(kFull, v.x, 1);  // column c + 4
  float r2 = __shfl_down_sync(kFull, v.y, 1);  // column c + 5
  if (lane == 0) {
    l2 = r.edge.x;
    l1 = r.edge.y;
  }
  if (lane == 31) {
    r1 = r.edge.x;
    r2 = r.edge.y;
  }
  const float p01 = jmax(v.x, v.y);
  const float p12 = jmax(v.y, v.z);
  const float p23 = jmax(v.z, v.w);
  const float p0123 = jmax(p01, p23);
  Seg s;
  s.x = v;
  s.h3 = make_float4(jmax(l1, p01), jmax(p01, v.z), jmax(p12, v.w),
                     jmax(p23, r1));
  s.h5 = make_float4(jmax(s.h3.x, jmax(l2, v.z)), jmax(p0123, l1),
                     jmax(p0123, r1), jmax(s.h3.w, jmax(v.y, r2)));
  return s;
}

// Asks L2 for the thread's 16 bytes of row i, a group before its load.
__device__ __forceinline__ void prefetch_l2(const float* in, int i, int W,
                                            int c) {
  const float* p = in + static_cast<int64_t>(i) * W + c;
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ out, int i,
                                          int W, int c, float4 m) {
  float* row = out + static_cast<int64_t>(i) * W;
  if (kVec) {
    if (c < W) *reinterpret_cast<float4*>(row + c) = m;
  } else {
    if (c < W) row[c] = m.x;
    if (c + 1 < W) row[c + 1] = m.y;
    if (c + 2 < W) row[c + 2] = m.z;
    if (c + 3 < W) row[c + 3] = m.w;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
    dilate_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W, int strip_rows) {
  const int lane = threadIdx.x & 31;
  const int c_warp = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kWarpCols;
  if (c_warp >= W) return;                  // the whole warp: no shuffles left
  const int c = c_warp + lane * kCols;
  const bool edge_lane = lane == 0 || lane == 31;
  const int ec = lane == 0 ? c_warp - 2 : c_warp + kWarpCols;
  const int r_begin = blockIdx.y * strip_rows;
  const int r_end = min(r_begin + strip_rows, H);
  const float4 floor4 = make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);

  // The window before output row i: rows i-2, i-1, i, i+1.
  Seg a = segments(load_row<kVec>(in, r_begin - 2, H, W, c, ec, edge_lane),
                   lane);
  Seg b = segments(load_row<kVec>(in, r_begin - 1, H, W, c, ec, edge_lane),
                   lane);
  Seg m = segments(load_row<kVec>(in, r_begin, H, W, c, ec, edge_lane),
                   lane);
  Seg d = segments(load_row<kVec>(in, r_begin + 1, H, W, c, ec, edge_lane),
                   lane);
  Row next[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    next[u] = load_row<kVec>(in, r_begin + 2 + u, H, W, c, ec, edge_lane);
  }
  for (int i = r_begin; i < r_end; i += kGroup) {
    Row cur[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) cur[u] = next[u];
    if (i + kGroup < r_end) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        next[u] = load_row<kVec>(in, i + kGroup + 2 + u, H, W, c, ec,
                                 edge_lane);
        const int ahead = i + 2 * kGroup + 2 + u;  // the group after next
        if (kVec && ahead < min(r_end + 2, H) && c < W) {
          prefetch_l2(in, ahead, W, c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const Seg e = segments(cur[u], lane);  // row i + u + 2
      if (i + u < r_end) {
        const float4 o = jmax4(jmax4(jmax4(a.x, b.h3), jmax4(m.h5, d.h3)),
                               jmax4(e.x, floor4));
        store_row<kVec>(out, i + u, W, c, o);
      }
      a = b;
      b = m;
      m = d;
      d = e;
    }
  }
}

}  // namespace

// One dilation pass, in -> out (distinct buffers), on `stream`; each
// thread block walks `tile_rows` rows of 4 * 128 columns.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_dilate_f32(const float* in, float* out, int H, int W,
                                int tile_rows, void* stream) {
  if (H <= 0 || W <= 0 || tile_rows <= 0) return cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 block(32 * kWarps);
  const dim3 grid((W + kWarps * kWarpCols - 1) / (kWarps * kWarpCols),
                  (H + tile_rows - 1) / tile_rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    dilate_kernel<true><<<grid, block, 0, s>>>(in, out, H, W, tile_rows);
  } else {
    dilate_kernel<false><<<grid, block, 0, s>>>(in, out, H, W, tile_rows);
  }
  return cudaGetLastError();
}
