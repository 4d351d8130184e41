// Fused squared-L2 distance + k-nearest selection (CHIP-KNN's blue and
// yellow modules in one kernel).
//
// Replaces: src/repro/kernels/knn/kernel.py, `knn` (`_knn_kernel`), the TPU
// kernel whose grid walks the data tiles sequentially and carries the
// running top-k in VMEM scratch from one tile to the next.
//
// Bound on the card: operations.  Each (query, point) pair costs a D-long
// dot product (2*D operations) plus 3 for the norm expansion, while the
// data are read once: with D = 16 that is 35 * Q operations per 64-byte
// point, about 70 per byte at Q = 128, far above the fp32 ridge point of
// 20 per byte.  TF32 tensor cores are not used: they would break the 1e-4
// distance tolerance.
//
// Design: blocks on the card run in no order, so nothing is carried across
// them.  Pass 1 splits the N points into contiguous ranges, one per thread
// block (a few blocks per SM even at Q = 128).  A block holds up to 128
// queries, one per thread, each query in registers; it stages 128 points
// at a time in shared memory with their norms, and every thread computes
// |q|^2 - 2 q.x + |x|^2 (the reference's expansion, so the tolerance
// holds) against the staged points, broadcast from shared memory, keeping
// a sorted top-k list in registers.  Points are visited in increasing
// index, and a point replaces the list's tail only when strictly closer,
// so among equal distances the lower index stays.  Pass 2 merges the
// per-range lists: one warp per query, each lane keeps its own top-k of a
// strided share of the candidates, and k rounds of a warp-wide minimum
// over (distance, index) pairs pick the result in ascending order, the
// lower global index winning a tie (jax.lax.top_k's order).
//
// Any D and any k: the register-resident path above holds D <= 64 and
// k <= 32.  Past either, the general path takes over.  Its pass 1 stages 32
// points at a time in chunks of 32 dimensions, keeps 32 partial dot products
// per thread in registers, and holds each query's sorted list in its own
// slot of the partial-result buffer.  Its pass 2 picks the k winners in k
// rounds: in each, every lane finds the smallest (distance, index) pair of
// its share that comes after the previous winner, and a warp-wide minimum
// takes the round's winner.  The ranges are disjoint, so no pair repeats.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQB = 128;    // queries per block = threads per block
constexpr int kTile = 128;  // points staged in shared memory at a time
constexpr float kBig = 3.4e38f;
static_assert(kQB == kTile, "each thread takes the norm of one staged point");

__device__ __forceinline__ bool lex_less(float d1, int i1, float d2, int i2) {
  return d1 < d2 ||
         (d1 == d2 && static_cast<unsigned>(i1) < static_cast<unsigned>(i2));
}

template <int DMAX, int KMAX>
__global__ void __launch_bounds__(kQB)
knn_partial_kernel(const float* __restrict__ Qm, const float* __restrict__ X,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   int Q, int N, int D, int k, int per_block) {
  __shared__ __align__(16) float xs[kTile * DMAX];
  __shared__ float xn[kTile];
  const int tid = threadIdx.x;
  const int q = blockIdx.y * kQB + tid;
  const int blk = blockIdx.x;
  const int n0 = blk * per_block;
  const int n1 = min(N, n0 + per_block);

  float qv[DMAX];
  float qn = 0.0f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qv[d] = (q < Q && d < D) ? Qm[static_cast<int64_t>(q) * D + d] : 0.0f;
    qn += qv[d] * qv[d];
  }
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = kBig;
    bi[j] = -1;
  }
  float worst = kBig;

  for (int t0 = n0; t0 < n1; t0 += kTile) {
    const int tn = min(kTile, n1 - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < kTile * DMAX; e += kQB) {
      const int p = e / DMAX, d = e % DMAX;
      xs[e] = (p < tn && d < D) ? X[static_cast<int64_t>(t0 + p) * D + d]
                                : 0.0f;
    }
    __syncthreads();
    {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        const float v = xs[tid * DMAX + d];
        s += v * v;
      }
      xn[tid] = s;
    }
    __syncthreads();
    if (q >= Q) continue;
    for (int p = 0; p < tn; ++p) {
      const float4* xp = reinterpret_cast<const float4*>(xs + p * DMAX);
      float dot = 0.0f;
#pragma unroll
      for (int v = 0; v < DMAX / 4; ++v) {
        const float4 x4 = xp[v];
        dot = fmaf(qv[4 * v + 0], x4.x, dot);
        dot = fmaf(qv[4 * v + 1], x4.y, dot);
        dot = fmaf(qv[4 * v + 2], x4.z, dot);
        dot = fmaf(qv[4 * v + 3], x4.w, dot);
      }
      const float dd = qn - 2.0f * dot + xn[p];
      if (dd < worst) {
        const int idx = t0 + p;
        // Stable insertion into the sorted list: dd goes after every
        // entry <= dd; the tail entry falls off.
#pragma unroll
        for (int j = KMAX - 1; j >= 0; --j) {
          if (j < k) {
            if (j > 0 && bd[j - 1] > dd) {
              bd[j] = bd[j - 1];
              bi[j] = bi[j - 1];
            } else if (bd[j] > dd) {
              bd[j] = dd;
              bi[j] = idx;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j == k - 1) worst = bd[j];
        }
      }
    }
  }

  if (q < Q) {
    const int64_t base = (static_cast<int64_t>(blk) * Q + q) * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        part_d[base + j] = bd[j];
        part_i[base + j] = bi[j];
      }
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(32)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int Q, int nblk, int k) {
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = kBig;
    bi[j] = -1;
  }
  float wd = kBig;
  int wi = -1;
  const int total = nblk * k;
  for (int c = lane; c < total; c += 32) {
    const int b = c / k, jj = c - b * k;
    const int64_t off = (static_cast<int64_t>(b) * Q + q) * k + jj;
    const int i = part_i[off];
    if (i < 0) continue;  // a range with fewer than k points
    const float d = part_d[off];
    if (!lex_less(d, i, wd, wi)) continue;
#pragma unroll
    for (int j = KMAX - 1; j >= 0; --j) {
      if (j < k) {
        if (j > 0 && lex_less(d, i, bd[j - 1], bi[j - 1])) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
        } else if (lex_less(d, i, bd[j], bi[j])) {
          bd[j] = d;
          bi[j] = i;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j == k - 1) {
        wd = bd[j];
        wi = bi[j];
      }
    }
  }

  for (int r = 0; r < k; ++r) {
    float md = bd[0];
    int mi = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, md, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (lex_less(od, oi, md, mi)) {
        md = od;
        mi = oi;
      }
    }
    if (bd[0] == md && bi[0] == mi) {  // this lane held the winner: pop it
#pragma unroll
      for (int j = 0; j < KMAX - 1; ++j) {
        bd[j] = bd[j + 1];
        bi[j] = bi[j + 1];
      }
      bd[KMAX - 1] = kBig;
      bi[KMAX - 1] = -1;
    }
    if (lane == 0) {
      out_d[static_cast<int64_t>(q) * k + r] = md;
      out_i[static_cast<int64_t>(q) * k + r] = mi;
    }
  }
}

constexpr int kTileG = 32;  // general path: points staged at a time
constexpr int kDimG = 32;   // general path: dimensions staged at a time
static_assert(kTile % kTileG == 0, "ranges are whole general tiles too");

__global__ void __launch_bounds__(kQB)
knn_partial_general_kernel(const float* __restrict__ Qm,
                           const float* __restrict__ X,
                           float* __restrict__ part_d,
                           int* __restrict__ part_i, int Q, int N, int D,
                           int k, int per_block) {
  __shared__ float xs[kTileG * kDimG];
  __shared__ float xn[kTileG];
  const int tid = threadIdx.x;
  const int q = blockIdx.y * kQB + tid;
  const bool live = q < Q;
  const int blk = blockIdx.x;
  const int n0 = blk * per_block;
  const int n1 = min(N, n0 + per_block);
  const float* qrow = Qm + static_cast<int64_t>(live ? q : 0) * D;
  // This query's sorted list lives in its slot of the partial results.
  const int64_t base = (static_cast<int64_t>(blk) * Q + (live ? q : 0)) * k;
  float* bd = part_d + base;
  int* bi = part_i + base;

  float qn = 0.0f;
  if (live) {
    for (int d = 0; d < D; ++d) qn += qrow[d] * qrow[d];
    for (int j = 0; j < k; ++j) {
      bd[j] = kBig;
      bi[j] = -1;
    }
  }
  float worst = kBig;

  for (int t0 = n0; t0 < n1; t0 += kTileG) {
    const int tn = min(kTileG, n1 - t0);
    float acc[kTileG];
#pragma unroll
    for (int p = 0; p < kTileG; ++p) acc[p] = 0.0f;
    float xacc = 0.0f;  // |x|^2 of point `tid` of the tile (tid < kTileG)
    for (int c0 = 0; c0 < D; c0 += kDimG) {
      const int cn = min(kDimG, D - c0);
      __syncthreads();  // the previous chunk (and tile's xn) is consumed
      for (int e = tid; e < kTileG * kDimG; e += kQB) {
        const int p = e / kDimG, d = e % kDimG;
        xs[e] = (p < tn && d < cn)
                    ? X[static_cast<int64_t>(t0 + p) * D + c0 + d]
                    : 0.0f;
      }
      __syncthreads();
      if (tid < kTileG) {
#pragma unroll
        for (int d = 0; d < kDimG; ++d) {
          const float v = xs[tid * kDimG + d];
          xacc += v * v;
        }
      }
      float qv[kDimG];
#pragma unroll
      for (int d = 0; d < kDimG; ++d)
        qv[d] = (live && d < cn) ? qrow[c0 + d] : 0.0f;
#pragma unroll
      for (int p = 0; p < kTileG; ++p) {
#pragma unroll
        for (int d = 0; d < kDimG; ++d)
          acc[p] = fmaf(qv[d], xs[p * kDimG + d], acc[p]);
      }
    }
    if (tid < kTileG) xn[tid] = xacc;
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int p = 0; p < kTileG; ++p) {
      if (p >= tn) break;
      const float dd = qn - 2.0f * acc[p] + xn[p];
      if (dd < worst) {
        // Stable insertion: dd goes after every entry <= dd.
        int j = k - 1;
        while (j > 0 && bd[j - 1] > dd) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
          --j;
        }
        bd[j] = dd;
        bi[j] = t0 + p;
        worst = bd[k - 1];
      }
    }
  }
}

__global__ void __launch_bounds__(32)
knn_merge_general_kernel(const float* __restrict__ part_d,
                         const int* __restrict__ part_i,
                         float* __restrict__ out_d, int* __restrict__ out_i,
                         int Q, int nblk, int k) {
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  const int total = nblk * k;
  float pd = 0.0f;  // the previous round's winner
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float md = kBig;
    int mi = -1;
    for (int c = lane; c < total; c += 32) {
      const int b = c / k, jj = c - b * k;
      const int64_t off = (static_cast<int64_t>(b) * Q + q) * k + jj;
      const int i = part_i[off];
      if (i < 0) continue;  // a range with fewer than k points
      const float d = part_d[off];
      if (r > 0 && !lex_less(pd, pi, d, i)) continue;  // already taken
      if (lex_less(d, i, md, mi)) {
        md = d;
        mi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, md, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (lex_less(od, oi, md, mi)) {
        md = od;
        mi = oi;
      }
    }
    if (lane == 0) {
      out_d[static_cast<int64_t>(q) * k + r] = md;
      out_i[static_cast<int64_t>(q) * k + r] = mi;
    }
    pd = md;
    pi = mi;
  }
}

int launch_general(const float* Qm, const float* X, float* part_d,
                   int* part_i, float* out_d, int* out_i, int Q, int N, int D,
                   int k, int per_block, int nblk, cudaStream_t s) {
  const dim3 grid1(nblk, (Q + kQB - 1) / kQB);
  knn_partial_general_kernel<<<grid1, kQB, 0, s>>>(Qm, X, part_d, part_i, Q,
                                                    N, D, k, per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knn_merge_general_kernel<<<Q, 32, 0, s>>>(part_d, part_i, out_d, out_i, Q,
                                            nblk, k);
  return cudaGetLastError();
}

template <int DMAX, int KMAX>
int launch(const float* Qm, const float* X, float* part_d, int* part_i,
           float* out_d, int* out_i, int Q, int N, int D, int k,
           int per_block, int nblk, cudaStream_t s) {
  const dim3 grid1(nblk, (Q + kQB - 1) / kQB);
  knn_partial_kernel<DMAX, KMAX><<<grid1, kQB, 0, s>>>(
      Qm, X, part_d, part_i, Q, N, D, k, per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knn_merge_kernel<KMAX><<<Q, 32, 0, s>>>(part_d, part_i, out_d, out_i, Q,
                                          nblk, k);
  return cudaGetLastError();
}

template <int DMAX>
int launch_k(const float* Qm, const float* X, float* part_d, int* part_i,
             float* out_d, int* out_i, int Q, int N, int D, int k,
             int per_block, int nblk, cudaStream_t s) {
  if (k <= 16)
    return launch<DMAX, 16>(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                            per_block, nblk, s);
  if (k <= 32)
    return launch<DMAX, 32>(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                            per_block, nblk, s);
  return launch_general(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                        per_block, nblk, s);
}

}  // namespace

extern "C" int repro_knn_tile() { return kTile; }

// The k nearest of data X [N,D] to each query Qm [Q,D] (row-major fp32):
// out_d [Q,k] ascending squared-L2, out_i [Q,k] int32.  part_d / part_i
// are [nblk, Q, k] scratch; the points are split into nblk contiguous
// ranges of per_block points (a multiple of repro_knn_tile()).
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int repro_knn_f32(const float* Qm, const float* X, float* part_d,
                             int* part_i, float* out_d, int* out_i, int Q,
                             int N, int D, int k, int per_block, int nblk,
                             void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0 || k > N || nblk <= 0 ||
      per_block <= 0 || per_block % kTile != 0 ||
      static_cast<int64_t>(per_block) * nblk < N)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_k<16>(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                        per_block, nblk, s);
  if (D <= 32)
    return launch_k<32>(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                        per_block, nblk, s);
  if (D <= 64)
    return launch_k<64>(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                        per_block, nblk, s);
  return launch_general(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                        per_block, nblk, s);
}
