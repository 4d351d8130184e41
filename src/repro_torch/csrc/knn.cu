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
// The arithmetic, the same on every path: |q|^2 and |x|^2 are fmaf chains
// from 0 over d = 0..D-1 in order, dot(q, x) likewise, and a pair's
// distance is qn - 2 * dot + xn.  Zero padding adds nothing, so a pair's
// distance depends on the query and the point alone: not on N, Q, the
// range split, the tile, the SM count or how the point was staged.  So the
// k nearest are a function of the values, the lower index winning a tie
// ((distance, index) compared lexicographically everywhere), whatever
// split or merge tree picks them.
//
// Design (D <= 64, k <= 32).  Blocks run in no order, so nothing carries
// across them.  Pass 1 splits the N points into contiguous ranges of whole
// kGranule-point granules (`split_ranges` in kernels/knn/kernel.py aims at
// one block per SM over all query blocks).  A block takes one range and
// kWarps * QT queries, QT to a warp; tiles of the range are staged in
// shared memory by cp.async (16-byte copies when the rows are 16-byte
// aligned, 4-byte copies otherwise), the next tile in flight while the
// current one is computed, with a padded row stride so that the lanes'
// 16-byte reads of distinct rows hit distinct banks.  In each step lane l
// takes points l, l + 32, l + 64, l + 96 of the next 128, so every value it
// reads feeds QT queries and each pair has its own FMA chain.  Each lane
// keeps its own top-k per query in registers: sorted descending, the worst
// in slot 0, -inf dummies past slot k-1 so the list length is a
// compile-time constant.  Points reach a lane in increasing index, so a
// pair enters only when strictly closer than the lane's worst.  The k
// smallest of the lanes' nearest distances are k distinct points, so a
// pair farther than the k-th of them cannot be among the warp's k nearest.
// That bound is taken by a warp bitonic sort, redone before any insertion
// in a step where some pair might enter; after the first steps almost no
// step has one, and a warp-wide vote skips the insertion code.  No
// arithmetic depends on the bound: it only skips pairs that cannot be
// kept.  At the end each warp merges its 32 lane lists
// (k rounds of a warp-wide lexicographic minimum over the lists' heads)
// into one sorted list per (query, range), so the partials are
// Q * ranges * k pairs.  Pass 2 gives each query kMergeWarps warps: each
// lane keeps a top-k of a strided, coalesced share of the query's
// candidates, each warp picks its k in k rounds of a warp-wide minimum,
// and one warp merges the warps' lists the same way.  Measured against
// the alternatives (lanes as queries with the range split over a block's
// warps; 1, 2 or 4 queries a thread or warp; 2, 4 or 8 points a step; 8
// or 16 warps a block; weaker bounds; list lengths 12 and 16 for k = 10;
// range granules of 256 to 1024 points; 2, 4 or 8 merge warps), it was
// the fastest at the main path's shard (times in PERF.md).
//
// Any D and any k: past D = 64 or k = 32 the general path takes over.  Its
// pass 1 stages 32 points at a time in chunks of 32 dimensions, keeps 32
// partial dot products per thread in registers, and holds each query's
// sorted list in its own slot of the partial-result buffer.  Its pass 2
// picks the k winners in k rounds: in each, every lane finds the smallest
// (distance, index) pair of its share that comes after the previous
// winner, and a warp-wide minimum takes the round's winner.  The ranges are
// disjoint, so no pair repeats.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kGranule = 256;      // ranges are whole granules of points
constexpr int kTileFloats = 16384; // one staged tile: 1024 points at D 16
constexpr int kWarps = 16;         // pass 1: warps a block
constexpr int kQT = 2;             // pass 1: queries a warp at D <= 16
constexpr int kPT = 4;             // pass 1: points a lane per step
constexpr int kMergeWarps = 8;     // pass 2: warps per query
constexpr int kQBG = 128;          // general path: queries per block

__device__ __forceinline__ bool lex_less(float d1, int i1, float d2, int i2) {
  return d1 < d2 ||
         (d1 == d2 && static_cast<unsigned>(i1) < static_cast<unsigned>(i2));
}

// The distance of a pair from its norms and dot product (every path).
__device__ __forceinline__ float pair_dist(float qn, float dot, float xn) {
  return qn - 2.0f * dot + xn;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Warp-wide lexicographic minimum of (d, i): every lane gets it.
__device__ __forceinline__ void warp_lex_min(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (lex_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

__device__ __forceinline__ int tile_len(int64_t remaining, int T) {
  return remaining < T ? static_cast<int>(remaining) : T;
}

// The warp's 32 values sorted ascending by lane (a bitonic network).
__device__ __forceinline__ float warp_sort_ascending(float v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = lower == ascending ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return v;
}

// Copies rows [t0, t0 + tn) of X [N, D] into xs (row stride RS floats;
// columns past D are left as they are), as one cp.async group.
template <int DMAX, int RS, int NT>
__device__ __forceinline__ void stage_tile(float* xs, const float* X,
                                           int64_t t0, int tn, int D,
                                           bool vec) {
  if (vec && D == DMAX) {  // a compile-time divisor
    constexpr int c4 = DMAX / 4;
    for (int e = threadIdx.x; e < tn * c4; e += NT) {
      const int p = e / c4, v = e - p * c4;
      cp_async16(xs + p * RS + 4 * v, X + (t0 + p) * D + 4 * v);
    }
  } else if (vec) {  // D % 4 == 0 and X 16-byte aligned: every row is
    const int c4 = D / 4;
    for (int e = threadIdx.x; e < tn * c4; e += NT) {
      const int p = e / c4, v = e - p * c4;
      cp_async16(xs + p * RS + 4 * v, X + (t0 + p) * D + 4 * v);
    }
  } else {
    for (int e = threadIdx.x; e < tn * D; e += NT) {
      const int p = e / D, d = e - p * D;
      cp_async4(xs + p * RS + d, X + (t0 + p) * D + d);
    }
  }
  cp_async_commit();
}

// Pass 1: one sorted list of the k nearest per (query, range), written at
// part[(q * nblk + range) * k + r], r = 0..k-1 ascending.  A range with
// fewer than k points pads its list with (kBig, -1).  Warp w of the block
// takes queries blockIdx.y * kWarps * QT + w * QT + t, t < QT; in each step
// lane l takes points base + l + 32 j, j < kPT, of the staged tile, so the
// lanes read distinct rows (a padded row stride keeps the 16-byte reads
// free of bank conflicts) and every value read feeds QT queries.
template <int DMAX, int KMAX, int QT>
__global__ void __launch_bounds__(32 * kWarps)
knn_range_kernel(const float* __restrict__ Qm, const float* __restrict__ X,
                 float* __restrict__ part_d, int* __restrict__ part_i, int Q,
                 int N, int D, int k, int per_block, bool vec) {
  constexpr int NT = 32 * kWarps;
  constexpr int T = kTileFloats / DMAX;  // points per staged tile
  constexpr int RS = DMAX + 4;           // row stride in shared memory
  constexpr int QB = kWarps * QT;        // queries per block
  static_assert(kGranule % (32 * kPT) == 0 && T % (32 * kPT) == 0,
                "ranges and tiles are whole steps");
  static_assert(kWarps * QT * KMAX * 32 * 2 <= 2 * T * RS,
                "the lists fit the tile buffers");
  extern __shared__ __align__(16) float smem[];
  float* xn = smem + 2 * T * RS;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q0 = blockIdx.y * QB + w * QT;  // query t is q0 + t
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int64_t n0 = static_cast<int64_t>(blk) * per_block;
  const int64_t n1 = n0 + per_block < N ? n0 + per_block : N;

  // Descending: bd[t][0] is the worst kept; slots k.. hold -inf dummies,
  // which no pair displaces.  best[t] is the lane's nearest so far; the k
  // smallest of the lanes' bests are k distinct points, so a pair farther
  // than the k-th of them cannot be among the warp's k nearest of query t:
  // bound[t] lies just above it.
  float bd[QT][KMAX];
  int bi[QT][KMAX];
  float best[QT], bound[QT], thr[QT];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      bd[t][j] = j < k ? kBig : -CUDART_INF_F;
      bi[t][j] = -1;
    }
    best[t] = kBig;
    bound[t] = kBig;
    thr[t] = kBig;
  }

  if (D < DMAX) {  // the padding columns, which no copy writes, read as 0
    for (int e = threadIdx.x; e < 2 * T * RS; e += NT) smem[e] = 0.0f;
    __syncthreads();
  }
  if (n0 < n1)
    stage_tile<DMAX, RS, NT>(smem, X, n0, tile_len(n1 - n0, T), D, vec);

  float qv[QT][DMAX];
  float qn[QT];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    qn[t] = 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      qv[t][d] = (q0 + t < Q && d < D)
                     ? Qm[static_cast<int64_t>(q0 + t) * D + d]
                     : 0.0f;
      qn[t] = fmaf(qv[t][d], qv[t][d], qn[t]);
    }
  }

  int buf = 0;
  for (int64_t t0 = n0; t0 < n1; t0 += T, buf ^= 1) {
    const int tn = tile_len(n1 - t0, T);
    const float* xs = smem + buf * T * RS;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the other buffer is consumed
    if (t0 + T < n1)
      stage_tile<DMAX, RS, NT>(smem + (buf ^ 1) * T * RS, X, t0 + T,
                         tile_len(n1 - t0 - T, T), D, vec);
    for (int p = threadIdx.x; p < tn; p += NT) {
      const float4* r = reinterpret_cast<const float4*>(xs + p * RS);
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < DMAX / 4; ++v) {
        const float4 x4 = r[v];
        acc = fmaf(x4.x, x4.x, acc);
        acc = fmaf(x4.y, x4.y, acc);
        acc = fmaf(x4.z, x4.z, acc);
        acc = fmaf(x4.w, x4.w, acc);
      }
      xn[p] = acc;
    }
    __syncthreads();  // the norms are visible
    for (int base = 0; base < tn; base += 32 * kPT) {
      float acc[QT][kPT];
#pragma unroll
      for (int t = 0; t < QT; ++t) {
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[t][j] = 0.0f;
      }
#pragma unroll
      for (int v = 0; v < DMAX / 4; ++v) {
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const float4 x4 = reinterpret_cast<const float4*>(
              xs + (base + lane + 32 * j) * RS)[v];
#pragma unroll
          for (int t = 0; t < QT; ++t) {
            acc[t][j] = fmaf(qv[t][4 * v + 0], x4.x, acc[t][j]);
            acc[t][j] = fmaf(qv[t][4 * v + 1], x4.y, acc[t][j]);
            acc[t][j] = fmaf(qv[t][4 * v + 2], x4.z, acc[t][j]);
            acc[t][j] = fmaf(qv[t][4 * v + 3], x4.w, acc[t][j]);
          }
        }
      }
      float dd[QT][kPT];
      bool near = false;
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        const int p = base + lane + 32 * j;
        const float xnp = xn[p];
#pragma unroll
        for (int t = 0; t < QT; ++t) {
          dd[t][j] = p < tn ? pair_dist(qn[t], acc[t][j], xnp) : CUDART_INF_F;
          best[t] = fminf(best[t], dd[t][j]);
          near |= dd[t][j] < thr[t];
        }
      }
      if (!__any_sync(0xffffffffu, near)) continue;  // the common step
      // Some pair may enter: tighten the bounds first.
#pragma unroll
      for (int t = 0; t < QT; ++t) {
        const float kth = __shfl_sync(
            0xffffffffu, warp_sort_ascending(best[t], lane), k - 1);
        bound[t] = fminf(bound[t], nextafterf(kth, CUDART_INF_F));
        thr[t] = fminf(bd[t][0], bound[t]);
      }
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
#pragma unroll
        for (int t = 0; t < QT; ++t) {
          if (dd[t][j] < thr[t]) {
            // Points reach a lane in increasing index, so dd goes after
            // every entry > dd and before the equal ones; slot 0 falls
            // off.
            const float d = dd[t][j];
            const int idx = static_cast<int>(t0 + base + lane + 32 * j);
#pragma unroll
            for (int i = 0; i < KMAX - 1; ++i) {
              const bool shift = bd[t][i + 1] > d;
              const bool place = bd[t][i] > d;
              bi[t][i] = shift ? bi[t][i + 1] : (place ? idx : bi[t][i]);
              bd[t][i] = shift ? bd[t][i + 1] : (place ? d : bd[t][i]);
            }
            if (bd[t][KMAX - 1] > d) {
              bd[t][KMAX - 1] = d;
              bi[t][KMAX - 1] = idx;
            }
            thr[t] = fminf(bd[t][0], bound[t]);
          }
        }
      }
    }
  }

  // Merge the 32 lane lists of each of the warp's queries: lane l's list
  // of query t ascending at (ld, li)[(t * KMAX + r) * 32 + l], r < k.
  __syncthreads();  // the tile buffers are free
  float* ld = smem + w * QT * KMAX * 32 * 2;
  int* li = reinterpret_cast<int*>(ld + QT * KMAX * 32);
#pragma unroll
  for (int t = 0; t < QT; ++t) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        ld[(t * KMAX + k - 1 - j) * 32 + lane] = bd[t][j];
        li[(t * KMAX + k - 1 - j) * 32 + lane] = bi[t][j];
      }
    }
  }
  __syncwarp();
  int h[QT];  // this lane's next entry of each list
  float hd[QT], od[QT];
  int hi[QT], oi[QT];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    h[t] = 0;
    hd[t] = ld[(t * KMAX) * 32 + lane];
    hi[t] = li[(t * KMAX) * 32 + lane];
    od[t] = kBig;
    oi[t] = -1;
  }
  for (int r = 0; r < k; ++r) {
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      float md = hd[t];
      int mi = hi[t];
      warp_lex_min(md, mi);
      if (lane == r) {
        od[t] = md;
        oi[t] = mi;
      }
      if (hd[t] == md && hi[t] == mi) {
        ++h[t];
        hd[t] = h[t] < k ? ld[(t * KMAX + h[t]) * 32 + lane] : kBig;
        hi[t] = h[t] < k ? li[(t * KMAX + h[t]) * 32 + lane] : -1;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    if (q0 + t < Q && lane < k) {
      const int64_t off =
          (static_cast<int64_t>(q0 + t) * nblk + blk) * k + lane;
      part_d[off] = od[t];
      part_i[off] = oi[t];
    }
  }
}

// Pass 2: the k nearest of each query from its nblk range lists.
template <int KMAX>
__global__ void __launch_bounds__(32 * kMergeWarps)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int nblk, int k) {
  __shared__ float wd[kMergeWarps * KMAX];
  __shared__ int wi[kMergeWarps * KMAX];
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(q) * nblk * k;
  const int total = nblk * k;
  // This lane's top-k of candidates c = threadIdx.x, + 32 * kMergeWarps,
  // ..., ascending (slots past k - 1 stay unused).
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = kBig;
    bi[j] = -1;
  }
  float worst_d = kBig;
  int worst_i = -1;
  for (int c = threadIdx.x; c < total; c += 32 * kMergeWarps) {
    const int i = part_i[base + c];
    if (i < 0) continue;  // a range with fewer than k points
    const float d = part_d[base + c];
    if (!lex_less(d, i, worst_d, worst_i)) continue;
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
        worst_d = bd[j];
        worst_i = bi[j];
      }
    }
  }
  // Each warp: its k smallest, popped off the lanes' list heads.
  for (int r = 0; r < k; ++r) {
    float md = bd[0];
    int mi = bi[0];
    warp_lex_min(md, mi);
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
      wd[w * KMAX + r] = md;
      wi[w * KMAX + r] = mi;
    }
  }
  __syncthreads();
  if (w != 0) return;
  // Warp 0: the k smallest of the warps' lists (lane o < kMergeWarps walks
  // list o).
  int h = 0;
  float hd = lane < kMergeWarps ? wd[lane * KMAX] : kBig;
  int hi = lane < kMergeWarps ? wi[lane * KMAX] : -1;
  float od = kBig;
  int oi = -1;
  for (int r = 0; r < k; ++r) {
    float md = hd;
    int mi = hi;
    warp_lex_min(md, mi);
    if (lane == r) {
      od = md;
      oi = mi;
    }
    if (lane < kMergeWarps && hd == md && hi == mi) {
      ++h;
      hd = h < k ? wd[lane * KMAX + h] : kBig;
      hi = h < k ? wi[lane * KMAX + h] : -1;
    }
  }
  if (lane < k) {
    out_d[static_cast<int64_t>(q) * k + lane] = od;
    out_i[static_cast<int64_t>(q) * k + lane] = oi;
  }
}

constexpr int kTileG = 32;  // general path: points staged at a time
constexpr int kDimG = 32;   // general path: dimensions staged at a time
static_assert(kGranule % kTileG == 0, "ranges are whole general tiles too");

__global__ void __launch_bounds__(kQBG)
knn_partial_general_kernel(const float* __restrict__ Qm,
                           const float* __restrict__ X,
                           float* __restrict__ part_d,
                           int* __restrict__ part_i, int Q, int N, int D,
                           int k, int per_block) {
  __shared__ float xs[kTileG * kDimG];
  __shared__ float xn[kTileG];
  const int tid = threadIdx.x;
  const int q = blockIdx.y * kQBG + tid;
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
    for (int d = 0; d < D; ++d) qn = fmaf(qrow[d], qrow[d], qn);
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
      for (int e = tid; e < kTileG * kDimG; e += kQBG) {
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
          xacc = fmaf(v, v, xacc);
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
      const float dd = pair_dist(qn, acc[p], xn[p]);
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
  const dim3 grid1(nblk, (Q + kQBG - 1) / kQBG);
  knn_partial_general_kernel<<<grid1, kQBG, 0, s>>>(Qm, X, part_d, part_i, Q,
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
  constexpr int QT = DMAX <= 16 && KMAX <= 16 ? kQT : 1;  // registers
  constexpr int T = kTileFloats / DMAX;
  constexpr int kBytes = 4 * (2 * T * (DMAX + 4) + T);
  auto kernel = knn_range_kernel<DMAX, KMAX, QT>;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (smem_set != cudaSuccess) return smem_set;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15u) == 0;
  const int qb = kWarps * QT;
  const dim3 grid1(nblk, (Q + qb - 1) / qb);
  kernel<<<grid1, 32 * kWarps, kBytes, s>>>(Qm, X, part_d, part_i, Q, N, D, k,
                                            per_block, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knn_merge_kernel<KMAX><<<Q, 32 * kMergeWarps, 0, s>>>(part_d, part_i,
                                                        out_d, out_i, nblk, k);
  return cudaGetLastError();
}

template <int DMAX>
int launch_k(const float* Qm, const float* X, float* part_d, int* part_i,
             float* out_d, int* out_i, int Q, int N, int D, int k,
             int per_block, int nblk, cudaStream_t s) {
  if (k <= 12)
    return launch<DMAX, 12>(Qm, X, part_d, part_i, out_d, out_i, Q, N, D, k,
                            per_block, nblk, s);
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

extern "C" int repro_knn_tile() { return kGranule; }

// The k nearest of data X [N,D] to each query Qm [Q,D] (row-major fp32):
// out_d [Q,k] ascending squared-L2, out_i [Q,k] int32.  part_d / part_i
// are nblk * Q * k scratch; the points are split into nblk contiguous
// ranges of per_block points (a multiple of repro_knn_tile()).
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int repro_knn_f32(const float* Qm, const float* X, float* part_d,
                             int* part_i, float* out_d, int* out_i, int Q,
                             int N, int D, int k, int per_block, int nblk,
                             void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0 || k > N || nblk <= 0 ||
      per_block <= 0 || per_block % kGranule != 0 ||
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
