// Blocked online-softmax attention (flash attention) on q, k [B, H, S, d]
// and v [B, H, S, dv], with GQA, causal masking aligned at the end
// (delta = Sk - Sq), a sliding window and a tanh logit softcap.  The v head
// dim may differ from q's and k's: DeepSeek's MLA gives q and k 192 (128
// nope + 64 rope) and v 128.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention`
// (`_flash_kernel`), the TPU kernel whose innermost, sequential grid axis
// walks the kv blocks and carries the running max m, sum l and fp32
// accumulator in VMEM scratch from one kv block to the next.
//
// What it computes, as the TPU kernel does: scores s = (q . k) * scale in
// fp32, then softcap * tanh(s / softcap) when a softcap is given, then the
// masks (kv tail kpos < Sk, causal kpos <= qpos + delta, window
// kpos > qpos + delta - window) by setting s = -1e30, not -inf: a row whose
// keys in a block are all masked takes exp(-1e30 - (-1e30)) = 1 there, and
// the first visible key wipes that with alpha = exp(-1e30 - m) = 0; with
// -inf the same row would give NaN.  Online softmax keeps m, l and the
// accumulator in fp32; p is rounded to v's dtype before the PV product (a
// no-op for fp32), l sums the unrounded p.  The output is acc / l (l == 0
// divides by 1), rounded to q's dtype.  GQA reads kv head h / (H / K)
// instead of repeating K and V; the tails are masked in the kernel, not
// padded in device memory.
//
// Bound on the card: operations.  At the main path's shape (B 4, H 32,
// K 8, S 2048, d 128, bf16, causal) the work is about 1.37e11 operations
// on 168 MB of operands and output, some 800 operations per byte: 0.139 ms
// at the bf16 tensor-core rate (989 TFLOP/s), 0.050 ms for the bytes.
//
// At MLA's shape (B 4, H 128, K 128, S 2048, d 192, dv 128, bf16, causal)
// the work is 2 (d + dv) = 640 operations a visible (query, key) pair,
// about 6.87e11 operations on 1.34 GB: 0.695 ms at the bf16 tensor-core
// rate, 0.40 ms for the bytes.  Aligned bf16 calls at (192, 128) go to
// the tensor-core kernel (flash_attention_sm90.cu); this kernel's (192, 128)
// instance takes the fp32 ones (MLA's fp32 parity runs) and views that TMA
// cannot read.  It keeps Q and K transposed at 192 floats a column and V at
// 128, 128 KB of shared memory, so one block fits on an SM.  Only this
// kernel takes the other pairs with dv != d.
//
// Why it does not reach that bound yet: this first design runs on the CUDA
// cores in fp32 (67 TFLOP/s, so no faster than 2.05 ms at that shape), as
// the simple design that is right first.  One thread block of 256 threads
// owns 64 query rows of one (batch, head); it keeps Q transposed in shared
// memory as fp32 and walks the visible keys in tiles of 64 (the loop bounds
// skip the tiles that are fully masked, the TPU kernel's `run` condition):
// K transposed and V row-major are staged in shared memory, each thread
// computes a 4 x 4 block of scores from float4 reads, the 16 threads of a
// row reduce its max and sum with warp shuffles, p goes to shared memory
// (over the K tile, after a barrier) and each thread accumulates a 4-row x
// (dv / 16)-column block of the output in registers.  Loads are not
// overlapped with compute beyond what two resident blocks per SM give.
// The tensor-core design (wgmma on bf16 tiles fed by TMA, warp-specialised)
// is flash_attention_sm90.cu.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;             // query rows per thread block
constexpr int kBlockK = 64;             // keys per tile
constexpr int kThreads = 256;           // 16 row groups x 16 key groups
constexpr int kPStride = kBlockK + 4;   // row stride of P in shared memory
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // Element strides of the batch, head and sequence axes; d is unit stride.
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int B, H, K, Sq, Sk, d, dv;   // d: q and k head dim; dv: v and o
  float scale, softcap;   // softcap <= 0: none
  int causal, window;     // window <= 0: none
  int vec;                // 1: every row of q, k, v is 16-byte aligned
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;   // elements per 16-byte load
  __device__ static float load(const float* p) { return *p; }
  __device__ static void load_vec(const float* p, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void load_vec(const __nv_bfloat16* p, float* dst) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  // Round to bf16 (nearest even, as astype) and back.
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// dst[e] = row[c0 + e] as fp32 for c0 + e < d, else 0 (row == nullptr: 0).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int c0, int d,
                                           bool vec, float* dst) {
  constexpr int N = Elem<T>::kVec;
  if (row != nullptr && vec && c0 + N <= d) {
    Elem<T>::load_vec(row + c0, dst);
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    dst[e] = (row != nullptr && c0 + e < d) ? Elem<T>::load(row + c0 + e)
                                            : 0.f;
  }
}

// Rows r0 .. r0 + 63 of base (rows >= nrows read as 0) into dst transposed,
// dst[c * 64 + r].  Consecutive lanes take consecutive rows, so the stores
// hit consecutive banks.
template <typename T, int DP>
__device__ void load_tile_t(const T* base, int64_t row_stride, int r0,
                            int nrows, int d, bool vec, float* dst) {
  constexpr int N = Elem<T>::kVec;
  constexpr int kChunks = DP / N;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i % 64;
    const int c0 = (i / 64) * N;
    const int row = r0 + r;
    float vals[N];
    load_chunk<T>(row < nrows ? base + row * row_stride : nullptr, c0, d,
                  vec, vals);
#pragma unroll
    for (int e = 0; e < N; ++e) dst[(c0 + e) * 64 + r] = vals[e];
  }
}

// Rows r0 .. r0 + 63 of base into dst row-major, dst[r * DP + c].
template <typename T, int DP>
__device__ void load_tile(const T* base, int64_t row_stride, int r0,
                          int nrows, int d, bool vec, float* dst) {
  constexpr int N = Elem<T>::kVec;
  constexpr int kChunks = DP / N;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c0 = (i % kChunks) * N;
    const int row = r0 + r;
    float vals[N];
    load_chunk<T>(row < nrows ? base + row * row_stride : nullptr, c0, d,
                  vec, vals);
    float4* out = reinterpret_cast<float4*>(dst + r * DP + c0);
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      out[e / 4] = make_float4(vals[e], vals[e + 1], vals[e + 2],
                               vals[e + 3]);
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Floats of Kt [DP][64], which P [64][kPStride] shares.
template <int DP>
__host__ __device__ constexpr int kt_floats() {
  return DP * kBlockK > kBlockQ * kPStride ? DP * kBlockK
                                           : kBlockQ * kPStride;
}

template <int DP, int DV>
__host__ __device__ constexpr int smem_floats() {
  // Qt [DP][64], Kt [DP][64] shared with P [64][kPStride], V [64][DV].
  return DP * kBlockQ + kt_floats<DP>() + kBlockK * DV;
}

// Grid: x = batch * head, y = query block (the heaviest causal blocks, the
// last rows, are issued first).  Thread t owns rows 4 * (t / 16) + i and,
// of each key tile, keys 4 * (t % 16) + j; of the output, columns
// 4 * (t % 16) + 64 * u + e.  DP pads d, DV pads dv.
template <typename T, int DP, int DV>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(const Args a) {
  static_assert(DP % 64 == 0 && DV % 64 == 0, "DP, DV multiples of 64");
  constexpr int kColGroups = DV / 64;   // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;
  float* Kt = Qt + DP * kBlockQ;
  float* Ps = Kt;
  float* Vs = Kt + kt_floats<DP>();

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int delta = a.Sk - a.Sq;
  const bool vec = a.vec != 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int tq = threadIdx.x / 16;
  const int tk = threadIdx.x % 16;

  // Visible keys of this block's rows: skip the tiles that are fully masked.
  const int q_last = min(q0 + kBlockQ, a.Sq) - 1;
  int k_begin = 0;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + delta + 1);
  if (a.window > 0) k_begin = max(0, q0 + delta - a.window + 1);

  load_tile_t<T, DP>(qb, a.q_ss, q0, a.Sq, a.d, vec, Qt);

  float acc[4][4 * kColGroups];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kColGroups; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the last tile's P and V are read; Q is written
    load_tile_t<T, DP>(kb, a.k_ss, k0, a.Sk, a.d, vec, Kt);
    load_tile<T, DV>(vb, a.v_ss, k0, a.Sk, a.dv, vec, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 16
    for (int c = 0; c < DP; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + c * 64 + 4 * tq);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + c * 64 + 4 * tk);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * tq + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tk + j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && kpos <= qpos + delta;
        if (a.window > 0) ok = ok && kpos > qpos + delta - a.window;
        s[i][j] = ok ? x : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mc));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum16(psum);
#pragma unroll
      for (int c = 0; c < 4 * kColGroups; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();   // every thread is done reading Kt before P lands
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(Ps + (4 * tq + i) * kPStride + 4 * tk) =
          make_float4(Elem<T>::round(s[i][0]), Elem<T>::round(s[i][1]),
                      Elem<T>::round(s[i][2]), Elem<T>::round(s[i][3]));
    }
    __syncthreads();

#pragma unroll 2
    for (int j0 = 0; j0 < kBlockK; j0 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (4 * tq + i) * kPStride + j0);
        p[i][0] = pv.x; p[i][1] = pv.y; p[i][2] = pv.z; p[i][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j0 + jj) * DV + 4 * tk;
#pragma unroll
        for (int u = 0; u < kColGroups; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * u + 0] = fmaf(p[i][jj], vv.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(p[i][jj], vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(p[i][jj], vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(p[i][jj], vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tq + i;
    if (row >= a.Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = ob + row * a.o_ss;
#pragma unroll
    for (int u = 0; u < kColGroups; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tk + 64 * u + e;
        if (col < a.dv) orow[col] = Elem<T>::store(acc[i][4 * u + e] / denom);
      }
    }
  }
}

template <typename T, int DP, int DV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem =
      smem_floats<DP, DV>() * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DP, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(a.B * a.H, (a.Sq + kBlockQ - 1) / kBlockQ);
  flash_kernel<T, DP, DV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance that takes (d, dv): (64, 64) when both fit, else (128, 128)
// when d does, else (192, 128).
template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.d <= 64 && a.dv <= 64) return launch<T, 64, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128, 128>(a, stream);
  return launch<T, 192, 128>(a, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o all of it).  strides: 12
// element strides, (batch, head, seq) of q, k, v and o in turn.  d is the
// head dim of q and k (at most 192), dv that of v and o (at most 128).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int K, int Sq, int Sk, int d, int dv,
                                     float scale, float softcap, int causal,
                                     int window, int vec, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0 ||
      d <= 0 || d > 192 || dv <= 0 || dv > 128 ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  Args a{q, k, v, o,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11],
         B, H, K, Sq, Sk, d, dv, scale, softcap, causal, window, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(a, s) : dispatch<__nv_bfloat16>(a, s);
}
