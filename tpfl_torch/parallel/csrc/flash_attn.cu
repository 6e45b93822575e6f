// Flash attention (forward, dQ, dK/dV) for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of tpfl/parallel/flash_kernel.py:
//   flash_fwd <- _fwd_kernel (flash_kernel.py:60): o = softmax(scale.QK^T)V
//                with an online softmax over key tiles, lse = m + log l
//   flash_dq  <- _dq_kernel  (flash_kernel.py:112): P = exp(scale.QK^T - lse),
//                dS = P o (dO.V^T - delta), dQ = scale . dS.K
//   flash_dkv <- _dkv_kernel (flash_kernel.py:149): dV = P^T.dO,
//                dK = scale . dS^T.Q
// Operands are [BH, S, D] row-major (batch x heads folded), lse and delta
// [BH, S] f32. The reference's grids become: one block per (64-row query
// tile, bh) for flash_fwd and flash_dq, and one block per (64-row key tile,
// bh) for flash_dkv, each with a loop over the other side's tiles in place
// of the TPU's sequential last grid dimension. Each block owns its output
// rows -- dQ rows in flash_dq, dK/dV rows in flash_dkv -- so there are no
// float atomics and results are the same run to run.
//
// Semantics kept from the reference (flash_kernel.py:35-191):
//   * operands stay in their dtype, products accumulate in f32; the scale
//     1/sqrt(D) (real D, from the caller) multiplies the f32 scores;
//   * P (and dS) are rounded to the operand dtype before P.V, P^T.dO, dS.K
//     and dS^T.Q when that dtype is bf16 (_lowp);
//   * dQ and dK are scaled on the f32 accumulator at the end;
//   * causal mask q_pos >= k_pos with -1e30, tiles entirely above the
//     diagonal skipped; keys at positions >= S are masked too (the reference
//     pads them and falls back to blockwise for non-causal unaligned S: the
//     values are the same); query rows >= S are never written;
//   * o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// What bounds them on an H100: at the transformer main path (BH = 512,
// S = 2048, D = 64, causal, bf16) each launch does 0.27-0.55 TFLOP against
// 0.5-0.8 GB of operands, so the least time is set by the tensor cores
// (0.28 / 0.42 / 0.56 ms at 989 TFLOP/s), not by the bytes.
//
// What the design does about it (first version: right and simple):
//   * bf16 products run on the tensor cores as WMMA 16x16x16 fragments with
//     f32 accumulators; score tiles never leave shared memory (the point of
//     the TPU kernel, kept here). Every block has 4 warps and each warp owns
//     16 rows of the block's 64 output rows, so the whole per-row pipeline
//     (scores, softmax, P, the product into the row accumulator) is
//     warp-local between the block-wide tile loads.
//   * WMMA accumulators have no documented row layout, so the forward keeps
//     its O accumulator, running max and denominator in shared memory for
//     the per-row rescale; dQ, dK and dV need no rescale and stay in
//     register fragments.
//   * f32 operands (tests, the f32 reference) take the same structure on
//     CUDA cores, each lane owning fixed columns.
//   * Still far from the bound: tiles are loaded, waited for and multiplied
//     in turn, WMMA round-trips the forward's accumulator through shared
//     memory every key tile, and 4 warps per block leave the tensor cores
//     idle between stages. mma.sync register-resident accumulators,
//     cp.async/TMA rings and wgmma are the next steps.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() after its launch. Kernels run on the caller's stream
// and allocate nothing. dtype codes: 0 = float32, 1 = bfloat16; an output
// dtype may be float32 for bf16 operands (the ring's per-step blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // query rows (fwd, dq) or key rows (dkv) per block; the other side's tile
constexpr int kWarpRows = 16;
constexpr float kNegInf = -1e30f;  // flash_kernel.py:35

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Leading dimension of a T tile with DP columns: WMMA wants a multiple of 8
// bf16 (16 bytes); f32 tiles are read by lanes along rows, so an odd pad
// keeps those reads on distinct banks.
template <typename T, int DP> struct Ld { static constexpr int v = DP + (sizeof(T) == 2 ? 8 : 1); };
constexpr int kLdS = kTile + 4;  // f32 score tiles (WMMA stores: multiple of 4)
constexpr int kLdStage = 20;     // per-warp 16x16 f32 staging tile

// Rows row0.. row0+63 of a [S, D] matrix into dst[64][ld] (zeros outside
// the matrix and in columns D..DP).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0,
                                          int S, int D, bool vec) {
  constexpr int ld = Ld<T, DP>::v;
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < kTile * (DP / V); e += kThreads) {
      const int r = e / (DP / V);
      const int c = (e % (DP / V)) * V;
      const int row = row0 + r;
      if (row < S && c < D) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) dst[r * ld + c + i] = vals[i];
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dst[r * ld + c + i] = from_f<T>(0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e % DP;
      const int row = row0 + r;
      dst[r * ld + c] = (row < S && c < D) ? src[(size_t)row * D + c] : from_f<T>(0.f);
    }
  }
}

// ---- a warp's products ------------------------------------------------------
// nt: C[16][64] (f32, ldc) = A[16][DP] . B[64][DP]^T, A and B in shared memory.
// RowAcc: a warp's 16 x DP f32 accumulator with acc += A[16][K] . B[K][DP].

template <typename T, int DP> struct Warp;

template <int DP> struct Warp<bf16, DP> {
  static __device__ __forceinline__ void nt(const bf16* A, int lda, const bf16* B, int ldb,
                                            float* C, int ldc) {
#pragma unroll
    for (int n = 0; n < kTile; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int k = 0; k < DP; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + k, lda);
        wmma::load_matrix_sync(b, B + n * ldb + k, ldb);  // B^T(k, n) = B[n][k]
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n, c, ldc, wmma::mem_row_major);
    }
  }

  struct RowAcc {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[DP / 16];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(f[j], 0.f);
    }
    __device__ __forceinline__ void load(const float* C, int ldc) {
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::load_matrix_sync(f[j], C + j * 16, ldc, wmma::mem_row_major);
    }
    __device__ __forceinline__ void store(float* C, int ldc) const {
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wmma::store_matrix_sync(C + j * 16, f[j], ldc, wmma::mem_row_major);
    }
    __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B, int ldb) {
#pragma unroll
      for (int k = 0; k < kTile; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + k, lda);
#pragma unroll
        for (int j = 0; j < DP / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, B + k * ldb + j * 16, ldb);
          wmma::mma_sync(f[j], a, b, f[j]);
        }
      }
    }
    // dst rows row0..row0+15 of a [S, D] output, times scale, through a
    // per-warp 16x16 staging tile.
    template <typename TO>
    __device__ __forceinline__ void write(TO* dst, int row0, int S, int D, float scale,
                                          float* stage) const {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::store_matrix_sync(stage, f[j], kLdStage, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = j * 16 + e % 16;
          if (row0 + r < S && c < D)
            dst[(size_t)(row0 + r) * D + c] = from_f<TO>(stage[(e / 16) * kLdStage + e % 16] * scale);
        }
        __syncwarp();
      }
    }
  };
};

template <int DP> struct Warp<float, DP> {
  static __device__ __forceinline__ void nt(const float* A, int lda, const float* B, int ldb,
                                            float* C, int ldc) {
    const int lane = threadIdx.x % 32;
#pragma unroll 1
    for (int r = 0; r < kWarpRows; ++r) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int k = 0; k < DP; ++k) {
        const float a = A[r * lda + k];
        s0 += a * B[lane * ldb + k];
        s1 += a * B[(lane + 32) * ldb + k];
      }
      C[r * ldc + lane] = s0;
      C[r * ldc + lane + 32] = s1;
    }
  }

  struct RowAcc {
    float a[kWarpRows][DP / 32];  // lane owns columns lane + 32 j
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int j = 0; j < DP / 32; ++j) a[r][j] = 0.f;
    }
    __device__ __forceinline__ void load(const float* C, int ldc) {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int j = 0; j < DP / 32; ++j) a[r][j] = C[r * ldc + lane + 32 * j];
    }
    __device__ __forceinline__ void store(float* C, int ldc) const {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int j = 0; j < DP / 32; ++j) C[r * ldc + lane + 32 * j] = a[r][j];
    }
    __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb) {
      const int lane = threadIdx.x % 32;
#pragma unroll 2
      for (int k = 0; k < kTile; ++k) {
        float b[DP / 32];
#pragma unroll
        for (int j = 0; j < DP / 32; ++j) b[j] = B[k * ldb + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          const float x = A[r * lda + k];
#pragma unroll
          for (int j = 0; j < DP / 32; ++j) a[r][j] += x * b[j];
        }
      }
    }
    template <typename TO>
    __device__ __forceinline__ void write(TO* dst, int row0, int S, int D, float scale,
                                          float*) const {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int j = 0; j < DP / 32; ++j) {
          const int c = lane + 32 * j;
          if (row0 + r < S && c < D) dst[(size_t)(row0 + r) * D + c] = from_f<TO>(a[r][j] * scale);
        }
    }
  };
};

// ---- shared-memory carve-up ---------------------------------------------------
struct Carve {
  char* p;
  template <typename X> __device__ __forceinline__ X* take(size_t n) {
    X* out = reinterpret_cast<X*>(p);
    p += (n * sizeof(X) + 127) / 128 * 128;
    return out;
  }
};
__host__ __device__ constexpr size_t rup(size_t b) { return (b + 127) / 128 * 128; }

template <typename T, int DP> struct Smem {
  static constexpr int ld = Ld<T, DP>::v;
  static constexpr size_t tileT = rup(sizeof(T) * kTile * ld);
  static constexpr size_t tileP = rup(sizeof(T) * kTile * Ld<T, kTile>::v);
  static constexpr size_t tileS = rup(sizeof(float) * kTile * kLdS);
  static constexpr size_t rows = rup(sizeof(float) * kTile);
  static constexpr size_t stage = rup(sizeof(float) * (kThreads / 32) * 16 * kLdStage);
  // Q, K, V; S; P; O (f32, ld DP + 4); running max m and denominator l.
  static constexpr size_t fwd = 3 * tileT + tileS + tileP + rup(sizeof(float) * kTile * (DP + 4)) + 2 * rows;
  // Q, dO, K, V; S, dP; dS; lse, delta; staging.
  static constexpr size_t bwd = 4 * tileT + 2 * tileS + tileP + 2 * rows + stage;
};

__device__ __forceinline__ bool masked(int qpos, int kpos, int S, bool causal) {
  return kpos >= S || qpos >= S || (causal && qpos < kpos);
}

// ---- flash_fwd ----------------------------------------------------------------
template <typename T, int DP, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 TO* __restrict__ o, float* __restrict__ lse, int S, int D, int causal,
                 float scale, int vec) {
  extern __shared__ __align__(128) char smem[];
  using W = Warp<T, DP>;
  constexpr int ld = Ld<T, DP>::v, ldp = Ld<T, kTile>::v, ldo = DP + 4;
  Carve cv{smem};
  T* Qs = cv.take<T>(kTile * ld);
  T* Ks = cv.take<T>(kTile * ld);
  T* Vs = cv.take<T>(kTile * ld);
  float* Ss = cv.take<float>(kTile * kLdS);
  T* Ps = cv.take<T>(kTile * ldp);
  float* Os = cv.take<float>(kTile * ldo);
  float* m_s = cv.take<float>(kTile);
  float* l_s = cv.take<float>(kTile);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * kWarpRows;

  load_tile<T, DP>(Qs, q + base, q0, S, D, vec);
  for (int e = threadIdx.x; e < kTile * ldo; e += kThreads) Os[e] = 0.f;
  if (threadIdx.x < kTile) { m_s[threadIdx.x] = kNegInf; l_s[threadIdx.x] = 0.f; }

  const int n_kt = (S + kTile - 1) / kTile;
  const int last_kt = causal ? min(n_kt - 1, min(q0 + kTile - 1, S - 1) / kTile) : n_kt - 1;
  typename W::RowAcc acc;
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DP>(Ks, k + base, k0, S, D, vec);
    load_tile<T, DP>(Vs, v + base, k0, S, D, vec);
    __syncthreads();

    W::nt(Qs + wr * ld, ld, Ks, ld, Ss + wr * kLdS, kLdS);
    __syncwarp();
    for (int r = 0; r < kWarpRows; ++r) {
      const int row = wr + r, qpos = q0 + row;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        s[h] = masked(qpos, k0 + c, S, causal) ? kNegInf : Ss[row * kLdS + c] * scale;
      }
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float corr = expf(m_prev - m_new);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = expf(s[h] - m_new);
        psum += p;
        Ps[row * ldp + lane + 32 * h] = from_f<T>(p);  // _lowp(v): bf16 rounds here
      }
      psum = warp_sum(psum);
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + psum;
      }
      for (int c = lane; c < DP; c += 32) Os[row * ldo + c] *= corr;
    }
    __syncwarp();
    acc.load(Os + wr * ldo, ldo);
    acc.mma(Ps + wr * ldp, ldp, Vs, ld);
    acc.store(Os + wr * ldo, ldo);
    __syncwarp();
  }

  // Finalize (flash_kernel.py:100-109): each warp its own rows.
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = wr + r, qpos = q0 + row;
    if (qpos >= S) break;
    const float l = fmaxf(l_s[row], 1e-30f);
    for (int c = lane; c < D; c += 32)
      o[base + (size_t)qpos * D + c] = from_f<TO>(Os[row * ldo + c] / l);
    if (lane == 0) lse[(size_t)bh * S + qpos] = m_s[row] + logf(l);
  }
}

// ---- flash_dq -----------------------------------------------------------------
template <typename T, int DP, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, TO* __restrict__ dq, int S, int D,
                int causal, float scale, int vec) {
  extern __shared__ __align__(128) char smem[];
  using W = Warp<T, DP>;
  constexpr int ld = Ld<T, DP>::v, ldp = Ld<T, kTile>::v;
  Carve cv{smem};
  T* Qs = cv.take<T>(kTile * ld);
  T* dOs = cv.take<T>(kTile * ld);
  T* Ks = cv.take<T>(kTile * ld);
  T* Vs = cv.take<T>(kTile * ld);
  float* Ss = cv.take<float>(kTile * kLdS);
  float* dPs = cv.take<float>(kTile * kLdS);
  T* dSs = cv.take<T>(kTile * ldp);
  float* lse_s = cv.take<float>(kTile);
  float* dd_s = cv.take<float>(kTile);
  float* stage = cv.take<float>((kThreads / 32) * 16 * kLdStage);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * kWarpRows;

  load_tile<T, DP>(Qs, q + base, q0, S, D, vec);
  load_tile<T, DP>(dOs, dout + base, q0, S, D, vec);
  if (threadIdx.x < kTile) {
    const int qpos = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
    dd_s[threadIdx.x] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;
  }

  const int n_kt = (S + kTile - 1) / kTile;
  const int last_kt = causal ? min(n_kt - 1, min(q0 + kTile - 1, S - 1) / kTile) : n_kt - 1;
  typename W::RowAcc acc;
  acc.zero();
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, DP>(Ks, k + base, k0, S, D, vec);
    load_tile<T, DP>(Vs, v + base, k0, S, D, vec);
    __syncthreads();

    W::nt(Qs + wr * ld, ld, Ks, ld, Ss + wr * kLdS, kLdS);
    W::nt(dOs + wr * ld, ld, Vs, ld, dPs + wr * kLdS, kLdS);
    __syncwarp();
    for (int e = lane; e < kWarpRows * kTile; e += 32) {
      const int row = wr + e / kTile, c = e % kTile;
      const int qpos = q0 + row;
      const float p = masked(qpos, k0 + c, S, causal)
                          ? 0.f : expf(Ss[row * kLdS + c] * scale - lse_s[row]);
      const float ds = p * (dPs[row * kLdS + c] - dd_s[row]);
      dSs[row * ldp + c] = from_f<T>(ds);  // _lowp(k)
    }
    __syncwarp();
    acc.mma(dSs + wr * ldp, ldp, Ks, ld);
  }
  acc.write(dq + base, q0 + wr, S, D, scale, stage + warp * 16 * kLdStage);
}

// ---- flash_dkv ----------------------------------------------------------------
template <typename T, int DP, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, TO* __restrict__ dk,
                 TO* __restrict__ dv, int S, int D, int causal, float scale, int vec) {
  extern __shared__ __align__(128) char smem[];
  using W = Warp<T, DP>;
  constexpr int ld = Ld<T, DP>::v, ldp = Ld<T, kTile>::v;
  Carve cv{smem};
  T* Ks = cv.take<T>(kTile * ld);
  T* Vs = cv.take<T>(kTile * ld);
  T* Qs = cv.take<T>(kTile * ld);
  T* dOs = cv.take<T>(kTile * ld);
  float* St = cv.take<float>(kTile * kLdS);   // S^T: key rows x query columns
  float* dPt = cv.take<float>(kTile * kLdS);  // dP^T, then dS^T in place
  T* Pt = cv.take<T>(kTile * ldp);            // P^T, then dS^T, in the operand dtype
  float* lse_s = cv.take<float>(kTile);
  float* dd_s = cv.take<float>(kTile);
  float* stage = cv.take<float>((kThreads / 32) * 16 * kLdStage);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * kWarpRows;

  load_tile<T, DP>(Ks, k + base, k0, S, D, vec);
  load_tile<T, DP>(Vs, v + base, k0, S, D, vec);

  const int n_qt = (S + kTile - 1) / kTile;
  const int first_qt = causal ? k0 / kTile : 0;
  typename W::RowAcc dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, DP>(Qs, q + base, q0, S, D, vec);
    load_tile<T, DP>(dOs, dout + base, q0, S, D, vec);
    if (threadIdx.x < kTile) {
      const int qpos = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
      dd_s[threadIdx.x] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;
    }
    __syncthreads();

    W::nt(Ks + wr * ld, ld, Qs, ld, St + wr * kLdS, kLdS);
    W::nt(Vs + wr * ld, ld, dOs, ld, dPt + wr * kLdS, kLdS);
    __syncwarp();
    for (int e = lane; e < kWarpRows * kTile; e += 32) {
      const int row = wr + e / kTile, c = e % kTile;
      const int kpos = k0 + row;
      const float p = masked(q0 + c, kpos, S, causal)
                          ? 0.f : expf(St[row * kLdS + c] * scale - lse_s[c]);
      Pt[row * ldp + c] = from_f<T>(p);  // _lowp(do)
      dPt[row * kLdS + c] = p * (dPt[row * kLdS + c] - dd_s[c]);
    }
    __syncwarp();
    dv_acc.mma(Pt + wr * ldp, ldp, dOs, ld);
    __syncwarp();
    for (int e = lane; e < kWarpRows * kTile; e += 32) {
      const int row = wr + e / kTile, c = e % kTile;
      Pt[row * ldp + c] = from_f<T>(dPt[row * kLdS + c]);  // _lowp(q)
    }
    __syncwarp();
    dk_acc.mma(Pt + wr * ldp, ldp, Qs, ld);
  }
  float* st = stage + warp * 16 * kLdStage;
  dk_acc.write(dk + base, k0 + wr, S, D, scale, st);
  dv_acc.write(dv + base, k0 + wr, S, D, 1.f, st);
}

// ---- launchers ------------------------------------------------------------------
inline unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o0, *o1, *lse_out;
  int BH, S, D, causal, vec;
  float scale;
  cudaStream_t st;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DP, typename TO>
cudaError_t launch(Which which, const Args& a) {
  const dim3 grid(cdiv(a.S, kTile), (unsigned)a.BH);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == kFwd) {
    auto kern = flash_fwd_kernel<T, DP, TO>;
    const size_t bytes = Smem<T, DP>::fwd;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kThreads, bytes, a.st>>>(q, k, v, static_cast<TO*>(a.o0),
                                          static_cast<float*>(a.lse_out), a.S, a.D,
                                          a.causal, a.scale, a.vec);
  } else if (which == kDq) {
    auto kern = flash_dq_kernel<T, DP, TO>;
    const size_t bytes = Smem<T, DP>::bwd;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kThreads, bytes, a.st>>>(q, k, v, dout, static_cast<const float*>(a.lse_in),
                                          static_cast<const float*>(a.delta),
                                          static_cast<TO*>(a.o0), a.S, a.D, a.causal,
                                          a.scale, a.vec);
  } else {
    auto kern = flash_dkv_kernel<T, DP, TO>;
    const size_t bytes = Smem<T, DP>::bwd;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kThreads, bytes, a.st>>>(q, k, v, dout, static_cast<const float*>(a.lse_in),
                                          static_cast<const float*>(a.delta),
                                          static_cast<TO*>(a.o0), static_cast<TO*>(a.o1),
                                          a.S, a.D, a.causal, a.scale, a.vec);
  }
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t by_width(Which which, const Args& a) {
  if (a.D <= 32) return launch<T, 32, TO>(which, a);
  if (a.D <= 64) return launch<T, 64, TO>(which, a);
  return launch<T, 128, TO>(which, a);
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

int dispatch(Which which, Args a, int dtype, int out_dtype) {
  if (a.D < 1 || a.D > 128 || a.S < 1 || a.BH < 1 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 1 ? 8 : 4;  // elements per 16-byte load
  a.vec = (a.D % V == 0) && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
          aligned16(a.dout);
  if (dtype == 0 && out_dtype == 0) return (int)by_width<float, float>(which, a);
  if (dtype == 1 && out_dtype == 1) return (int)by_width<bf16, bf16>(which, a);
  if (dtype == 1 && out_dtype == 0) return (int)by_width<bf16, float>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v [BH, S, D] (dtype) -> o [BH, S, D] (out_dtype), lse [BH, S] f32.
int tpfl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int S, int D, int causal, float scale, int dtype, int out_dtype,
                   void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, BH, S, D, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, a, dtype, out_dtype);
}

// q, k, v, dout [BH, S, D] (dtype), lse, delta [BH, S] f32 -> dq (out_dtype).
int tpfl_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int BH, int S, int D,
                  int causal, float scale, int dtype, int out_dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, BH, S, D, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, a, dtype, out_dtype);
}

// As tpfl_flash_dq -> dk, dv (out_dtype).
int tpfl_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                   int D, int causal, float scale, int dtype, int out_dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, BH, S, D, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, a, dtype, out_dtype);
}

}  // extern "C"
