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
// [BH, S] f32. The reference's grids become one block per (query tile, bh)
// for flash_fwd and flash_dq and one per (key tile, bh) for flash_dkv, each
// with a loop over the other side's tiles in place of the TPU's sequential
// last grid dimension. Each block owns its output rows -- O and lse rows in
// flash_fwd, dQ rows in flash_dq, dK/dV rows in flash_dkv -- so there are
// no float atomics and results are the same run to run.
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
// (0.28 / 0.42 / 0.56 ms at 989 TFLOP/s), not by the bytes. At D = 64 the
// forward also does one exponential per score, and the special-function
// units (16 a clock per SM) need about as long for them as the tensor
// cores need for the two products: the softmax has to run beside the
// products, not between them.
//
// What the design does about it:
//   * bf16 operands whose rows TMA can address (D a multiple of 8 up to
//     128) -- the main path -- run all three kernels on wgmma fed by TMA
//     (the section "bf16 on Hopper" below, helpers in hopper.cuh). A
//     producer keeps the other side's tiles in flight through a 3-stage
//     shared-memory ring with mbarriers: K/V for flash_fwd and flash_dq,
//     whose blocks own query rows; Q/dO/lse/delta for flash_dkv, whose
//     blocks own key rows. Consumer warpgroups keep every accumulator in
//     registers, run the softmax (P, dS) in the accumulator's own row
//     layout (two rows a thread, quad shuffles), and feed P and dS to the
//     next product from registers. flash_fwd issues S_{j+1} = Q.K_{j+1}^T
//     before O += P_j.V_j, and flash_dq issues S_{j+1} and dP_{j+1} before
//     dQ += dS_j.K_j, so the exponentials of one tile run beside the
//     products of the next; both schedule the longest causal query tiles
//     first. Masks are applied only on tiles that cross the diagonal or the
//     end of S; tiles above the diagonal are skipped.
//   * f32 operands, and bf16 operands whose rows TMA cannot address (D not
//     a multiple of 8, or past 128), run on WMMA 16x16x16 fragments (bf16)
//     or CUDA cores (f32), 4 warps a block each owning 16 rows of the
//     block's 64, the forward's O accumulator, running max and denominator
//     in shared memory (WMMA has no documented row layout), tiles loaded
//     and waited for in turn. They take any D: past 128, a grid axis over
//     128-column chunks of D (the note above flash_fwd_kernel).
//     dispatch() chooses by dtype and shape before launch, and each entry
//     reports which kernel it took.
//   * BH is folded into gridDim.x with the row tiles, so it has no 65535
//     limit (the reference's grid puts B*H on its first axis).
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() after its launch. Kernels run on the caller's stream
// and allocate nothing. dtype codes: 0 = float32, 1 = bfloat16; an output
// dtype may be float32 for bf16 operands (the ring's per-step blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Rows row0.. row0+63, columns 0..ncols-1 of a matrix of S rows `stride`
// elements apart into dst[64][ld] (zeros past row S and in columns
// ncols..DP).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0,
                                          int S, int stride, int ncols, bool vec) {
  constexpr int ld = Ld<T, DP>::v;
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < kTile * (DP / V); e += kThreads) {
      const int r = e / (DP / V);
      const int c = (e % (DP / V)) * V;
      const int row = row0 + r;
      if (row < S && c < ncols) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * stride + c);
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
      dst[r * ld + c] = (row < S && c < ncols) ? src[(size_t)row * stride + c] : from_f<T>(0.f);
    }
  }
}

// ---- a warp's products ------------------------------------------------------
// nt: C[16][64] (f32, ldc) = A[16][DP] . B[64][DP]^T (+ C if accumulate), A and
// B in shared memory.
// RowAcc: a warp's 16 x DP f32 accumulator with acc += A[16][K] . B[K][DP].

template <typename T, int DP> struct Warp;

template <int DP> struct Warp<bf16, DP> {
  static __device__ __forceinline__ void nt(const bf16* A, int lda, const bf16* B, int ldb,
                                            float* C, int ldc, bool accumulate) {
#pragma unroll
    for (int n = 0; n < kTile; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        wmma::load_matrix_sync(c, C + n, ldc, wmma::mem_row_major);
      else
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
    // dst rows row0..row0+15, columns 0..ncols-1 of an output whose rows
    // are `stride` apart, times scale, through a per-warp 16x16 staging tile.
    template <typename TO>
    __device__ __forceinline__ void write(TO* dst, int row0, int S, int stride, int ncols,
                                          float scale, float* stage) const {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::store_matrix_sync(stage, f[j], kLdStage, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = j * 16 + e % 16;
          if (row0 + r < S && c < ncols)
            dst[(size_t)(row0 + r) * stride + c] = from_f<TO>(stage[(e / 16) * kLdStage + e % 16] * scale);
        }
        __syncwarp();
      }
    }
  };
};

template <int DP> struct Warp<float, DP> {
  static __device__ __forceinline__ void nt(const float* A, int lda, const float* B, int ldb,
                                            float* C, int ldc, bool accumulate) {
    const int lane = threadIdx.x % 32;
#pragma unroll 1
    for (int r = 0; r < kWarpRows; ++r) {
      float s0 = accumulate ? C[r * ldc + lane] : 0.f;
      float s1 = accumulate ? C[r * ldc + lane + 32] : 0.f;
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
    __device__ __forceinline__ void write(TO* dst, int row0, int S, int stride, int ncols,
                                          float scale, float*) const {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int j = 0; j < DP / 32; ++j) {
          const int c = lane + 32 * j;
          if (row0 + r < S && c < ncols)
            dst[(size_t)(row0 + r) * stride + c] = from_f<TO>(a[r][j] * scale);
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

// Grid of the kernels below: x = bh * tiles + tile (no 65535 limit on
// BH), y = the block's 128-column chunk of D when D > 128 (kChunked).
// A chunked block forms S = Q.K^T (and dP = dO.V^T) over the whole of D,
// walking the chunks through its shared tiles, and writes only its own
// columns of O, dQ, dK, dV. S, and so the softmax's max, sum and lse, come
// out identical in every chunk's block (the same products in the same
// order); lse is written by chunk 0. The score products repeat once per
// chunk: exact, and meant for shapes no main path runs.
struct Chunk {
  int c0, ncols, n;  // first column, columns of this block's chunk, chunks of D
};
template <int DP, bool kChunked>
__device__ __forceinline__ Chunk chunk_of(int D) {
  if constexpr (!kChunked) return Chunk{0, D, 1};
  const int c0 = blockIdx.y * DP;
  return Chunk{c0, min(DP, D - c0), (D + DP - 1) / DP};
}

// ---- flash_fwd ----------------------------------------------------------------
template <typename T, int DP, typename TO, bool kChunked>
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

  const int n_kt = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_kt;
  const int q0 = (blockIdx.x % n_kt) * kTile;
  const Chunk ch = chunk_of<DP, kChunked>(D);
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * kWarpRows;

  if (!kChunked) load_tile<T, DP>(Qs, q + base, q0, S, D, D, vec);
  for (int e = threadIdx.x; e < kTile * ldo; e += kThreads) Os[e] = 0.f;
  if (threadIdx.x < kTile) { m_s[threadIdx.x] = kNegInf; l_s[threadIdx.x] = 0.f; }

  const int last_kt = causal ? min(n_kt - 1, min(q0 + kTile - 1, S - 1) / kTile) : n_kt - 1;
  typename W::RowAcc acc;
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    if constexpr (!kChunked) {
      load_tile<T, DP>(Ks, k + base, k0, S, D, D, vec);
      load_tile<T, DP>(Vs, v + base, k0, S, D, D, vec);
      __syncthreads();
      W::nt(Qs + wr * ld, ld, Ks, ld, Ss + wr * kLdS, kLdS, false);
    } else {
      for (int j = 0; j < ch.n; ++j) {
        if (j) __syncthreads();
        load_tile<T, DP>(Qs, q + base + j * DP, q0, S, D, D - j * DP, vec);
        load_tile<T, DP>(Ks, k + base + j * DP, k0, S, D, D - j * DP, vec);
        __syncthreads();
        W::nt(Qs + wr * ld, ld, Ks, ld, Ss + wr * kLdS, kLdS, j > 0);
      }
      load_tile<T, DP>(Vs, v + base + ch.c0, k0, S, D, ch.ncols, vec);
      __syncthreads();
    }
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
    for (int c = lane; c < ch.ncols; c += 32)
      o[base + (size_t)qpos * D + ch.c0 + c] = from_f<TO>(Os[row * ldo + c] / l);
    if (lane == 0 && ch.c0 == 0) lse[(size_t)bh * S + qpos] = m_s[row] + logf(l);
  }
}

// ---- flash_dq -----------------------------------------------------------------
template <typename T, int DP, typename TO, bool kChunked>
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

  const int n_kt = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_kt;
  const int q0 = (blockIdx.x % n_kt) * kTile;
  const Chunk ch = chunk_of<DP, kChunked>(D);
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * kWarpRows;

  if (!kChunked) {
    load_tile<T, DP>(Qs, q + base, q0, S, D, D, vec);
    load_tile<T, DP>(dOs, dout + base, q0, S, D, D, vec);
  }
  if (threadIdx.x < kTile) {
    const int qpos = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
    dd_s[threadIdx.x] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;
  }

  const int last_kt = causal ? min(n_kt - 1, min(q0 + kTile - 1, S - 1) / kTile) : n_kt - 1;
  typename W::RowAcc acc;
  acc.zero();
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    if constexpr (!kChunked) {
      load_tile<T, DP>(Ks, k + base, k0, S, D, D, vec);
      load_tile<T, DP>(Vs, v + base, k0, S, D, D, vec);
      __syncthreads();
      W::nt(Qs + wr * ld, ld, Ks, ld, Ss + wr * kLdS, kLdS, false);
      W::nt(dOs + wr * ld, ld, Vs, ld, dPs + wr * kLdS, kLdS, false);
    } else {
      for (int j = 0; j < ch.n; ++j) {
        if (j) __syncthreads();
        const int off = j * DP, cols = D - j * DP;
        load_tile<T, DP>(Qs, q + base + off, q0, S, D, cols, vec);
        load_tile<T, DP>(dOs, dout + base + off, q0, S, D, cols, vec);
        load_tile<T, DP>(Ks, k + base + off, k0, S, D, cols, vec);
        load_tile<T, DP>(Vs, v + base + off, k0, S, D, cols, vec);
        __syncthreads();
        W::nt(Qs + wr * ld, ld, Ks, ld, Ss + wr * kLdS, kLdS, j > 0);
        W::nt(dOs + wr * ld, ld, Vs, ld, dPs + wr * kLdS, kLdS, j > 0);
      }
      __syncthreads();
      load_tile<T, DP>(Ks, k + base + ch.c0, k0, S, D, ch.ncols, vec);
      __syncthreads();
    }
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
  acc.write(dq + base + ch.c0, q0 + wr, S, D, ch.ncols, scale, stage + warp * 16 * kLdStage);
}

// ---- flash_dkv ----------------------------------------------------------------
template <typename T, int DP, typename TO, bool kChunked>
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

  const int n_qt = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_qt;
  const int k0 = (blockIdx.x % n_qt) * kTile;
  const Chunk ch = chunk_of<DP, kChunked>(D);
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * kWarpRows;

  if (!kChunked) {
    load_tile<T, DP>(Ks, k + base, k0, S, D, D, vec);
    load_tile<T, DP>(Vs, v + base, k0, S, D, D, vec);
  }

  const int first_qt = causal ? k0 / kTile : 0;
  typename W::RowAcc dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int qpos = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
      dd_s[threadIdx.x] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;
    }
    if constexpr (!kChunked) {
      load_tile<T, DP>(Qs, q + base, q0, S, D, D, vec);
      load_tile<T, DP>(dOs, dout + base, q0, S, D, D, vec);
      __syncthreads();
      W::nt(Ks + wr * ld, ld, Qs, ld, St + wr * kLdS, kLdS, false);
      W::nt(Vs + wr * ld, ld, dOs, ld, dPt + wr * kLdS, kLdS, false);
    } else {
      for (int j = 0; j < ch.n; ++j) {
        if (j) __syncthreads();
        const int off = j * DP, cols = D - j * DP;
        load_tile<T, DP>(Ks, k + base + off, k0, S, D, cols, vec);
        load_tile<T, DP>(Vs, v + base + off, k0, S, D, cols, vec);
        load_tile<T, DP>(Qs, q + base + off, q0, S, D, cols, vec);
        load_tile<T, DP>(dOs, dout + base + off, q0, S, D, cols, vec);
        __syncthreads();
        W::nt(Ks + wr * ld, ld, Qs, ld, St + wr * kLdS, kLdS, j > 0);
        W::nt(Vs + wr * ld, ld, dOs, ld, dPt + wr * kLdS, kLdS, j > 0);
      }
      __syncthreads();
      load_tile<T, DP>(Qs, q + base + ch.c0, q0, S, D, ch.ncols, vec);
      load_tile<T, DP>(dOs, dout + base + ch.c0, q0, S, D, ch.ncols, vec);
      __syncthreads();
    }
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
  dk_acc.write(dk + base + ch.c0, k0 + wr, S, D, ch.ncols, scale, st);
  dv_acc.write(dv + base + ch.c0, k0 + wr, S, D, ch.ncols, 1.f, st);
}

// ---- bf16 on Hopper: wgmma fed by a TMA ring ---------------------------------------
// flash_fwd, flash_dq and flash_dkv for bf16 operands whose rows TMA can
// address (D a multiple of 8, 16-byte aligned bases); D pads to DP = 64 or
// 128 (TMA fills the columns past D with zeros). A block is consumer
// warpgroups of 64 rows each plus a producer. The producer's lane 0 issues
// every TMA load: the block's own tiles once, and the other side's tiles through a
// ring of kStages shared-memory stages, each with a "full" mbarrier (the
// TMA bytes landed) and an "empty" one (every consumer warp is done with
// it). Consumers run the products as wgmma with f32 accumulators in
// registers and do the softmax arithmetic in the accumulator's row layout
// (hopper.cuh): a thread holds two rows, so a row reduction is two shuffles
// within a quad. Products whose A operand is P or dS take it from
// registers, rounded to bf16 (_lowp); nothing f32 goes to shared memory.

namespace hp = hopper;

constexpr int kFwdKeys = 64;  // key rows per ring stage of the forward (flash_kernel.KEY_TILE)
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of a bf16 tile of `rows` rows x DP columns: DP / 64 swizzled halves.
template <int DP> __host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return (uint32_t)(DP / 64) * rows * 128;
}

__device__ __forceinline__ char* align1024(char* p) {
  const uint32_t a = hp::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64n(16 KS) accumulator rounded to bf16 as the A operand of KS k-steps.
template <int KS>
__device__ __forceinline__ void to_a_operand(const float (&c)[8 * KS], uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
}

// acc[64 x N] = A[64 x DP] . B[N x DP]^T, A and B K-major tiles whose
// 64-column halves lie a_half / b_half bytes apart.
template <int DP, int R>
__device__ __forceinline__ void gemm_nt(float (&acc)[R], const char* a, uint32_t a_half,
                                        const char* b, uint32_t b_half) {
  const uint64_t da = hp::desc_sw128(a, 16, 1024), db = hp::desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    hp::wgmma_ss(acc, da + (((kk / 4) * a_half + (kk % 4) * 32) >> 4),
                 db + (((kk / 4) * b_half + (kk % 4) * 32) >> 4), kk > 0);
}

// acc[64 x DP] += P[64 x 16 KS] . B[16 KS x DP], P in registers, B a
// row-major (MN-major) tile whose halves lie b_half bytes apart.
template <int KS, int R>
__device__ __forceinline__ void gemm_pv(float (&acc)[R], const uint32_t (&p)[KS][4],
                                        const char* b, uint32_t b_half) {
  const uint64_t db = hp::desc_sw128(b, b_half, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) hp::wgmma_rs(acc, p[kk], db + ((kk * 16 * 128) >> 4), 1);
}

template <typename TO> __device__ __forceinline__ void store2(TO* p, float a, float b);
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows row and row + 8 of a [S, D] output from an m64nDP accumulator,
// times scale0 and scale1.
template <int DP, typename TO>
__device__ __forceinline__ void store_rows(TO* dst, const float (&acc)[DP / 2], int row, int S,
                                           int D, float scale0, float scale1) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const float sc = h ? scale1 : scale0;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < D)
        store2(dst + (size_t)r * D + c, acc[4 * j + 2 * h] * sc, acc[4 * j + 2 * h + 1] * sc);
    }
  }
}

// One online-softmax step on a score tile in registers (raw Q.K^T sums of
// this thread's rows row, row + 8 against keys k0..k0 + kN): masks it where
// it crosses the diagonal or the end of S, moves the running max m (raw
// units) and the per-thread partial denominators l, and leaves
// P = exp(scale (s - m)) in s. corr receives each row's rescale of the
// earlier sums.
template <int kN>
__device__ __forceinline__ void softmax_tile(float (&s)[kN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int row, int r0, int S,
                                             bool causal, float scale_log2) {
  const int col = 2 * (threadIdx.x % 4);
  if ((causal && k0 + kN - 1 > r0) || k0 + kN > S) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + col + (i % 2), r = row + 8 * ((i / 2) % 2);
      if (key >= S || (causal && key > r)) s[i] = -CUDART_INF_F;
    }
  }
  float mx[2] = {m[0], m[1]}, nb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = hp::exp2_fast((m[h] - mx[h]) * scale_log2);
    m[h] = mx[h];
    nb[h] = -mx[h] * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    s[i] = hp::exp2_fast(fmaf(s[i], scale_log2, nb[(i / 2) % 2]));
    rs[(i / 2) % 2] += s[i];
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

template <int DP, int WG> struct FwdSmem {
  static constexpr int kStages = 3;
  static constexpr uint32_t q = tile_bytes<DP>(64 * WG), kv = tile_bytes<DP>(kFwdKeys);
  static constexpr size_t bytes = 1024 + q + 2 * kStages * kv + (1 + 2 * kStages) * 8;
};

// Block: FwdWG<DP> consumer warpgroups (64 query rows each), then one
// producer warp; one block per SM, no setmaxnreg. At D = 64 three
// warpgroups fit the 416-thread block's registers without spilling (two
// blocks of two warpgroups spill, and ran slower on the H100); at D = 128
// three spill, so two.
template <int DP> constexpr int FwdWG = DP == 64 ? 3 : 2;

template <int DP, typename TO>
__global__ void __launch_bounds__(FwdWG<DP> * 128 + 32, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, TO* __restrict__ o,
                float* __restrict__ lse, int S, int D, int causal, float scale) {
  constexpr int kWG = FwdWG<DP>, kRows = 64 * kWG;
  using L = FwdSmem<DP, kWG>;
  constexpr int kN = kFwdKeys, kStages = L::kStages;
  extern __shared__ char smem_raw[];
  char* Qs = align1024(smem_raw);
  char* Ks = Qs + L::q;
  char* Vs = Ks + kStages * L::kv;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * L::kv);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (S + kRows - 1) / kRows;  // grid x: bh * n_qt + query tile
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kRows;  // longest causal rows first
  const int n_kt = (S + kN - 1) / kN;
  const int n_tiles = causal ? min(n_kt, (min(q0 + kRows, S) - 1) / kN + 1) : n_kt;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, kWG * 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // provably warp-uniform
  const int lane = threadIdx.x % 32;
  if (wg == kWG) {  // producer warp: lane 0 issues every load
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(q_full, L::q);
      for (int h = 0; h < DP / 64; ++h)
        hp::tma_load_3d(Qs + h * kRows * 128, &map_q, q_full, 64 * h, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        hp::mbar_wait(empty + s, ((j / kStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(full + s, 2 * L::kv);
        for (int h = 0; h < DP / 64; ++h) {
          hp::tma_load_3d(Ks + s * L::kv + h * kN * 128, &map_k, full + s, 64 * h, j * kN, bh);
          hp::tma_load_3d(Vs + s * L::kv + h * kN * 128, &map_v, full + s, 64 * h, j * kN, bh);
        }
      }
    }
  } else {
    const int warp = (threadIdx.x % 128) / 32;
    const int r0 = q0 + 64 * wg;                // the warpgroup's first query row
    const int row = r0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
    // Key tiles 0..last have keys this warpgroup's rows see; the block's
    // later tiles (causal) are only waited for and released.
    const int last = r0 >= S ? -1 : causal ? min(n_kt - 1, min(r0 + 63, S - 1) / kN) : n_kt - 1;
    const char* Qw = Qs + 64 * wg * 128;
    const float scale_log2 = scale * kLog2e;

    float acc[DP / 2], sc[kN / 2], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t pa[kN / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    hp::mbar_wait(q_full, 0);

    // Software pipeline within the warpgroup: while O += P_j.V_j runs on
    // the tensor cores, the softmax of S_{j+1} = Q.K_{j+1}^T (issued
    // before it) runs on the other units.
    if (last >= 0) {
      hp::mbar_wait(full, 0);
      __syncwarp();  // wgmma is .aligned: the warp converged after the spin
      hp::wgmma_fence();
      gemm_nt<DP>(sc, Qw, kRows * 128, Ks, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(sc);
      softmax_tile<kN>(sc, m, l, corr, 0, row, r0, S, causal, scale_log2);
      to_a_operand(sc, pa);  // _lowp(v): P rounds to bf16 here
    }
    // Tiles 0..last-1: issue S_{j+1}, then O += P_j.V_j; softmax S_{j+1}
    // once it has landed, while the second product runs.
    for (int j = 0; j < last; ++j) {
      const int s = j % kStages, sn = (j + 1) % kStages;
      hp::mbar_wait(full + sn, ((j + 1) / kStages) & 1);
      __syncwarp();
      hp::fence_regs(acc);
      hp::wgmma_fence();
      gemm_nt<DP>(sc, Qw, kRows * 128, Ks + sn * L::kv, kN * 128);
      hp::wgmma_commit();
      gemm_pv(acc, pa, Vs + s * L::kv, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
      softmax_tile<kN>(sc, m, l, corr, (j + 1) * kN, row, r0, S, causal, scale_log2);
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      to_a_operand(sc, pa);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);
    }
    if (last >= 0) {  // the last tile: O += P.V alone
      hp::fence_regs(acc);
      hp::wgmma_fence();
      gemm_pv(acc, pa, Vs + (last % kStages) * L::kv, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + last % kStages);
    }
    for (int j = last + 1; j < n_tiles; ++j) {  // tiles this warpgroup's rows do not see
      hp::mbar_wait(full + j % kStages, (j / kStages) & 1);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + j % kStages);
    }

    if (last >= 0) {  // finalize (flash_kernel.py:100-109)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = fmaxf(l[h], 1e-30f);
      }
      store_rows<DP>(o + (size_t)bh * S * D, acc, row, S, D, 1.f / l[0], 1.f / l[1]);
      if (lane % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row + 8 * h < S) lse[(size_t)bh * S + row + 8 * h] = m[h] * scale + logf(l[h]);
      }
    }
  }
}

// P^T and dS^T in place of a tile's S^T and dP^T (key rows row, row + 8
// against queries q0..q0 + kN): P^T = exp(scale S^T - lse[q]) with lse in
// log2 units, masked only where the tile crosses the diagonal or the end of
// S; dS^T = P^T (dP^T - delta[q]).
template <int kN>
__device__ __forceinline__ void dkv_grads(float (&st)[kN / 2], float (&dpt)[kN / 2],
                                          const float* ls, const float* dd, int q0, int row,
                                          int kr0, int S, bool causal, float scale_log2) {
  const int col = 2 * (threadIdx.x % 4);
  const bool edge = (causal && q0 < kr0 + 63) || q0 + kN > S;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int c = 8 * (i / 4) + col + (i % 2), q = q0 + c, r = row + 8 * ((i / 2) % 2);
    float p = hp::exp2_fast(fmaf(st[i], scale_log2, -ls[c]));
    if (edge && (q >= S || (causal && q < r))) p = 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - dd[c]);
  }
}

constexpr int kDkvWG = 2;  // consumer warpgroups of flash_dkv: 128 key rows a block

template <int DP> struct DkvSmem {
  static constexpr int kStages = 3;
  static constexpr int kN = DP == 128 ? 32 : 64;  // query rows per ring stage
  static constexpr uint32_t kv = tile_bytes<DP>(64 * kDkvWG), q = tile_bytes<DP>(kN);
  static constexpr size_t bytes =
      1024 + 2 * kv + 2 * kStages * q + 2 * kStages * kN * sizeof(float) + (1 + 2 * kStages) * 8;
};

// Block: kDkvWG consumer warpgroups (64 key rows each), then a producer
// warpgroup of which one warp works; one block per SM. A 384-thread block
// gets 168 registers a thread at launch; four accumulators (dK, dV, S^T,
// dP^T) press on that, so the producer gives its registers up
// (setmaxnreg) and the consumers may take kConsumerRegs. At D = 64 nothing
// spills (ptxas, as chip_smoke.py prints it).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
template <int DP, typename TO>
__global__ void __launch_bounds__((kDkvWG + 1) * 128, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                TO* __restrict__ dk, TO* __restrict__ dv, int S, int D, int causal, float scale) {
  using L = DkvSmem<DP>;
  constexpr int kWG = kDkvWG, kRows = 64 * kWG, kN = L::kN, kStages = L::kStages;
  extern __shared__ char smem_raw[];
  char* Ks = align1024(smem_raw);
  char* Vs = Ks + L::kv;
  char* Qs = Vs + L::kv;
  char* dOs = Qs + kStages * L::q;
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * L::q);  // [kStages][kN]
  float* dd_s = lse_s + kStages * kN;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dd_s + kStages * kN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int n_kt = (S + kRows - 1) / kRows;  // grid x: bh * n_kt + key block
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kRows;  // causal: the first key blocks see the most queries
  const int first = causal ? k0 / kN : 0;
  const int n_tiles = (S + kN - 1) / kN - first;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, kWG * 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // provably warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  if (wg == kWG) {  // producer: TMA from one lane, lse / delta rows from its warp
    hp::regs_dec<kProducerRegs>();
    if (warp == 0) {
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(kv_full, 2 * L::kv);
        for (int h = 0; h < DP / 64; ++h) {
          hp::tma_load_3d(Ks + h * kRows * 128, &map_k, kv_full, 64 * h, k0, bh);
          hp::tma_load_3d(Vs + h * kRows * 128, &map_v, kv_full, 64 * h, k0, bh);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, q0 = (first + t) * kN;
        hp::mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        for (int i = lane; i < kN; i += 32) {
          const int q = q0 + i;
          lse_s[s * kN + i] = q < S ? lse[(size_t)bh * S + q] * kLog2e : 0.f;
          dd_s[s * kN + i] = q < S ? delta[(size_t)bh * S + q] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(full + s, 2 * L::q);
          for (int h = 0; h < DP / 64; ++h) {
            hp::tma_load_3d(Qs + s * L::q + h * kN * 128, &map_q, full + s, 64 * h, q0, bh);
            hp::tma_load_3d(dOs + s * L::q + h * kN * 128, &map_do, full + s, 64 * h, q0, bh);
          }
        }
      }
    }
  } else {
    hp::regs_inc<kConsumerRegs>();
    const int kr0 = k0 + 64 * wg;                // the warpgroup's first key row
    const int row = kr0 + 16 * warp + lane / 4;  // this thread's key rows: row, row + 8
    const bool active = kr0 < S;
    const char* Kw = Ks + 64 * wg * 128;
    const char* Vw = Vs + 64 * wg * 128;
    const float scale_log2 = scale * kLog2e;

    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hp::mbar_wait(kv_full, 0);

    // Causal: this warpgroup's keys see no query of the block's first tiles.
    const int t0 = !active ? n_tiles : causal ? kr0 / kN - first : 0;
    for (int t = 0; t < t0; ++t) {
      hp::mbar_wait(full + t % kStages, (t / kStages) & 1);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + t % kStages);
    }
    for (int t = t0; t < n_tiles; ++t) {
      const int s = t % kStages;
      float st[kN / 2], dpt[kN / 2];  // S^T, dP^T: key rows x query columns
      uint32_t pa[kN / 16][4], da[kN / 16][4];
      hp::mbar_wait(full + s, (t / kStages) & 1);
      __syncwarp();  // wgmma is .aligned: the warp converged after the spin
      hp::wgmma_fence();
      gemm_nt<DP>(st, Kw, kRows * 128, Qs + s * L::q, kN * 128);
      gemm_nt<DP>(dpt, Vw, kRows * 128, dOs + s * L::q, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(st);
      hp::fence_regs(dpt);
      dkv_grads<kN>(st, dpt, lse_s + s * kN, dd_s + s * kN, (first + t) * kN, row, kr0, S,
                    causal, scale_log2);
      to_a_operand(st, pa);   // _lowp(do): P^T rounds to bf16 here
      to_a_operand(dpt, da);  // _lowp(q)
      hp::fence_regs(dv_acc);
      hp::fence_regs(dk_acc);
      hp::wgmma_fence();
      gemm_pv(dv_acc, pa, dOs + s * L::q, kN * 128);
      gemm_pv(dk_acc, da, Qs + s * L::q, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dv_acc);
      hp::fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);
    }
    if (active) {
      const size_t base = (size_t)bh * S * D;
      store_rows<DP>(dk + base, dk_acc, row, S, D, scale, scale);
      store_rows<DP>(dv + base, dv_acc, row, S, D, 1.f, 1.f);
    }
  }
}

// dS in place of a tile's S (query rows row, row + 8 against keys
// k0..k0 + kN): P = exp(scale S - lse) with lse in log2 units, masked only
// where the tile crosses the diagonal or the end of S; dS = P (dP - delta).
// dkv_grads with rows and columns swapped: lse and delta are this thread's
// two rows', in registers.
template <int kN>
__device__ __forceinline__ void dq_grads(float (&s)[kN / 2], const float (&dp)[kN / 2],
                                         const float (&ls)[2], const float (&dd)[2], int k0,
                                         int row, int r0, int S, bool causal, float scale_log2) {
  const int col = 2 * (threadIdx.x % 4);
  const bool edge = (causal && k0 + kN - 1 > r0) || k0 + kN > S;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int h = (i / 2) % 2, key = k0 + 8 * (i / 4) + col + (i % 2);
    float p = hp::exp2_fast(fmaf(s[i], scale_log2, -ls[h]));
    if (edge && (key >= S || (causal && key > row + 8 * h))) p = 0.f;
    s[i] = p * (dp[i] - dd[h]);
  }
}

// flash_dq's block: kDqWG consumer warpgroups of 64 query rows, then a
// producer warpgroup of which one lane issues every TMA load (the forward's
// 64-key ring stages; the block's own tiles are Q and dO). Per key tile a
// consumer thread keeps four things in registers: the dQ accumulator
// (DP / 2 floats), S and dP (32 each) and dS as the next A operand (16
// words). Three warpgroups (a 512-thread block, 128 registers a thread)
// spilled at D = 64 and ran slower on the H100 than two (384 threads, 168
// registers, no spills; chip_smoke.py prints them). As in flash_dkv, the
// producer gives its registers up (setmaxnreg); ptxas still holds the
// consumers' code to the launch budget of 168, so at D = 128 (a dQ
// accumulator of 64 floats) it spills 40 bytes there.
constexpr int kDqWG = 2;

template <int DP, int WG> struct DqSmem : FwdSmem<DP, WG> {
  static constexpr size_t bytes = FwdSmem<DP, WG>::bytes + FwdSmem<DP, WG>::q;  // + dO
};

template <int DP, typename TO>
__global__ void __launch_bounds__((kDqWG + 1) * 128, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               TO* __restrict__ dq, int S, int D, int causal, float scale) {
  constexpr int kWG = kDqWG, kRows = 64 * kWG;
  using L = DqSmem<DP, kWG>;
  constexpr int kN = kFwdKeys, kStages = L::kStages;
  extern __shared__ char smem_raw[];
  char* Qs = align1024(smem_raw);
  char* dOs = Qs + L::q;
  char* Ks = dOs + L::q;
  char* Vs = Ks + kStages * L::kv;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * L::kv);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (S + kRows - 1) / kRows;  // grid x: bh * n_qt + query tile
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kRows;  // longest causal rows first
  const int n_kt = (S + kN - 1) / kN;
  const int n_tiles = causal ? min(n_kt, (min(q0 + kRows, S) - 1) / kN + 1) : n_kt;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, kWG * 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // provably warp-uniform
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  if (wg == kWG) {  // producer: one lane issues every load
    hp::regs_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      hp::mbar_arrive_expect_tx(q_full, 2 * L::q);
      for (int h = 0; h < DP / 64; ++h) {
        hp::tma_load_3d(Qs + h * kRows * 128, &map_q, q_full, 64 * h, q0, bh);
        hp::tma_load_3d(dOs + h * kRows * 128, &map_do, q_full, 64 * h, q0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        hp::mbar_wait(empty + s, ((j / kStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(full + s, 2 * L::kv);
        for (int h = 0; h < DP / 64; ++h) {
          hp::tma_load_3d(Ks + s * L::kv + h * kN * 128, &map_k, full + s, 64 * h, j * kN, bh);
          hp::tma_load_3d(Vs + s * L::kv + h * kN * 128, &map_v, full + s, 64 * h, j * kN, bh);
        }
      }
    }
  } else {
    hp::regs_inc<kConsumerRegs>();
    const int r0 = q0 + 64 * wg;                // the warpgroup's first query row
    const int row = r0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
    // Key tiles 0..last have keys this warpgroup's rows see; the block's
    // later tiles (causal) are only waited for and released.
    const int last = r0 >= S ? -1 : causal ? min(n_kt - 1, min(r0 + 63, S - 1) / kN) : n_kt - 1;
    const char* Qw = Qs + 64 * wg * 128;
    const char* dOw = dOs + 64 * wg * 128;
    const float scale_log2 = scale * kLog2e;
    float ls[2], dd[2];  // lse (log2 units) and delta of rows row, row + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      ls[h] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
      dd[h] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }

    float acc[DP / 2], sc[kN / 2], dp[kN / 2];
    uint32_t da[kN / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    hp::mbar_wait(q_full, 0);
    // Software pipeline within the warpgroup: while dQ += dS_j.K_j runs on
    // the tensor cores, dS of S_{j+1} = Q.K_{j+1}^T and dP_{j+1} =
    // dO.V_{j+1}^T (issued before it) is formed on the other units.
    if (last >= 0) {
      hp::mbar_wait(full, 0);
      __syncwarp();  // wgmma is .aligned: the warp converged after the spin
      hp::wgmma_fence();
      gemm_nt<DP>(sc, Qw, kRows * 128, Ks, kN * 128);
      gemm_nt<DP>(dp, dOw, kRows * 128, Vs, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(sc);
      hp::fence_regs(dp);
      dq_grads<kN>(sc, dp, ls, dd, 0, row, r0, S, causal, scale_log2);
      to_a_operand(sc, da);  // _lowp(k): dS rounds to bf16 here
    }
    for (int j = 0; j < last; ++j) {
      const int s = j % kStages, sn = (j + 1) % kStages;
      hp::mbar_wait(full + sn, ((j + 1) / kStages) & 1);
      __syncwarp();
      hp::fence_regs(acc);
      hp::wgmma_fence();
      gemm_nt<DP>(sc, Qw, kRows * 128, Ks + sn * L::kv, kN * 128);
      gemm_nt<DP>(dp, dOw, kRows * 128, Vs + sn * L::kv, kN * 128);
      hp::wgmma_commit();
      gemm_pv(acc, da, Ks + s * L::kv, kN * 128);  // K_j read MN-major
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
      hp::fence_regs(dp);
      dq_grads<kN>(sc, dp, ls, dd, (j + 1) * kN, row, r0, S, causal, scale_log2);
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      to_a_operand(sc, da);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);
    }
    if (last >= 0) {  // the last tile: dQ += dS.K alone
      hp::fence_regs(acc);
      hp::wgmma_fence();
      gemm_pv(acc, da, Ks + (last % kStages) * L::kv, kN * 128);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + last % kStages);
    }
    for (int j = last + 1; j < n_tiles; ++j) {  // tiles this warpgroup's rows do not see
      hp::mbar_wait(full + j % kStages, (j / kStages) & 1);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + j % kStages);
    }
    if (last >= 0) store_rows<DP>(dq + (size_t)bh * S * D, acc, row, S, D, scale, scale);
  }
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

template <typename T, int DP, typename TO, bool kChunked>
cudaError_t launch(Which which, const Args& a) {
  const dim3 grid(cdiv(a.S, kTile) * (unsigned)a.BH, kChunked ? cdiv(a.D, DP) : 1);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == kFwd) {
    auto kern = flash_fwd_kernel<T, DP, TO, kChunked>;
    const size_t bytes = Smem<T, DP>::fwd;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kThreads, bytes, a.st>>>(q, k, v, static_cast<TO*>(a.o0),
                                          static_cast<float*>(a.lse_out), a.S, a.D,
                                          a.causal, a.scale, a.vec);
  } else if (which == kDq) {
    auto kern = flash_dq_kernel<T, DP, TO, kChunked>;
    const size_t bytes = Smem<T, DP>::bwd;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<grid, kThreads, bytes, a.st>>>(q, k, v, dout, static_cast<const float*>(a.lse_in),
                                          static_cast<const float*>(a.delta),
                                          static_cast<TO*>(a.o0), a.S, a.D, a.causal,
                                          a.scale, a.vec);
  } else {
    auto kern = flash_dkv_kernel<T, DP, TO, kChunked>;
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
  if (a.D <= 32) return launch<T, 32, TO, false>(which, a);
  if (a.D <= 64) return launch<T, 64, TO, false>(which, a);
  if (a.D <= 128) return launch<T, 128, TO, false>(which, a);
  return launch<T, 128, TO, true>(which, a);
}

// setmaxnreg.inc waits until the block's pool holds the registers it asks
// for: refuse a build whose launch budget (kWG consumer warpgroups and one
// producer warpgroup) could not cover them.
template <typename K>
cudaError_t check_reg_budget(K kernel, int kWG, int producer_regs, int consumer_regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * (kWG + 1) < producer_regs + consumer_regs * kWG)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

template <int DP, typename TO>
cudaError_t launch_wgmma(Which which, const Args& a) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if (which == kFwd) {
    constexpr int kWG = FwdWG<DP>;
    if (!hp::make_bf16_map(&mq, a.q, a.BH, a.S, a.D, 64 * kWG) ||
        !hp::make_bf16_map(&mk, a.k, a.BH, a.S, a.D, kFwdKeys) ||
        !hp::make_bf16_map(&mv, a.v, a.BH, a.S, a.D, kFwdKeys))
      return cudaErrorInvalidValue;
    auto kern = flash_fwd_wgmma<DP, TO>;
    const size_t bytes = FwdSmem<DP, kWG>::bytes;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<cdiv(a.S, 64 * kWG) * (unsigned)a.BH, kWG * 128 + 32, bytes, a.st>>>(
        mq, mk, mv, static_cast<TO*>(a.o0), static_cast<float*>(a.lse_out), a.S, a.D, a.causal,
        a.scale);
  } else if (which == kDq) {
    constexpr int kWG = kDqWG;
    if (!hp::make_bf16_map(&mq, a.q, a.BH, a.S, a.D, 64 * kWG) ||
        !hp::make_bf16_map(&mdo, a.dout, a.BH, a.S, a.D, 64 * kWG) ||
        !hp::make_bf16_map(&mk, a.k, a.BH, a.S, a.D, kFwdKeys) ||
        !hp::make_bf16_map(&mv, a.v, a.BH, a.S, a.D, kFwdKeys))
      return cudaErrorInvalidValue;
    auto kern = flash_dq_wgmma<DP, TO>;
    const size_t bytes = DqSmem<DP, kWG>::bytes;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    if ((err = check_reg_budget(kern, kWG, kProducerRegs, kConsumerRegs)) != cudaSuccess)
      return err;
    kern<<<cdiv(a.S, 64 * kWG) * (unsigned)a.BH, (kWG + 1) * 128, bytes, a.st>>>(
        mq, mk, mv, mdo, static_cast<const float*>(a.lse_in), static_cast<const float*>(a.delta),
        static_cast<TO*>(a.o0), a.S, a.D, a.causal, a.scale);
  } else {
    constexpr int kN = DkvSmem<DP>::kN, kWG = kDkvWG, kRows = 64 * kWG;
    if (!hp::make_bf16_map(&mq, a.q, a.BH, a.S, a.D, kN) ||
        !hp::make_bf16_map(&mdo, a.dout, a.BH, a.S, a.D, kN) ||
        !hp::make_bf16_map(&mk, a.k, a.BH, a.S, a.D, kRows) ||
        !hp::make_bf16_map(&mv, a.v, a.BH, a.S, a.D, kRows))
      return cudaErrorInvalidValue;
    auto kern = flash_dkv_wgmma<DP, TO>;
    const size_t bytes = DkvSmem<DP>::bytes;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    if ((err = check_reg_budget(kern, kWG, kProducerRegs, kConsumerRegs)) != cudaSuccess)
      return err;
    kern<<<cdiv(a.S, kRows) * (unsigned)a.BH, (kWG + 1) * 128, bytes, a.st>>>(
        mq, mk, mv, mdo, static_cast<const float*>(a.lse_in), static_cast<const float*>(a.delta),
        static_cast<TO*>(a.o0), static_cast<TO*>(a.o1), a.S, a.D, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename TO>
cudaError_t wgmma_by_width(Which which, const Args& a) {
  return a.D <= 64 ? launch_wgmma<64, TO>(which, a) : launch_wgmma<128, TO>(which, a);
}

// The kernel is chosen by dtype and shape before launch, never as a
// fallback on failure: bf16 operands whose rows TMA can address (D a
// multiple of 8 up to 128, so rows are 16-byte strided, and 16-byte
// aligned bases) take the wgmma kernels, and *took_wgmma says so once the
// launch is accepted; other bf16 shapes and f32 operands take the WMMA /
// CUDA-core kernels, which take any D (past 128 in 128-column chunks) and
// any BH.
int dispatch(Which which, Args a, int dtype, int out_dtype, int* took_wgmma) {
  *took_wgmma = 0;
  if (a.D < 1 || a.S < 1 || a.BH < 1) return (int)cudaErrorInvalidValue;
  const bool operands16 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
  if (dtype == 1 && a.D % 8 == 0 && a.D <= 128 && operands16) {
    cudaError_t err;
    if (out_dtype == 1)
      err = wgmma_by_width<bf16>(which, a);
    else if (out_dtype == 0)
      err = wgmma_by_width<float>(which, a);
    else
      return (int)cudaErrorInvalidValue;
    *took_wgmma = err == cudaSuccess;
    return (int)err;
  }
  const int V = dtype == 1 ? 8 : 4;  // elements per 16-byte load
  a.vec = (a.D % V == 0) && operands16;
  if (dtype == 0 && out_dtype == 0) return (int)by_width<float, float>(which, a);
  if (dtype == 1 && out_dtype == 1) return (int)by_width<bf16, bf16>(which, a);
  if (dtype == 1 && out_dtype == 0) return (int)by_width<bf16, float>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v [BH, S, D] (dtype) -> o [BH, S, D] (out_dtype), lse [BH, S] f32.
// *took_wgmma: 1 if the launch took the wgmma kernel (the rule of
// dispatch), else 0; the same for the two entries below.
int tpfl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int S, int D, int causal, float scale, int dtype, int out_dtype,
                   void* stream, int* took_wgmma) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, BH, S, D, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, a, dtype, out_dtype, took_wgmma);
}

// q, k, v, dout [BH, S, D] (dtype), lse, delta [BH, S] f32 -> dq (out_dtype).
int tpfl_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int BH, int S, int D,
                  int causal, float scale, int dtype, int out_dtype, void* stream,
                  int* took_wgmma) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, BH, S, D, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, a, dtype, out_dtype, took_wgmma);
}

// As tpfl_flash_dq -> dk, dv (out_dtype).
int tpfl_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                   int D, int causal, float scale, int dtype, int out_dtype, void* stream,
                   int* took_wgmma) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, BH, S, D, causal, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, a, dtype, out_dtype, took_wgmma);
}

}  // extern "C"
