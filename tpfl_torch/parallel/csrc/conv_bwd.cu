// Per-node 3x3 SAME / stride-1 convolution backward for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of tpfl/parallel/conv_kernel.py:
//   conv_dw  <- _dw_kernel (conv_kernel.py:82):
//               dW[k*k*Cin, Cout] = im2col(x)^T . dout, f32 accumulated
//   conv_dx  <- _dx_kernel (conv_kernel.py:103):
//               dx[B*H*W, Cin] = im2col(dout) . rot180(w)^T
// Both operate on node-stacked operands [N, B, H, W, C] (NHWC per node) and
// one launch covers all N nodes: the node index is a grid dimension, the
// counterpart of jax.vmap over the Pallas grid.
//
// What bounds them on an H100: at the federation's shapes (N=100, B=128,
// 32x32x3->32 and 16x16x32->64, bf16) each launch moves 0.6-0.9 GB and does
// 23-121 GFLOP, so the least time is set by the bytes (0.19-0.27 ms at
// 3.35 TB/s), not by the tensor cores.
//
// What the design does about it:
//   * Implicit im2col: patch entries are computed on the fly from the NHWC
//     input with bounds checks that produce the zero SAME halo, in the
//     channel order (di*k + dj)*C + ci of conv_kernel.py:68-79. No patch
//     matrix is ever written to device memory -- the point of the TPU
//     kernel, kept here. Each operand is streamed through shared memory
//     once per output tile.
//   * conv_dw reduces over all B*H*W positions. The TPU kernel carried that
//     sum across a sequential grid in a revisited output block; Hopper
//     blocks run in parallel and in no order. Here each block owns one tile
//     of one node's [k*k*Cin, Cout] output and loops over a contiguous range
//     of positions. Where there are too few tiles to fill the card, the
//     position range is split S ways into an f32 scratch
//     [N, S, k*k*Cin, Cout] and a second kernel sums the S partials in a
//     fixed order. No float atomics: results are identical run to run.
//   * Channel counts need no alignment (Conv_0 has Cin = 3): every load is
//     bounds-checked and tiles are zero-filled at the ragged edge.
//   * bf16 operands (the federation's compute type) go through the tensor
//     cores with WMMA 16x16x16 fragments and f32 accumulators; the im2col
//     index arithmetic of a block's fixed side is computed once into shared
//     memory, and the register budget leaves room for 3 resident blocks per
//     SM, which hide each stage's load latency. f32 operands (tests, f32
//     models) take CUDA-core kernels with 8 f32 accumulators per thread.
//   * Still far above the memory bound: each stage loads, waits and
//     multiplies in turn, with scalar 2-byte loads. Overlapping the next
//     stage's loads with this stage's products (cp.async or TMA into a ring
//     of tiles) and wgmma are the next steps.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() after its launches. Kernels run on the caller's stream
// and allocate nothing. dtype: 0 = float32, 1 = bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

constexpr int kThreads = 256;

// ---- conv_dw --------------------------------------------------------------
// Block tile: DW_TK rows of the [k*k*Cin, Cout] output x DW_TC columns,
// reduced over DW_TM positions per shared-memory stage. Thread t owns rows
// (t/16)*2 + {0,1} and columns (t%16)*4 + {0..3}.
constexpr int DW_TK = 32;
constexpr int DW_TC = 64;
constexpr int DW_TM = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
               float* __restrict__ out, int B, int H, int W, int Cin,
               int Cout, int k, int splits, int chunk) {
  __shared__ __align__(16) float Ps[DW_TM][DW_TK];
  __shared__ __align__(16) float Gs[DW_TM][DW_TC];

  const int K2C = k * k * Cin;
  const int HW = H * W;
  const int M = B * HW;
  const int R = k / 2;
  const int r0 = blockIdx.x * DW_TK;
  const int c0 = blockIdx.y * DW_TC;
  const int n = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  const int m_begin = s * chunk;
  const int m_end = min(M, m_begin + chunk);
  const T* xn = x + (size_t)n * M * Cin;
  const T* gn = g + (size_t)n * M * Cout;

  const int t = threadIdx.x;
  const int tr = (t / 16) * 2;
  const int tc = (t % 16) * 4;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int mb = m_begin; mb < m_end; mb += DW_TM) {
    // Patch tile: Ps[mm][rr] = x_pad[pixel(mb+mm) + tap offset, ci].
#pragma unroll
    for (int i = 0; i < (DW_TM * DW_TK) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int mm = e / DW_TK;
      const int rr = e % DW_TK;
      const int m = mb + mm;
      const int kk = r0 + rr;
      float v = 0.f;
      if (m < m_end && kk < K2C) {
        const int tap = kk / Cin;
        const int ci = kk - tap * Cin;
        const int di = tap / k;
        const int dj = tap - di * k;
        const int b = m / HW;
        const int rem = m - b * HW;
        const int ii = rem / W + di - R;
        const int jj = rem % W + dj - R;
        if (ii >= 0 && ii < H && jj >= 0 && jj < W)
          v = to_f(xn[((size_t)(b * H + ii) * W + jj) * Cin + ci]);
      }
      Ps[mm][rr] = v;
    }
    // dout tile: Gs[mm][cc] = g[mb+mm, c0+cc].
#pragma unroll
    for (int i = 0; i < (DW_TM * DW_TC) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int mm = e / DW_TC;
      const int cc = e % DW_TC;
      const int m = mb + mm;
      const int c = c0 + cc;
      Gs[mm][cc] = (m < m_end && c < Cout) ? to_f(gn[(size_t)m * Cout + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < DW_TM; ++mm) {
      const float2 p = *reinterpret_cast<const float2*>(&Ps[mm][tr]);
      const float4 q = *reinterpret_cast<const float4*>(&Gs[mm][tc]);
      acc[0][0] += p.x * q.x; acc[0][1] += p.x * q.y;
      acc[0][2] += p.x * q.z; acc[0][3] += p.x * q.w;
      acc[1][0] += p.y * q.x; acc[1][1] += p.y * q.y;
      acc[1][2] += p.y * q.z; acc[1][3] += p.y * q.w;
    }
    __syncthreads();
  }

  float* dst = out + (size_t)(n * splits + s) * K2C * Cout;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = r0 + tr + a;
    if (row >= K2C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tc + j;
      if (col < Cout) dst[(size_t)row * Cout + col] = acc[a][j];
    }
  }
}

// Fixed-order sum of the S position-split partials: out[n, e] =
// sum_s partial[n, s, e]. Deterministic by construction.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int N, int per_node, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)N * per_node) return;
  const size_t n = idx / per_node;
  const size_t e = idx - n * per_node;
  const float* p = partial + n * splits * (size_t)per_node + e;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += p[(size_t)s * per_node];
  out[idx] = acc;
}

// ---- conv_dx --------------------------------------------------------------
// GEMM [M positions, k*k*Cout] x [k*k*Cout, Cin] per node. Block tile:
// DX_TM positions x DX_TN input channels, DX_TK reduction entries per
// stage. Thread t owns positions (t/8)*2 + {0,1} and channels (t%8)*4 +
// {0..3}. As is padded to 33 columns so the two-row reads hit 8 banks.
constexpr int DX_TM = 64;
constexpr int DX_TN = 32;
constexpr int DX_TK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dx_kernel(const T* __restrict__ g, const T* __restrict__ w,
               T* __restrict__ dx, int B, int H, int W, int Cin, int Cout,
               int k) {
  __shared__ float As[DX_TM][DX_TK + 1];
  __shared__ __align__(16) float Bs[DX_TK][DX_TN];

  const int K2 = k * k * Cout;
  const int HW = H * W;
  const int M = B * HW;
  const int R = k / 2;
  const int m0 = blockIdx.x * DX_TM;
  const int n0 = blockIdx.y * DX_TN;
  const int n = blockIdx.z;
  const T* gn = g + (size_t)n * M * Cout;
  const T* wn = w + (size_t)n * k * k * Cin * Cout;

  const int t = threadIdx.x;
  const int tm = (t / 8) * 2;
  const int tn = (t % 8) * 4;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int kb = 0; kb < K2; kb += DX_TK) {
    // im2col(dout) tile: As[mm][kq] = g_pad[pixel(m0+mm) + tap offset, co].
#pragma unroll
    for (int i = 0; i < (DX_TM * DX_TK) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int mm = e / DX_TK;
      const int kq = e % DX_TK;
      const int m = m0 + mm;
      const int kk = kb + kq;
      float v = 0.f;
      if (m < M && kk < K2) {
        const int tap = kk / Cout;
        const int co = kk - tap * Cout;
        const int di = tap / k;
        const int dj = tap - di * k;
        const int b = m / HW;
        const int rem = m - b * HW;
        const int ii = rem / W + di - R;
        const int jj = rem % W + dj - R;
        if (ii >= 0 && ii < H && jj >= 0 && jj < W)
          v = to_f(gn[((size_t)(b * H + ii) * W + jj) * Cout + co]);
      }
      As[mm][kq] = v;
    }
    // rot180(w) with in/out swapped (conv_kernel.py:171-173):
    // wrot[(di*k+dj)*Cout + co, ci] = w[k-1-di, k-1-dj, ci, co].
#pragma unroll
    for (int i = 0; i < (DX_TK * DX_TN) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int kq = e / DX_TN;
      const int cc = e % DX_TN;
      const int kk = kb + kq;
      const int ci = n0 + cc;
      float v = 0.f;
      if (kk < K2 && ci < Cin) {
        const int tap = kk / Cout;
        const int co = kk - tap * Cout;
        const int di = tap / k;
        const int dj = tap - di * k;
        v = to_f(wn[((size_t)((k - 1 - di) * k + (k - 1 - dj)) * Cin + ci) * Cout + co]);
      }
      Bs[kq][cc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kq = 0; kq < DX_TK; ++kq) {
      const float a0 = As[tm][kq];
      const float a1 = As[tm + 1][kq];
      const float4 q = *reinterpret_cast<const float4*>(&Bs[kq][tn]);
      acc[0][0] += a0 * q.x; acc[0][1] += a0 * q.y;
      acc[0][2] += a0 * q.z; acc[0][3] += a0 * q.w;
      acc[1][0] += a1 * q.x; acc[1][1] += a1 * q.y;
      acc[1][2] += a1 * q.z; acc[1][3] += a1 * q.w;
    }
    __syncthreads();
  }

  T* dst = dx + (size_t)n * M * Cin;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int m = m0 + tm + a;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tn + j;
      if (ci < Cin) dst[(size_t)m * Cin + ci] = from_f<T>(acc[a][j]);
    }
  }
}

// ---- bf16: the same two GEMMs on the tensor cores (WMMA 16x16x16) --------
// The operands are copied into shared memory as they are (bf16, no
// conversion) and multiplied with f32 accumulators; only the tile
// bookkeeping differs from the f32 kernels above. The im2col index
// arithmetic is hoisted out of the element loop: a block's output rows
// (conv_dw) or positions (conv_dx) are fixed for its whole life, so their
// (tap, channel) or (image, row, column) decompositions are computed once
// into shared memory, and per stage only the other side's.

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

// Blocks resident per SM that the register budget must allow (<= 85
// registers a thread): a stage's loads wait on memory with nothing else to
// do in the block, so other resident blocks are what hides that latency.
constexpr int kWmmaBlocks = 3;

// conv_dw: block tile 64 rows (k*k*Cin) x 64 columns (Cout), 64 positions
// per stage. Warp w owns rows (w/2)*16 and columns (w%2)*32 + {0, 16}.
constexpr int WDW_BK = 64, WDW_BC = 64, WDW_TM = 64;
constexpr int WDW_LD = WDW_BK + 8;   // bf16 leading dims: multiples of 8
constexpr int WDW_LDC = WDW_BC + 4;  // f32 epilogue tile

__global__ void __launch_bounds__(kThreads, kWmmaBlocks)
conv_dw_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                    float* __restrict__ out, int B, int H, int W, int Cin,
                    int Cout, int k, int splits, int chunk) {
  __shared__ __align__(32) bf16 Ps[WDW_TM][WDW_LD];
  __shared__ __align__(32) bf16 Gs[WDW_TM][WDW_LD];
  __shared__ __align__(32) float Cs[WDW_BK][WDW_LDC];
  __shared__ int row_off[WDW_BK], row_di[WDW_BK], row_dj[WDW_BK];
  __shared__ int pos_base[WDW_TM], pos_i[WDW_TM], pos_j[WDW_TM];

  const int K2C = k * k * Cin;
  const int HW = H * W;
  const int M = B * HW;
  const int R = k / 2;
  const int r0 = blockIdx.x * WDW_BK;
  const int c0 = blockIdx.y * WDW_BC;
  const int n = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  const int m_begin = s * chunk;
  const int m_end = min(M, m_begin + chunk);
  const bf16* xn = x + (size_t)n * M * Cin;
  const bf16* gn = g + (size_t)n * M * Cout;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int wr = (warp / 2) * 16;
  const int wc = (warp % 2) * 32;
  const bf16 zero = __float2bfloat16(0.f);

  if (t < WDW_BK) {  // row kk -> (tap offset, channel); invalid rows: di huge
    const int kk = r0 + t;
    if (kk < K2C) {
      const int tap = kk / Cin;
      const int ci = kk - tap * Cin;
      const int di = tap / k - R, dj = tap % k - R;
      row_off[t] = (di * W + dj) * Cin + ci;
      row_di[t] = di;
      row_dj[t] = dj;
    } else {
      row_off[t] = 0;
      row_di[t] = 1 << 20;
      row_dj[t] = 0;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int mb = m_begin; mb < m_end; mb += WDW_TM) {
    if (t < WDW_TM) {  // position -> (pixel base, row, column); invalid: i huge
      const int m = mb + t;
      if (m < m_end) {
        const int b = m / HW;
        const int rem = m - b * HW;
        pos_i[t] = rem / W;
        pos_j[t] = rem % W;
        pos_base[t] = m * Cin;
      } else {
        pos_i[t] = 1 << 20;
        pos_j[t] = 0;
        pos_base[t] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < (WDW_TM * WDW_BK) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int mm = e / WDW_BK;
      const int rr = e % WDW_BK;
      const int ii = pos_i[mm] + row_di[rr];
      const int jj = pos_j[mm] + row_dj[rr];
      Ps[mm][rr] = (ii >= 0 && ii < H && jj >= 0 && jj < W)
                       ? xn[pos_base[mm] + row_off[rr]] : zero;
    }
#pragma unroll
    for (int i = 0; i < (WDW_TM * WDW_BC) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int mm = e / WDW_BC;
      const int cc = e % WDW_BC;
      const int m = mb + mm;
      const int c = c0 + cc;
      Gs[mm][cc] = (m < m_end && c < Cout) ? gn[(size_t)m * Cout + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WDW_TM; ks += 16) {
      // A = P^T: element (kk, m) lives at Ps[m][kk] -> column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, &Ps[ks][wr], WDW_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bq;
        wmma::load_matrix_sync(bq, &Gs[ks][wc + f * 16], WDW_LD);
        wmma::mma_sync(acc[f], a, bq, acc[f]);
      }
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(&Cs[wr][wc], acc[0], WDW_LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(&Cs[wr][wc + 16], acc[1], WDW_LDC, wmma::mem_row_major);
  __syncthreads();
  float* dst = out + (size_t)(n * splits + s) * K2C * Cout;
  for (int e = t; e < WDW_BK * WDW_BC; e += kThreads) {
    const int row = r0 + e / WDW_BC;
    const int col = c0 + e % WDW_BC;
    if (row < K2C && col < Cout) dst[(size_t)row * Cout + col] = Cs[e / WDW_BC][e % WDW_BC];
  }
}

// conv_dx: block tile 128 positions x 32 input channels, 32 reduction
// entries per stage. Warp w owns positions w*16 and channels {0, 16}.
constexpr int WDX_BM = 128, WDX_BN = 32, WDX_BK = 32;
constexpr int WDX_LDA = WDX_BK + 8, WDX_LDB = WDX_BN + 8, WDX_LDC = WDX_BN + 4;

__global__ void __launch_bounds__(kThreads, kWmmaBlocks)
conv_dx_wmma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                    bf16* __restrict__ dx, int B, int H, int W, int Cin,
                    int Cout, int k) {
  __shared__ __align__(32) bf16 As[WDX_BM][WDX_LDA];
  __shared__ __align__(32) bf16 Bs[WDX_BK][WDX_LDB];
  __shared__ __align__(32) float Cs[WDX_BM][WDX_LDC];
  __shared__ int pos_base[WDX_BM], pos_i[WDX_BM], pos_j[WDX_BM];
  __shared__ int col_off[WDX_BK], col_di[WDX_BK], col_dj[WDX_BK], col_w[WDX_BK];

  const int K2 = k * k * Cout;
  const int HW = H * W;
  const int M = B * HW;
  const int R = k / 2;
  const int m0 = blockIdx.x * WDX_BM;
  const int n0 = blockIdx.y * WDX_BN;
  const int n = blockIdx.z;
  const bf16* gn = g + (size_t)n * M * Cout;
  const bf16* wn = w + (size_t)n * k * k * Cin * Cout;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const bf16 zero = __float2bfloat16(0.f);

  if (t < WDX_BM) {
    const int m = m0 + t;
    if (m < M) {
      const int b = m / HW;
      const int rem = m - b * HW;
      pos_i[t] = rem / W;
      pos_j[t] = rem % W;
      pos_base[t] = m * Cout;
    } else {
      pos_i[t] = 1 << 20;
      pos_j[t] = 0;
      pos_base[t] = 0;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int kb = 0; kb < K2; kb += WDX_BK) {
    if (t < WDX_BK) {  // entry kk -> (tap offset, out channel, rot180 w offset)
      const int kk = kb + t;
      if (kk < K2) {
        const int tap = kk / Cout;
        const int co = kk - tap * Cout;
        const int di = tap / k, dj = tap % k;
        col_off[t] = ((di - R) * W + (dj - R)) * Cout + co;
        col_di[t] = di - R;
        col_dj[t] = dj - R;
        col_w[t] = ((k - 1 - di) * k + (k - 1 - dj)) * Cin * Cout + co;
      } else {
        col_off[t] = 0;
        col_di[t] = 1 << 20;
        col_dj[t] = 0;
        col_w[t] = -1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < (WDX_BM * WDX_BK) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int mm = e / WDX_BK;
      const int kq = e % WDX_BK;
      const int ii = pos_i[mm] + col_di[kq];
      const int jj = pos_j[mm] + col_dj[kq];
      As[mm][kq] = (ii >= 0 && ii < H && jj >= 0 && jj < W)
                       ? gn[pos_base[mm] + col_off[kq]] : zero;
    }
#pragma unroll
    for (int i = 0; i < (WDX_BK * WDX_BN) / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int kq = e / WDX_BN;
      const int ci = n0 + e % WDX_BN;
      Bs[kq][e % WDX_BN] = (col_w[kq] >= 0 && ci < Cin)
                               ? wn[col_w[kq] + (size_t)ci * Cout] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WDX_BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[warp * 16][ks], WDX_LDA);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bq;
        wmma::load_matrix_sync(bq, &Bs[ks][f * 16], WDX_LDB);
        wmma::mma_sync(acc[f], a, bq, acc[f]);
      }
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(&Cs[warp * 16][0], acc[0], WDX_LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(&Cs[warp * 16][16], acc[1], WDX_LDC, wmma::mem_row_major);
  __syncthreads();
  bf16* dst = dx + (size_t)n * M * Cin;
  for (int e = t; e < WDX_BM * WDX_BN; e += kThreads) {
    const int m = m0 + e / WDX_BN;
    const int ci = n0 + e % WDX_BN;
    if (m < M && ci < Cin) dst[(size_t)m * Cin + ci] = __float2bfloat16(Cs[e / WDX_BN][e % WDX_BN]);
  }
}

inline unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

// conv_dw's block tile for a dtype: {rows of k*k*Cin, columns of Cout,
// positions per stage}. The split count and the chunk rounding below
// read it from here, so they follow any change of either kernel's tile.
struct DwTile { int rows, cols, stage; };
inline DwTile dw_tile(int dtype) {
  return dtype == 1 ? DwTile{WDW_BK, WDW_BC, WDW_TM} : DwTile{DW_TK, DW_TC, DW_TM};
}

// Position splits of conv_dw: enough blocks (~kTargetBlocks) to fill the
// card, never more than one stage of positions per split, and a grid z
// (N * splits) within 65535.
constexpr long kTargetBlocks = 1024;
inline int dw_splits(int N, int K2C, int Cout, int M, int dtype) {
  const DwTile tile = dw_tile(dtype);
  const long blocks = (long)N * cdiv(K2C, tile.rows) * cdiv(Cout, tile.cols);
  long s = (kTargetBlocks + blocks - 1) / blocks;
  s = s < (long)cdiv(M, tile.stage) ? s : (long)cdiv(M, tile.stage);
  s = s < 65535L / N ? s : 65535L / N;
  return s > 1 ? (int)s : 1;
}

template <typename T>
void launch_dw(const void* x, const void* g, void* partial, void* out, int N,
               int B, int H, int W, int Cin, int Cout, int k, int splits,
               cudaStream_t st) {
  const int M = B * H * W;
  const int K2C = k * k * Cin;
  const DwTile tile = dw_tile(std::is_same<T, bf16>::value ? 1 : 0);
  int chunk = (M + splits - 1) / splits;
  chunk = ((chunk + tile.stage - 1) / tile.stage) * tile.stage;
  dim3 grid(cdiv(K2C, tile.rows), cdiv(Cout, tile.cols), (unsigned)(N * splits));
  float* dst = splits > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  if constexpr (std::is_same<T, bf16>::value) {
    conv_dw_wmma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), dst, B, H, W,
        Cin, Cout, k, splits, chunk);
  } else {
    conv_dw_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), dst, B, H, W, Cin,
        Cout, k, splits, chunk);
  }
  if (splits > 1) {
    const long total = (long)N * K2C * Cout;
    dw_reduce_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), N,
        K2C * Cout, splits);
  }
}

template <typename T>
void launch_dx(const void* g, const void* w, void* dx, int N, int B, int H,
               int W, int Cin, int Cout, int k, cudaStream_t st) {
  const int M = B * H * W;
  if constexpr (std::is_same<T, bf16>::value) {
    dim3 grid(cdiv(M, WDX_BM), cdiv(Cin, WDX_BN), (unsigned)N);
    conv_dx_wmma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(w),
        static_cast<bf16*>(dx), B, H, W, Cin, Cout, k);
  } else {
    dim3 grid(cdiv(M, DX_TM), cdiv(Cin, DX_TN), (unsigned)N);
    conv_dx_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx),
        B, H, W, Cin, Cout, k);
  }
}

}  // namespace

extern "C" {

// The position split count conv_dw takes for these shapes and dtype; the
// caller sizes the partial scratch of tpfl_conv_dw with it.
int tpfl_conv_dw_splits(int N, int B, int H, int W, int Cin, int Cout, int k,
                        int dtype) {
  return dw_splits(N, k * k * Cin, Cout, B * H * W, dtype);
}

// x [N,B,H,W,Cin], g [N,B,H,W,Cout] (same dtype) -> out f32 [N,k*k*Cin,Cout].
// splits: tpfl_conv_dw_splits of the same arguments. partial: f32 scratch
// [N,splits,k*k*Cin,Cout], unused when splits == 1.
int tpfl_conv_dw(const void* x, const void* g, void* partial, void* out, int N,
                 int B, int H, int W, int Cin, int Cout, int k, int splits,
                 int dtype, void* stream) {
  if (splits != tpfl_conv_dw_splits(N, B, H, W, Cin, Cout, k, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_dw<float>(x, g, partial, out, N, B, H, W, Cin, Cout, k, splits, st);
  else if (dtype == 1)
    launch_dw<bf16>(x, g, partial, out, N, B, H, W, Cin, Cout, k, splits, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g [N,B,H,W,Cout], w [N,k,k,Cin,Cout] (same dtype) -> dx [N,B,H,W,Cin].
int tpfl_conv_dx(const void* g, const void* w, void* dx, int N, int B, int H,
                 int W, int Cin, int Cout, int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_dx<float>(g, w, dx, N, B, H, W, Cin, Cout, k, st);
  else if (dtype == 1)
    launch_dx<bf16>(g, w, dx, N, B, H, W, Cin, Cout, k, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
