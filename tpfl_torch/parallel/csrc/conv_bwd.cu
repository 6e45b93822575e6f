// Per-node 3x3 SAME / stride-1 convolution backward for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of tpfl/parallel/conv_kernel.py:
//   conv_dw  <- _dw_kernel (conv_kernel.py:82):
//               dW[k*k*Cin, Cout] = im2col(x)^T . dout, f32 accumulated
//   conv_dx  <- _dx_kernel (conv_kernel.py:103):
//               dx[B*H*W, Cin] = im2col(dout) . rot180(w)^T
// Both operate on node-stacked operands [N, B, H, W, C] (NHWC per node) and
// one launch covers all N nodes: the node index is folded into the grid's x
// (no 65535 limit on N), or persistent blocks walk ranges of images across
// nodes -- the counterpart of jax.vmap over the Pallas grid.
//
// What bounds them on an H100: at the federation's shapes (N=100, B=128,
// 32x32x3->32 and 16x16x32->64, bf16) each launch moves 0.6-0.9 GB and does
// 23-121 GFLOP, so the least time is set by the bytes (0.19-0.27 ms at
// 3.35 TB/s), not by the tensor cores. conv_dx at Conv_1 (dout
// [100,128,16,16,64] -> dx [...,32]) reads 419 MB and writes 210 MB:
// 0.189 ms of bytes against 0.122 ms of products at 989 TFLOP/s, so the
// tensor cores are not far behind. conv_dw reads x (79 / 210 MB) and dout
// (839 / 419 MB) at Conv_0 / Conv_1: 0.274 / 0.190 ms of bytes against
// 54 / 121 GFLOP (0.05 / 0.12 ms).
//
// conv_dw on Hopper (bf16, the main path; section "conv_dw on Hopper"):
// per image one TMA box of x is the zero-haloed image and one box of dout
// is the B operand as it lands (pixel rows of 32 or 64 channels, MN-major),
// so each element of both leaves device memory once; the shifted im2col^T
// rows are the register A fragment (ldmatrix.trans from the halo rows, or
// element loads from Conv_0's 3-channel rows through a 3-D view of x);
// wgmma accumulates a node's images in registers, a block writes one f32
// partial per node it touches and a fixed-order pass sums them.
//
// conv_dx on Hopper (bf16, the main path; section "conv_dx on Hopper"):
//   * One read of dout, the halo for free. The work unit is one image of
//     one node: a 4-D TMA map views dout as [N*B, H, W, Cout] and one box
//     of [64 channels, W+2, H+2, 1] starting at (c0, -1, -1, image) lands
//     the zero-haloed image in shared memory -- TMA fills coordinates
//     outside the tensor with zeros, which is exactly the SAME halo. Each
//     dout element leaves device memory once (per 32 input channels).
//     Boxes use the 128-byte swizzle: a pixel's 64 channels are one row.
//   * Weights are the B operand, resident for a node. w [k,k,Cin,Cout] has
//     Cout innermost, so tap (di,dj) of rot180(w)^T is the slice
//     w[2-di, 2-dj] as it stands: Cin rows of 64 contiguous Cout values, a
//     K-major B tile. All 9 taps (of the block's 32 input channels) load
//     with one box when a block starts a node.
//   * Nine shifted-tap products on wgmma. For a 64-pixel M-tile and tap
//     (di,dj) the A rows are the halo tile's rows (i+di)(W+2) + (j+dj).
//     They do not start on swizzle atoms, so they cannot be a descriptor:
//     ldmatrix.x4 loads them, with per-lane row addresses and the swizzle
//     XOR applied, as the register A fragment of m64k16; wgmma.m64n32k16
//     multiplies it with the tap's weight tile. A tap's fragments load
//     while the previous tap's products run. 9 taps x Cout/16 k-steps sum
//     in one f32 accumulator; dx is rounded to bf16 once.
//   * A producer warp keeps TMA loads of the next images in a ring of 2-4
//     stages (mbarriers, each wait traps after ~10 s) while four consumer
//     warpgroups multiply; one persistent block per SM walks a contiguous
//     range of images, so it loads its weights once per node it touches.
//   * Output: accumulator -> bf16 -> a per-warp shared tile -> 16-byte
//     stores of dx rows; pixels past H*W in the last M-tile are masked.
//   * Chosen by shape before launch, never on failure (dx_variant;
//     tpfl_conv_dx reports whether it took this kernel): bf16, k = 3, Cout a multiple of 64, Cin a
//     multiple of 8 up to 64 (one or two 32-channel tiles), H*W <= 512
//     (two 64-pixel accumulators per warpgroup), W+2 and H+2 <= 256 (a TMA
//     box), 16-byte-aligned g, w and dx, and the weights plus a ring of
//     at least two halo'd images in the card's shared memory. Other bf16
//     shapes take the WMMA kernel below, f32 the CUDA-core kernel. A
//     refused tensor map or launch returns an error.
//
// The other kernels:
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
//     multiplies in turn, with scalar 2-byte loads; the WMMA conv_dx also
//     fetches each dout element once per tap (nine times). They serve the
//     shapes the Hopper kernels' rules leave out.
//
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError() after its launches. Kernels run on the caller's stream
// and allocate nothing. dtype: 0 = float32, 1 = bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace hp = hopper;

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
  const int n = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int r0 = blockIdx.y * DW_TK;
  const int c0 = blockIdx.z * DW_TC;
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
  const int m_tiles = (M + DX_TM - 1) / DX_TM;
  const int n = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x % m_tiles) * DX_TM;
  const int n0 = blockIdx.y * DX_TN;
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
  const int n = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int r0 = blockIdx.y * WDW_BK;
  const int c0 = blockIdx.z * WDW_BC;
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
  const int m_tiles = (M + WDX_BM - 1) / WDX_BM;
  const int n = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x % m_tiles) * WDX_BM;
  const int n0 = blockIdx.y * WDX_BN;
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

// ---- conv_dx on Hopper (bf16): halo'd TMA images, shifted taps on wgmma ------
// Block: kDxWG consumer warpgroups, then one producer warp; one block per
// SM. Warpgroup wg owns the image's 64-pixel M-tiles wg, wg + kDxWG, ...
// (at most kDxTilesPerWG of them, each with its own accumulator, since an
// image arrives as Cout/64 ring stages that all add into them) and the
// block's 32 input channels (blockIdx.y). Shared memory, 1024-aligned:
// the weights [Cout/64][9 taps][32 rows][128 B], the ring of halo'd image
// chunks [H+2][W+2][128 B] (one TMA box each), the per-warp output tiles,
// the mbarriers. Four warpgroups of one M-tile each (at 16x16) hide each
// tap's ldmatrix and wgmma latency better than two of two tiles, or two
// issuing a pair of tiles per tap, although ptxas then budgets 96
// registers a thread (a block's registers are counted in whole warpgroups)
// and spills a few bytes.
constexpr int kDxWG = 4;
constexpr int kDxTilesPerWG = 2;
constexpr int kDxMaxPixels = 64 * kDxWG * kDxTilesPerWG;
constexpr int kDxN = 32;      // input channels a block computes (wgmma N)
constexpr int kDxMaxCin = 64;
constexpr int kDxMaxStages = 4;
constexpr int kDxTapBytes = kDxN * 128;           // one tap's weight tile
constexpr int kDxChunkWBytes = 9 * kDxTapBytes;   // 9 taps of 64 Cout channels
constexpr int kDxOutPitch = 80;                   // bytes a row of a warp's output tile
constexpr int kDxOutBytes = kDxWG * 4 * 16 * kDxOutPitch;
constexpr int kDxThreads = kDxWG * 128 + 32;

__device__ __forceinline__ char* align1024(char* p) {
  const uint32_t a = hp::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// This thread's share of the A fragments of one tap, k-steps 0..3 (64
// channels): row r of the halo tile (its 8 rows for this lane's matrix),
// 16-byte chunk 2 kk + hi stored at chunk (2 kk + hi) ^ (r % 8).
__device__ __forceinline__ void load_tap(uint32_t (&a)[4][4], uint32_t tile, int r, uint32_t hi) {
  const uint32_t row = tile + (uint32_t)r * 128, x = (uint32_t)r & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hp::ldmatrix_x4(a[kk], row + (((2 * kk + hi) ^ x) << 4));
}

// acc[64 x 32] += the nine shifted-tap products of one M-tile against one
// 64-channel chunk of Cout. r0: this lane's halo row at tap (0, 0). Tap t
// (di, dj) = (t / 3, t % 3) multiplies weight tile 8 - t, i.e.
// w[2 - di, 2 - dj]. The next tap's fragments load while this tap's
// products run.
__device__ __forceinline__ void mtile_products(float (&acc)[16], uint32_t tile, const char* wt,
                                               int r0, int W2, uint32_t hi) {
  uint32_t a[2][4][4];
  load_tap(a[0], tile, r0, hi);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    hp::wgmma_fence();
    const uint64_t db = hp::desc_sw128(wt + (8 - t) * kDxTapBytes, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::wgmma_rs_kmajor(acc, a[t & 1][kk], db + 2 * kk, 1);
    hp::wgmma_commit();
    if (t < 8) {
      hp::wgmma_wait<1>();  // tap t - 1 is done with the buffer tap t + 1 fills
      load_tap(a[(t + 1) & 1], tile, r0 + ((t + 1) / 3) * W2 + (t + 1) % 3, hi);
    }
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
}

// An M-tile's accumulator rounded to bf16, through this warp's output tile
// (16 rows x 80 bytes) into dx rows m0 .. m0 + 15 of one image,
// columns ci0 .. ci0 + cw: 16-byte stores, pixels past HW masked.
__device__ __forceinline__ void store_mtile(const float (&acc)[16], char* out, bf16* dst, int m0,
                                            int HW, int Cin, int ci0, int cw) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(out + (lane / 4 + 8 * h) * kDxOutPitch +
                                         (8 * j + 2 * (lane % 4)) * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncwarp();
  const int per_row = cw / 8;
  for (int e = lane; e < 16 * per_row; e += 32) {
    const int row = e / per_row, c = e % per_row, m = m0 + row;
    if (m < HW)
      *reinterpret_cast<uint4*>(dst + (size_t)m * Cin + ci0 + 8 * c) =
          *reinterpret_cast<const uint4*>(out + row * kDxOutPitch + 16 * c);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kDxThreads, 1)
conv_dx_wgmma(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w,
              bf16* __restrict__ dx, int NB, int B, int H, int W, int Cin, int chunks, int stages,
              int stage_bytes) {
  extern __shared__ char smem_raw[];
  char* Ws = align1024(smem_raw);
  char* ring = Ws + chunks * kDxChunkWBytes;
  char* outs = ring + stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kDxOutBytes);
  uint64_t* empty = full + stages;
  uint64_t* w_full = empty + stages;
  uint64_t* w_empty = w_full + 1;

  const int HW = H * W, W2 = W + 2;
  const int ci0 = blockIdx.y * kDxN;
  const int img0 = (int)((long)blockIdx.x * NB / gridDim.x);
  const int img1 = (int)((long)(blockIdx.x + 1) * NB / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, kDxWG * 4);
    }
    hp::mbar_init(w_full, 1);
    hp::mbar_init(w_empty, kDxWG * 4);
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // provably warp-uniform
  const int lane = threadIdx.x % 32;
  if (wg == kDxWG) {  // producer warp: lane 0 issues every load
    if (lane == 0) {
      const uint32_t box_bytes = (uint32_t)(H + 2) * W2 * 128;
      int node = -1, loads = 0, u = 0;
      for (int img = img0; img < img1; ++img) {
        if (img / B != node) {  // a new node: its weights, once the last node's are done
          node = img / B;
          if (loads > 0) hp::mbar_wait(w_empty, (loads - 1) & 1);
          hp::mbar_arrive_expect_tx(w_full, chunks * kDxChunkWBytes);
          for (int h = 0; h < chunks; ++h)
            hp::tma_load_4d(Ws + h * kDxChunkWBytes, &map_w, w_full, 64 * h, ci0, 0, node);
          ++loads;
        }
        for (int h = 0; h < chunks; ++h, ++u) {
          const int s = u % stages;
          hp::mbar_wait(empty + s, ((u / stages) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(full + s, box_bytes);
          hp::tma_load_4d(ring + s * stage_bytes, &map_g, full + s, 64 * h, -1, -1, img);
        }
      }
    }
  } else {
    const int warp = (threadIdx.x % 128) / 32;
    const int n_mt = (HW + 63) / 64;
    const uint32_t hi = lane >> 4;  // ldmatrix matrices 2, 3: k-columns 8..15
    const int cw = min(kDxN, Cin - ci0);
    char* out = outs + (wg * 4 + warp) * 16 * kDxOutPitch;
    // This lane's ldmatrix row of each M-tile as a halo-tile row at tap
    // (0, 0); masked pixels read pixel 0 and are never stored.
    int r0[kDxTilesPerWG];
#pragma unroll
    for (int q = 0; q < kDxTilesPerWG; ++q) {
      int m = (wg + kDxWG * q) * 64 + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
      if (m >= HW) m = 0;
      r0[q] = (m / W) * W2 + m % W;
    }
    float acc[kDxTilesPerWG][16];
    int node = -1, loads = 0, u = 0;
    for (int img = img0; img < img1; ++img) {
      if (img / B != node) {
        node = img / B;
        hp::mbar_wait(w_full, loads & 1);
        ++loads;
      }
#pragma unroll
      for (int q = 0; q < kDxTilesPerWG; ++q)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[q][i] = 0.f;
      for (int h = 0; h < chunks; ++h, ++u) {
        const int s = u % stages;
        hp::mbar_wait(full + s, (u / stages) & 1);
        __syncwarp();  // wgmma is .aligned: the warp converged after the spin
        const uint32_t tile = hp::smem_u32(ring + s * stage_bytes);
        const char* wt = Ws + h * kDxChunkWBytes;
#pragma unroll
        for (int q = 0; q < kDxTilesPerWG; ++q)
          if (wg + kDxWG * q < n_mt) mtile_products(acc[q], tile, wt, r0[q], W2, hi);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(empty + s);
      }
      if (img + 1 == img1 || (img + 1) / B != node) {  // the node's weights are free
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(w_empty);
      }
      bf16* dst = dx + (size_t)img * HW * Cin;
#pragma unroll
      for (int q = 0; q < kDxTilesPerWG; ++q)
        if (wg + kDxWG * q < n_mt)
          store_mtile(acc[q], out, dst, (wg + kDxWG * q) * 64 + 16 * warp, HW, Cin, ci0, cw);
    }
  }
}

// ---- conv_dw on Hopper (bf16): halo'd TMA images, im2col^T fragments on wgmma ----
// dW[k*k*Cin, Cout] of a node = sum over its images of im2col(x)^T . dout:
// M = the (tap, ci) rows, N = a chunk of NC output channels (blockIdx.y),
// K = the image's pixels. Per image one TMA box of x is the zero-haloed
// image (the SAME halo from TMA's zero fill) and one box of dout is the
// image's NC channels, each element read from device memory once (x once
// per Cout chunk). B = the dout box as it lands: pixel rows of NC channels,
// MN-major, swizzled by the row's width (64 or 128 bytes). A = im2col^T: row
// (tap, ci), column pixel p = x_halo[p + tap offset][ci]. Shifted per tap it
// cannot be a descriptor, so it is the register A fragment of m64k16:
//   * 4-D view (Cin 8, 16 or 32): x as [N*B, H, W, Cin], box [Cin, W+2, H+2, 1]
//     at (0, -1, -1, image), rows of Cin*2 bytes swizzled by their width.
//     ldmatrix.x4.trans reads the halo rows of 16 pixels (8-row groups of M
//     are (tap, 8 channels); each of the four matrices has its own tap) with
//     the swizzle XOR. Consumer warpgroup wg owns M-tile wg (288 rows at
//     Cin 32: 5 tiles, 5 warpgroups) and every image.
//   * 3-D view (Cin < 8: Conv_0's 3 channels are 6-byte pixels TMA cannot
//     step over): x as [N*B, H, W*Cin], box [XB, H+3, 1] at (0, -2, image)
//     with XB = (W+1)*Cin rounded up to 8. A box row holds image row r - 2
//     and then at least Cin zeros past the tensor's edge: those zeros are
//     the right halo of the row and the left halo of the next one (pixel
//     column -1 of row r is element -Cin of box row r, the tail of box row
//     r - 1), and rows 0 and 1 are zero. (A negative innermost coordinate,
//     not a multiple of 16 bytes, faults on the H100.) The 9*Cin rows are
//     one M-tile (rows past them are zero), loaded element by element into
//     the fragment layout. Three warpgroups
//     take the images in turn, each with its own accumulator (its own slot
//     of partials), so the ring keeps three images in flight. The ring has
//     exactly three stages, so stage s belongs to warpgroup s: a parity wait
//     only tells a barrier's next phase from its current one, and a ring
//     shared by warpgroups that run apart would let one read another's
//     later phase as its own.
// Pixels are padded to two commit groups of k-steps (dw_pixel_pad): the
// dout box runs a few rows past H, where TMA fills zeros, and the A columns
// of those pixels read pixel 0.
// A producer warp feeds a ring of (x box, dout box) stages (mbarriers whose
// waits trap); one block per SM walks a contiguous range of images that may
// cross nodes. Accumulators stay in registers across a node's images; at
// the end of each node the block writes its f32 partial once, into slot
// (block + node) * R + replica of `partial` (unique: a later block never
// starts at an earlier node), and dw_reduce_ranges sums each node's slots
// in a fixed order. No float atomics: results are identical run to run.
constexpr int kDwWG4 = 5;  // consumer warpgroups, 4-D view: one M-tile each
constexpr int kDwWG3 = 3;  // consumer warpgroups, 3-D view: images in turn
constexpr int kDwMaxStages = 4;
// k-steps (16 pixels each) per wgmma commit group: the register budget of
// the 4-D view's 672-thread block holds two groups of 2 fragments beside a
// 64-column accumulator, the 3-D view's two groups of 4. Pixels are padded
// to two groups, so the loop over groups unrolls by two with both fragment
// buffers in named registers (an index computed at run time would put them
// in local memory).
__host__ __device__ constexpr int dw_kgroup(bool flat) { return flat ? 4 : 2; }
__host__ __device__ constexpr int dw_pixel_pad(bool flat) { return 32 * dw_kgroup(flat); }

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <bool kFlat, int NC>
__global__ void __launch_bounds__((kFlat ? kDwWG3 : kDwWG4) * 128 + 32, 1)
conv_dw_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_g,
              float* __restrict__ partial, int NB, int B, int H, int W, int Cin, int Cout,
              int HWpad, int XB, int stages, int x_bytes, int stage_bytes) {
  constexpr int kWG = kFlat ? kDwWG3 : kDwWG4;
  constexpr int R = kFlat ? kDwWG3 : 1;  // accumulator replicas (partial slots) per node
  constexpr int kGRow = NC * 2;          // bytes of a dout pixel row
  extern __shared__ char smem_raw[];
  char* ring = align1024(smem_raw);
  int* tab = reinterpret_cast<int*>(ring + stages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + HWpad);
  uint64_t* empty = full + stages;

  const int HW = H * W, K2C = 9 * Cin;
  const int c0 = blockIdx.y * NC;
  const int img0 = (int)((long)blockIdx.x * NB / gridDim.x);
  const int img1 = (int)((long)(blockIdx.x + 1) * NB / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, kFlat ? 4 : kWG * 4);
    }
    hp::mbar_fence_init();
  }
  // Pixel -> its halo row (4-D) or halo element (3-D) at tap (0, 0);
  // padding pixels read pixel 0 (their dout rows are zeros).
  for (int p = threadIdx.x; p < HWpad; p += blockDim.x) {
    const int i = p / W, j = p % W;
    tab[p] = p >= HW ? 0 : kFlat ? (i + 1) * XB + (j - 1) * Cin : i * (W + 2) + j;
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // provably warp-uniform
  const int lane = threadIdx.x % 32;
  if (wg == kWG) {  // producer warp: lane 0 issues every load
    if (lane == 0) {
      const uint32_t g_box = (uint32_t)kGRow * W * ((HWpad + W - 1) / W);
      const uint32_t x_box = kFlat ? (uint32_t)(H + 3) * XB * 2 : (uint32_t)(H + 2) * (W + 2) * Cin * 2;
      for (int img = img0, u = 0; img < img1; ++img, ++u) {
        const int s = u % stages;
        char* st = ring + s * stage_bytes;
        hp::mbar_wait(empty + s, ((u / stages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(full + s, x_box + g_box);
        if constexpr (kFlat)
          hp::tma_load_3d(st, &map_x, full + s, 0, -2, img);
        else
          hp::tma_load_4d(st, &map_x, full + s, 0, -1, -1, img);
        hp::tma_load_4d(st + x_bytes, &map_g, full + s, c0, 0, 0, img);
      }
    }
    return;
  }

  constexpr int KG = dw_kgroup(kFlat);
  const int warp = (threadIdx.x % 128) / 32;
  const int n_groups = HWpad / (16 * KG);  // even (dw_pixel_pad)
  // 4-D: this lane's ldmatrix matrix i = lane / 8 holds M rows 8 (i % 2) ..
  // of the warp's 16 and pixels 8 (i / 2) + lane % 8 of the k-step; its
  // 8-row group of M is (tap, 8-channel chunk).
  const int mt = kFlat ? 0 : wg;
  const bool active = mt * 64 < K2C;  // warpgroup-uniform
  const int grp = mt * 8 + 2 * warp + ((lane >> 3) & 1);
  const int chunks = kFlat ? 1 : Cin / 8;  // 8-channel chunks of a pixel
  const int tap = grp / chunks;
  const int xrow = Cin * 2;  // bytes of a halo row (4-D view)
  const int tap_off = tap < 9 ? (tap / 3) * (W + 2) + tap % 3 : 0;
  const uint32_t chunk = (uint32_t)(grp % chunks);
  const uint32_t swz_mask = (uint32_t)(xrow / 16 - 1);
  const int kpix = 8 * ((lane >> 4) & 1) + (lane & 7);
  // 3-D: this thread's fragment rows m0 = 16 warp + lane / 4 and m0 + 8, as
  // halo element offsets at pixel 0, masked to zero past 9 Cin.
  int off[2];
  uint16_t keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + lane / 4 + 8 * h, t = m / Cin, ci = m % Cin;
    const bool ok = kFlat && m < K2C;
    off[h] = ok ? (t / 3) * XB + (t % 3) * Cin + ci : 0;
    keep[h] = ok ? 0xFFFF : 0;
  }
  const bool warp_rows = kFlat ? 16 * warp < K2C : active;  // warp-uniform
  const int q2 = 2 * (lane % 4);

  const int n_lo = img0 / B, n_hi = img1 > img0 ? (img1 - 1) / B : n_lo - 1;
  for (int n = n_lo; n <= n_hi; ++n) {
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    const int a = max(img0, n * B), b = min(img1, (n + 1) * B);
    for (int img = a; img < b; ++img) {
      const int u = img - img0, s = u % stages;
      if (kFlat && u % R != wg) continue;
      hp::mbar_wait(full + s, (u / stages) & 1);
      __syncwarp();  // wgmma is .aligned: the warp converged after the spin
      const char* st = ring + s * stage_bytes;
      const uint32_t xt = hp::smem_u32(st);
      const char* gt = st + x_bytes;
      if (kFlat || active) {
        // The A fragment of k-step ks into f[].
        auto load_a = [&](uint32_t (&f)[4], int ks) {
          if constexpr (kFlat) {
            if (!warp_rows) {
              f[0] = f[1] = f[2] = f[3] = 0u;
              return;
            }
            const uint16_t* xs = reinterpret_cast<const uint16_t*>(st);
            const int p = 16 * ks + q2;
            const int e0 = tab[p], e1 = tab[p + 1], e2 = tab[p + 8], e3 = tab[p + 9];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              f[h] = pack2(xs[e0 + off[h]] & keep[h], xs[e1 + off[h]] & keep[h]);
              f[2 + h] = pack2(xs[e2 + off[h]] & keep[h], xs[e3 + off[h]] & keep[h]);
            }
          } else {
            const uint32_t r = (uint32_t)(tab[16 * ks + kpix] + tap_off);
            const uint32_t swz = ((r * xrow) >> 7) & swz_mask;
            hp::ldmatrix_x4_trans(f, xt + r * xrow + ((chunk ^ swz) << 4));
          }
        };
        // Commit group gi: KG products from `cur`; once group gi - 1 is
        // done, the fragments of group gi + 1 load into `nxt` while gi runs.
        auto group = [&](uint32_t (&cur)[KG][4], uint32_t (&nxt)[KG][4], int gi) {
          hp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KG; ++kk)
            hp::wgmma_rs(acc, cur[kk],
                         hp::desc_swizzled(gt + (gi * KG + kk) * 16 * kGRow, 16, 8 * kGRow, kGRow),
                         1);
          hp::wgmma_commit();
          hp::wgmma_wait<1>();
          if (gi + 1 < n_groups) {
#pragma unroll
            for (int kk = 0; kk < KG; ++kk) load_a(nxt[kk], (gi + 1) * KG + kk);
          }
        };
        uint32_t f0[KG][4], f1[KG][4];
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) load_a(f0[kk], kk);
        for (int gi = 0; gi < n_groups; gi += 2) {
          group(f0, f1, gi);
          group(f1, f0, gi + 1);
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);
    }
    if (kFlat || active) {  // this node's partial: rows mt*64 + ..., columns c0 + ...
      const int slot = (blockIdx.x + n) * R + (kFlat ? wg : 0);
      float* dst = partial + (size_t)slot * K2C * Cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 64 + 16 * warp + lane / 4 + 8 * h;
        if (row >= K2C) continue;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
          *reinterpret_cast<float2*>(dst + (size_t)row * Cout + c0 + 8 * j + q2) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// out[n, e] = the sum, in block order and then replica order, of the
// partial slots (b + n) * R + r of every block b whose image range meets
// node n (conv_dw_wgmma's layout). Deterministic by construction.
__global__ void __launch_bounds__(kThreads)
dw_reduce_ranges(const float* __restrict__ partial, float* __restrict__ out, int N, int per_node,
                 int B, int NB, int G, int R) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)N * per_node) return;
  const long n = (long)(idx / per_node);
  const size_t e = idx - (size_t)n * per_node;
  // The last block whose range starts at or before the node's first image.
  long b = (((long)n * B + 1) * G - 1) / NB;
  float acc = 0.f;
  for (; b < G && b * NB / G < (n + 1) * B; ++b)
    for (int r = 0; r < R; ++r) acc += partial[(size_t)((b + n) * R + r) * per_node + e];
  out[idx] = acc;
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
// card, never more than one stage of positions per split. N * splits is
// the grid's x, which has no 65535 limit.
constexpr long kTargetBlocks = 1024;
inline int dw_splits(int N, int K2C, int Cout, int M, int dtype) {
  const DwTile tile = dw_tile(dtype);
  const long blocks = (long)N * cdiv(K2C, tile.rows) * cdiv(Cout, tile.cols);
  long s = (kTargetBlocks + blocks - 1) / blocks;
  s = s < (long)cdiv(M, tile.stage) ? s : (long)cdiv(M, tile.stage);
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
  dim3 grid((unsigned)(N * splits), cdiv(K2C, tile.rows), cdiv(Cout, tile.cols));
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

// The kernel tpfl_conv_dx launches for a shape.
enum DxVariant { kDxCudaCores = 0, kDxWmma = 1, kDxWgmma = 2 };

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

// Ring depth, stage size and dynamic shared memory of a wgmma conv_dx launch.
struct DxPlan { int stages, stage_bytes; size_t smem; };

// The shape rule of the wgmma conv_dx (the note at the top of this file):
// kDxWgmma with *plan filled, or the kernel the shape takes instead, or
// -(CUDA error) if the card cannot be queried.
int dx_variant(const void* g, const void* w, const void* dx, int H, int W, int Cin, int Cout,
               int k, int dtype, DxPlan* plan) {
  if (dtype == 0) return kDxCudaCores;
  if (k != 3 || Cout % 64 != 0 || Cin % 8 != 0 || Cin < 8 || Cin > kDxMaxCin || H < 1 ||
      W < 1 || H * W > kDxMaxPixels || H + 2 > 256 || W + 2 > 256 || !aligned16(g) ||
      !aligned16(w) || !aligned16(dx))
    return kDxWmma;
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  const int stage_bytes = ((H + 2) * (W + 2) * 128 + 1023) / 1024 * 1024;
  for (int stages = kDxMaxStages; stages >= 2; --stages) {
    const size_t smem = 1024 + (size_t)(Cout / 64) * kDxChunkWBytes +
                        (size_t)stages * stage_bytes + kDxOutBytes + (2 * stages + 2) * 8;
    if (smem <= (size_t)optin) {
      *plan = DxPlan{stages, stage_bytes, smem};
      return kDxWgmma;
    }
  }
  return kDxWmma;
}

cudaError_t launch_dx_wgmma(const void* g, const void* w, void* dx, int N, int B, int H, int W,
                            int Cin, int Cout, const DxPlan& plan, cudaStream_t st) {
  // dout as [N*B, H, W, Cout] and w as [N, 9, Cin, Cout], innermost first.
  CUtensorMap map_g, map_w;
  const cuuint64_t g_dims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)N * B};
  const cuuint32_t g_box[4] = {64, (cuuint32_t)(W + 2), (cuuint32_t)(H + 2), 1};
  const cuuint64_t w_dims[4] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9, (cuuint64_t)N};
  const cuuint32_t w_box[4] = {64, (cuuint32_t)kDxN, 9, 1};
  if (!hp::make_bf16_map_nd(&map_g, g, 4, g_dims, g_box) ||
      !hp::make_bf16_map_nd(&map_w, w, 4, w_dims, w_box))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_dx_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  int dev, sms;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // Persistent: one block per SM, each a contiguous range of images.
  const int tiles = (Cin + kDxN - 1) / kDxN;
  const int blocks = std::max(1, std::min(N * B, sms / tiles));
  conv_dx_wgmma<<<dim3(blocks, tiles), kDxThreads, plan.smem, st>>>(
      map_g, map_w, static_cast<bf16*>(dx), N * B, B, H, W, Cin, Cout / 64, plan.stages,
      plan.stage_bytes);
  return cudaGetLastError();
}

// The kernel tpfl_conv_dw launches for a shape.
enum DwVariant { kDwOther = 0, kDwWgmma = 1 };

// Everything a wgmma conv_dw launch needs: the view of x, the Cout chunk,
// the ring, the padded pixel count, the grid and the partial slots.
struct DwPlan {
  bool flat;
  int nc, stages, x_bytes, stage_bytes, hwpad, hb, xb, blocks, chunks;
  size_t smem;
  long partials;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The shape rule of the wgmma conv_dw (the note above conv_dw_wgmma): bf16,
// k = 3, Cout a multiple of 32, 16-byte-aligned x and g; Cin 8, 16 or 32
// (4-D view) or Cin < 8 with W*Cin a multiple of 8 and (W+1)*Cin <= 256
// (3-D view); every box dimension within TMA's 256 and the ring within the
// card's shared memory: at least two stages (4-D view), exactly kDwWG3 (3-D
// view, one per warpgroup). kDwWgmma with *plan filled, or kDwOther, or
// -(CUDA error) if the card cannot be queried.
int dw_variant(const void* x, const void* g, int N, int B, int H, int W, int Cin, int Cout, int k,
               int dtype, DwPlan* plan) {
  if (dtype != 1 || k != 3 || Cout % 32 != 0 || H < 1 || W < 1 || H + 3 > 256 || W + 2 > 256 ||
      !aligned16(x) || !aligned16(g))
    return kDwOther;
  DwPlan p{};
  p.flat = Cin < 8;
  if (p.flat) {
    p.xb = round_up((W + 1) * Cin, 8);
    if ((W * Cin) % 8 != 0 || p.xb > 256) return kDwOther;
  } else if (Cin != 8 && Cin != 16 && Cin != 32) {
    return kDwOther;
  }
  p.nc = !p.flat && Cout % 64 == 0 ? 64 : 32;
  p.hwpad = round_up(H * W, dw_pixel_pad(p.flat));
  p.hb = (p.hwpad + W - 1) / W;
  if (p.hb > 256) return kDwOther;
  p.x_bytes = round_up(p.flat ? (H + 3) * p.xb * 2 : (H + 2) * (W + 2) * Cin * 2, 1024);
  p.stage_bytes = p.x_bytes + round_up(p.nc * 2 * W * p.hb, 1024);
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int min_stages = p.flat ? kDwWG3 : 2;
  for (p.stages = p.flat ? kDwWG3 : kDwMaxStages; p.stages >= min_stages; --p.stages) {
    p.smem = 1024 + (size_t)p.stages * p.stage_bytes + (size_t)p.hwpad * 4 + 2 * p.stages * 8;
    if (p.smem <= (size_t)optin) break;
  }
  if (p.stages < min_stages) return kDwOther;
  // Persistent: one block per SM and Cout chunk, each a contiguous,
  // non-empty range of images.
  p.chunks = Cout / p.nc;
  p.blocks = std::max(1, std::min(N * B, sms / p.chunks));
  p.partials = (long)(p.blocks + N - 1) * (p.flat ? kDwWG3 : 1);
  *plan = p;
  return kDwWgmma;
}

cudaError_t launch_dw_wgmma(const void* x, const void* g, void* partial, void* out, int N, int B,
                            int H, int W, int Cin, int Cout, const DwPlan& p, cudaStream_t st) {
  CUtensorMap map_x, map_g;
  const cuuint64_t NB = (cuuint64_t)N * B;
  bool ok;
  if (p.flat) {  // x as [N*B, H, W*Cin]
    const cuuint64_t dims[3] = {(cuuint64_t)W * Cin, (cuuint64_t)H, NB};
    const cuuint32_t box[3] = {(cuuint32_t)p.xb, (cuuint32_t)(H + 3), 1};
    ok = hp::make_bf16_map_nd(&map_x, x, 3, dims, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {  // x as [N*B, H, W, Cin], rows swizzled by their width
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, NB};
    const cuuint32_t box[4] = {(cuuint32_t)Cin, (cuuint32_t)(W + 2), (cuuint32_t)(H + 2), 1};
    const CUtensorMapSwizzle swz = Cin == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : Cin == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                               : CU_TENSOR_MAP_SWIZZLE_NONE;
    ok = hp::make_bf16_map_nd(&map_x, x, 4, dims, box, swz);
  }
  const cuuint64_t g_dims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, NB};
  const cuuint32_t g_box[4] = {(cuuint32_t)p.nc, (cuuint32_t)W, (cuuint32_t)p.hb, 1};
  ok = ok && hp::make_bf16_map_nd(&map_g, g, 4, g_dims, g_box,
                                  p.nc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = p.flat ? conv_dw_wgmma<true, 32>
              : p.nc == 64 ? conv_dw_wgmma<false, 64> : conv_dw_wgmma<false, 32>;
  const int threads = (p.flat ? kDwWG3 : kDwWG4) * 128 + 32;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.blocks, p.chunks), threads, p.smem, st>>>(
      map_x, map_g, static_cast<float*>(partial), N * B, B, H, W, Cin, Cout, p.hwpad, p.xb,
      p.stages, p.x_bytes, p.stage_bytes);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int per_node = 9 * Cin * Cout;
  dw_reduce_ranges<<<cdiv((long)N * per_node, kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), N, per_node, B, N * B,
      p.blocks, p.flat ? kDwWG3 : 1);
  return cudaGetLastError();
}

template <typename T>
void launch_dx(const void* g, const void* w, void* dx, int N, int B, int H,
               int W, int Cin, int Cout, int k, cudaStream_t st) {
  const int M = B * H * W;
  if constexpr (std::is_same<T, bf16>::value) {
    dim3 grid(cdiv(M, WDX_BM) * (unsigned)N, cdiv(Cin, WDX_BN));
    conv_dx_wmma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(w),
        static_cast<bf16*>(dx), B, H, W, Cin, Cout, k);
  } else {
    dim3 grid(cdiv(M, DX_TM) * (unsigned)N, cdiv(Cin, DX_TN));
    conv_dx_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx),
        B, H, W, Cin, Cout, k);
  }
}

// The partial slots a conv_dw launch of this variant and plan writes: the
// wgmma kernel's (blocks + N - 1) * replicas, or the WMMA / CUDA-core
// kernels' N * splits position splits (0: none).
long dw_partials(int variant, const DwPlan& plan, int N, int B, int H, int W, int Cin, int Cout,
                 int k, int dtype) {
  if (variant == kDwWgmma) return plan.partials;
  const int splits = dw_splits(N, k * k * Cin, Cout, B * H * W, dtype);
  return splits > 1 ? (long)N * splits : 0;
}

}  // namespace

extern "C" {

// The f32 partial slices [k*k*Cin, Cout] that tpfl_conv_dw needs as
// scratch for these operands (0: none), or -(CUDA error). The launcher
// picks the kernel and its split, so it sizes the scratch.
long tpfl_conv_dw_partials(const void* x, const void* g, int N, int B, int H, int W, int Cin,
                           int Cout, int k, int dtype) {
  DwPlan plan;
  const int variant = dw_variant(x, g, N, B, H, W, Cin, Cout, k, dtype, &plan);
  if (variant < 0) return variant;
  return dw_partials(variant, plan, N, B, H, W, Cin, Cout, k, dtype);
}

// x [N,B,H,W,Cin], g [N,B,H,W,Cout] (same dtype) -> out f32 [N,k*k*Cin,Cout].
// partial: f32 scratch of `partials` slices (tpfl_conv_dw_partials of the
// same arguments; any other count is refused). *took_wgmma: 1 if the launch
// took the wgmma kernel (the rule of dw_variant), else 0.
int tpfl_conv_dw(const void* x, const void* g, void* partial, void* out, int N, int B, int H,
                 int W, int Cin, int Cout, int k, long partials, int dtype, void* stream,
                 int* took_wgmma) {
  *took_wgmma = 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  DwPlan plan;
  const int variant = dw_variant(x, g, N, B, H, W, Cin, Cout, k, dtype, &plan);
  if (variant < 0) return -variant;
  if (partials != dw_partials(variant, plan, N, B, H, W, Cin, Cout, k, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kDwWgmma) {
    const cudaError_t err = launch_dw_wgmma(x, g, partial, out, N, B, H, W, Cin, Cout, plan, st);
    *took_wgmma = err == cudaSuccess;
    return (int)err;
  }
  const int splits = dw_splits(N, k * k * Cin, Cout, B * H * W, dtype);
  if (dtype == 0)
    launch_dw<float>(x, g, partial, out, N, B, H, W, Cin, Cout, k, splits, st);
  else
    launch_dw<bf16>(x, g, partial, out, N, B, H, W, Cin, Cout, k, splits, st);
  return (int)cudaGetLastError();
}

// g [N,B,H,W,Cout], w [N,k,k,Cin,Cout] (same dtype) -> dx [N,B,H,W,Cin].
// *took_wgmma: 1 if the launch took the wgmma kernel (the shape rule at the
// top of this file), else 0.
int tpfl_conv_dx(const void* g, const void* w, void* dx, int N, int B, int H,
                 int W, int Cin, int Cout, int k, int dtype, void* stream,
                 int* took_wgmma) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *took_wgmma = 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  DxPlan plan;
  const int variant = dx_variant(g, w, dx, H, W, Cin, Cout, k, dtype, &plan);
  if (variant < 0) return -variant;
  if (variant == kDxWgmma) {
    const cudaError_t err = launch_dx_wgmma(g, w, dx, N, B, H, W, Cin, Cout, plan, st);
    *took_wgmma = err == cudaSuccess;
    return (int)err;
  }
  if (dtype == 0)
    launch_dx<float>(g, w, dx, N, B, H, W, Cin, Cout, k, st);
  else
    launch_dx<bf16>(g, w, dx, N, B, H, W, Cin, Cout, k, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
