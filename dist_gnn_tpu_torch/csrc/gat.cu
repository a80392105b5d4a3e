// K4 (fused GAT attention forward) and K5 (its backward) for Hopper, sm_90a.
//
// Plain C interface, loaded with ctypes by dist_gnn_tpu_torch/ops/gat.py
// (built by dist_gnn_tpu_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Layouts (those of dist_gnn_tpu/ops/gat_pallas.py): x_n [K, S, E] k-major
// neighbour inputs; el [S, H] and er3 [K, S, H] f32 score halves (computed
// outside, as two matmuls); mask [S, K] f32; w [E, H*D]; out [S, H*D] with
// head h in columns [h*D, (h+1)*D).  x_n, w, g, out, dxn share one dtype,
// float32 or bfloat16.  Any D: no column pad, no vector width that assumes
// alignment.
//
// Both kernels share the score chain of _score_chain (gat_pallas.py:70): per
// row, pre = el + er3, LeakyReLU, masked slots -1e30, ONE max over all K*H
// scores of the row, e = exp(s - max) * mask, den = max(sum_k e, 1e-12),
// alpha = e * (1 / den).  Rows whose every slot is masked get alpha = 0 and
// so output exactly 0.
//
// K4 dg_gat_fwd replaces _fwd_call / _fwd_kernel (gat_pallas.py:206, :102).
//   Per row: alpha; agg_h = sum_k alpha_kh * x_n[k] (alpha rounded to x's
//   dtype as the Pallas kernel casts it, f32 sums); agg_h rounded to w's
//   dtype; out_h = agg_h @ W_h with f32 sums, written once in x's dtype.
//   Bound: bytes (x_n read once dominates: 101 MB of the ~147 MB at the GAT
//   bench layer 0); the FLOPs are an order lower even at the f32 FMA rate.
//   Design: one block per tile of up to 16 destination rows; the block's
//   alpha and agg [rows, H, E] live in shared memory, so x_n is read once
//   and agg never reaches device memory; the projection runs in the same
//   block, each thread owning output columns and keeping one f32 sum per
//   row in registers, with W's rows read coalesced from L2 once per tile.
//   Plain FMA loops: mma/wgmma is later work.
//
// K5 dg_gat_bwd replaces _bwd_call / _bwd_kernel (gat_pallas.py:230, :127).
//   Outputs dW [E, H*D] f32, d_el [S, H] f32, d_er3 [K, S, H] f32 and, only
//   when dxn is not null, dxn [K, S, E].  Two launches:
//   (1) gat_bwd_rows_kernel, per tile of rows: alpha recomputed; dagg_h =
//       g_h @ W_h^T (from a transposed copy of w the wrapper makes, so the
//       reads coalesce); d_alpha[k,h] = x_k . dagg_h directly (2*K*S*E*H
//       FLOPs -- the Pallas z-form x_k @ W, ~52 GFLOP at bench layer 0,
//       existed only to avoid TPU lane reductions; here a warp reduces);
//       d_pre = alpha (d_alpha - sum_k alpha d_alpha) * leaky'; d_el, d_er3;
//       dxn[k] = sum_h alpha_kh dagg_h; and agg_h = sum_k alpha_kh x_k,
//       written in w's dtype (the Pallas kernel casts it so before dW).
//   (2) gat_dw_kernel: dW[:, hD:(h+1)D] = sum_s agg_h[s]^T g_h[s], a tiled
//       product split over S; each block adds its f32 partial tile into the
//       zeroed dW with atomics.  The TPU revisited one f32 dW block across a
//       sequential grid; blocks here run in no order, so the order of the
//       atomic adds, and the last bits of dW, vary from run to run.
//   Bound: bytes (x_n read once, dxn written once when asked), as for K4.
//
// In both kernels the loops that issue one device-memory or L2 load per
// step (over E, D or K) are unrolled, so several loads are in flight per
// thread: with a few blocks per SM the loads' latency, not the FMAs, is
// what limits these loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kMaxRows = 16;   // destination rows per block, at most
constexpr int kMaxHeads = 8;
constexpr int kMaxK = 32;
constexpr int kSmemBudget = 96 * 1024;      // two blocks per SM when it fits
constexpr int kSmemMax = 227 * 1024;        // what one block may opt in to
constexpr float kNeg = -1e30f;

// dW tiles: 64 e x 64 d outputs per block, 32 rows of S per step
constexpr int kTileE = 64;
constexpr int kTileD = 64;
constexpr int kTileS = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
// x rounded to T's precision, kept as float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// The shared score chain for rows [s0, s0 + rows): alpha[r][k][h] (f32,
// masked slots exactly 0) and, when pre is not null, pre[r][k][h] = el + er3.
// gmax [rows] and rden [rows][H] are scratch.  Ends with a barrier.
__device__ void score_chain(const float* __restrict__ el,
                            const float* __restrict__ er3,
                            const float* __restrict__ mask, int64_t S,
                            int64_t s0, int rows, int K, int H, float slope,
                            float* alpha, float* pre, float* gmax,
                            float* rden) {
  const int KH = K * H;
  const int n = rows * KH;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / KH, k = (i % KH) / H, h = i % H;
    const int64_t s = s0 + r;
    const float p = el[s * H + h] + er3[((int64_t)k * S + s) * H + h];
    float sc = p >= 0.f ? p : p * slope;
    if (!(mask[s * K + k] > 0.f)) sc = kNeg;
    alpha[i] = sc;
    if (pre != nullptr) pre[i] = p;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float g = alpha[r * KH];
    for (int j = 1; j < KH; ++j) g = fmaxf(g, alpha[r * KH + j]);
    gmax[r] = g;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / KH, k = (i % KH) / H;
    alpha[i] = expf(alpha[i] - gmax[r]) * mask[(s0 + r) * K + k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int r = i / H, h = i % H;
    float den = 0.f;
    for (int k = 0; k < K; ++k) den += alpha[(r * K + k) * H + h];
    rden[i] = 1.f / fmaxf(den, 1e-12f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / KH, h = i % H;
    alpha[i] *= rden[r * H + h];
  }
  __syncthreads();
}

// ---- K4 -------------------------------------------------------------------

size_t fwd_row_floats(int K, int E, int H) {
  return (size_t)K * H + (size_t)H * E + 1 + H;  // alpha, agg, gmax, rden
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const T* __restrict__ x_n, const float* __restrict__ el,
               const float* __restrict__ er3, const float* __restrict__ mask,
               const T* __restrict__ w, T* __restrict__ out, int K, int64_t S,
               int E, int H, int D, float slope, int rows_per_block) {
  extern __shared__ float smem[];
  const int64_t s0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, S - s0);
  const int HD = H * D;
  float* alpha = smem;                              // [rows][K][H]
  float* agg = alpha + rows_per_block * K * H;      // [rows][H][E]
  float* gmax = agg + rows_per_block * H * E;       // [rows]
  float* rden = gmax + rows_per_block;              // [rows][H]
  score_chain(el, er3, mask, S, s0, rows, K, H, slope, alpha, nullptr, gmax,
              rden);

  // agg[r][h][e] = sum_k T(alpha) * x_n[k, s, e]: threads over (r, e), so a
  // warp reads one contiguous run of a row of x_n
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, e = i % E;
    const int64_t s = s0 + r;
    float acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = to_float(x_n[((int64_t)k * S + s) * E + e]);
      const float* a = alpha + (r * K + k) * H;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < H) acc[h] += round_to<T>(a[h]) * x;
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) agg[(r * H + h) * E + e] = round_to<T>(acc[h]);
    }
  }
  __syncthreads();

  // out[s, c] = sum_e agg[r][c / D][e] * w[e, c]: threads over columns, one
  // f32 sum per row in registers, each w element read once per tile
  for (int c = threadIdx.x; c < HD; c += blockDim.x) {
    const int h = c / D;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) {
      const float wv = to_float(w[(int64_t)e * HD + c]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) acc[r] += agg[(r * H + h) * E + e] * wv;
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) out[(s0 + r) * HD + c] = from_float<T>(acc[r]);
    }
  }
}

// ---- K5 -------------------------------------------------------------------

size_t bwd_row_floats(int K, int E, int H, int D) {
  // alpha, pre, dal [K][H] each; g [H*D]; dagg [H][E]; gmax; rden/T [H]
  return 3 * (size_t)K * H + (size_t)H * D + (size_t)H * E + 1 + H;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_bwd_rows_kernel(const T* __restrict__ x_n, const float* __restrict__ el,
                    const float* __restrict__ er3,
                    const float* __restrict__ mask, const T* __restrict__ w_t,
                    const T* __restrict__ g, float* __restrict__ d_el,
                    float* __restrict__ d_er3, T* __restrict__ dxn,
                    T* __restrict__ aggs, int K, int64_t S, int E, int H,
                    int D, float slope, int rows_per_block) {
  extern __shared__ float smem[];
  const int64_t s0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, S - s0);
  const int HD = H * D;
  const int KH = K * H;
  float* alpha = smem;                           // [rows][K][H]
  float* pre = alpha + rows_per_block * KH;      // [rows][K][H]
  float* dal = pre + rows_per_block * KH;        // [rows][K][H]
  float* gs = dal + rows_per_block * KH;         // [rows][H*D]
  float* dagg = gs + rows_per_block * HD;        // [rows][H][E]
  float* gmax = dagg + rows_per_block * H * E;   // [rows]
  float* tsum = gmax + rows_per_block;           // [rows][H]
  score_chain(el, er3, mask, S, s0, rows, K, H, slope, alpha, pre, gmax, tsum);

  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x)
    gs[i] = to_float(g[s0 * HD + i]);  // the tile's rows are contiguous
  __syncthreads();

  // dagg[r][h][e] = sum_d g[r, hD + d] * w[e, hD + d]: threads over (h, e),
  // reading w^T [H*D, E] rows coalesced
  for (int i = threadIdx.x; i < H * E; i += blockDim.x) {
    const int h = i / E, e = i % E;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const int c = h * D + d;
      const float wv = to_float(w_t[(int64_t)c * E + e]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) acc[r] += gs[r * HD + c] * wv;
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) dagg[(r * H + h) * E + e] = acc[r];
    }
  }

  // agg_h = sum_k alpha_kh x_k (f32 alpha, f32 sums), stored in T for dW
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, e = i % E;
    const int64_t s = s0 + r;
    float acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = to_float(x_n[((int64_t)k * S + s) * E + e]);
      const float* a = alpha + (r * K + k) * H;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < H) acc[h] += a[h] * x;
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) aggs[(s * H + h) * E + e] = from_float<T>(acc[h]);
    }
  }
  __syncthreads();

  // d_alpha[r][k][h] = x_k . dagg_h and dxn[k] = sum_h alpha_kh dagg_h:
  // one warp per (row, slot), lanes along E, a shuffle reduction per head
  const int lane = threadIdx.x & 31;
  const bool want_dx = dxn != nullptr;
  for (int p = threadIdx.x >> 5; p < rows * K; p += blockDim.x >> 5) {
    const int r = p / K, k = p % K;
    const int64_t base = ((int64_t)k * S + s0 + r) * E;
    const float* a = alpha + (r * K + k) * H;
    float part[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) part[h] = 0.f;
#pragma unroll 4
    for (int e = lane; e < E; e += 32) {
      const float x = to_float(x_n[base + e]);
      float dx = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < H) {
          const float dg = dagg[(r * H + h) * E + e];
          part[h] += x * dg;
          dx += a[h] * dg;
        }
      }
      if (want_dx) dxn[base + e] = from_float<T>(dx);
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) {
        float v = part[h];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) dal[(r * K + k) * H + h] = v;
      }
    }
  }
  __syncthreads();

  // softmax and LeakyReLU backward: d_pre = alpha (d_alpha - T) * leaky',
  // T = sum_k alpha d_alpha; d_er3[k] = d_pre, d_el = sum_k d_pre
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int r = i / H, h = i % H;
    const int64_t s = s0 + r;
    float t = 0.f;
    for (int k = 0; k < K; ++k) {
      const int j = (r * K + k) * H + h;
      t += alpha[j] * dal[j];
    }
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int j = (r * K + k) * H + h;
      const float d_pre = alpha[j] * (dal[j] - t) * (pre[j] >= 0.f ? 1.f : slope);
      acc += d_pre;
      d_er3[((int64_t)k * S + s) * H + h] = d_pre;
    }
    d_el[s * H + h] = acc;
  }
}

// dW[e, h*D + d] += sum over this block's rows s of aggs[s, h, e] * g[s, h*D + d]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_dw_kernel(const T* __restrict__ aggs, const T* __restrict__ g,
              float* __restrict__ dw, int64_t S, int E, int H, int D,
              int64_t s_chunk) {
  __shared__ __align__(16) float As[kTileS][kTileE];
  __shared__ __align__(16) float Bs[kTileS][kTileD];
  const int HD = H * D;
  const int d_tiles = (D + kTileD - 1) / kTileD;
  const int e0 = blockIdx.x * kTileE;
  const int h = blockIdx.y / d_tiles;
  const int d0 = (blockIdx.y % d_tiles) * kTileD;
  const int64_t s_begin = (int64_t)blockIdx.z * s_chunk;
  const int64_t s_end = min(S, s_begin + s_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int64_t st = s_begin; st < s_end; st += kTileS) {
    for (int i = threadIdx.x; i < kTileS * kTileE; i += blockDim.x) {
      const int ss = i / kTileE, col = i % kTileE;
      const int64_t s = st + ss;
      const bool row_ok = s < s_end;
      const int e = e0 + col, d = d0 + col;
      As[ss][col] = row_ok && e < E ? to_float(aggs[(s * H + h) * E + e]) : 0.f;
      Bs[ss][col] = row_ok && d < D ? to_float(g[s * HD + h * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ss = 0; ss < kTileS; ++ss) {
      const float4 a = *reinterpret_cast<const float4*>(&As[ss][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[ss][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = e0 + ty * 4 + i;
    if (e >= E) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < D) atomicAdd(dw + (int64_t)e * HD + h * D + d, acc[i][j]);
    }
  }
}

// Rows per block: as many as fit kSmemBudget (at most kMaxRows), else one
// row if it fits what a block may opt in to; 0 if not even that.
int rows_for(size_t row_floats) {
  const size_t row_bytes = row_floats * sizeof(float);
  size_t rows = kSmemBudget / row_bytes;
  if (rows > (size_t)kMaxRows) rows = kMaxRows;
  if (rows == 0 && row_bytes <= (size_t)kSmemMax) rows = 1;
  return (int)rows;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(int K, int64_t S, int E, int H, int D) {
  return K > 0 && K <= kMaxK && S > 0 && E > 0 && H > 0 && H <= kMaxHeads &&
         D > 0;
}

template <typename T>
int launch_fwd(const void* x_n, const float* el, const float* er3,
               const float* mask, const void* w, void* out, int K, int64_t S,
               int E, int H, int D, float slope, cudaStream_t stream) {
  const int rows = rows_for(fwd_row_floats(K, E, H));
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * fwd_row_floats(K, E, H) * sizeof(float);
  const int rc = allow_smem(gat_fwd_kernel<T>, smem);
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)((S + rows - 1) / rows);
  gat_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x_n), el, er3, mask, static_cast<const T*>(w),
      static_cast<T*>(out), K, S, E, H, D, slope, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x_n, const float* el, const float* er3,
               const float* mask, const void* w_t, const void* g, float* dw,
               float* d_el, float* d_er3, void* dxn, void* aggs, int K,
               int64_t S, int E, int H, int D, float slope,
               cudaStream_t stream) {
  const int rows = rows_for(bwd_row_floats(K, E, H, D));
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * bwd_row_floats(K, E, H, D) * sizeof(float);
  int rc = allow_smem(gat_bwd_rows_kernel<T>, smem);
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)((S + rows - 1) / rows);
  gat_bwd_rows_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x_n), el, er3, mask, static_cast<const T*>(w_t),
      static_cast<const T*>(g), d_el, d_er3, static_cast<T*>(dxn),
      static_cast<T*>(aggs), K, S, E, H, D, slope, rows);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // split S so the dW grid fills the card about twice over
  const int64_t tiles = (int64_t)((E + kTileE - 1) / kTileE) * H *
                        ((D + kTileD - 1) / kTileD);
  const int64_t s_steps = (S + kTileS - 1) / kTileS;
  int64_t splits = (264 + tiles - 1) / tiles;
  if (splits > s_steps) splits = s_steps;
  const int64_t s_chunk = ((s_steps + splits - 1) / splits) * kTileS;
  splits = (S + s_chunk - 1) / s_chunk;
  dim3 dgrid((E + kTileE - 1) / kTileE, H * ((D + kTileD - 1) / kTileD),
             (unsigned)splits);
  gat_dw_kernel<T><<<dgrid, kThreads, 0, stream>>>(
      static_cast<const T*>(aggs), static_cast<const T*>(g), dw, S, E, H, D,
      s_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4.  dtype 0 = float32, 1 = bfloat16 (of x_n, w and out).
int dg_gat_fwd(const void* x_n, const float* el, const float* er3,
               const float* mask, const void* w, void* out, int K, int64_t S,
               int E, int H, int D, float slope, int dtype, void* stream) {
  if (!shape_ok(K, S, E, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(x_n, el, er3, mask, w, out, K, S, E, H, D, slope, st);
    case 1:
      return launch_fwd<__nv_bfloat16>(x_n, el, er3, mask, w, out, K, S, E, H, D, slope, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5.  w_t is w transposed, [H*D, E]; dw a zeroed f32 [E, H*D]; aggs a
// scratch [S, H, E] in the dtype; dxn [K, S, E] or null to skip d_x.
int dg_gat_bwd(const void* x_n, const float* el, const float* er3,
               const float* mask, const void* w_t, const void* g, float* dw,
               float* d_el, float* d_er3, void* dxn, void* aggs, int K,
               int64_t S, int E, int H, int D, float slope, int dtype,
               void* stream) {
  if (!shape_ok(K, S, E, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x_n, el, er3, mask, w_t, g, dw, d_el, d_er3,
                               dxn, aggs, K, S, E, H, D, slope, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(x_n, el, er3, mask, w_t, g, dw, d_el,
                                       d_er3, dxn, aggs, K, S, E, H, D, slope, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
