// K4 (fused GAT attention forward) and K5 (its backward) for Hopper, sm_90a.
//
// Plain C interface, loaded with ctypes by dist_gnn_tpu_torch/ops/gat.py
// (built by dist_gnn_tpu_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
// The launch geometry (rows per block, heads per block, padded widths,
// shared-memory bytes, grids) comes from ops/gat.py::gat_plan; the launchers
// check it against the layout below and refuse a plan that disagrees.
//
// Layouts (those of dist_gnn_tpu/ops/gat_pallas.py): x_n [K, S, E] k-major
// neighbour inputs; el [S, H] and er3 [K, S, H] f32 score halves (computed
// outside, as two matmuls); mask [S, K] f32; w [E, H*D]; out [S, H*D] with
// head h in columns [h*D, (h+1)*D).  x_n, w, g, out, dxn share one dtype,
// float32 or bfloat16.  Any D and E: the bf16 kernels pad E to a multiple of
// 16 and D to a multiple of 16 in shared memory only.
//
// Both kernels share the score chain of _score_chain (gat_pallas.py:70): per
// row, pre = el + er3, LeakyReLU, masked slots -1e30, ONE max over all K*H
// scores of the row, e = exp(s - max) * mask, den = max(sum_k e, 1e-12),
// alpha = e * (1 / den).  Rows whose every slot is masked get alpha = 0 and
// so output exactly 0.  One warp per row, lane k holding slot k: a shuffle
// max over the row and the heads' shuffle sums side by side, from el, er3
// and mask staged into shared memory by cp.async.
//
// The bf16 kernels ask L2 for the block's x_n tile as they start, and stream
// W through a cp.async ring kStages deep, so the tile, the score inputs and
// the first stages of W are in flight while the score chain runs.  On the
// H100 what holds them back is each block's chain of dependent phases (score
// chain, agg, projection), not the device-memory rate: the plan sizes tiles
// so two blocks share an SM (PERF.md).
//
// K4 dg_gat_fwd replaces _fwd_call / _fwd_kernel (gat_pallas.py:206, :102).
//   Per row: alpha; agg_h = sum_k bf16(alpha_kh) * x_n[k] (f32 sums);
//   agg_h rounded to w's dtype; out_h = agg_h @ W_h with f32 sums.
//   Bound: bytes (x_n read once: 101 MB of the ~147 MB at the GAT bench
//   layer 0).  bf16 design: a block takes R rows and hc heads (the plan
//   splits heads across blocks where rows alone cannot fill the card); agg
//   is rounded to bf16 where the TPU kernel rounds it, so it lives in shared
//   memory in bf16 as the A operand; W's rows stream through the ring,
//   padded per head (heads that start off a 16-byte boundary, D = 47, by
//   plain copies, all of W in the prologue); the projection runs on the
//   tensor cores (mma.sync m16n8k16 bf16 -> f32, operands by ldmatrix), each warp
//   holding an m16 x (8 * NTW) slab of f32 accumulators for the whole sweep
//   over E.  f32 keeps exact FMA (no TF32): agg in f32 shared memory and a
//   per-column loop.
//
// K5 dg_gat_bwd replaces _bwd_call / _bwd_kernel (gat_pallas.py:230, :127).
//   Outputs dW [E, H*D] f32, d_el [S, H] f32, d_er3 [K, S, H] f32 and, only
//   when dxn is not null, dxn [K, S, E].  Two launches:
//   (1) the rows kernel, per tile of R rows and all heads: alpha;
//       dagg_h = g_h @ W_h^T in f32; d_alpha[k,h] = x_k . dagg_h (2*K*S*E*H
//       FLOPs -- the Pallas z-form x_k @ W existed only to avoid TPU lane
//       reductions); d_pre = alpha (d_alpha - sum_k alpha d_alpha) * leaky';
//       d_el, d_er3; dxn[k] = sum_h alpha_kh dagg_h; and agg_h = sum_k
//       alpha_kh x_k, written in w's dtype for dW (the Pallas kernel casts
//       it so before dW).  bf16 design: g's tile sits in shared memory as
//       the A operand, W streams through a cp.async ring one 16-deep slice of
//       D at a time for an E-chunk of every head, and dagg = g_h W_h^T comes
//       out of mma.sync straight into registers: each warp owns 16 rows x
//       16 columns of E for every head, so x_k is read once, into the same
//       fragment positions, for d_alpha (a 4-lane shuffle, then a shared
//       atomic per row, slot and head), dxn and agg.  dagg never leaves
//       registers.  f32: the FMA loops with dagg in shared memory.
//   (2) the dW kernel: dW[:, hD:(h+1)D] = sum_s agg_h[s]^T g_h[s], a tiled
//       product split over S (bf16: mma.sync with both operands by
//       ldmatrix.trans from a cp.async ring; f32: a 4x4 register tile); each
//       block adds its f32 partial tile into the zeroed dW with atomics.  The
//       TPU revisited one f32 dW block across a sequential grid; blocks here
//       run in no order, so the order of the atomic adds, and the last bits
//       of dW, vary from run to run.
//   Bound: bytes (x_n read once, dxn written once when asked), as for K4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 8;
constexpr int kMaxK = 32;
constexpr int kMaxE = 1024;
constexpr float kNeg = -1e30f;

// bf16 rings: cp.async stages in flight (K5's rows kernel one fewer, for
// its copies of d_alpha); at most 16 m16n8 accumulators a warp
constexpr int kStages = 4;
constexpr int kBwdStages = 3;
constexpr int kMaxTilesPerWarp = 16;
// f32 kernels: at most 16 rows a block (register sums per row)
constexpr int kMaxRowsF32 = 16;
// dW tiles: 64 e x 64 d outputs per block, 32 rows of S per step
constexpr int kTileE = 64;
constexpr int kTileD = 64;
constexpr int kTileS = 32;
constexpr int kDwLd = 72;  // bf16 dW stage row stride: 144 B, conflict-free ldmatrix

// x rounded to bf16 (nearest even, as torch casts), kept as float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// ---- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The cells of a rows x units grid, unit fastest, dealt to the block's
// threads in turn: thread t starts at cell t and steps by blockDim.x cells,
// with one division per walk instead of one per cell.
struct GridWalk {
  int r, u, dr, du, units;
  __device__ explicit GridWalk(int units_) : units(units_) {
    r = threadIdx.x / units;
    u = threadIdx.x % units;
    dr = blockDim.x / units;
    du = blockDim.x % units;
  }
  __device__ void next() {
    u += du;
    r += dr;
    if (u >= units) {
      u -= units;
      ++r;
    }
  }
};

// Copies an nrows x ncols bf16 tile (source row stride lds elements) into
// shared memory at dst (row stride ldd elements, a multiple of 8), zero-filling
// columns [ncols, ncols_pad) and rows [nrows, nrows_pad).  gran is the byte
// alignment of the source rows and of every granule's start: granules of 16,
// 8 or 4 bytes go by cp.async (the caller commits and waits); with gran 2 (a
// head starting at an odd element, D = 47) every element is a plain copy,
// kCopyBatch loads in flight per thread before their stores.
constexpr int kCopyBatch = 4;
__device__ void stage_tile(bf16* dst, int ldd, const bf16* __restrict__ src, int64_t lds,
                           int nrows, int ncols, int nrows_pad, int ncols_pad, int gran) {
  if (gran < 4) {
    GridWalk ld(ncols_pad);
    while (ld.r < nrows_pad) {
      GridWalk st = ld;
      bf16 v[kCopyBatch];
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        v[b] = ld.r < nrows && ld.u < ncols ? src[ld.r * lds + ld.u] : __float2bfloat16(0.f);
        ld.next();
      }
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        if (st.r < nrows_pad) dst[st.r * ldd + st.u] = v[b];
        st.next();
      }
    }
    return;
  }
  const int ge = gran / 2;  // elements per granule
  for (GridWalk it(ncols_pad / ge); it.r < nrows_pad; it.next()) {
    const int r = it.r, c = it.u * ge;
    bf16* d = dst + r * ldd + c;
    const bf16* s = src + r * lds + c;
    if (r < nrows && c + ge <= ncols) {
      if (gran >= 16) cp_async<16>(d, s);
      else if (gran >= 8) cp_async<8>(d, s);
      else cp_async<4>(d, s);
    } else {
      for (int j = 0; j < ge; ++j)
        d[j] = (r < nrows && c + j < ncols) ? s[j] : __float2bfloat16(0.f);
    }
  }
}

// Asks L2 for x_n's rows [s0, s0 + rows) of every slot (K spans of rows * E
// elements), one 128-byte line per request: the block's tile streams from
// device memory while the score chain and the W pipeline run, and the
// loads that follow hit L2.
__device__ void prefetch_rows_l2(const bf16* x_n, int64_t S, int64_t s0, int rows, int K,
                                 int E) {
  const int64_t span = (int64_t)rows * E * 2;
  for (int k = 0; k < K; ++k) {
    const char* base = reinterpret_cast<const char*>(x_n + ((int64_t)k * S + s0) * E);
    for (int64_t off = (int64_t)threadIdx.x * 128; off < span; off += (int64_t)blockDim.x * 128)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(base + off));
  }
}

// ---- the score chain ---------------------------------------------------------

// alpha[r][k][h] (f32, masked slots exactly 0) for `rows` rows and, when pre
// is not null, pre[r][k][h] = el + er3, from el [r][h], er3 [k][r][h] (k
// planes kstride apart) and mask [r][k].  One warp per row, lane k holds
// slot k; every input is loaded before anything is stored.  The caller
// synchronises before reading alpha.
__device__ void score_chain(const float* el, const float* er3, const float* mask,
                            int64_t kstride, int rows, int K, int H, float slope, float* alpha,
                            float* pre) {
  const int lane = threadIdx.x & 31;
  const int k = lane;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const float m = k < K ? mask[r * K + k] : 0.f;
    float p[kMaxHeads], sc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      p[h] = h < H && k < K ? el[r * H + h] + er3[k * kstride + r * H + h] : 0.f;
    float mx = kNeg;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      sc[h] = kNeg;
      if (h < H && k < K) {
        if (pre != nullptr) pre[(r * K + k) * H + h] = p[h];
        const float v = p[h] >= 0.f ? p[h] : p[h] * slope;
        sc[h] = m > 0.f ? v : kNeg;
      }
      mx = fmaxf(mx, sc[h]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float e[kMaxHeads], den[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) den[h] = e[h] = h < H && k < K ? expf(sc[h] - mx) * m : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)  // the heads' sums side by side
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) den[h] += __shfl_xor_sync(0xffffffffu, den[h], off);  // H is warp-uniform
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < H && k < K) alpha[(r * K + k) * H + h] = e[h] * (1.f / fmaxf(den[h], 1e-12f));
  }
}

// The score chain's inputs for rows [s0, s0 + rows), copied by 4-byte
// cp.async (the caller commits) into dst: el [R][H], er3 [K][R][H], mask
// [R][K], so the chain reads shared memory only.
__host__ __device__ inline int score_stage_bytes(int R, int K, int H) {
  return R * (H * (K + 1) + K) * 4;
}
// n floats from src to dst by cp.async: 16-byte granules where both are
// 16-byte aligned, 4-byte copies for the rest
__device__ void copy_f32_span(float* dst, const float* __restrict__ src, int n) {
  int head = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    head = n & ~3;
    for (int i = threadIdx.x * 4; i < head; i += blockDim.x * 4) cp_async<16>(dst + i, src + i);
  }
  for (int i = head + threadIdx.x; i < n; i += blockDim.x) cp_async<4>(dst + i, src + i);
}
__device__ void stage_scores(float* dst, const float* __restrict__ el,
                             const float* __restrict__ er3, const float* __restrict__ mask,
                             int64_t S, int64_t s0, int rows, int R, int K, int H) {
  copy_f32_span(dst, el + s0 * H, rows * H);
  for (int k = 0; k < K; ++k)
    copy_f32_span(dst + R * H * (k + 1), er3 + ((int64_t)k * S + s0) * H, rows * H);
  copy_f32_span(dst + R * H * (K + 1), mask + s0 * K, rows * K);
}

// V consecutive bf16 values (V * 2 bytes aligned) to and from f32
template <int V> struct VecOf;
template <> struct VecOf<8> { using type = uint4; };
template <> struct VecOf<4> { using type = uint2; };
template <> struct VecOf<2> { using type = uint32_t; };
template <> struct VecOf<1> { using type = uint16_t; };

template <int V> __device__ __forceinline__ void load_vec(const bf16* p, float (&v)[V]) {
  const typename VecOf<V>::type u = *reinterpret_cast<const typename VecOf<V>::type*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __bfloat162float(b[j]);
}
template <int V> __device__ __forceinline__ void store_vec(bf16* p, const float (&v)[V]) {
  typename VecOf<V>::type u;
  bf16* b = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < V; ++j) b[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<typename VecOf<V>::type*>(p) = u;
}

// ---- K4, bf16 ---------------------------------------------------------------
//
// Shared memory, in order (ops/gat.py::gat_plan mirrors it):
//   alpha f32 [R][K][H]                      (16-byte aligned end)
//   agg   bf16 [hc][R][lda], lda = e_pad + 8  (lda / 8 odd: ldmatrix rows
//                                              fall in 8 distinct bank groups);
//         the score chain's staged inputs share this region before agg
//   ring  bf16 [min(kStages, slices)][ks][ldw], ldw = hc * d_pad + 8: ks rows
//         of W a stage (a plan whose slices all fit stages all W at once)
__host__ __device__ inline int fwd_bf16_smem(int R, int K, int H, int hc, int e_pad, int d_pad,
                                             int ks) {
  const int agg = hc * R * (e_pad + 8) * 2, scores = score_stage_bytes(R, K, H);
  const int slices = (e_pad + ks - 1) / ks;
  return align16(R * K * H * 4) + align16(agg > scores ? agg : scores) +
         (slices < kStages ? slices : kStages) * ks * (hc * d_pad + 8) * 2;
}

// agg[hl][r][e] = bf16(sum_k bf16(alpha[r][k][h0 + hl]) * x_n[k, s0 + r, e]),
// zero in padded rows and columns; threads over (row, V-wide column group)
template <int V>
__device__ void fwd_agg_bf16(const bf16* __restrict__ x_n, const float* alpha, bf16* agg,
                             int lda, int K, int64_t S, int E, int H, int64_t s0, int rows,
                             int R, int h0, int nh, int hc, int e_pad) {
  const int units = e_pad / V;
  const int64_t kstride = S * E;
  for (GridWalk it(units); it.r < R; it.next()) {
    const int r = it.r, e = it.u * V;
    float acc[kMaxHeads][V];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[h][v] = 0.f;
    if (r < rows && e < E) {  // V divides E, so the whole group is in range
      const bf16* xp = x_n + (s0 + r) * E + e;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float xv[V];
        load_vec<V>(xp + k * kstride, xv);
        const float* a = alpha + (r * K + k) * H + h0;
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h) {
          if (h < nh) {
            const float ah = round_bf16(a[h]);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[h][v] += ah * xv[v];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < hc) store_vec<V>(agg + (h * R + r) * lda + e, acc[h]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gat_fwd_bf16_kernel(const bf16* __restrict__ x_n, const float* __restrict__ el,
                    const float* __restrict__ er3, const float* __restrict__ mask,
                    const bf16* __restrict__ w, bf16* __restrict__ out, int K, int64_t S, int E,
                    int H, int D, float slope, int R, int hc, int e_pad, int d_pad, int ks,
                    int vec, int gran_w, int out_pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t s0 = (int64_t)blockIdx.x * R;
  const int rows = (int)min((int64_t)R, S - s0);
  const int h0 = blockIdx.y * hc;
  const int nh = min(hc, H - h0);
  const int HD = H * D;
  const int lda = e_pad + 8, ldw = hc * d_pad + 8;
  const int agg_bytes = hc * R * lda * 2, scores_bytes = score_stage_bytes(R, K, H);
  float* alpha = reinterpret_cast<float*>(smem_raw);
  bf16* agg = reinterpret_cast<bf16*>(smem_raw + align16(R * K * H * 4));
  float* scores = reinterpret_cast<float*>(agg);  // until agg is written
  bf16* ring = agg + align16(agg_bytes > scores_bytes ? agg_bytes : scores_bytes) / 2;
  const int n_slices = (e_pad + ks - 1) / ks;

  // W rows [e0, e0 + n) of this block's heads, each head padded to d_pad;
  // one cp.async group per slice, empty past the last
  auto stage = [&](int i) {
    if (i < n_slices) {
      const int e0 = i * ks;
      const int n = min(ks, e_pad - e0);
      const int valid = max(0, min(n, E - e0));
      bf16* buf = ring + (i % kStages) * ks * ldw;
      for (int hl = 0; hl < hc; ++hl)
        stage_tile(buf + hl * d_pad, ldw, w + (int64_t)e0 * HD + (int64_t)(h0 + hl) * D, HD,
                   hl < nh ? valid : 0, D, n, d_pad, gran_w);
    }
    cp_async_commit();
  };
  stage_scores(scores, el, er3, mask, S, s0, rows, R, K, H);
  cp_async_commit();
  for (int i = 0; i < kStages - 1; ++i) stage(i);  // in flight through the score chain and agg
  prefetch_rows_l2(x_n, S, s0, rows, K, E);
  cp_async_wait<kStages - 1>();
  __syncthreads();
  score_chain(scores, scores + R * H, scores + R * H * (K + 1), R * H, rows, K, H, slope, alpha,
              nullptr);
  __syncthreads();
  switch (vec) {
    case 4: fwd_agg_bf16<4>(x_n, alpha, agg, lda, K, S, E, H, s0, rows, R, h0, nh, hc, e_pad); break;
    case 2: fwd_agg_bf16<2>(x_n, alpha, agg, lda, K, S, E, H, s0, rows, R, h0, nh, hc, e_pad); break;
    default: fwd_agg_bf16<1>(x_n, alpha, agg, lda, K, S, E, H, s0, rows, R, h0, nh, hc, e_pad); break;
  }

  // out tile: warp (mt, q) owns rows [16 mt, 16 mt + 16) and n-tiles
  // [q NTW, (q + 1) NTW) of the block's hc * d_pad columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpm = kWarps / (R / 16);
  const int mt = warp / wpm, q = warp % wpm;
  const int tpd = d_pad / 8;
  const int ntw = (hc * tpd + wpm - 1) / wpm;
  const int nvalid = nh * tpd;
  // tile t of this warp is n-tile q ntw + t, column block in0 + t of head
  // hl0 (counted forward in the loops, which divide nothing)
  const int hl0 = (q * ntw) / tpd, in0 = (q * ntw) % tpd;
  float acc[kMaxTilesPerWarp][4];
#pragma unroll
  for (int i = 0; i < kMaxTilesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int i = 0; i < n_slices; ++i) {
    cp_async_wait<kStages - 2>();  // slice i has landed
    __syncthreads();                // ... for every thread; slice i - 1 is free
    stage(i + kStages - 1);
    const bf16* buf = ring + (i % kStages) * ks * ldw;
    const int ksteps = min(ks, e_pad - i * ks) / 16;
    for (int kk = 0; kk < ksteps; ++kk) {
      const int e = i * ks + kk * 16;
      uint32_t a[4];
      int hl = hl0, in_head = in0, cur = -1;
#pragma unroll
      for (int t = 0; t < kMaxTilesPerWarp; ++t) {
        const int nt = q * ntw + t;
        if (t < ntw && nt < nvalid) {  // uniform across the warp
          if (hl != cur) {
            ldsm_x4(a, agg + (hl * R + mt * 16 + (lane & 15)) * lda + e + (lane >> 4) * 8);
            cur = hl;
          }
          uint32_t b[2];
          ldsm_x2_trans(b, buf + (kk * 16 + (lane & 15)) * ldw + nt * 8);
          mma_bf16(acc[t], a, b[0], b[1]);
        }
        if (++in_head == tpd) {
          in_head = 0;
          ++hl;
        }
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0, hl = hl0, in_head = in0; t < kMaxTilesPerWarp; ++t) {
    const int nt = q * ntw + t;
    if (t < ntw && nt < nvalid) {
      const int d = in_head * 8 + 2 * tq;
      const int64_t col = (int64_t)(h0 + hl) * D + d;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        if (r >= rows) continue;
        bf16* o = out + (s0 + r) * HD + col;
        if (out_pairs && d + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[t][2 * half], acc[t][2 * half + 1]);
        } else {
          if (d < D) o[0] = __float2bfloat16(acc[t][2 * half]);
          if (d + 1 < D) o[1] = __float2bfloat16(acc[t][2 * half + 1]);
        }
      }
    }
    if (++in_head == tpd) {
      in_head = 0;
      ++hl;
    }
  }
}

// ---- K4, f32 (exact FMA) ------------------------------------------------------
//
// Shared memory: alpha f32 [R][K][H], agg f32 [R][H][E].
__host__ __device__ inline int fwd_f32_smem(int R, int K, int E, int H) {
  return R * (K * H + H * E) * 4;
}

__global__ void __launch_bounds__(kThreads)
gat_fwd_f32_kernel(const float* __restrict__ x_n, const float* __restrict__ el,
                   const float* __restrict__ er3, const float* __restrict__ mask,
                   const float* __restrict__ w, float* __restrict__ out, int K, int64_t S, int E,
                   int H, int D, float slope, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t s0 = (int64_t)blockIdx.x * R;
  const int rows = (int)min((int64_t)R, S - s0);
  const int HD = H * D;
  float* alpha = reinterpret_cast<float*>(smem_raw);  // [rows][K][H]
  float* agg = alpha + R * K * H;                      // [rows][H][E]
  score_chain(el + s0 * H, er3 + s0 * H, mask + s0 * K, S * H, rows, K, H, slope, alpha,
              nullptr);
  __syncthreads();

  // agg[r][h][e] = sum_k alpha * x_n[k, s, e]: threads over (r, e), so a
  // warp reads one contiguous run of a row of x_n
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, e = i % E;
    const int64_t s = s0 + r;
    float acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = x_n[((int64_t)k * S + s) * E + e];
      const float* a = alpha + (r * K + k) * H;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) acc[h] += a[h] * x;
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < H) agg[(r * H + h) * E + e] = acc[h];
  }
  __syncthreads();

  // out[s, c] = sum_e agg[r][c / D][e] * w[e, c]: threads over columns, one
  // f32 sum per row in registers, each w element read once per tile
  for (int c = threadIdx.x; c < HD; c += blockDim.x) {
    const int h = c / D;
    float acc[kMaxRowsF32];
#pragma unroll
    for (int r = 0; r < kMaxRowsF32; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) {
      const float wv = w[(int64_t)e * HD + c];
#pragma unroll
      for (int r = 0; r < kMaxRowsF32; ++r)
        if (r < rows) acc[r] += agg[(r * H + h) * E + e] * wv;
    }
#pragma unroll
    for (int r = 0; r < kMaxRowsF32; ++r)
      if (r < rows) out[(s0 + r) * HD + c] = acc[r];
  }
}

// ---- K5 --------------------------------------------------------------------------

// Softmax and LeakyReLU backward for rows [s0, s0 + rows), from alpha, pre
// and d_alpha [r][k][h] in shared memory: d_pre = alpha (d_alpha - T) *
// leaky', T = sum_k alpha d_alpha; d_er3[k] = d_pre, d_el = sum_k d_pre.
__device__ void softmax_bwd(const float* alpha, const float* pre, const float* dal,
                            float* __restrict__ d_el, float* __restrict__ d_er3, int64_t S,
                            int64_t s0, int rows, int K, int H, float slope) {
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

// ---- K5 rows kernel, bf16 --------------------------------------------------------
//
// Shared memory, in order (ops/gat.py::gat_plan mirrors it):
//   alpha, pre f32 [R][K][H] each            (16-byte aligned ends)
//   dal  f32 [slots][R][K][H], after the score chain's staged inputs: with
//        slots = WE each column group of warps owns one copy (plain adds),
//        with slots = 1 they share it (shared-memory float atomics, which
//        compile to compare-and-swap loops)
//   gA   bf16 [H][R][ldg], ldg = d_pad + 8     (g's tile, the A operand)
//   ring bf16 [kBwdStages][EC][ldr], ldr = 16 H + 8  (W[e0:e0+EC, h D + 16 ds :
//                                                  +16] for every head h)
// with warps as WM = R / 16 row tiles by WE = 8 / WM column groups of 16,
// so one pass covers EC = 16 WE columns of E.
__host__ __device__ inline int bwd_bf16_chunk(int R) { return 16 * kWarps / (R / 16); }
__host__ __device__ inline int bwd_bf16_smem(int R, int K, int H, int d_pad, int slots) {
  const int dal = slots * R * K * H * 4, scores = score_stage_bytes(R, K, H);
  return 2 * align16(R * K * H * 4) + align16(dal > scores ? dal : scores) +
         align16(H * R * (d_pad + 8) * 2) + kBwdStages * bwd_bf16_chunk(R) * (16 * H + 8) * 2;
}

template <int kH>
__global__ void __launch_bounds__(kThreads, kH > 4 ? 1 : 2)
gat_bwd_bf16_kernel(const bf16* __restrict__ x_n, const float* __restrict__ el,
                    const float* __restrict__ er3, const float* __restrict__ mask,
                    const bf16* __restrict__ w, const bf16* __restrict__ g,
                    float* __restrict__ d_el, float* __restrict__ d_er3, bf16* __restrict__ dxn,
                    bf16* __restrict__ aggs, int K, int64_t S, int E, int H, int D, float slope,
                    int R, int d_pad, int slots, int pairs, int gran_w, int gran_g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t s0 = (int64_t)blockIdx.x * R;
  const int rows = (int)min((int64_t)R, S - s0);
  const int HD = H * D, KH = K * H;
  const int ldg = d_pad + 8, ldr = 16 * H + 8;
  const int EC = bwd_bf16_chunk(R);
  const int sc_bytes = align16(R * KH * 4);
  const int scores_bytes = score_stage_bytes(R, K, H);
  const int dal_bytes = align16(slots * R * KH * 4 > scores_bytes ? slots * R * KH * 4 : scores_bytes);
  float* alpha = reinterpret_cast<float*>(smem_raw);
  float* pre = reinterpret_cast<float*>(smem_raw + sc_bytes);
  float* dal = reinterpret_cast<float*>(smem_raw + 2 * sc_bytes);
  float* scores = dal;  // until the score chain has read them
  bf16* gA = reinterpret_cast<bf16*>(smem_raw + 2 * sc_bytes + dal_bytes);
  bf16* ring = gA + align16(H * R * ldg * 2) / 2;
  const int n_ds = d_pad / 16;
  const int n_chunks = (E + EC - 1) / EC;
  const int n_stages = n_chunks * n_ds;

  // stage j: the 16-deep slice ds of D of E-chunk c, every head; one
  // cp.async group per stage, empty past the last
  auto stage = [&](int j) {
    if (j < n_stages) {
      const int c = j / n_ds, ds = j % n_ds;
      const int e0 = c * EC;
      bf16* buf = ring + (j % kBwdStages) * EC * ldr;
      for (int h = 0; h < H; ++h)
        stage_tile(buf + h * 16, ldr, w + (int64_t)e0 * HD + (int64_t)h * D + ds * 16, HD,
                   min(EC, E - e0), min(16, D - ds * 16), EC, 16, gran_w);
    }
    cp_async_commit();
  };
  stage_scores(scores, el, er3, mask, S, s0, rows, R, K, H);
  cp_async_commit();
  for (int h = 0; h < H; ++h)  // g's tile joins stage 0's group
    stage_tile(gA + h * R * ldg, ldg, g + s0 * HD + (int64_t)h * D, HD, rows, D, R, d_pad, gran_g);
  for (int j = 0; j < kBwdStages - 1; ++j) stage(j);
  prefetch_rows_l2(x_n, S, s0, rows, K, E);
  cp_async_wait<kBwdStages - 1>();
  __syncthreads();
  score_chain(scores, scores + R * H, scores + R * H * (K + 1), R * H, rows, K, H, slope, alpha,
              pre);
  __syncthreads();
  for (int i = threadIdx.x; i < slots * R * KH; i += kThreads) dal[i] = 0.f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int WE = kWarps / (R / 16);
  const int wm = warp / WE, we = warp % WE;
  float* dal_w = dal + (slots > 1 ? we * R * KH : 0);  // this warp's copy of d_alpha
  const int g8 = lane >> 2, tq = lane & 3;
  const int rr[2] = {wm * 16 + g8, wm * 16 + g8 + 8};  // this thread's two rows
  const bool ok[2] = {rr[0] < rows, rr[1] < rows};
  const bool want_dx = dxn != nullptr;

  for (int c = 0; c < n_chunks; ++c) {
    // dagg[h][nt] = g_h @ W_h^T over rows 16 wm.. and columns e0 + 16 we +
    // 8 nt.. of E, f32 in mma's C layout: [2 half + j] = (row rr[half],
    // column eb + 8 nt + j)
    float dg[kH][2][4];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) dg[h][t][j] = 0.f;
    for (int ds = 0; ds < n_ds; ++ds) {
      const int j = c * n_ds + ds;
      cp_async_wait<kBwdStages - 2>();  // stage j has landed
      __syncthreads();                   // ... for every thread; stage j - 1 is free
      stage(j + kBwdStages - 1);
      const bf16* buf = ring + (j % kBwdStages) * EC * ldr;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        if (h < H) {
          uint32_t a[4], b[4];
          ldsm_x4(a, gA + (h * R + wm * 16 + (lane & 15)) * ldg + ds * 16 + (lane >> 4) * 8);
          ldsm_x4(b, buf + (we * 16 + (lane & 7) + 8 * (lane >> 4)) * ldr + h * 16 +
                         8 * ((lane >> 3) & 1));
          mma_bf16(dg[h][0], a, b[0], b[1]);
          mma_bf16(dg[h][1], a, b[2], b[3]);
        }
      }
    }

    // per slot k: x_k at the fragment's positions, read once, gives dxn,
    // this chunk's share of d_alpha and agg
    const int eb = c * EC + we * 16 + 2 * tq;
    float ag[kH][2][4];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) ag[h][t][j] = 0.f;
    // x_k at this thread's fragment positions, in the C layout
    auto load_x = [&](int k, float (&x)[2][4]) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t base = ((int64_t)k * S + s0 + rr[half]) * E;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int e = eb + 8 * t;
          float x0 = 0.f, x1 = 0.f;
          if (ok[half] && e < E) {
            const bf16* p = x_n + base + e;
            if (pairs) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
              x0 = f.x;
              x1 = f.y;
            } else {
              x0 = __bfloat162float(p[0]);
              if (e + 1 < E) x1 = __bfloat162float(p[1]);
            }
          }
          x[t][2 * half] = x0;
          x[t][2 * half + 1] = x1;
        }
      }
    };
    float xn[2][4];
    load_x(0, xn);
    for (int k = 0; k < K; ++k) {
      float x[2][4], a[2][kH];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[t][j] = xn[t][j];
      if (k + 1 < K) load_x(k + 1, xn);  // in flight through slot k's arithmetic
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          a[half][h] = ok[half] && h < H ? alpha[(rr[half] * K + k) * H + h] : 0.f;
      if (want_dx) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!ok[half]) continue;
          bf16* o = dxn + ((int64_t)k * S + s0 + rr[half]) * E;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int e = eb + 8 * t;
            if (e >= E) continue;
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int h = 0; h < kH; ++h) {
              v0 += a[half][h] * dg[h][t][2 * half];
              v1 += a[half][h] * dg[h][t][2 * half + 1];
            }
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(o + e) = __floats2bfloat162_rn(v0, v1);
            } else {
              o[e] = __float2bfloat16(v0);
              if (e + 1 < E) o[e + 1] = __float2bfloat16(v1);
            }
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          if (h < H) {  // uniform across the warp
            float p = 0.f;
#pragma unroll
            for (int t = 0; t < 2; ++t)
              p += x[t][2 * half] * dg[h][t][2 * half] + x[t][2 * half + 1] * dg[h][t][2 * half + 1];
            p += __shfl_xor_sync(0xffffffffu, p, 1);
            p += __shfl_xor_sync(0xffffffffu, p, 2);
            if (tq == 0 && ok[half]) {
              float* d = dal_w + (rr[half] * K + k) * H + h;
              if (slots > 1) *d += p;  // this lane alone adds here
              else atomicAdd(d, p);
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              ag[h][t][2 * half] += a[half][h] * x[t][2 * half];
              ag[h][t][2 * half + 1] += a[half][h] * x[t][2 * half + 1];
            }
          }
        }
      }
    }
    // agg_h for dW, rounded to w's dtype
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!ok[half]) continue;
      const int64_t s = s0 + rr[half];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        if (h >= H) continue;
        bf16* o = aggs + (s * H + h) * E;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int e = eb + 8 * t;
          if (e >= E) continue;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o + e) =
                __floats2bfloat162_rn(ag[h][t][2 * half], ag[h][t][2 * half + 1]);
          } else {
            o[e] = __float2bfloat16(ag[h][t][2 * half]);
            if (e + 1 < E) o[e + 1] = __float2bfloat16(ag[h][t][2 * half + 1]);
          }
        }
      }
    }
  }
  __syncthreads();
  if (slots > 1) {  // the copies' sum into copy 0
    for (int i = threadIdx.x; i < rows * KH; i += kThreads)
      for (int c = 1; c < slots; ++c) dal[i] += dal[c * R * KH + i];
    __syncthreads();
  }
  softmax_bwd(alpha, pre, dal, d_el, d_er3, S, s0, rows, K, H, slope);
}

// ---- K5 rows kernel, f32 (exact FMA) ----------------------------------------------
//
// Shared memory: alpha, pre, dal [R][K][H]; g [R][H*D]; dagg [R][H][E]; f32.
__host__ __device__ inline int bwd_f32_smem(int R, int K, int E, int H, int D) {
  return R * (3 * K * H + H * D + H * E) * 4;
}

__global__ void __launch_bounds__(kThreads)
gat_bwd_f32_kernel(const float* __restrict__ x_n, const float* __restrict__ el,
                   const float* __restrict__ er3, const float* __restrict__ mask,
                   const float* __restrict__ w, const float* __restrict__ g,
                   float* __restrict__ d_el, float* __restrict__ d_er3, float* __restrict__ dxn,
                   float* __restrict__ aggs, int K, int64_t S, int E, int H, int D, float slope,
                   int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t s0 = (int64_t)blockIdx.x * R;
  const int rows = (int)min((int64_t)R, S - s0);
  const int HD = H * D, KH = K * H;
  float* alpha = reinterpret_cast<float*>(smem_raw);  // [rows][K][H]
  float* pre = alpha + R * KH;                         // [rows][K][H]
  float* dal = pre + R * KH;                           // [rows][K][H]
  float* gs = dal + R * KH;                            // [rows][H*D]
  float* dagg = gs + R * HD;                           // [rows][H][E]
  score_chain(el + s0 * H, er3 + s0 * H, mask + s0 * K, S * H, rows, K, H, slope, alpha, pre);
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x)
    gs[i] = g[s0 * HD + i];  // the tile's rows are contiguous
  __syncthreads();

  // dagg[r][h][e] = sum_d g[r, hD + d] * w[e, hD + d]: threads over (h, e)
  for (int i = threadIdx.x; i < H * E; i += blockDim.x) {
    const int h = i / E, e = i % E;
    const float* wr = w + (int64_t)e * HD + h * D;
    float acc[kMaxRowsF32];
#pragma unroll
    for (int r = 0; r < kMaxRowsF32; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float wv = wr[d];
#pragma unroll
      for (int r = 0; r < kMaxRowsF32; ++r)
        if (r < rows) acc[r] += gs[r * HD + h * D + d] * wv;
    }
#pragma unroll
    for (int r = 0; r < kMaxRowsF32; ++r)
      if (r < rows) dagg[(r * H + h) * E + e] = acc[r];
  }

  // agg_h = sum_k alpha_kh x_k (f32 alpha, f32 sums), kept for dW
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, e = i % E;
    const int64_t s = s0 + r;
    float acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = x_n[((int64_t)k * S + s) * E + e];
      const float* a = alpha + (r * K + k) * H;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) acc[h] += a[h] * x;
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < H) aggs[(s * H + h) * E + e] = acc[h];
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
      const float x = x_n[base + e];
      float dx = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < H) {
          const float dg = dagg[(r * H + h) * E + e];
          part[h] += x * dg;
          dx += a[h] * dg;
        }
      }
      if (want_dx) dxn[base + e] = dx;
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
  softmax_bwd(alpha, pre, dal, d_el, d_er3, S, s0, rows, K, H, slope);
}

// ---- K5 dW kernels -----------------------------------------------------------------

// dW[e, h*D + d] += sum over this block's rows s of aggs[s, h, e] * g[s, h*D
// + d], bf16 on the tensor cores: A = agg^T (m = e, k = s) and B = g (k = s,
// n = d) both by ldmatrix.trans from a kStages-deep cp.async ring.
__global__ void __launch_bounds__(kThreads, 4)
gat_dw_bf16_kernel(const bf16* __restrict__ aggs, const bf16* __restrict__ g,
                   float* __restrict__ dw, int64_t S, int E, int H, int D, int64_t s_chunk,
                   int gran_a, int gran_g) {
  __shared__ __align__(16) bf16 As[kStages][kTileS][kDwLd];
  __shared__ __align__(16) bf16 Bs[kStages][kTileS][kDwLd];
  const int HD = H * D;
  const int d_tiles = (D + kTileD - 1) / kTileD;
  const int e0 = blockIdx.x * kTileE;
  const int h = blockIdx.y / d_tiles;
  const int d0 = (blockIdx.y % d_tiles) * kTileD;
  const int64_t s_begin = (int64_t)blockIdx.z * s_chunk;
  const int64_t s_end = min(S, s_begin + s_chunk);
  const int steps = (int)((s_end - s_begin + kTileS - 1) / kTileS);
  auto stage = [&](int i) {  // one cp.async group per step, empty past the last
    if (i < steps) {
      const int64_t st = s_begin + (int64_t)i * kTileS;
      const int nr = (int)min((int64_t)kTileS, s_end - st);
      stage_tile(&As[i % kStages][0][0], kDwLd, aggs + (st * H + h) * E + e0, (int64_t)H * E,
                 nr, min(kTileE, E - e0), kTileS, kTileE, gran_a);
      stage_tile(&Bs[i % kStages][0][0], kDwLd, g + st * HD + (int64_t)h * D + d0, HD, nr,
                 min(kTileD, D - d0), kTileS, kTileD, gran_g);
    }
    cp_async_commit();
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp >> 1, nb = (warp & 1) * 4;  // rows 16 mt of e, n-tiles nb..nb+3 of d
  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
  for (int i = 0; i < kStages - 1; ++i) stage(i);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();  // step i has landed
    __syncthreads();                // ... for every thread; step i - 1 is free
    stage(i + kStages - 1);
    const int b = i % kStages;
#pragma unroll
    for (int kk = 0; kk < kTileS / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_trans(a, &As[b][kk * 16 + (lane & 7) + 8 * (lane >> 4)][mt * 16 + 8 * ((lane >> 3) & 1)]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, &Bs[b][kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)][(nb + 2 * p) * 8 + 8 * (lane >> 4)]);
        mma_bf16(acc[2 * p], a, bb[0], bb[1]);
        mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
      }
    }
  }
  const int g8 = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int d = d0 + (nb + t) * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = e0 + mt * 16 + g8 + 8 * half;
      if (e >= E) continue;
      float* o = dw + (int64_t)e * HD + (int64_t)h * D;
      if (d < D) atomicAdd(o + d, acc[t][2 * half]);
      if (d + 1 < D) atomicAdd(o + d + 1, acc[t][2 * half + 1]);
    }
  }
}

// The same product in f32 with exact FMA: a 4x4 register tile per thread.
__global__ void __launch_bounds__(kThreads)
gat_dw_f32_kernel(const float* __restrict__ aggs, const float* __restrict__ g,
                  float* __restrict__ dw, int64_t S, int E, int H, int D, int64_t s_chunk) {
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
      As[ss][col] = row_ok && e < E ? aggs[(s * H + h) * E + e] : 0.f;
      Bs[ss][col] = row_ok && d < D ? g[s * HD + h * D + d] : 0.f;
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

// ---- launchers -------------------------------------------------------------------

int round16(int x) { return (x + 15) / 16 * 16; }

// The largest of 16, 8, 4 bytes that aligns p and every stride in a, b; 2
// when none does (bf16 rows or heads that start at an odd element).
int gran_of(const void* p, int64_t a, int64_t b) {
  const uint64_t v = (uint64_t)(uintptr_t)p | (uint64_t)a | (uint64_t)b;
  int gr = 16;
  while (gr > 2 && v % gr != 0) gr /= 2;
  return gr;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool shape_ok(int K, int64_t S, int E, int H, int D) {
  return K > 0 && K <= kMaxK && S > 0 && E > 0 && E <= kMaxE && H > 0 && H <= kMaxHeads &&
         D > 0;
}

constexpr int kInvalid = (int)cudaErrorInvalidValue;

int launch_fwd_bf16(const bf16* x_n, const float* el, const float* er3, const float* mask,
                    const bf16* w, bf16* out, int K, int64_t S, int E, int H, int D, float slope,
                    int R, int hc, int e_pad, int d_pad, int ks, int smem, int grid_x,
                    int grid_y, cudaStream_t st) {
  if ((R != 16 && R != 32 && R != 64) || hc < 1 || hc > H || e_pad != round16(E) ||
      d_pad != round16(D) || ks < 16 || ks % 16 != 0 || ks > e_pad ||
      grid_y != (H + hc - 1) / hc || (int64_t)grid_x * R < S || (int64_t)(grid_x - 1) * R >= S ||
      smem != fwd_bf16_smem(R, K, H, hc, e_pad, d_pad, ks))
    return kInvalid;
  const int wpm = kWarps / (R / 16);
  if ((hc * d_pad / 8 + wpm - 1) / wpm > kMaxTilesPerWarp) return kInvalid;
  int vec = 4;  // 8 would need 64 registers of sums for 8 heads
  while (vec > 1 && (E % vec != 0 || (uintptr_t)x_n % (2 * vec) != 0)) vec /= 2;
  const int rc = allow_smem(gat_fwd_bf16_kernel, smem);
  if (rc != 0) return rc;
  gat_fwd_bf16_kernel<<<dim3(grid_x, grid_y), kThreads, smem, st>>>(
      x_n, el, er3, mask, w, out, K, S, E, H, D, slope, R, hc, e_pad, d_pad, ks, vec,
      gran_of(w, 2 * (int64_t)H * D, 2 * (int64_t)D), D % 2 == 0 && (uintptr_t)out % 4 == 0);
  return (int)cudaGetLastError();
}

int launch_fwd_f32(const float* x_n, const float* el, const float* er3, const float* mask,
                   const float* w, float* out, int K, int64_t S, int E, int H, int D, float slope,
                   int R, int hc, int smem, int grid_x, int grid_y, cudaStream_t st) {
  if (R < 1 || R > kMaxRowsF32 || hc != H || grid_y != 1 || (int64_t)grid_x * R < S ||
      (int64_t)(grid_x - 1) * R >= S || smem != fwd_f32_smem(R, K, E, H))
    return kInvalid;
  const int rc = allow_smem(gat_fwd_f32_kernel, smem);
  if (rc != 0) return rc;
  gat_fwd_f32_kernel<<<grid_x, kThreads, smem, st>>>(x_n, el, er3, mask, w, out, K, S, E, H, D,
                                                      slope, R);
  return (int)cudaGetLastError();
}

template <int kH>
int launch_bwd_rows_bf16(const bf16* x_n, const float* el, const float* er3, const float* mask,
                         const bf16* w, const bf16* g, float* d_el, float* d_er3, bf16* dxn,
                         bf16* aggs, int K, int64_t S, int E, int H, int D, float slope, int R,
                         int d_pad, int slots, int smem, int grid_x, cudaStream_t st) {
  const int pairs = E % 2 == 0 && (uintptr_t)x_n % 4 == 0 && (uintptr_t)aggs % 4 == 0 &&
                    (dxn == nullptr || (uintptr_t)dxn % 4 == 0);
  const int rc = allow_smem(gat_bwd_bf16_kernel<kH>, smem);
  if (rc != 0) return rc;
  gat_bwd_bf16_kernel<kH><<<grid_x, kThreads, smem, st>>>(
      x_n, el, er3, mask, w, g, d_el, d_er3, dxn, aggs, K, S, E, H, D, slope, R, d_pad, slots, pairs,
      gran_of(w, 2 * (int64_t)H * D, 2 * (int64_t)D), gran_of(g, 2 * (int64_t)H * D, 2 * (int64_t)D));
  return (int)cudaGetLastError();
}

bool dw_ok(int64_t S, int splits, int64_t s_chunk) {
  return splits >= 1 && s_chunk > 0 && s_chunk % kTileS == 0 && splits * s_chunk >= S &&
         (splits - 1) * s_chunk < S;
}

dim3 dw_grid(int E, int H, int D, int splits) {
  return dim3((E + kTileE - 1) / kTileE, H * ((D + kTileD - 1) / kTileD), splits);
}

int launch_bwd_bf16(const bf16* x_n, const float* el, const float* er3, const float* mask,
                    const bf16* w, const bf16* g, float* dw, float* d_el, float* d_er3,
                    bf16* dxn, bf16* aggs, int K, int64_t S, int E, int H, int D, float slope,
                    int R, int d_pad, int slots, int smem, int grid_x, int splits,
                    int64_t s_chunk, cudaStream_t st) {
  if ((R != 16 && R != 32 && R != 64) || d_pad != round16(D) || (int64_t)grid_x * R < S ||
      (int64_t)(grid_x - 1) * R >= S || (slots != 1 && slots != bwd_bf16_chunk(R) / 16) ||
      smem != bwd_bf16_smem(R, K, H, d_pad, slots) || !dw_ok(S, splits, s_chunk))
    return kInvalid;
  // the rows kernel keeps H heads' dagg and agg in registers: instantiated
  // for 1, 2, 4 and 8 heads at most
  auto* rows = H <= 1   ? launch_bwd_rows_bf16<1>
               : H <= 2 ? launch_bwd_rows_bf16<2>
               : H <= 4 ? launch_bwd_rows_bf16<4>
                        : launch_bwd_rows_bf16<8>;
  const int rc = rows(x_n, el, er3, mask, w, g, d_el, d_er3, dxn, aggs, K, S, E, H, D, slope, R,
                      d_pad, slots, smem, grid_x, st);
  if (rc != 0) return rc;
  gat_dw_bf16_kernel<<<dw_grid(E, H, D, splits), kThreads, 0, st>>>(
      aggs, g, dw, S, E, H, D, s_chunk, gran_of(aggs, 2 * (int64_t)E, 0),
      gran_of(g, 2 * (int64_t)H * D, 2 * (int64_t)D));
  return (int)cudaGetLastError();
}

int launch_bwd_f32(const float* x_n, const float* el, const float* er3, const float* mask,
                   const float* w, const float* g, float* dw, float* d_el, float* d_er3,
                   float* dxn, float* aggs, int K, int64_t S, int E, int H, int D, float slope,
                   int R, int smem, int grid_x, int splits, int64_t s_chunk, cudaStream_t st) {
  if (R < 1 || R > kMaxRowsF32 || (int64_t)grid_x * R < S || (int64_t)(grid_x - 1) * R >= S ||
      smem != bwd_f32_smem(R, K, E, H, D) || !dw_ok(S, splits, s_chunk))
    return kInvalid;
  int rc = allow_smem(gat_bwd_f32_kernel, smem);
  if (rc != 0) return rc;
  gat_bwd_f32_kernel<<<grid_x, kThreads, smem, st>>>(x_n, el, er3, mask, w, g, d_el, d_er3, dxn,
                                                      aggs, K, S, E, H, D, slope, R);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  gat_dw_f32_kernel<<<dw_grid(E, H, D, splits), kThreads, 0, st>>>(aggs, g, dw, S, E, H, D,
                                                                    s_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4.  dtype 0 = float32, 1 = bfloat16 (of x_n, w and out).  The plan
// (rows, heads per block, padded E and D, rows of W per stage,
// shared-memory bytes, grid) is
// ops/gat.py::gat_plan's; a plan that disagrees with this source's layout
// is refused with cudaErrorInvalidValue before any launch.
int dg_gat_fwd(const void* x_n, const float* el, const float* er3, const float* mask,
               const void* w, void* out, int K, int64_t S, int E, int H, int D, float slope,
               int dtype, int rows, int heads_per_block, int e_pad, int d_pad, int w_rows,
               int smem, int grid_x, int grid_y, void* stream) {
  if (!shape_ok(K, S, E, H, D)) return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd_f32(static_cast<const float*>(x_n), el, er3, mask,
                            static_cast<const float*>(w), static_cast<float*>(out), K, S, E, H,
                            D, slope, rows, heads_per_block, smem, grid_x, grid_y, st);
    case 1:
      return launch_fwd_bf16(static_cast<const bf16*>(x_n), el, er3, mask,
                             static_cast<const bf16*>(w), static_cast<bf16*>(out), K, S, E, H, D,
                             slope, rows, heads_per_block, e_pad, d_pad, w_rows, smem, grid_x,
                             grid_y, st);
    default:
      return kInvalid;
  }
}

// K5.  w [E, H*D] as K4 takes it; dw a zeroed f32 [E, H*D]; aggs a scratch
// [S, H, E] in the dtype; dxn [K, S, E] or null to skip d_x.  The plan as
// for K4, plus the copies of d_alpha (dal_slots) and the dW kernel's split
// of S (dw_splits chunks of dw_s_chunk rows).
int dg_gat_bwd(const void* x_n, const float* el, const float* er3, const float* mask,
               const void* w, const void* g, float* dw, float* d_el, float* d_er3, void* dxn,
               void* aggs, int K, int64_t S, int E, int H, int D, float slope, int dtype,
               int rows, int d_pad, int dal_slots, int smem, int grid_x, int dw_splits,
               int64_t dw_s_chunk, void* stream) {
  if (!shape_ok(K, S, E, H, D)) return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd_f32(static_cast<const float*>(x_n), el, er3, mask,
                            static_cast<const float*>(w), static_cast<const float*>(g), dw,
                            d_el, d_er3, static_cast<float*>(dxn), static_cast<float*>(aggs), K,
                            S, E, H, D, slope, rows, smem, grid_x, dw_splits, dw_s_chunk, st);
    case 1:
      return launch_bwd_bf16(static_cast<const bf16*>(x_n), el, er3, mask,
                             static_cast<const bf16*>(w), static_cast<const bf16*>(g), dw, d_el,
                             d_er3, static_cast<bf16*>(dxn), static_cast<bf16*>(aggs), K, S, E,
                             H, D, slope, rows, d_pad, dal_slots, smem, grid_x, dw_splits,
                             dw_s_chunk, st);
    default:
      return kInvalid;
  }
}

}  // extern "C"
