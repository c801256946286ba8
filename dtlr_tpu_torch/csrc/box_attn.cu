// Multi-head attention forward with the Gaussian box prior fused in, for
// Hopper (sm_90a). Port of the Pallas kernels `_mha_box_kernel` (prior) and
// `_mha_kernel` (key bias only) of dtlr_tpu/ops/flash_attn.py.
//
//   out[b,m,q,:] = softmax_s( q.k_s / sqrt(D) - gamma_m/2 * d2(q,s) + key_bias[b,s] ) . v_s
//   d2 = ((px_s - cx_l) * ihw_l)^2 + ((py_s - cy_l) * ihh_l)^2,  l = level of key s
//
// Two kernels, chosen by the inputs' type; each has a prior and a no-prior
// instantiation, and the no-prior one a masked instantiation as well.
//
// The mask (the self-attention of a detection training step): the
// contrastive denoising (CDN) queries go before the 900 matching queries,
// and the matching queries may not see them, nor one denoising group
// another. It arrives as one int32 group per query, used for rows and keys
// alike (Q = S): a score (row r, key c) is blocked when g[c] >= 0 and
// g[c] != g[r] (dtlr_tpu_torch/models/cdn.py). This replaces, besides
// `_mha_kernel` (dtlr_tpu/ops/flash_attn.py:174, launched :267), the
// materialized masked attention JAX runs there, with its (Q, Q) scores and
// jnp.where(blocked, finfo.min, logits) (dtlr_tpu/models/layers.py:184-195).
// What it costs: the key groups ride the cp.async ring beside key_bias (4
// bytes a key); a warp reads its tile's 64 key groups once and decides: a
// tile whose keys all carry -1 (every matching key) runs the unmasked
// code; a tile whose keys all carry one group that none of the warp's 16
// rows has is skipped outright (the 900 matching rows never touch the
// 128-query denoising prefix's tiles); any other tile pays one compare and
// one select per score (a blocked score becomes -inf, whose exponent is 0;
// the running max starts at a finite -1e30, so a row whose whole tile is
// blocked rescales by 1 and stays finite). What bounds it is what bounds the
// unmasked kernel, the per-score work, over the pairs it computes: at the
// detection step's Q = S = 1028 with one group of 128, 89% of the pairs. No
// (Q, Q) tensor exists: at D=32 the per-score instructions set the time, and
// a byte mask would add a load per score. A null group pointer selects the
// unmasked instantiations, whose code is unchanged.
//
// bf16 inputs (the recipe's compute dtype, the main path): tensor cores.
// What bounds it on this card: at the decoder's shapes (B=8, M=8, Q=900,
// S=2720, D=32) there are 156.7 M scores. Their two products take 0.020 ms
// on the tensor cores at 989 TFLOP/s, but every score also needs about ten
// fp32 instructions on the CUDA cores (scale, bias, prior, max, exponent
// argument, row sum: 0.04-0.05 ms at 33.5 T lane-ops/s) and one ex2 on the
// SFU (16 per SM per clock: 0.04 ms). So at D=32 the kernel is bound by the
// per-score CUDA-core and SFU work, not by the matrix products or the bytes.
// What the design does about it:
// - q.k^T and p.v run as mma.sync.m16n8k16 bf16 products with fp32
//   accumulators (K fragments by ldmatrix, V by ldmatrix.trans). p stays in
//   registers: the C fragment of the scores becomes the A fragment of p.v,
//   as in FlashAttention-2. A fifth n-tile multiplies p by a column of ones,
//   so the tensor cores also take the row sums.
// - What is left per score on the CUDA cores is eight instructions: five
//   FMAs for the logit (scale and bias, then the prior as two FMAs that form
//   the offsets from per-(query, level) constants in registers and two that
//   subtract their squares), one max, the exponent's FMA (log2(e) folded
//   in) and an ex2 on the SFU, plus half a bf16 pack.
// - The softmax is online per 64-key tile: row maxima by a tree and two quad
//   shuffles, one rescale of the accumulator per tile.
// - K, V and the per-key fields arrive through a two-stage cp.async ring,
//   so loads overlap the math; eight warps (128 queries) share each tile.
// mma.sync rather than wgmma: at D=32 the products are a fifth of the
// floor, and mma.sync keeps the scores in the layout the softmax needs
// without a shared-memory round trip. What holds it at about four times
// the floor is not one saturated unit (by instruction counts neither the
// issue slots, the SFU nor the tensor cores should be) but stalls between
// them, with 16 warps of at most 128 registers per SM. A deeper ring, 4
// warps, 32-key softmax steps (fewer registers, up to 20 warps), or
// issuing the next tile's q.k^T before this tile's softmax (more
// registers, fewer warps) each measured slower.
//
// fp32 inputs (--compute_dtype float32): CUDA cores, fp32 products (its
// 1e-4 tolerance rules out bf16 or TF32 products). Bound by operations:
// 2*B*M*Q*S*(2D+8) = 22.6 GFLOP at S=2720 against 67 TFLOP/s. Each key row
// is read from shared memory once per warp as float4 broadcasts and used
// for two queries per thread.
//
// Layout: q, k, v and out are indexed through the element strides of their
// batch, head and row axes (unit stride on D), so the decoder passes its
// projections' (B, S, M, D) views and an output laid out as (B, Q, M, D)
// without copies. The ragged last key tile is masked by its length;
// queries past Q are computed from zeros and never stored. A key's level
// comes from an int32 level id; nothing assumes that levels start on a
// tile boundary.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 32;     // head dimension
constexpr int MAX_L = 8;  // most feature levels the prior takes

struct Strides {  // element strides of the batch, head and row axes
  long long b, m, r;
};
struct Layout {
  Strides q, k, v, out;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int WARPS = 4;          // each warp takes BK / WARPS keys of a tile
constexpr int THREADS = WARPS * 32;
constexpr int QPT = BQ / 32;      // queries per thread
constexpr int KPW = BK / WARPS;   // keys per warp per tile

// One block per (64-query tile, head m, batch b). Its four warps split each
// 64-key tile into four runs of 16 keys; every lane holds two queries
// (lane, lane + 32) with their running max, normalizer and accumulator in
// registers. The warps' partial softmaxes are merged in shared memory in a
// fixed order.
template <bool PRIOR, bool MASK>
__global__ void __launch_bounds__(THREADS)
box_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ key_bias,
                    const float* __restrict__ cx, const float* __restrict__ cy,
                    const float* __restrict__ ihw, const float* __restrict__ ihh,
                    const int* __restrict__ level, const float* __restrict__ px,
                    const float* __restrict__ py, const float* __restrict__ gamma,
                    const int* __restrict__ group, float* __restrict__ out, Layout lay, int Q,
                    int S, int L, float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float kbias[BK];
  __shared__ float kpx[BK];
  __shared__ float kpy[BK];
  __shared__ int klvl[BK];
  __shared__ int kgrp[MASK ? BK : 1];
  __shared__ float box[PRIOR ? MAX_L * 4 : 1][BQ];  // [level*4 + {cx,cy,ihw,ihh}][query]
  __shared__ float part_max[WARPS][BQ];
  __shared__ float part_sum[WARPS][BQ];
  __shared__ float out_tile[BQ][D + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const float* qg = q + b * lay.q.b + m * lay.q.m;
  const float* kg = k + b * lay.k.b + m * lay.k.m;
  const float* vg = v + b * lay.v.b + m * lay.v.m;
  const int k_r = (int)lay.k.r, v_r = (int)lay.v.r;  // rows span < 2^31 elements
  const float* kbg = key_bias + (size_t)b * S;

  float qr[QPT][D];
  float acc[QPT][D];
  float run_max[QPT];
  float run_sum[QPT];
  int qgrp[QPT];  // the rows' CDN groups (MASK)
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = q0 + lane + 32 * i;
    if constexpr (MASK) qgrp[i] = qi < Q ? group[qi] : -2;
    const float* qrow = qg + (qi < Q ? qi : 0) * lay.q.r;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[i][d] = qi < Q ? qrow[d] * scale : 0.f;
      acc[i][d] = 0.f;
    }
    run_max[i] = -1e30f;
    run_sum[i] = 0.f;
  }

  float half_gamma = 0.f;
  if constexpr (PRIOR) {
    half_gamma = 0.5f * gamma[m];
    for (int t = tid; t < L * 4 * BQ; t += THREADS) {
      const int qq = t % BQ;
      const int p = (t / BQ) % 4;
      const int l = t / (4 * BQ);
      const int qi = q0 + qq;
      const float* src = p == 0 ? cx : p == 1 ? cy : p == 2 ? ihw : ihh;
      // queries past Q get a finite box: their rows are never written
      box[l * 4 + p][qq] = qi < Q ? src[((size_t)b * Q + qi) * L + l] : 1.f;
    }
  }

  for (int s0 = 0; s0 < S; s0 += BK) {
    const int n = min(BK, S - s0);
    __syncthreads();  // the previous tile is consumed (and the box is staged)
    for (int t = tid; t < n * (D / 4); t += THREADS) {  // rows are 16-byte aligned
      const int j = t / (D / 4), d = 4 * (t % (D / 4));
      *reinterpret_cast<float4*>(&ks[j][d]) =
          *reinterpret_cast<const float4*>(kg + ((s0 + j) * k_r + d));
      *reinterpret_cast<float4*>(&vs[j][d]) =
          *reinterpret_cast<const float4*>(vg + ((s0 + j) * v_r + d));
    }
    for (int t = tid; t < n; t += THREADS) {
      kbias[t] = kbg[s0 + t];
      if constexpr (MASK) kgrp[t] = group[s0 + t];
      if constexpr (PRIOR) {
        kpx[t] = px[s0 + t];
        kpy[t] = py[s0 + t];
        klvl[t] = level[s0 + t];
      }
    }
    __syncthreads();

    const int j_end = min((warp + 1) * KPW, n);
    for (int j = warp * KPW; j < j_end; ++j) {
      const float4* krow = reinterpret_cast<const float4*>(ks[j]);
      float s[QPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) s[i] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = krow[d4];
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          s[i] = fmaf(qr[i][4 * d4 + 0], kk.x, s[i]);
          s[i] = fmaf(qr[i][4 * d4 + 1], kk.y, s[i]);
          s[i] = fmaf(qr[i][4 * d4 + 2], kk.z, s[i]);
          s[i] = fmaf(qr[i][4 * d4 + 3], kk.w, s[i]);
        }
      }
      if constexpr (PRIOR) {
        const int l4 = klvl[j] * 4;
        const float pxj = kpx[j];
        const float pyj = kpy[j];
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const int qq = lane + 32 * i;
          const float dx = (pxj - box[l4 + 0][qq]) * box[l4 + 2][qq];
          const float dy = (pyj - box[l4 + 1][qq]) * box[l4 + 3][qq];
          s[i] -= half_gamma * (dx * dx + dy * dy);
        }
      }
      const float bias = kbias[j];
      const float4* vrow = reinterpret_cast<const float4*>(vs[j]);
      int gk = -1;
      if constexpr (MASK) gk = kgrp[j];
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        float si = s[i] + bias;
        if (MASK && gk >= 0 && gk != qgrp[i]) si = -INFINITY;  // exp gives 0
        if (si > run_max[i]) {  // new running max: rescale what was summed
          const float a = __expf(run_max[i] - si);
          run_sum[i] *= a;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[i][d] *= a;
          run_max[i] = si;
        }
        const float p = __expf(si - run_max[i]);
        run_sum[i] += p;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vrow[d4];
          acc[i][4 * d4 + 0] = fmaf(p, vv.x, acc[i][4 * d4 + 0]);
          acc[i][4 * d4 + 1] = fmaf(p, vv.y, acc[i][4 * d4 + 1]);
          acc[i][4 * d4 + 2] = fmaf(p, vv.z, acc[i][4 * d4 + 2]);
          acc[i][4 * d4 + 3] = fmaf(p, vv.w, acc[i][4 * d4 + 3]);
        }
      }
    }
  }

  // merge the warps' partial softmaxes, in warp order
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    part_max[warp][lane + 32 * i] = run_max[i];
    part_sum[warp][lane + 32 * i] = run_sum[i];
  }
  __syncthreads();
  float factor[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qq = lane + 32 * i;
    float mall = part_max[0][qq];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mall = fmaxf(mall, part_max[w][qq]);
    float lall = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) lall += part_sum[w][qq] * __expf(part_max[w][qq] - mall);
    factor[i] = __expf(run_max[i] - mall) / lall;
  }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qq = lane + 32 * i;
#pragma unroll
        for (int d = 0; d < D; ++d)
          out_tile[qq][d] = (w == 0 ? 0.f : out_tile[qq][d]) + acc[i][d] * factor[i];
      }
    }
    __syncthreads();
  }
  float* og = out + b * lay.out.b + m * lay.out.m;
  const int rows = min(BQ, Q - q0);
  for (int t = tid; t < rows * D; t += THREADS)
    og[(q0 + t / D) * lay.out.r + t % D] = out_tile[t / D][t % D];
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

// 8 warps x 16 rows share each staged K/V tile; two such blocks of at most
// 128 registers a thread fill an SM. Measured on the H100 against 4 warps
// x 64 queries and against 3- and 4-stage rings: 5% faster at S = 2720,
// the same at S = 900.
constexpr int WARPS = 8;
constexpr int BQ = 16 * WARPS;       // queries per block: 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 2;        // blocks per SM the registers must allow
constexpr int BK = 64;               // keys per ring stage and softmax step
constexpr int STAGES = 2;            // cp.async ring depth
constexpr int NT = BK / 8;           // n-tiles of 8 keys in the score fragment
constexpr int KROW = D + 8;          // shared row of 80 bytes: the 8 rows an
                                     // ldmatrix phase reads hit 8 distinct
                                     // 16-byte bank groups
constexpr float LOG2E = 1.4426950408889634f;

// One ring stage: a tile of K and V rows and the tile's per-key fields,
// the latter packed by key pair (2i, 2i+1) as one thread reads them.
struct __align__(16) Stage {
  __nv_bfloat16 k[BK][KROW];
  __nv_bfloat16 v[BK][KROW];
  float4 pxy[BK / 2];  // {px(2i), px(2i+1), py(2i), py(2i+1)}
  float2 kb[BK / 2];   // key_bias
  int2 lvl[BK / 2];    // level id
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies; a false predicate fills zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Queue the copies of key tile [s0, s0 + BK) into a stage. A whole tile
// copies unpredicated, from 32-bit offsets off the tile's first row (row
// offsets within one (batch, head) are 32-bit: the wrapper refuses an
// operand whose rows span 2^31 elements or more). In the RAGGED last tile
// keys past S are zero-filled from the tile's first row (their scores are
// masked, and zero V rows keep 0 * V finite).
static_assert(BK * 4 % THREADS == 0, "whole 16-byte chunks of K and V per thread");
template <bool PRIOR, bool MASK, bool RAGGED>
__device__ __forceinline__ void load_tile(Stage& st, int2* grp, const __nv_bfloat16* kg,
                                          const __nv_bfloat16* vg, int k_r, int v_r,
                                          const float* kbg, const float* px, const float* py,
                                          const int* level, const int* group, int s0, int S,
                                          int tid) {
  const __nv_bfloat16* kt = kg + s0 * k_r;
  const __nv_bfloat16* vt = vg + s0 * v_r;
#pragma unroll
  for (int n = 0; n < BK * 4 / THREADS; ++n) {  // 64 rows x 4 chunks of 16 bytes
    const int c = tid + n * THREADS;
    const int j = c >> 2, ch = c & 3;
    const bool ok = !RAGGED || s0 + j < S;
    const int r = ok ? j : 0;
    cp_async16(&st.k[j][ch * 8], kt + (r * k_r + ch * 8), ok);
    cp_async16(&st.v[j][ch * 8], vt + (r * v_r + ch * 8), ok);
  }
  if (tid < BK) {  // per-key fields: 4-byte copies (key_bias rows are not 16-byte aligned)
    const int j = tid;
    const bool ok = !RAGGED || s0 + j < S;
    const int s = ok ? s0 + j : s0;
    cp_async4(reinterpret_cast<float*>(st.kb) + j, kbg + s, ok);
    if constexpr (MASK) cp_async4(reinterpret_cast<int*>(grp) + j, group + s, ok);
    if constexpr (PRIOR) {
      float* pxy = reinterpret_cast<float*>(st.pxy) + (j >> 1) * 4 + (j & 1);
      cp_async4(pxy, px + s, ok);
      cp_async4(pxy + 2, py + s, ok);
      cp_async4(reinterpret_cast<int*>(st.lvl) + j, level + s, ok);
    }
  }
}

// The logits of one tile in natural units, as dense_reference forms them:
// s * scale + key_bias - gamma/2 * d2. d2's two squares come from
// per-(query, level) constants c = {ax, ax*cx, ay, ay*cy}, ax =
// sqrt(|gamma/2|) * ihw, and are subtracted by two FMAs (added where gamma
// < 0: NEG). ONE_LEVEL: every key of the tile lies in one level, whose
// constants the caller holds in registers (ca, cb for the rows r0, r0 + 8);
// otherwise each key looks up its own level's.
template <bool PRIOR, bool RAGGED, bool ONE_LEVEL, bool NEG>
__device__ __forceinline__ void tile_logits(float (&sc)[NT][4], const Stage& st,
                                            const float4* box, float4 ca, float4 cb, int r0,
                                            int tq, int s0, int S, float scale) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int i = j * 4 + tq;  // this thread's key pair (2i, 2i+1) in the tile
    const float2 kb = st.kb[i];
    float4 pp = make_float4(0.f, 0.f, 0.f, 0.f);
    int2 lv = make_int2(0, 0);
    if constexpr (PRIOR) {
      pp = st.pxy[i];
      if constexpr (!ONE_LEVEL) lv = st.lvl[i];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e & 1;    // key 2i + hi
      const int row = e >> 1;  // row r0 + 8 * row
      float t = fmaf(sc[j][e], scale, hi ? kb.y : kb.x);
      if constexpr (PRIOR) {
        float4 c = row ? cb : ca;
        if constexpr (!ONE_LEVEL) c = box[(hi ? lv.y : lv.x) * BQ + r0 + 8 * row];
        const float u = fmaf(hi ? pp.y : pp.x, c.x, -c.y);
        const float w = fmaf(hi ? pp.w : pp.z, c.z, -c.w);
        t = fmaf(NEG ? u : -u, u, t);
        t = fmaf(NEG ? w : -w, w, t);
      }
      if (RAGGED && s0 + 2 * i + hi >= S) t = -INFINITY;
      sc[j][e] = t;
    }
  }
}

// One 64-key tile (keys s0..) for this warp's 16 rows: S = Q K^T, logits,
// online softmax, O += P V. The fifth n-tile of O multiplies P by a column
// of ones: the row sums of the bf16 probabilities, the same ones P.V sums.
template <bool PRIOR, bool RAGGED, bool NEG, bool MASK>
__device__ __forceinline__ void tile_step(const Stage& st, const float4* box, const int2* grp,
                                          int ga, int gb, const uint32_t (&qf)[2][4],
                                          float (&o)[5][4], float (&mrow)[2], float (&mlog)[2],
                                          int lane, int r0, int s0, int S, float scale) {
  const int tq = lane & 3;
  float sc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    uint32_t kf[4];  // keys j*8..j*8+7, dims 0-7, 8-15, 16-23, 24-31
    ldmatrix_x4(kf, &st.k[j * 8 + (lane & 7)][(lane >> 3) * 8]);
    mma_bf16(sc[j], qf[0], kf[0], kf[1]);
    mma_bf16(sc[j], qf[1], kf[2], kf[3]);
  }

  const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (PRIOR) {
    // the warp checks the tile's 64 levels (two per lane) against its first
    const int ref = st.lvl[0].x;
    const int2 lv = st.lvl[lane];
    const int k0 = s0 + 2 * lane;
    const bool same = (lv.x == ref || (RAGGED && k0 >= S)) &&
                      (lv.y == ref || (RAGGED && k0 + 1 >= S));
    if (__all_sync(0xffffffffu, same))
      tile_logits<PRIOR, RAGGED, true, NEG>(sc, st, box, box[ref * BQ + r0],
                                            box[ref * BQ + r0 + 8], r0, tq, s0, S, scale);
    else
      tile_logits<PRIOR, RAGGED, false, NEG>(sc, st, box, none, none, r0, tq, s0, S, scale);
  } else {
    tile_logits<PRIOR, RAGGED, true, NEG>(sc, st, box, none, none, r0, tq, s0, S, scale);
  }
  if constexpr (MASK) {
    // blocked where the key's group is >= 0 and not the row's (ga for row
    // r0, gb for r0 + 8): -inf, whose exponent below is 0
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int2 gk = grp[j * 4 + tq];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = (e & 1) ? gk.y : gk.x;
        if (g >= 0 && g != ((e >> 1) ? gb : ga)) sc[j][e] = -INFINITY;
      }
    }
  }

  // row maxima: a tree over this lane's 16 scores of each row, then over
  // the quad that shares the row; one rescale per tile
  float alpha[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) a[j] = fmaxf(sc[j][2 * row], sc[j][2 * row + 1]);
#pragma unroll
    for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
    float mx = fmaxf(a[0], __shfl_xor_sync(0xffffffffu, a[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mnew = fmaxf(mrow[row], mx);
    const float mlnew = mnew * LOG2E;
    alpha[row] = ex2(mlog[row] - mlnew);
    mrow[row] = mnew;
    mlog[row] = mlnew;
  }
  // unnormalized probabilities 2^(t*log2e - m*log2e); every exponent of a
  // row is taken against the same stored mlog, so the row stays consistent
  // even where m*log2e rounds (a row whose keys all carry -1e9)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = ex2(fmaf(sc[j][e], LOG2E, -mlog[e >> 1]));
#pragma unroll
  for (int n = 0; n < 5; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  // O += P V: P's C fragments are P.V's A fragments (rounded to bf16 here);
  // the ones column is B's column 0, held by the lanes with g = 0
  const uint32_t ones = (lane >> 2) == 0 ? 0x3F803F80u : 0u;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
    pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
    pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
    pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t vf[4];  // keys kk*16 + 0-7, 8-15 for dims (2p)*8.. and (2p+1)*8..
      ldmatrix_x4_trans(vf, &st.v[kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                 [(2 * p + (lane >> 4)) * 8]);
      mma_bf16(o[2 * p], pa, vf[0], vf[1]);
      mma_bf16(o[2 * p + 1], pa, vf[2], vf[3]);
    }
    mma_bf16(o[4], pa, ones, ones);
  }
}

// One block per (128-query tile, head m, batch b); each of its eight warps
// owns 16 query rows and walks all keys. Lane (g = lane/4, tq = lane%4)
// holds rows g and g + 8 of the warp's 16 in the m16n8 fragments.
template <bool PRIOR, bool MASK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
box_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                     const float* __restrict__ cx, const float* __restrict__ cy,
                     const float* __restrict__ ihw, const float* __restrict__ ihh,
                     const int* __restrict__ level, const float* __restrict__ px,
                     const float* __restrict__ py, const float* __restrict__ gamma,
                     const int* __restrict__ group, float* __restrict__ out, Layout lay, int Q,
                     int S, int L, float scale) {
  static_assert(!(PRIOR && MASK), "the group mask is the self-attention's, without the prior");
  // dynamic shared memory: the ring, then (prior) [level][query] {ax, ax*cx,
  // ay, ay*cy}, or (mask) per stage the tile's key groups, packed by key pair
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  float4* box = reinterpret_cast<float4*>(smem + STAGES * sizeof(Stage));
  int2* grps = reinterpret_cast<int2*>(smem + STAGES * sizeof(Stage));  // [STAGES][BK / 2]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* kg = k + b * lay.k.b + m * lay.k.m;
  const __nv_bfloat16* vg = v + b * lay.v.b + m * lay.v.m;
  const int k_r = (int)lay.k.r, v_r = (int)lay.v.r;
  const float* kbg = key_bias + (size_t)b * S;
  const int ntiles = (S + BK - 1) / BK;

  auto load = [&](int stage, int t) {  // tile t into a stage, if there is one
    if (t >= ntiles) return;
    int2* grp = grps + stage * (BK / 2);
    if ((t + 1) * BK <= S)
      load_tile<PRIOR, MASK, false>(ring[stage], grp, kg, vg, k_r, v_r, kbg, px, py, level,
                                    group, t * BK, S, tid);
    else
      load_tile<PRIOR, MASK, true>(ring[stage], grp, kg, vg, k_r, v_r, kbg, px, py, level,
                                   group, t * BK, S, tid);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    load(t, t);
    cp_async_commit();
  }

  bool neg = false;  // gamma < 0: the prior raises the logits
  if constexpr (PRIOR) {
    const float hg = 0.5f * gamma[m];
    const float root = sqrtf(fabsf(hg));
    neg = hg < 0.f;
    for (int t = tid; t < L * BQ; t += THREADS) {
      const int l = t / BQ, r = t % BQ, qi = q0 + r;
      float4 c = make_float4(0.f, 0.f, 0.f, 0.f);  // queries past Q: no prior
      if (qi < Q) {
        const size_t o = ((size_t)b * Q + qi) * L + l;
        const float ax = root * ihw[o], ay = root * ihh[o];
        c = make_float4(ax, ax * cx[o], ay, ay * cy[o]);
      }
      box[l * BQ + r] = c;
    }
  }

  // Q's A fragments (two k-steps of 16 dims), rows past Q zero
  const int r0 = warp * 16 + g;
  uint32_t qf[2][4];
  {
    const __nv_bfloat16* qg = q + b * lay.q.b + m * lay.q.m;
    const int qa = q0 + r0, qb = qa + 8;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ks * 16 + h * 8 + 2 * tq;
        qf[ks][2 * h] = qa < Q ? *reinterpret_cast<const uint32_t*>(qg + qa * lay.q.r + col) : 0u;
        qf[ks][2 * h + 1] =
            qb < Q ? *reinterpret_cast<const uint32_t*>(qg + qb * lay.q.r + col) : 0u;
      }
    }
  }

  float o[5][4];  // O's four n-tiles of 8 dims, and the row sums
#pragma unroll
  for (int n = 0; n < 5; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max from a finite -1e30: a row whose every key carries -1e9
  // stays uniform, and no exponent of (-inf) - (-inf) appears
  float mrow[2] = {-1e30f, -1e30f};
  float mlog[2] = {-1e30f * LOG2E, -1e30f * LOG2E};
  const bool live = q0 + warp * 16 < Q;
  // the CDN groups of this lane's rows (rows past Q: -2, blocked from every
  // denoising key, never stored)
  int ga = -2, gb = -2;
  if constexpr (MASK) {
    const int qa = q0 + r0;
    if (qa < Q) ga = group[qa];
    if (qa + 8 < Q) gb = group[qa + 8];
  }

  int ld = STAGES - 1;  // the stage the next tile loads into
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and tile it-1 is consumed
    load(ld, it + STAGES - 1);
    cp_async_commit();
    ld = ld + 1 == STAGES ? 0 : ld + 1;
    if (!live) continue;
    const Stage& st = ring[it % STAGES];
    const int2* grp = grps + (it % STAGES) * (BK / 2);
    const int s0 = it * BK;
    const bool ragged = s0 + BK > S;
    bool masked = false;
    if constexpr (MASK) {
      // the warp reads the tile's 64 key groups (two per lane). All -1 (the
      // matching queries' keys), or all the one group every row has: nothing
      // is blocked. All one group that none of the rows has: the tile adds
      // nothing, skip it. Otherwise check every score.
      const int2 gk = grp[lane];
      if (!__all_sync(0xffffffffu, gk.x < 0 && gk.y < 0)) {
        const int kmin = __reduce_min_sync(0xffffffffu, min(gk.x, gk.y));
        const int kmax = __reduce_max_sync(0xffffffffu, max(gk.x, gk.y));
        if (!ragged && kmin == kmax) {
          if (__all_sync(0xffffffffu, ga != kmin && gb != kmin)) continue;
          masked = !__all_sync(0xffffffffu, ga == kmin && gb == kmin);
        } else {
          masked = true;
        }
      }
    }
    if constexpr (MASK) {
      if (masked) {  // every key's group checked, ragged or not
        tile_step<PRIOR, true, false, true>(st, box, grp, ga, gb, qf, o, mrow, mlog, lane, r0,
                                            s0, S, scale);
        continue;
      }
    }
    if (!ragged && !neg)
      tile_step<PRIOR, false, false, false>(st, box, grp, ga, gb, qf, o, mrow, mlog, lane, r0,
                                            s0, S, scale);
    else if (!ragged)
      tile_step<PRIOR, false, true, false>(st, box, grp, ga, gb, qf, o, mrow, mlog, lane, r0, s0,
                                           S, scale);
    else if (!neg)
      tile_step<PRIOR, true, false, false>(st, box, grp, ga, gb, qf, o, mrow, mlog, lane, r0, s0,
                                           S, scale);
    else
      tile_step<PRIOR, true, true, false>(st, box, grp, ga, gb, qf, o, mrow, mlog, lane, r0, s0,
                                          S, scale);
  }
  cp_async_wait<0>();
  if (!live) return;

  float* og = out + b * lay.out.b + m * lay.out.m;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    // the row sum sits in column 0 of the ones tile: the quad's lane tq = 0
    const float inv = 1.f / __shfl_sync(0xffffffffu, o[4][2 * row], lane & ~3);
    const int qi = q0 + r0 + 8 * row;
    if (qi < Q) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<float2*>(og + qi * lay.out.r + n * 8 + 2 * tq) =
            make_float2(o[n][2 * row] * inv, o[n][2 * row + 1] * inv);
    }
  }
}

}  // namespace tc

// dynamic shared memory of the bf16 kernel: the ring, then (prior) L
// levels of per-query box constants or (mask) each stage's key groups
size_t bf16_smem(bool prior, int L, bool mask) {
  return tc::STAGES * sizeof(tc::Stage) + (prior ? (size_t)L * tc::BQ * sizeof(float4) : 0) +
         (mask ? (size_t)tc::STAGES * (tc::BK / 2) * sizeof(int2) : 0);
}

struct Args {
  const void *q, *k, *v;
  const float *key_bias, *cx, *cy, *ihw, *ihh;
  const int* level;
  const float *px, *py, *gamma;
  const int* group;
  float* out;
};

template <bool PRIOR, bool MASK>
cudaError_t launch(const Args& a, bool bf16, const Layout& lay, int B, int M, int Q, int S,
                   int L, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  if (bf16) {
    const dim3 grid((Q + tc::BQ - 1) / tc::BQ, M, B);
    // allow the most shared memory any L needs, once
    static const cudaError_t sized = cudaFuncSetAttribute(
        tc::box_attn_bf16_kernel<PRIOR, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bf16_smem(PRIOR, MAX_L, MASK));
    if (sized != cudaSuccess) return sized;
    tc::box_attn_bf16_kernel<PRIOR, MASK><<<grid, tc::THREADS, bf16_smem(PRIOR, L, MASK), stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v,
        a.key_bias, a.cx, a.cy, a.ihw, a.ihh, a.level, a.px, a.py, a.gamma, a.group, a.out, lay,
        Q, S, L, scale);
  } else {
    const dim3 grid((Q + f32::BQ - 1) / f32::BQ, M, B);
    f32::box_attn_f32_kernel<PRIOR, MASK><<<grid, f32::THREADS, 0, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, a.key_bias, a.cx, a.cy, a.ihw,
        a.ihh, a.level, a.px, a.py, a.gamma, a.group, a.out, lay, Q, S, L, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and out in
// that order; D has unit stride in all four. group: null, or (without the
// prior, Q = S) the (Q,) int32 CDN groups of the rows and keys.
extern "C" int dtlr_box_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* key_bias, const void* cx, const void* cy,
                                 const void* ihw, const void* ihh, const void* level,
                                 const void* px, const void* py, const void* gamma,
                                 const void* group, void* out, int B, int M, int Q, int S, int D_,
                                 int L, int bf16, int prior, const long long* strides,
                                 void* stream) {
  if (D_ != D || L < 1 || L > MAX_L || Q < 1 || S < 1 || B < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  if (group != nullptr && (prior || Q != S)) return (int)cudaErrorInvalidValue;
  Layout lay;
  Strides* dst[4] = {&lay.q, &lay.k, &lay.v, &lay.out};
  for (int i = 0; i < 4; ++i) *dst[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,
               k,
               v,
               (const float*)key_bias,
               (const float*)cx,
               (const float*)cy,
               (const float*)ihw,
               (const float*)ihh,
               (const int*)level,
               (const float*)px,
               (const float*)py,
               (const float*)gamma,
               (const int*)group,
               (float*)out};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = prior              ? launch<true, false>(a, bf16 != 0, lay, B, M, Q, S, L, st)
                          : group != nullptr ? launch<false, true>(a, bf16 != 0, lay, B, M, Q, S, L, st)
                                             : launch<false, false>(a, bf16 != 0, lay, B, M, Q, S, L, st);
  return (int)err;
}

extern "C" int dtlr_box_attn_head_dim() { return D; }

// bytes of dynamic shared memory a bf16 block takes (ptxas reports only
// static shared memory)
extern "C" int dtlr_box_attn_bf16_smem(int prior, int L, int mask) {
  return (int)bf16_smem(prior != 0, L, mask != 0);
}
