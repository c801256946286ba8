// Multi-head attention forward with the Gaussian box prior fused in, for
// Hopper (sm_90a). Port of the Pallas kernels `_mha_box_kernel` (prior) and
// `_mha_kernel` (key bias only) of dtlr_tpu/ops/flash_attn.py.
//
//   out[b,m,q,:] = softmax_s( q.k_s / sqrt(D) - gamma_m/2 * d2(q,s) + key_bias[b,s] ) . v_s
//   d2 = ((px_s - cx_l) * ihw_l)^2 + ((py_s - cy_l) * ihh_l)^2,  l = level of key s
//
// Two kernels, chosen by the inputs' type, both on the tensor cores; each
// has a prior and a no-prior instantiation, and the no-prior one a masked
// instantiation as well.
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
// fp32 inputs (--compute_dtype float32, the precision mode every gate
// against the JAX package's fp32 reading runs in): tensor cores in
// 3xTF32. A single TF32 product keeps 11 bits of each operand, about 1e-3
// relative, which the 1e-4 tolerance rules out; so each fp32 operand x is
// split into big = tf32(x) and small = tf32(x - big), and every product is
// formed as small.big + big.small + big.big with mma.sync.m16n8k8.tf32 and
// fp32 accumulators (CUTLASS's OpMultiplyAddFastF32): only small.small,
// about 2^-22 relative, is dropped, so the result keeps fp32's accuracy.
// What bounds it on this card: the three products of both matrix
// products, 3 * 2*B*M*Q*S*2D = 60.2 GFLOP at S=2720, take 0.122 ms at 495
// TFLOP/s of dense TF32, more than the per-score work on the CUDA cores
// (about 16 instructions: the bf16 kernel's, the prior's exact offsets, p's
// split and sum, K's and V's split; 0.075 ms) or the bytes. What the
// design does about it:
// - the bf16 kernel's structure: warps of 16 query rows, 64-key tiles
//   through the same two-stage cp.async ring, the same logits, mask and
//   online softmax per tile, P kept in registers;
// - K and V are split once per tile, after their copy lands: each thread
//   splits the 16-byte chunks it copied itself (no barrier needed before),
//   big in place and small into a second plane, so the eight warps that
//   read the tile split nothing; Q is split once per block, in registers;
//   p per score (three instructions);
// - no shuffles: the dims of a k-step are permuted (k index t takes dim
//   8t + 2ks, t + 4 takes 8t + 2ks + 1) so a lane reads its Q and K
//   fragments as two 16-byte loads per 8 keys, and the score fragment's
//   key columns 2t, 2t+1 become P.V's k indices t, t+4, with V's rows
//   read in that order and its dims permuted the same way (n-tile n,
//   column c takes dim 4c + n), so a lane also reads V as two 16-byte
//   loads per 8 keys and writes its 8 output dims as two;
// - shared rows of 36 floats: each quarter warp's 16-byte loads fall in 8
//   distinct bank groups;
// - accuracy: the tensor cores' fp32 sums are not rounded to nearest, so
//   each tile's P.V starts from zero and joins O by one fp32 FMA (on an
//   H100 80GB HBM3 at 700 W one chain over all 900 keys of the
//   self-attention measured several times the error of a chain per
//   tile); the prior's offsets are formed as (px - cx) * ax, as
//   dense_reference forms them, and the row sums are taken in fp32 on the
//   CUDA cores (a column of ones would round p to tf32).
// On that card it takes 0.52 ms at Q=900, S=2720 (the earlier CUDA-core
// kernel 1.16 ms, SDPA in fp32 1.62 ms), a quarter of its bound.
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
// What both kernels share: the block shape, the ring, the logits, the mask
// and the online softmax
// ---------------------------------------------------------------------------

// 8 warps x 16 rows share each staged K/V tile. Measured on the H100
// (bf16) against 4 warps x 64 queries and against 3- and 4-stage rings:
// 5% faster at S = 2720, the same at S = 900.
constexpr int WARPS = 8;
constexpr int BQ = 16 * WARPS;       // queries per block: 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int BK = 64;               // keys per ring stage and softmax step
constexpr int STAGES = 2;            // cp.async ring depth
constexpr int NT = BK / 8;           // n-tiles of 8 keys in the score fragment
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <bool B>
struct Flag {  // a compile-time bool handed to a generic lambda
  static constexpr bool value = B;
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

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte chunks of one K or V row, and the chunks each thread copies (its
// own: the fp32 kernel splits exactly these after they land)
template <class T>
constexpr int ROW_CHUNKS = D * (int)sizeof(T) / 16;
template <class T>
constexpr int CHUNKS_PER_THREAD = BK * ROW_CHUNKS<T> / THREADS;

// Queue the copies of key tile [s0, s0 + BK) into a stage (K and V rows of
// element type T, the per-key fields packed by key pair (2i, 2i+1) as one
// thread reads them, and under the mask the key groups). A whole tile
// copies unpredicated, from 32-bit offsets off the tile's first row (row
// offsets within one (batch, head) are 32-bit: the wrapper refuses an
// operand whose rows span 2^31 elements or more). In the RAGGED last tile
// keys past S are zero-filled from the tile's first row (their scores are
// masked, and zero V rows keep 0 * V finite).
template <bool PRIOR, bool MASK, bool RAGGED, class T, class St>
__device__ __forceinline__ void load_tile(St& st, int2* grp, const T* kg, const T* vg, int k_r,
                                          int v_r, const float* kbg, const float* px,
                                          const float* py, const int* level, const int* group,
                                          int s0, int S, int tid) {
  constexpr int CH = ROW_CHUNKS<T>, EL = 16 / (int)sizeof(T);
  static_assert(BK * CH % THREADS == 0, "whole 16-byte chunks of K and V per thread");
  const T* kt = kg + s0 * k_r;
  const T* vt = vg + s0 * v_r;
#pragma unroll
  for (int n = 0; n < CHUNKS_PER_THREAD<T>; ++n) {
    const unsigned c = tid + n * THREADS;
    const int j = c / CH, ch = c % CH;
    const bool ok = !RAGGED || s0 + j < S;
    const int r = ok ? j : 0;
    cp_async16(&st.k[j][ch * EL], kt + (r * k_r + ch * EL), ok);
    cp_async16(&st.v[j][ch * EL], vt + (r * v_r + ch * EL), ok);
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
// per-(query, level) constants, ax = sqrt(|gamma/2|) * ihw (ay the same
// with ihh), and are subtracted by two FMAs (added where gamma < 0: NEG).
// The bf16 stage holds c = {ax, ax*cx, ay, ay*cy} and forms each offset
// as one FMA, px*ax - ax*cx; the fp32 stage (St::EXACT_PRIOR) holds c =
// {ax, cx, ay, cy} and forms (px - cx)*ax, as dense_reference does: the
// FMA's rounded ax*cx (ax up to about 30) costs some 1e-6 of an offset,
// which fp32's 1e-4 tolerance on the output cannot spare. ONE_LEVEL: every key of the tile lies in one level, whose
// constants the caller holds in registers (ca, cb for the rows r0, r0 + 8);
// otherwise each key looks up its own level's. sc is the m16n8 score
// fragment of both kernels: lane (g, tq) holds keys 2i, 2i+1 (i = j*4 +
// tq) of rows r0 = g and r0 + 8.
template <bool PRIOR, bool RAGGED, bool ONE_LEVEL, bool NEG, class St>
__device__ __forceinline__ void tile_logits(float (&sc)[NT][4], const St& st, const float4* box,
                                            float4 ca, float4 cb, int r0, int tq, int s0, int S,
                                            float scale) {
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
        const float pxk = hi ? pp.y : pp.x, pyk = hi ? pp.w : pp.z;
        const float u = St::EXACT_PRIOR ? (pxk - c.y) * c.x : fmaf(pxk, c.x, -c.y);
        const float w = St::EXACT_PRIOR ? (pyk - c.w) * c.z : fmaf(pyk, c.z, -c.w);
        t = fmaf(NEG ? u : -u, u, t);
        t = fmaf(NEG ? w : -w, w, t);
      }
      if (RAGGED && s0 + 2 * i + hi >= S) t = -INFINITY;
      sc[j][e] = t;
    }
  }
}

// The tile's raw products q.k in sc become unnormalized probabilities:
// logits, the CDN mask, the row maxima (a tree over this lane's 16 scores
// of each row, then over the quad that shares the row) and one rescale
// factor per row (alpha) for what was summed before.
template <bool PRIOR, bool RAGGED, bool NEG, bool MASK, class St>
__device__ __forceinline__ void tile_softmax(float (&sc)[NT][4], float (&alpha)[2], const St& st,
                                             const float4* box, const int2* grp, int ga, int gb,
                                             float (&mrow)[2], float (&mlog)[2], int lane, int r0,
                                             int s0, int S, float scale) {
  const int tq = lane & 3;
  const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (PRIOR) {
    // the warp checks the tile's 64 levels (two per lane) against its first
    const int ref = st.lvl[0].x;
    const int2 lv = st.lvl[lane];
    const int k0 = s0 + 2 * lane;
    const bool same = (lv.x == ref || (RAGGED && k0 >= S)) &&
                      (lv.y == ref || (RAGGED && k0 + 1 >= S));
    if (__all_sync(FULL, same))
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
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) a[j] = fmaxf(sc[j][2 * row], sc[j][2 * row + 1]);
#pragma unroll
    for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
    float mx = fmaxf(a[0], __shfl_xor_sync(FULL, a[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
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
}

// Stage the prior's per-(query, level) constants of the block's queries
// in the stage type's form (see tile_logits); returns whether gamma < 0.
template <class St>
__device__ __forceinline__ bool stage_box(float4* box, const float* cx, const float* cy,
                                          const float* ihw, const float* ihh,
                                          const float* gamma, int b, int m, int q0, int Q, int L,
                                          int tid) {
  const float hg = 0.5f * gamma[m];
  const float root = sqrtf(fabsf(hg));
  for (int t = tid; t < L * BQ; t += THREADS) {
    const int l = t / BQ, r = t % BQ, qi = q0 + r;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);  // queries past Q: no prior
    if (qi < Q) {
      const size_t o = ((size_t)b * Q + qi) * L + l;
      const float ax = root * ihw[o], ay = root * ihh[o];
      c = St::EXACT_PRIOR ? make_float4(ax, cx[o], ay, cy[o])
                          : make_float4(ax, ax * cx[o], ay, ay * cy[o]);
    }
    box[l * BQ + r] = c;
  }
  return hg < 0.f;
}

// One warp's walk over the key tiles of a block: the ring (tile it lands
// while tile it+1 loads), the mask's choice per tile, and the call
// step(st, grp, s0, ragged, neg, masked) with the last three as Flag<>s.
// prepare(st) runs on each landed stage before the block's barrier.
// load(stage, t) queues tile t, if there is one; the first STAGES - 1
// tiles were queued by the caller.
template <bool MASK, class St, class Load, class Prepare, class Step>
__device__ __forceinline__ void key_loop(St* ring, const int2* grps, int ntiles, int S, bool live,
                                         bool neg, int ga, int gb, int lane, Load load,
                                         Prepare prepare, Step step) {
  int ld = STAGES - 1;  // the stage the next tile loads into
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's copies)
    prepare(ring[it % STAGES]);
    __syncthreads();              // ... everyone's, and tile it-1 is consumed
    load(ld, it + STAGES - 1);
    cp_async_commit();
    ld = ld + 1 == STAGES ? 0 : ld + 1;
    if (!live) continue;
    const St& st = ring[it % STAGES];
    const int2* grp = grps + (it % STAGES) * (BK / 2);
    const int s0 = it * BK;
    const bool ragged = s0 + BK > S;
    if constexpr (MASK) {
      // the warp reads the tile's 64 key groups (two per lane). All -1 (the
      // matching queries' keys), or all the one group every row has: nothing
      // is blocked. All one group that none of the rows has: the tile adds
      // nothing, skip it. Otherwise check every score.
      bool masked = false;
      const int2 gk = grp[lane];
      if (!__all_sync(FULL, gk.x < 0 && gk.y < 0)) {
        const int kmin = __reduce_min_sync(FULL, min(gk.x, gk.y));
        const int kmax = __reduce_max_sync(FULL, max(gk.x, gk.y));
        if (!ragged && kmin == kmax) {
          if (__all_sync(FULL, ga != kmin && gb != kmin)) continue;
          masked = !__all_sync(FULL, ga == kmin && gb == kmin);
        } else {
          masked = true;
        }
      }
      if (masked) {  // every key's group checked, ragged or not
        step(st, grp, s0, Flag<true>{}, Flag<false>{}, Flag<true>{});
        continue;
      }
    }
    if (!ragged && !neg)
      step(st, grp, s0, Flag<false>{}, Flag<false>{}, Flag<false>{});
    else if (!ragged)
      step(st, grp, s0, Flag<false>{}, Flag<true>{}, Flag<false>{});
    else if (!neg)
      step(st, grp, s0, Flag<true>{}, Flag<false>{}, Flag<false>{});
    else
      step(st, grp, s0, Flag<true>{}, Flag<true>{}, Flag<false>{});
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync bf16
// ---------------------------------------------------------------------------
namespace tc {

constexpr int MIN_BLOCKS = 2;  // two blocks of at most 128 registers a thread fill an SM
constexpr int KROW = D + 8;  // shared row of 80 bytes: the 8 rows an
                             // ldmatrix phase reads hit 8 distinct
                             // 16-byte bank groups

// One ring stage: a tile of K and V rows and the tile's per-key fields,
// the latter packed by key pair (2i, 2i+1) as one thread reads them.
struct __align__(16) Stage {
  __nv_bfloat16 k[BK][KROW];
  __nv_bfloat16 v[BK][KROW];
  float4 pxy[BK / 2];  // {px(2i), px(2i+1), py(2i), py(2i+1)}
  float2 kb[BK / 2];   // key_bias
  int2 lvl[BK / 2];    // level id
  static constexpr bool EXACT_PRIOR = false;
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One 64-key tile (keys s0..) for this warp's 16 rows: S = Q K^T, logits,
// online softmax, O += P V. The fifth n-tile of O multiplies P by a column
// of ones: the row sums of the bf16 probabilities, the same ones P.V sums.
template <bool PRIOR, bool RAGGED, bool NEG, bool MASK>
__device__ __forceinline__ void tile_step(const Stage& st, const float4* box, const int2* grp,
                                          int ga, int gb, const uint32_t (&qf)[2][4],
                                          float (&o)[5][4], float (&mrow)[2], float (&mlog)[2],
                                          int lane, int r0, int s0, int S, float scale) {
  float sc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    uint32_t kf[4];  // keys j*8..j*8+7, dims 0-7, 8-15, 16-23, 24-31
    ldmatrix_x4(kf, &st.k[j * 8 + (lane & 7)][(lane >> 3) * 8]);
    mma_bf16(sc[j], qf[0], kf[0], kf[1]);
    mma_bf16(sc[j], qf[1], kf[2], kf[3]);
  }
  float alpha[2];
  tile_softmax<PRIOR, RAGGED, NEG, MASK>(sc, alpha, st, box, grp, ga, gb, mrow, mlog, lane, r0,
                                         s0, S, scale);
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
  if constexpr (PRIOR) neg = stage_box<Stage>(box, cx, cy, ihw, ihh, gamma, b, m, q0, Q, L, tid);

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

  key_loop<MASK>(ring, grps, ntiles, S, live, neg, ga, gb, lane, load, [](Stage&) {},
                 [&](const Stage& st, const int2* grp, int s0, auto ragged, auto negf, auto mask) {
                   tile_step<PRIOR, decltype(ragged)::value, decltype(negf)::value,
                             decltype(mask)::value>(st, box, grp, ga, gb, qf, o, mrow, mlog, lane,
                                                    r0, s0, S, scale);
                 });
  if (!live) return;

  float* og = out + b * lay.out.b + m * lay.out.m;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    // the row sum sits in column 0 of the ones tile: the quad's lane tq = 0
    const float inv = 1.f / __shfl_sync(FULL, o[4][2 * row], lane & ~3);
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

// ---------------------------------------------------------------------------
// fp32: tensor cores, mma.sync tf32 in 3xTF32
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int ROW = D + 4;  // shared row of 144 bytes: a quarter warp's
                            // 16-byte loads (rows g, g + 1 at chunk
                            // offsets 2t or 9 rows apart) hit 8 distinct
                            // 16-byte bank groups

// One ring stage: K and V as copied, then split (big in place, small in
// the second plane), and the tile's per-key fields as the bf16 stage has
// them.
struct __align__(16) Stage {
  float k[BK][ROW];   // K, then its tf32 big part
  float ks[BK][ROW];  // K's tf32 small part
  float v[BK][ROW];   // V, then its tf32 big part
  float vs[BK][ROW];  // V's tf32 small part
  float4 pxy[BK / 2];
  float2 kb[BK / 2];
  int2 lvl[BK / 2];
  static constexpr bool EXACT_PRIOR = true;
};

__device__ __forceinline__ uint32_t tf32(float x) {  // round to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small up to 2^-22 |x|, both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(float4& big, float4& small) {
  uint32_t b, s;
  split(big.x, b, s), big.x = __uint_as_float(b), small.x = __uint_as_float(s);
  split(big.y, b, s), big.y = __uint_as_float(b), small.y = __uint_as_float(s);
  split(big.z, b, s), big.z = __uint_as_float(b), small.z = __uint_as_float(s);
  split(big.w, b, s), big.w = __uint_as_float(b), small.w = __uint_as_float(s);
}

// Split the K and V chunks this thread copied into a landed stage (the
// chunks of load_tile<float>): its own cp.async copies are visible to it
// once they land, so no barrier comes before; the block's barrier after
// publishes both planes.
__device__ __forceinline__ void split_tile(Stage& st, int tid) {
  constexpr int CH = ROW_CHUNKS<float>;
#pragma unroll
  for (int n = 0; n < CHUNKS_PER_THREAD<float>; ++n) {
    const unsigned c = tid + n * THREADS;
    const int j = c / CH, d = (c % CH) * 4;
    float4 kb = *reinterpret_cast<float4*>(&st.k[j][d]), ksm;
    float4 vb = *reinterpret_cast<float4*>(&st.v[j][d]), vsm;
    split4(kb, ksm);
    split4(vb, vsm);
    *reinterpret_cast<float4*>(&st.k[j][d]) = kb;
    *reinterpret_cast<float4*>(&st.ks[j][d]) = ksm;
    *reinterpret_cast<float4*>(&st.v[j][d]) = vb;
    *reinterpret_cast<float4*>(&st.vs[j][d]) = vsm;
  }
}

// c (16x8 fp32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the small terms first, then big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0b, float b1b,
                                           float b0s, float b1s) {
  mma_tf32(c, as, __float_as_uint(b0b), __float_as_uint(b1b));
  mma_tf32(c, ab, __float_as_uint(b0s), __float_as_uint(b1s));
  mma_tf32(c, ab, __float_as_uint(b0b), __float_as_uint(b1b));
}

__device__ __forceinline__ float at(const float4& x, int i) {  // i known at compile time
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// One 64-key tile (keys s0..) for this warp's 16 rows: S = Q K^T, logits,
// online softmax, O += P V, row sums. In both products a k-step's k index
// t stands for dims (q.k) or keys (p.v) chosen so that every fragment is
// two 16-byte loads (see the header): q.k's k-step ks takes dim 8t + 2ks
// at t and 8t + 2ks + 1 at t + 4; p.v's k-step j takes key 8j + 2t at t
// and 8j + 2t + 1 at t + 4, the score fragment's own columns; p.v's n-tile
// n takes dim 4c + n at column c.
template <bool PRIOR, bool RAGGED, bool NEG, bool MASK>
__device__ __forceinline__ void tile_step(const Stage& st, const float4* box, const int2* grp,
                                          int ga, int gb, const uint32_t (&qb)[4][4],
                                          const uint32_t (&qs)[4][4], float (&o)[4][4],
                                          float (&lsum)[2], float (&mrow)[2], float (&mlog)[2],
                                          int lane, int r0, int s0, int S, float scale) {
  const int g = lane >> 2, tq = lane & 3;
  float sc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    // key 8j + g, dims 8tq .. 8tq + 7: b0 of k-step ks is dim 8tq + 2ks, b1 the next
    const float4* kb = reinterpret_cast<const float4*>(&st.k[8 * j + g][8 * tq]);
    const float4* ks = reinterpret_cast<const float4*>(&st.ks[8 * j + g][8 * tq]);
    const float4 kb0 = kb[0], kb1 = kb[1], ks0 = ks[0], ks1 = ks[1];
    mma_3xtf32(sc[j], qb[0], qs[0], kb0.x, kb0.y, ks0.x, ks0.y);
    mma_3xtf32(sc[j], qb[1], qs[1], kb0.z, kb0.w, ks0.z, ks0.w);
    mma_3xtf32(sc[j], qb[2], qs[2], kb1.x, kb1.y, ks1.x, ks1.y);
    mma_3xtf32(sc[j], qb[3], qs[3], kb1.z, kb1.w, ks1.z, ks1.w);
  }
  float alpha[2];
  tile_softmax<PRIOR, RAGGED, NEG, MASK>(sc, alpha, st, box, grp, ga, gb, mrow, mlog, lane, r0,
                                         s0, S, scale);
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) s += sc[j][2 * row] + sc[j][2 * row + 1];
    lsum[row] = fmaf(lsum[row], alpha[row], s);
  }
  // this tile's P V, k-step j over keys 8j .. 8j + 7: P's A fragment is
  // the score fragment's n-tile j, {row g key 2t, row g+8 key 2t, row g
  // key 2t+1, row g+8 key 2t+1}, split here. It starts from zero and joins
  // O by one fp32 FMA a value (O * alpha + tile): the tensor cores' fp32
  // sums are not rounded to nearest but drift one way, and a chain over
  // every key would carry that through hundreds of steps.
  float pv[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t pb[4], ps[4];
    split(sc[j][0], pb[0], ps[0]);
    split(sc[j][2], pb[1], ps[1]);
    split(sc[j][1], pb[2], ps[2]);
    split(sc[j][3], pb[3], ps[3]);
    const int key = 8 * j + 2 * tq;  // b0's key; b1's is the next
    const float4 v0 = *reinterpret_cast<const float4*>(&st.v[key][4 * g]);
    const float4 v1 = *reinterpret_cast<const float4*>(&st.v[key + 1][4 * g]);
    const float4 w0 = *reinterpret_cast<const float4*>(&st.vs[key][4 * g]);
    const float4 w1 = *reinterpret_cast<const float4*>(&st.vs[key + 1][4 * g]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mma_3xtf32(pv[n], pb, ps, at(v0, n), at(v1, n), at(w0, n), at(w1, n));
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
}

// One block per (128-query tile, head m, batch b), as the bf16 kernel, but
// one block an SM: at two, 128 registers a thread spill, and one block of
// up to 207 spills nothing, measured the same at Q = 900 and faster at
// Q = 1028, whose 576 blocks end in a smaller last wave (on an H100 80GB
// HBM3 at 700 W). Splitting K and V in registers instead of in shared
// memory measured slower.
template <bool PRIOR, bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
box_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ key_bias,
                    const float* __restrict__ cx, const float* __restrict__ cy,
                    const float* __restrict__ ihw, const float* __restrict__ ihh,
                    const int* __restrict__ level, const float* __restrict__ px,
                    const float* __restrict__ py, const float* __restrict__ gamma,
                    const int* __restrict__ group, float* __restrict__ out, Layout lay, int Q,
                    int S, int L, float scale) {
  static_assert(!(PRIOR && MASK), "the group mask is the self-attention's, without the prior");
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
  const float* kg = k + b * lay.k.b + m * lay.k.m;
  const float* vg = v + b * lay.v.b + m * lay.v.m;
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
  if constexpr (PRIOR) neg = stage_box<Stage>(box, cx, cy, ihw, ihh, gamma, b, m, q0, Q, L, tid);

  // Q's A fragments, split once: rows r0 and r0 + 8, dims 8tq .. 8tq + 7
  // (k-step ks: dim 8tq + 2ks at k index tq, the next at tq + 4); rows
  // past Q zero
  const int r0 = warp * 16 + g;
  uint32_t qb[4][4], qs[4][4];
  {
    const float* qg = q + b * lay.q.b + m * lay.q.m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // row r0 + 8h: a1 and a3 hold the second row
      const int qi = q0 + r0 + 8 * h;
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
      if (qi < Q) {
        const float4* row = reinterpret_cast<const float4*>(qg + qi * lay.q.r + 8 * tq);
        const float4 x0 = row[0], x1 = row[1];
        x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w;
        x[4] = x1.x, x[5] = x1.y, x[6] = x1.z, x[7] = x1.w;
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        split(x[2 * ks], qb[ks][h], qs[ks][h]);
        split(x[2 * ks + 1], qb[ks][2 + h], qs[ks][2 + h]);
      }
    }
  }

  float o[4][4];  // O's four n-tiles (n-tile n, column c: dim 4c + n)
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float lsum[2] = {0.f, 0.f};  // this lane's share of the row sums
  float mrow[2] = {-1e30f, -1e30f};
  float mlog[2] = {-1e30f * LOG2E, -1e30f * LOG2E};
  const bool live = q0 + warp * 16 < Q;
  int ga = -2, gb = -2;
  if constexpr (MASK) {
    const int qa = q0 + r0;
    if (qa < Q) ga = group[qa];
    if (qa + 8 < Q) gb = group[qa + 8];
  }

  key_loop<MASK>(ring, grps, ntiles, S, live, neg, ga, gb, lane, load,
                 [&](Stage& st) { split_tile(st, tid); },
                 [&](const Stage& st, const int2* grp, int s0, auto ragged, auto negf, auto mask) {
                   tile_step<PRIOR, decltype(ragged)::value, decltype(negf)::value,
                             decltype(mask)::value>(st, box, grp, ga, gb, qb, qs, o, lsum, mrow,
                                                    mlog, lane, r0, s0, S, scale);
                 });
  if (!live) return;

  float* og = out + b * lay.out.b + m * lay.out.m;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float s = lsum[row] + __shfl_xor_sync(FULL, lsum[row], 1);
    s += __shfl_xor_sync(FULL, s, 2);
    const float inv = 1.f / s;
    const int qi = q0 + r0 + 8 * row;
    if (qi < Q) {  // dims 8tq .. 8tq + 3 from columns 2tq, the next four from 2tq + 1
      float4* dst = reinterpret_cast<float4*>(og + qi * lay.out.r + 8 * tq);
      dst[0] = make_float4(o[0][2 * row] * inv, o[1][2 * row] * inv, o[2][2 * row] * inv,
                           o[3][2 * row] * inv);
      dst[1] = make_float4(o[0][2 * row + 1] * inv, o[1][2 * row + 1] * inv,
                           o[2][2 * row + 1] * inv, o[3][2 * row + 1] * inv);
    }
  }
}

}  // namespace f32

// dynamic shared memory of a block: the ring, then (prior) L levels of
// per-query box constants or (mask) each stage's key groups
size_t smem_bytes(bool bf16, bool prior, int L, bool mask) {
  return STAGES * (bf16 ? sizeof(tc::Stage) : sizeof(f32::Stage)) +
         (prior ? (size_t)L * BQ * sizeof(float4) : 0) +
         (mask ? (size_t)STAGES * (BK / 2) * sizeof(int2) : 0);
}

struct Args {
  const void *q, *k, *v;
  const float *key_bias, *cx, *cy, *ihw, *ihh;
  const int* level;
  const float *px, *py, *gamma;
  const int* group;
  float* out;
};

// allow a kernel the most shared memory any L needs
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool bf16, bool prior, bool mask) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(bf16, prior, MAX_L, mask));
}

template <bool PRIOR, bool MASK>
cudaError_t launch(const Args& a, bool bf16, const Layout& lay, int B, int M, int Q, int S,
                   int L, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  const dim3 grid((Q + BQ - 1) / BQ, M, B);
  const size_t smem = smem_bytes(bf16, PRIOR, L, MASK);
  if (bf16) {
    static const cudaError_t sized =
        allow_smem(tc::box_attn_bf16_kernel<PRIOR, MASK>, true, PRIOR, MASK);
    if (sized != cudaSuccess) return sized;
    tc::box_attn_bf16_kernel<PRIOR, MASK><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v,
        a.key_bias, a.cx, a.cy, a.ihw, a.ihh, a.level, a.px, a.py, a.gamma, a.group, a.out, lay,
        Q, S, L, scale);
  } else {
    static const cudaError_t sized =
        allow_smem(f32::box_attn_f32_kernel<PRIOR, MASK>, false, PRIOR, MASK);
    if (sized != cudaSuccess) return sized;
    f32::box_attn_f32_kernel<PRIOR, MASK><<<grid, THREADS, smem, stream>>>(
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

// bytes of dynamic shared memory a block takes (ptxas reports only static
// shared memory)
extern "C" int dtlr_box_attn_smem(int bf16, int prior, int L, int mask) {
  return (int)smem_bytes(bf16 != 0, prior != 0, L, mask != 0);
}
