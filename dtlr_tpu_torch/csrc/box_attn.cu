// Multi-head attention forward with the Gaussian box prior fused in, for
// Hopper (sm_90a). Port of the Pallas kernels `_mha_box_kernel` (prior) and
// `_mha_kernel` (key bias only) of dtlr_tpu/ops/flash_attn.py.
//
//   out[b,m,q,:] = softmax_s( q.k_s / sqrt(D) - gamma_m/2 * d2(q,s) + key_bias[b,s] ) . v_s
//   d2 = ((px_s - cx_l) * ihw_l)^2 + ((py_s - cy_l) * ihh_l)^2,  l = level of key s
//
// What bounds it on this card: at the decoder's shapes (B=8, M=8, Q=900,
// S=2720, D=32) the function reads and writes about 59 MB in fp32 but does
// 2*B*M*Q*S*(2D+8) = 22.6 GFLOP, so it is bound by operations, not bytes.
// What the design does about it: the (Q, S) scores and the prior never
// reach device memory (one pass, online softmax); each key row is read
// from shared memory once per warp as float4 broadcasts and used for two
// queries per thread, so the inner loop is fused multiply-adds on the CUDA
// cores in fp32. Tensor cores (wgmma) are the next step and not taken here.
//
// Layout: one block per (64-query tile, head m, batch b). Its four warps
// split each 64-key shared-memory tile into four runs of 16 keys; every
// lane holds two queries (lane, lane + 32) with their running max,
// normalizer and fp32 accumulator in registers. The ragged last key tile
// is masked by its length, never padded; queries past Q are not computed.
// The four warps' partial softmaxes are merged in shared memory in a fixed
// order, and the normalized tile is written once. A key's level comes from
// an int32 level id; the per-query box of each level sits in shared memory.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 32;             // head dimension
constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int WARPS = 4;          // each warp takes BK / WARPS keys of a tile
constexpr int THREADS = WARPS * 32;
constexpr int QPT = BQ / 32;      // queries per thread
constexpr int KPW = BK / WARPS;   // keys per warp per tile
constexpr int MAX_L = 8;          // most feature levels the prior takes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, bool PRIOR>
__global__ void __launch_bounds__(THREADS)
box_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ key_bias,
                const float* __restrict__ cx, const float* __restrict__ cy,
                const float* __restrict__ ihw, const float* __restrict__ ihh,
                const int* __restrict__ level, const float* __restrict__ px,
                const float* __restrict__ py, const float* __restrict__ gamma,
                float* __restrict__ out, int M, int Q, int S, int L, float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float kbias[BK];
  __shared__ float kpx[BK];
  __shared__ float kpy[BK];
  __shared__ int klvl[BK];
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
  const size_t bm = (size_t)b * M + m;
  const T* kg = k + bm * S * D;
  const T* vg = v + bm * S * D;
  const float* kbg = key_bias + (size_t)b * S;

  float qr[QPT][D];
  float acc[QPT][D];
  float run_max[QPT];
  float run_sum[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = q0 + lane + 32 * i;
    const T* qrow = q + (bm * Q + (qi < Q ? qi : 0)) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[i][d] = qi < Q ? to_f32(qrow[d]) * scale : 0.f;
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
    for (int t = tid; t < n * D; t += THREADS) {
      ks[t / D][t % D] = to_f32(kg[(size_t)s0 * D + t]);
      vs[t / D][t % D] = to_f32(vg[(size_t)s0 * D + t]);
    }
    for (int t = tid; t < n; t += THREADS) {
      kbias[t] = kbg[s0 + t];
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
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float si = s[i] + bias;
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
  float* og = out + (bm * Q + q0) * D;
  const int rows = min(BQ, Q - q0);
  for (int t = tid; t < rows * D; t += THREADS) og[t] = out_tile[t / D][t % D];
}

template <typename T>
void launch(bool prior, const void* q, const void* k, const void* v,
            const float* key_bias, const float* cx, const float* cy,
            const float* ihw, const float* ihh, const int* level,
            const float* px, const float* py, const float* gamma, float* out,
            int B, int M, int Q, int S, int L, cudaStream_t stream) {
  const dim3 grid((Q + BQ - 1) / BQ, M, B);
  const float scale = 1.f / sqrtf((float)D);
  if (prior)
    box_attn_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, key_bias, cx, cy, ihw, ihh,
        level, px, py, gamma, out, M, Q, S, L, scale);
  else
    box_attn_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, key_bias, cx, cy, ihw, ihh,
        level, px, py, gamma, out, M, Q, S, L, scale);
}

}  // namespace

extern "C" int dtlr_box_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* key_bias, const void* cx,
                                 const void* cy, const void* ihw,
                                 const void* ihh, const void* level,
                                 const void* px, const void* py,
                                 const void* gamma, void* out, int B, int M,
                                 int Q, int S, int D_, int L, int bf16,
                                 int prior, void* stream) {
  if (D_ != D || L < 1 || L > MAX_L || Q < 1 || S < 1) return (int)cudaErrorInvalidValue;
  auto launch_t = bf16 ? launch<__nv_bfloat16> : launch<float>;
  launch_t(prior != 0, q, k, v, (const float*)key_bias, (const float*)cx,
           (const float*)cy, (const float*)ihw, (const float*)ihh,
           (const int*)level, (const float*)px, (const float*)py,
           (const float*)gamma, (float*)out, B, M, Q, S, L,
           (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int dtlr_box_attn_head_dim() { return D; }
