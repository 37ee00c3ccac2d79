// K1b: relative-position self-attention backward, float32, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of
// neural_sp_tpu/ops/rel_attention_pallas.py (last present at 583dfc4~1),
// reached through `_call` / `_rel_attention_bwd`. With the forward's
// scores s (K1: q.k + p[i, min(|i-j|, R-1)], masked to finfo.min / 2 for
// keys j >= klens[b]) and its row statistics m, l:
//
//   P[i,j]  = exp(s[i,j] - m[i]) / l[i]
//   D[i]    = sum_d dO[i,d] O[i,d]          (= sum_j P[i,j] dP[i,j])
//   dP[i,j] = dO[i] . v[j]
//   ds[i,j] = P[i,j] (dP[i,j] - D[i])  for valid keys, 0 for masked ones
//   dv[j] = sum_i P[i,j] dO[i]     dk[j] = sum_i ds[i,j] q[i]
//   dq[i] = sum_j ds[i,j] k[j]     dp[i,r] = sum_j ds[i,j] [min(|i-j|,R-1) = r]
//
// (the masked `where` of the JAX module passes no gradient to a masked
// score; a row with every key masked has uniform P, so only dv is non-zero
// there, as in JAX).
//
// What bounds it on the H100: as the forward, O(T^2 dk) float32
// multiply-adds per (b, h) against O(T dk) bytes. The TPU kernel rebuilt a
// whole [T, T] row block in VMEM; here nothing of size T x T is stored:
//   1. rel_attn_bwd_delta: D, a warp per row;
//   2. rel_attn_bwd_dq: a block per (32 queries, head, batch) walks the key
//      tiles up to klens, rebuilds P from the statistics and the in-kernel
//      rel-PE bias, and sums dq and dp. dp's buckets r < R-1 receive at most
//      the two keys j = i +- r (shared-memory atomics, only near the
//      diagonal); the last bucket sums the far band in registers;
//   3. rel_attn_bwd_dkdv: a block per (32 keys, head, batch) walks every
//      query tile and sums dk and dv. Key tiles past klens write zeros.
// No global atomics, so the result does not depend on the launch order.

#include <cuda_runtime.h>
#include <cfloat>
#include <math.h>

namespace {

constexpr int kB = 32;        // queries or keys per tile
constexpr int kThreads = 256; // thread (ty, tx) = (tid / 16, tid % 16)

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
rel_attn_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                   float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int d = lane; d < DK; d += 32) s += o[(size_t)row * DK + d] * dout[(size_t)row * DK + d];
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Loads rows r0.. of a [T, DK] matrix into a [kB][DK + 1] tile (0 past T).
template <int DK>
__device__ __forceinline__ void load_tile(float (*dst)[DK + 1], const float* src, int r0, int T) {
  for (int idx = threadIdx.x; idx < kB * DK; idx += kThreads) {
    const int r = idx / DK, d = idx % DK, i = r0 + r;
    dst[r][d] = (i < T) ? src[(size_t)i * DK + d] : 0.0f;
  }
}

// P and ds of one (query i, key j) pair from the dot products s = q.k and
// dpv = dO.v. Pairs outside [0, T) give 0.
__device__ __forceinline__ void p_ds(float s, float dpv, int i, int j, int T, int klen, int R,
                                     const float* pb, const float* mb, const float* lb,
                                     const float* db, float& P, float& ds) {
  P = 0.0f;
  ds = 0.0f;
  if (i >= T || j >= T) return;
  const float kNeg = -FLT_MAX / 2.0f;
  const bool valid = j < klen;
  const float sv = valid ? s + pb[(size_t)i * R + min(abs(i - j), R - 1)] : kNeg;
  P = expf(sv - mb[i]) / lb[i];
  if (valid) ds = P * (dpv - db[i]);
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
rel_attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ p,
                const int* __restrict__ klens, const float* __restrict__ m,
                const float* __restrict__ l, const float* __restrict__ delta,
                const float* __restrict__ dout, float* __restrict__ dq,
                float* __restrict__ dp, int H, int T, int R) {
  __shared__ float qs[kB][DK + 1];
  __shared__ float dos[kB][DK + 1];
  __shared__ float ks[kB][DK + 1];
  __shared__ float vs[kB][DK + 1];
  __shared__ float dss[kB][kB + 1];
  extern __shared__ float dps[];  // [kB][R]: dp of the tile's queries

  constexpr int kDM = DK / 16;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* pb = p + bh * T * R;
  const float* mb = m + bh * T;
  const float* lb = l + bh * T;
  const float* db = delta + bh * T;

  load_tile<DK>(qs, q + bh * T * DK, q0, T);
  load_tile<DK>(dos, dout + bh * T * DK, q0, T);
  for (int idx = tid; idx < kB * R; idx += kThreads) dps[idx] = 0.0f;

  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : 0;  // no key valid: ds = 0
  const int n_tiles = (kend + kB - 1) / kB;

  float acc[2][kDM];
  float far[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int mm = 0; mm < kDM; ++mm) acc[r][mm] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<DK>(ks, k + bh * T * DK, k0, T);
    load_tile<DK>(vs, v + bh * T * DK, k0, T);
    __syncthreads();

    float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    float dpv[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float qa = qs[2 * ty][d], qb = qs[2 * ty + 1][d];
      const float oa = dos[2 * ty][d], ob = dos[2 * ty + 1][d];
      const float ka = ks[tx][d], kb2 = ks[tx + 16][d];
      const float va = vs[tx][d], vb = vs[tx + 16][d];
      s[0][0] += qa * ka;  s[0][1] += qa * kb2;
      s[1][0] += qb * ka;  s[1][1] += qb * kb2;
      dpv[0][0] += oa * va;  dpv[0][1] += oa * vb;
      dpv[1][0] += ob * va;  dpv[1][1] += ob * vb;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + 2 * ty + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + tx + 16 * c;
        float P, ds;
        p_ds(s[r][c], dpv[r][c], i, j, T, klen, R, pb, mb, lb, db, P, ds);
        dss[2 * ty + r][tx + 16 * c] = ds;
        if (i < T && j < klen && j < T) {
          const int dist = min(abs(i - j), R - 1);
          if (dist == R - 1) far[r] += ds;
          else atomicAdd(&dps[(2 * ty + r) * R + dist], ds);
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      const float d0 = dss[2 * ty][c], d1 = dss[2 * ty + 1][c];
#pragma unroll
      for (int mm = 0; mm < kDM; ++mm) {
        const float kk = ks[c][tx + 16 * mm];
        acc[0][mm] += d0 * kk;
        acc[1][mm] += d1 * kk;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) far[r] = group_sum(far[r]);
  __syncthreads();
  if (tx == 0) {
    dps[(2 * ty) * R + R - 1] += far[0];
    dps[(2 * ty + 1) * R + R - 1] += far[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + 2 * ty + r;
    if (i >= T) continue;
    float* dqb = dq + (bh * T + i) * DK;
#pragma unroll
    for (int mm = 0; mm < kDM; ++mm) dqb[tx + 16 * mm] = acc[r][mm];
  }
  for (int idx = tid; idx < kB * R; idx += kThreads) {
    const int i = q0 + idx / R;
    if (i < T) dp[(bh * T + i) * R + idx % R] = dps[idx];
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
rel_attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ p,
                  const int* __restrict__ klens, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ delta,
                  const float* __restrict__ dout, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int T, int R) {
  __shared__ float ks[kB][DK + 1];
  __shared__ float vs[kB][DK + 1];
  __shared__ float qs[kB][DK + 1];
  __shared__ float dos[kB][DK + 1];
  __shared__ float ps[kB][kB + 1];   // [query][key]
  __shared__ float dss[kB][kB + 1];

  constexpr int kDM = DK / 16;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * kB;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* pb = p + bh * T * R;
  const float* mb = m + bh * T;
  const float* lb = l + bh * T;
  const float* db = delta + bh * T;
  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : T;  // no key valid: uniform P

  float acc_k[2][kDM], acc_v[2][kDM];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int mm = 0; mm < kDM; ++mm) acc_k[r][mm] = acc_v[r][mm] = 0.0f;

  if (j0 < kend) {
    load_tile<DK>(ks, k + bh * T * DK, j0, T);
    load_tile<DK>(vs, v + bh * T * DK, j0, T);
    for (int i0 = 0; i0 < T; i0 += kB) {
      __syncthreads();
      load_tile<DK>(qs, q + bh * T * DK, i0, T);
      load_tile<DK>(dos, dout + bh * T * DK, i0, T);
      __syncthreads();
      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      float dpv[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
        const float qa = qs[2 * ty][d], qb = qs[2 * ty + 1][d];
        const float oa = dos[2 * ty][d], ob = dos[2 * ty + 1][d];
        const float ka = ks[tx][d], kb2 = ks[tx + 16][d];
        const float va = vs[tx][d], vb = vs[tx + 16][d];
        s[0][0] += qa * ka;  s[0][1] += qa * kb2;
        s[1][0] += qb * ka;  s[1][1] += qb * kb2;
        dpv[0][0] += oa * va;  dpv[0][1] += oa * vb;
        dpv[1][0] += ob * va;  dpv[1][1] += ob * vb;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float P, ds;
          p_ds(s[r][c], dpv[r][c], i0 + 2 * ty + r, j0 + tx + 16 * c, T, klen, R, pb, mb, lb,
               db, P, ds);
          ps[2 * ty + r][tx + 16 * c] = P;
          dss[2 * ty + r][tx + 16 * c] = ds;
        }
      __syncthreads();
      // thread (ty, tx) now owns keys 2*ty, 2*ty+1 of the tile
#pragma unroll 4
      for (int c = 0; c < kB; ++c) {
        const float p0 = ps[c][2 * ty], p1 = ps[c][2 * ty + 1];
        const float s0 = dss[c][2 * ty], s1 = dss[c][2 * ty + 1];
#pragma unroll
        for (int mm = 0; mm < kDM; ++mm) {
          const float od = dos[c][tx + 16 * mm], qd = qs[c][tx + 16 * mm];
          acc_v[0][mm] += p0 * od;
          acc_v[1][mm] += p1 * od;
          acc_k[0][mm] += s0 * qd;
          acc_k[1][mm] += s1 * qd;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 2 * ty + r;
    if (j >= T) continue;
    float* dkb = dk + (bh * T + j) * DK;
    float* dvb = dv + (bh * T + j) * DK;
#pragma unroll
    for (int mm = 0; mm < kDM; ++mm) {
      dkb[tx + 16 * mm] = acc_k[r][mm];
      dvb[tx + 16 * mm] = acc_v[r][mm];
    }
  }
}

template <int DK>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* p,
                       const int* klens, const float* o, const float* m, const float* l,
                       const float* dout, float* dq, float* dk, float* dv, float* dp,
                       float* delta, int B, int H, int T, int R, cudaStream_t s) {
  const int rows = B * H * T;
  rel_attn_bwd_delta<DK><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      o, dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dp_smem = sizeof(float) * kB * R;
  err = cudaFuncSetAttribute(rel_attn_bwd_dq<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dp_smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kB - 1) / kB, H, B);
  rel_attn_bwd_dq<DK><<<grid, kThreads, dp_smem, s>>>(q, k, v, p, klens, m, l, delta, dout, dq,
                                                      dp, H, T, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rel_attn_bwd_dkdv<DK><<<grid, kThreads, 0, s>>>(q, k, v, p, klens, m, l, delta, dout, dk,
                                                  dv, H, T, R);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: [B, H, T, dk]; p, dp: [B, H, T, R];
// klens [B] int32; m, l (the forward's row statistics) and the scratch
// delta: [B, H, T]. All contiguous, on the device of `stream`. Returns a
// cudaError_t.
extern "C" int nsp_rel_attention_bwd_f32(const void* q, const void* k, const void* v,
                                         const void* p, const void* klens, const void* o,
                                         const void* m, const void* l, const void* dout,
                                         void* dq, void* dk, void* dv, void* dp, void* delta,
                                         int B, int H, int T, int R, int dk_, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || R <= 0 || H > 65535 || B > 65535 ||
      (size_t)kB * R * sizeof(float) > 160 * 1024)
    return (int)cudaErrorInvalidValue;
#define NSP_ARGS(D)                                                                           \
  launch_bwd<D>(static_cast<const float*>(q), static_cast<const float*>(k),                  \
                static_cast<const float*>(v), static_cast<const float*>(p),                  \
                static_cast<const int*>(klens), static_cast<const float*>(o),                \
                static_cast<const float*>(m), static_cast<const float*>(l),                  \
                static_cast<const float*>(dout), static_cast<float*>(dq),                    \
                static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dp),   \
                static_cast<float*>(delta), B, H, T, R, static_cast<cudaStream_t>(stream))
  switch (dk_) {
    case 16: return (int)NSP_ARGS(16);
    case 32: return (int)NSP_ARGS(32);
    case 64: return (int)NSP_ARGS(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NSP_ARGS
}
