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
// What bounds it on the H100: five products of 2 dk flops per query-key
// pair against O(T dk) bytes per (b, h): arithmetic, 0.42 ms at B 32, H 8,
// T 750 on the tensor cores at float32 accuracy (3xTF32, 165 TFLOP/s).
//
// Design: every product on the tensor cores with the 3xTF32 split
// (rel_attention_common.cuh), blocks of 4 warps owning 64 rows (16 a
// warp), and the operand a block walks over split into TF32 (hi, lo) pairs
// in device memory first, then streamed in tiles of 32 rows through a
// two-stage cp.async ring. Two passes, no [T, T] block stored:
//   1. rel_attn_bwd_dq, a block per (64 queries, head, batch), streaming
//      split k and v: D of its rows from O and dO, then over the key tiles
//      up to klens: S = Q K^T and dP = dO V^T in registers, P and ds
//      formed there with the bias (from the block's rows of p, copied into
//      shared memory once when R <= 16), dq += ds K. dp's buckets near the
//      diagonal (r < R-1) take ds from the fragment: the keys i - r and
//      i + r are its only addends, added onto zero, so the order of the two
//      adds does not change the sum; the far bucket is a row sum in
//      registers, stored once. It writes D for pass 2.
//   2. rel_attn_bwd_dkdv, a block per (64 keys, head, batch), streaming
//      split q and dO: over all query tiles, S^T = K Q^T and dP^T = V dO^T,
//      then dv += P^T dO and dk += ds^T Q. Key tiles past klens write zeros
//      (dk) or, with no valid key, only dv.
// Both passes reuse one scratch for the split operands. S and dP are
// formed in both passes: seven products where five suffice. FA2's single
// key-major pass would need dq summed across blocks with float32 atomics,
// whose order changes from run to run; this design keeps the result
// deterministic instead.

#include "rel_attention_common.cuh"

#include <math.h>

namespace {

using namespace nsp_rel;

template <int DK>
__global__ void __launch_bounds__(kThreads, 2)
rel_attn_bwd_dq(const float* __restrict__ q, const float2* __restrict__ kp,
                const float2* __restrict__ vp, const float* __restrict__ p,
                const int* __restrict__ klens, const float* __restrict__ o,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ dout, float* __restrict__ dq,
                float* __restrict__ dp, float* __restrict__ delta, int H, int T, int R) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // raw [64][DK + 4]
  float* dos = qs + Tile<DK>::kRaw;             // raw [64][DK + 4]
  float2* ring = reinterpret_cast<float2*>(dos + Tile<DK>::kRaw);  // 2 x (K, V) split
  float* ps = reinterpret_cast<float*>(ring + 4 * Tile<DK>::kPairs);  // [64][R <= kSmemR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float2* kb = kp + bh * T * DK;
  const float2* vb = vp + bh * T * DK;
  const float* pb = p + bh * T * R;
  float* dpb = dp + bh * T * R;

  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : 0;  // no key valid: ds = 0
  const int n_tiles = (kend + kStep - 1) / kStep;

  load_raw_async<DK>(qs, q + bh * T * DK, q0, T);
  load_raw_async<DK>(dos, dout + bh * T * DK, q0, T);
  if (n_tiles > 0) {
    load_pairs_async<DK>(ring, kb, 0, T);
    load_pairs_async<DK>(ring + Tile<DK>::kPairs, vb, 0, T);
  }
  cp_async_commit();

  const float* prows = stage_p_rows<kRows>(ps, pb, q0, T, R);  // row q0 of p
  // the block's rows of dp start at zero (only this block touches them)
  for (int idx = threadIdx.x; idx < kRows * R; idx += kThreads)
    if (q0 + idx / R < T) dpb[(size_t)q0 * R + idx] = 0.0f;

  // D of this warp's 16 rows, a row per pass of the warp
  const int w0 = q0 + 16 * warp;
  float d_mine = 0.0f;  // D of row w0 + lane (lanes 0..15)
  for (int rr = 0; rr < 16; ++rr) {
    const int i = w0 + rr;
    float sum = 0.0f;
    if (i < T)
      for (int d = lane; d < DK; d += 32)
        sum += o[(bh * T + i) * DK + d] * dout[(bh * T + i) * DK + d];
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == rr) d_mine = sum;
  }
  if (lane < 16 && w0 + lane < T) delta[bh * T + w0 + lane] = d_mine;
  const int rows[2] = {w0 + g, w0 + g + 8};
  float dr[2], mr[2], inv_l[2], far_p[2], far_ds[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    dr[e] = __shfl_sync(0xffffffffu, d_mine, g + 8 * e);
    const bool in = rows[e] < T;
    mr[e] = in ? m[bh * T + rows[e]] : 0.0f;
    inv_l[e] = in ? 1.0f / l[bh * T + rows[e]] : 0.0f;
    far_p[e] = in ? pb[(size_t)rows[e] * R + R - 1] : 0.0f;
  }

  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      float2* next = ring + ((it + 1) & 1) * 2 * Tile<DK>::kPairs;
      load_pairs_async<DK>(next, kb, (it + 1) * kStep, T);
      load_pairs_async<DK>(next + Tile<DK>::kPairs, vb, (it + 1) * kStep, T);
    }
    cp_async_commit();
    const float2* ks = ring + (it & 1) * 2 * Tile<DK>::kPairs;
    const float2* vs = ks + Tile<DK>::kPairs;
    const int k0 = it * kStep;

    float s[kStep / 8][4], dpv[kStep / 8][4];
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.0f;
    product_nt<DK>(s, [&](int kk) { return load_a<DK>(qs, 16 * warp, kk * 8, g, t); }, ks, g,
                   t);
    product_nt<DK>(dpv, [&](int kk) { return load_a<DK>(dos, 16 * warp, kk * 8, g, t); }, vs,
                   g, t);

    // P and ds in registers; dp's buckets from ds
    const bool plain = k0 + kStep <= kend && min_distance(w0, 16, k0, kStep) >= R - 1;
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = rows[r], j = k0 + n * 8 + 2 * t + (e & 1);
        float ds;
        if (plain) {
          ds = __expf(s[n][e] + far_p[r] - mr[r]) * inv_l[r] * (dpv[n][e] - dr[r]);
          far_ds[r] += ds;
        } else if (i < T && j < kend) {
          const int dist = min(abs(i - j), R - 1);
          ds = __expf(s[n][e] + prows[(i - q0) * R + dist] - mr[r]) * inv_l[r] *
               (dpv[n][e] - dr[r]);
          if (dist == R - 1) far_ds[r] += ds;
          else atomicAdd(dpb + (size_t)i * R + dist, ds);
        } else {
          ds = 0.0f;
        }
        s[n][e] = ds;
      }
    product_pn<DK>(acc, s, ks, g, t);  // dq += ds K
  }
  cp_async_wait_all();  // with no key tile, the Q and dO copies are still in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    const float far = quad_sum(far_ds[r]);
    if (i >= T) continue;
    if (t == 0) dpb[(size_t)i * R + R - 1] = far;
    float* dqrow = dq + (bh * T + i) * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<float2*>(dqrow + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Per streamed query tile, beside its split Q and dO tiles: the rows' m,
// 1 / l, D and far-bucket bias, then their rows of p when R <= kSmemR.
constexpr int kRowStats = 4 * kStep + kStep * kSmemR;

template <int DK>
__device__ __forceinline__ void load_query_stage(float2* stage, const float2* qb,
                                                 const float2* dob, const float* mb,
                                                 const float* lb, const float* db,
                                                 const float* pb, int i0, int T, int R) {
  load_pairs_async<DK>(stage, qb, i0, T);
  load_pairs_async<DK>(stage + Tile<DK>::kPairs, dob, i0, T);
  float* st = reinterpret_cast<float*>(stage + 2 * Tile<DK>::kPairs);
  for (int r = threadIdx.x; r < kStep; r += kThreads) {
    const int i = i0 + r;
    const bool in = i < T;
    st[r] = in ? mb[i] : 0.0f;
    st[kStep + r] = in ? 1.0f / lb[i] : 0.0f;
    st[2 * kStep + r] = in ? db[i] : 0.0f;
    st[3 * kStep + r] = in ? pb[(size_t)i * R + R - 1] : 0.0f;
  }
  stage_p_rows<kStep>(st + 4 * kStep, pb, i0, T, R);
}

template <int DK>
__global__ void __launch_bounds__(kThreads, 2)
rel_attn_bwd_dkdv(const float2* __restrict__ qp, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ p,
                  const int* __restrict__ klens, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ delta,
                  const float2* __restrict__ dop, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int T, int R) {
  constexpr int kStage = 2 * Tile<DK>::kPairs + kRowStats / 2;  // in pairs
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // this block's keys, raw [64][DK + 4]
  float* vs = ks + Tile<DK>::kRaw;
  float2* ring = reinterpret_cast<float2*>(vs + Tile<DK>::kRaw);  // 2 x (Q, dO, stats)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float2* qb = qp + bh * T * DK;
  const float2* dob = dop + bh * T * DK;
  const float* pb = p + bh * T * R;
  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : T;  // no key valid: uniform P
  const int n_tiles = j0 < kend ? (T + kStep - 1) / kStep : 0;

  if (n_tiles > 0) {
    load_raw_async<DK>(ks, k + bh * T * DK, j0, T);
    load_raw_async<DK>(vs, v + bh * T * DK, j0, T);
    load_query_stage<DK>(ring, qb, dob, m + bh * T, l + bh * T, delta + bh * T, pb, 0, T, R);
  }
  cp_async_commit();

  // this thread's two keys (rows of the transposed tiles)
  const int c0 = j0 + 16 * warp;
  const int keys[2] = {c0 + g, c0 + g + 8};
  float acc_k[DK / 8][4], acc_v[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // stage `it` has landed; every warp is done with it - 1
    if (it + 1 < n_tiles)
      load_query_stage<DK>(ring + ((it + 1) & 1) * kStage, qb, dob, m + bh * T, l + bh * T,
                           delta + bh * T, pb, (it + 1) * kStep, T, R);
    cp_async_commit();
    const float2* qs = ring + (it & 1) * kStage;
    const float2* dos = qs + Tile<DK>::kPairs;
    const float* st = reinterpret_cast<const float*>(dos + Tile<DK>::kPairs);
    const int i0 = it * kStep;
    const float* prows = R <= kSmemR ? st + 4 * kStep : pb + (size_t)i0 * R;  // row i0 of p

    float sp[kStep / 8][4];  // S^T, then P^T
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) sp[n][0] = sp[n][1] = sp[n][2] = sp[n][3] = 0.0f;
    product_nt<DK>(sp, [&](int kk) { return load_a<DK>(ks, 16 * warp, kk * 8, g, t); }, qs, g,
                   t);

    const bool far_tile = min_distance(i0, kStep, c0, 16) >= R - 1;
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), i = i0 + c, j = keys[e >> 1];
        float P = 0.0f;
        if (i < T && j < T) {
          float sv;
          if (j >= klen) sv = kNeg;
          else if (far_tile) sv = sp[n][e] + st[3 * kStep + c];
          else sv = sp[n][e] + rel_bias(prows + c * R, i, j, R);
          P = __expf(sv - st[c]) * st[kStep + c];
        }
        sp[n][e] = P;
      }
    product_pn<DK>(acc_v, sp, dos, g, t);  // dv += P^T dO

    float dpv[kStep / 8][4];  // dP^T, then ds^T
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) dpv[n][0] = dpv[n][1] = dpv[n][2] = dpv[n][3] = 0.0f;
    product_nt<DK>(dpv, [&](int kk) { return load_a<DK>(vs, 16 * warp, kk * 8, g, t); }, dos,
                   g, t);
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        dpv[n][e] = keys[e >> 1] < klen ? sp[n][e] * (dpv[n][e] - st[2 * kStep + c]) : 0.0f;
      }
    product_pn<DK>(acc_k, dpv, qs, g, t);  // dk += ds^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = keys[r];
    if (j >= T) continue;
    float* dkrow = dk + (bh * T + j) * DK;
    float* dvrow = dv + (bh * T + j) * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      *reinterpret_cast<float2*>(dkrow + n * 8 + 2 * t) =
          make_float2(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dvrow + n * 8 + 2 * t) =
          make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int DK>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* p,
                       const int* klens, const float* o, const float* m, const float* l,
                       const float* dout, float* dq, float* dk, float* dv, float* dp,
                       float* delta, float2* pairs, int B, int H, int T, int R,
                       cudaStream_t s) {
  const size_t n = (size_t)B * H * T * DK;
  const int smem_dq = 2 * Tile<DK>::kRaw * (int)sizeof(float) +  // Q, dO; 2 x (K, V); p rows
                      4 * Tile<DK>::kPairs * (int)sizeof(float2) +
                      kRows * kSmemR * (int)sizeof(float);
  const int smem_dkdv = 2 * Tile<DK>::kRaw * (int)sizeof(float) +  // K, V; 2 x (Q, dO, stats)
                        2 * (2 * Tile<DK>::kPairs * (int)sizeof(float2) +
                             kRowStats * (int)sizeof(float));
  cudaError_t err = allow_smem<rel_attn_bwd_dq<DK>>(smem_dq);
  if (err == cudaSuccess) err = allow_smem<rel_attn_bwd_dkdv<DK>>(smem_dkdv);
  // pass 1 streams split k and v, pass 2 split q and dO, through the same
  // scratch (in stream order)
  if (err == cudaSuccess) err = split_pairs(k, v, pairs, n, s);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kRows - 1) / kRows, H, B);
  rel_attn_bwd_dq<DK><<<grid, kThreads, smem_dq, s>>>(q, pairs, pairs + n, p, klens, o, m, l,
                                                      dout, dq, dp, delta, H, T, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = split_pairs(q, dout, pairs, n, s)) != cudaSuccess) return err;
  rel_attn_bwd_dkdv<DK><<<grid, kThreads, smem_dkdv, s>>>(pairs, k, v, p, klens, m, l, delta,
                                                          pairs + n, dk, dv, H, T, R);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: [B, H, T, dk]; p, dp: [B, H, T, R];
// klens [B] int32; m, l (the forward's row statistics) and the scratch
// delta: [B, H, T]; pairs: scratch [2, B, H, T, dk, 2] for split operands.
// All contiguous, the [.., dk] ones 16-byte aligned, on the device of
// `stream`. Returns a cudaError_t.
extern "C" int nsp_rel_attention_bwd_f32(const void* q, const void* k, const void* v,
                                         const void* p, const void* klens, const void* o,
                                         const void* m, const void* l, const void* dout,
                                         void* dq, void* dk, void* dv, void* dp, void* delta,
                                         void* pairs, int B, int H, int T, int R, int dk_,
                                         void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || R <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
#define NSP_ARGS(D)                                                                           \
  launch_bwd<D>(static_cast<const float*>(q), static_cast<const float*>(k),                  \
                static_cast<const float*>(v), static_cast<const float*>(p),                  \
                static_cast<const int*>(klens), static_cast<const float*>(o),                \
                static_cast<const float*>(m), static_cast<const float*>(l),                  \
                static_cast<const float*>(dout), static_cast<float*>(dq),                    \
                static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dp),   \
                static_cast<float*>(delta), static_cast<float2*>(pairs), B, H, T, R,         \
                static_cast<cudaStream_t>(stream))
  switch (dk_) {
    case 16: return (int)NSP_ARGS(16);
    case 32: return (int)NSP_ARGS(32);
    case 64: return (int)NSP_ARGS(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NSP_ARGS
}
