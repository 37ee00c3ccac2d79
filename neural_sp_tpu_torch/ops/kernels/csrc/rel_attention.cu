// K1: relative-position self-attention forward, float32, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` of
// neural_sp_tpu/ops/rel_attention_pallas.py (last present at 583dfc4~1),
// reached through `_call` / `_rel_attention_fwd`. Same semantics:
//
//   s[b,h,i,j] = q[b,h,i,:] . k[b,h,j,:] + p[b,h,i, min(|i-j|, R-1)]
//   s          = finfo(f32).min / 2            for keys j >= klens[b]
//   o[b,h,i,:] = sum_j softmax_j(s)[i,j] v[b,h,j,:]
//
// q and p come pre-scaled by 1/sqrt(dk). An unclamped table is R = T.
//
// What bounds it on the H100: 4 dk flops per query-key pair against O(T dk)
// bytes per (b, h), so at T = 200..800 it is bound by arithmetic: about
// 0.02 ms at B 4, H 8, T 800 on the tensor cores at float32 accuracy
// (3xTF32, 165 TFLOP/s), 0.05 ms on the float32 SIMT pipes.
//
// Design:
// - both products, q k^T and P v, on the tensor cores with the 3xTF32 split
//   (rel_attention_common.cuh), so float32 accuracy holds;
// - one block of 4 warps per (64 queries, head, batch); each warp holds its
//   16 rows of q as split A fragments in registers for the whole loop;
// - k and v are split into TF32 (hi, lo) pairs once, by a pass over device
//   memory before the main kernel, and stream in tiles of 32 keys through
//   a two-stage cp.async ring: the next tile's copy runs under the current
//   tile's products, one barrier per tile, and a B fragment costs one
//   8-byte shared load per element and no split. Two blocks share an SM
//   (72 KB of shared memory each, up to 255 registers a thread; capping
//   the registers at 170 to fit a third block ran slower);
// - the scores stay in registers (mma C fragments) through an online
//   float32 softmax, and P feeds the P v product from registers; no
//   [B,H,T,T] tensor is written;
// - the rel-PE bias is added in registers: a warp whose 16 rows and the
//   tile's 32 keys are all at distance >= R-1 adds one far-bucket value per
//   row, other tiles look each score's bucket up in the block's rows of p,
//   copied into shared memory once (R <= 16; a longer table is read
//   through L1).
// Key tiles past klens[b] are skipped: their weights exp(min/2 - max) are
// exactly 0 once one valid key was seen. With klens[b] == 0 every key is
// masked and the row gets uniform weights, as the masked softmax of the
// JAX module does.
//
// The forward also writes each row's softmax statistics, the running max
// m and the sum l of exp(s - m), for the backward (K1b): P = exp(s - m) /
// l. Both are kept instead of one log-sum-exp m + log l because a row with
// every key masked has m = finfo.min / 2, where adding log l would be
// absorbed and P would come out 1 instead of 1 / T.

#include "rel_attention_common.cuh"

#include <math.h>

namespace {

using namespace nsp_rel;

template <int DK>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_fwd_kernel(const float* __restrict__ q, const float2* __restrict__ kp,
                         const float2* __restrict__ vp, const float* __restrict__ p,
                         const int* __restrict__ klens, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, int H, int T,
                         int R) {
  extern __shared__ float4 smem4[];
  float2* ring = reinterpret_cast<float2*>(smem4);  // 2 stages x (K, V) split tiles
  float* ps = reinterpret_cast<float*>(ring + 4 * Tile<DK>::kPairs);  // [64][R <= kSmemR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float2* kb = kp + bh * T * DK;
  const float2* vb = vp + bh * T * DK;
  const float* pb = p + bh * T * R;

  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : T;
  const int n_tiles = (kend + kStep - 1) / kStep;

  load_pairs_async<DK>(ring, kb, 0, T);
  load_pairs_async<DK>(ring + Tile<DK>::kPairs, vb, 0, T);
  cp_async_commit();
  const float* prows = stage_p_rows<kRows>(ps, pb, q0, T, R);  // row q0 of p

  // this thread's two query rows, their far-bucket bias, and the warp's 16
  // rows of q as split A fragments, held for the whole key loop
  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  float far[2];
  FragA qa[DK / 8];
  {
    const float* qr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = rows[e] < T;
      far[e] = in ? pb[(size_t)rows[e] * R + R - 1] : 0.0f;
      qr[e] = in ? q + (bh * T + rows[e]) * DK : nullptr;
    }
#pragma unroll
    for (int kk = 0; kk < DK / 8; ++kk) {
      const int c = kk * 8 + t;
      qa[kk].set(qr[0] ? qr[0][c] : 0.0f, qr[1] ? qr[1][c] : 0.0f,
                 qr[0] ? qr[0][c + 4] : 0.0f, qr[1] ? qr[1][c + 4] : 0.0f);
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
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

    float s[kStep / 8][4];
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt<DK>(s, [&](int kk) { return qa[kk]; }, ks, g, t);

    // bias and mask, in registers
    const bool plain = k0 + kStep <= min(klen, T) &&
                       min_distance(w0, 16, k0, kStep) >= R - 1;
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1], j = k0 + n * 8 + 2 * t + (e & 1);
        if (plain) {
          s[n][e] += far[e >> 1];
        } else if (j >= T) {
          s[n][e] = -INFINITY;  // not a key at all
        } else if (j >= klen) {
          s[n][e] = kNeg;       // masked key, like apply_mask_logits
        } else if (i < T) {
          s[n][e] += rel_bias(prows + (i - q0) * R, i, j, R);
        }
      }

    // online softmax; each quad of lanes shares its two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
        tile_max = fmaxf(tile_max, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m_run[r], quad_max(tile_max));  // finite: key k0 < T
      const float alpha = __expf(m_run[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = __expf(s[n][2 * r + c] - m_new);
          s[n][2 * r + c] = e;
          psum += e;
        }
      l_run[r] = l_run[r] * alpha + psum;  // this lane's share of the row sum
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    product_pn<DK>(acc, s, vs, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    const float l = quad_sum(l_run[r]);
    if (i >= T) continue;
    if (t == 0) {
      m_out[bh * T + i] = m_run[r];
      l_out[bh * T + i] = l;
    }
    const float inv = 1.0f / l;
    float* orow = o + (bh * T + i) * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int DK>
cudaError_t launch(const float* q, const float* k, const float* v, const float* p,
                   const int* klens, float* o, float* m, float* l, float2* kvp, int B, int H,
                   int T, int R, cudaStream_t stream) {
  const size_t n = (size_t)B * H * T * DK;
  const int smem = 4 * Tile<DK>::kPairs * (int)sizeof(float2) +  // 2 x (K, V), p rows
                   kRows * kSmemR * (int)sizeof(float);
  cudaError_t err = allow_smem<rel_attention_fwd_kernel<DK>>(smem);
  if (err == cudaSuccess) err = split_pairs(k, v, kvp, n, stream);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kRows - 1) / kRows, H, B);
  rel_attention_fwd_kernel<DK><<<grid, kThreads, smem, stream>>>(q, kvp, kvp + n, p, klens, o,
                                                                 m, l, H, T, R);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, T, dk]; p: [B, H, T, R]; klens: [B] int32; m, l:
// [B, H, T] row statistics; kvp: scratch [2, B, H, T, dk, 2] for the split
// k and v. All contiguous and 16-byte aligned, on the device of `stream`.
// Returns a cudaError_t.
extern "C" int nsp_rel_attention_f32(const void* q, const void* k, const void* v,
                                     const void* p, const void* klens, void* o, void* m,
                                     void* l, void* kvp, int B, int H, int T, int R, int dk,
                                     void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || R <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* pf = static_cast<const float*>(p);
  const int* kl = static_cast<const int*>(klens);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float2* kvpf = static_cast<float2*>(kvp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16: return (int)launch<16>(qf, kf, vf, pf, kl, of, mf, lf, kvpf, B, H, T, R, s);
    case 32: return (int)launch<32>(qf, kf, vf, pf, kl, of, mf, lf, kvpf, B, H, T, R, s);
    case 64: return (int)launch<64>(qf, kf, vf, pf, kl, of, mf, lf, kvpf, B, H, T, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
