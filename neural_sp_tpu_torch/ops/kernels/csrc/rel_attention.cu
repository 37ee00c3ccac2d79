// K1: relative-position self-attention forward, float32 and bf16 entries,
// for sm_90a.
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
// A window on the keys (causal, chunkwise; rel_attention_common.cuh's
// Window and key_range) and a query offset against cached keys are three
// and two integers. Each block visits only the key tiles that one of its
// 64 rows may attend (per query tile, not per batch row: a tile spans
// several chunks); keys outside a row's range inside them score finfo.min
// / 2, whose weights exp(min/2 - max) are exactly 0 once one allowed key
// was seen. A row with no allowed key (klens[b] == 0, or a pad query whose
// chunk window lies wholly past klens[b]) gets uniform weights over all Tk
// keys, as the masked softmax of the JAX module does: a block holding one
// visits every key tile.
//
// Dropout of the attention probabilities (the Transformer-XL's
// dropout_att) is a third instantiation of the windowed kernel: after the
// online softmax each exp(s - m) is multiplied by its element's scale from
// the counter hash (rel_attention_common.cuh's Drop: 1 / (1 - rate) kept,
// 0 dropped) before P v, while the row sum l takes the undropped values,
// so o = sum_j P_j M_j v_j with P the undropped softmax.
//
// The forward also writes each row's softmax statistics, the running max
// m and the sum l of exp(s - m), for the backward (K1b): P = exp(s - m) /
// l. Both are kept instead of one log-sum-exp m + log l because a row with
// every key masked has m = finfo.min / 2, where adding log l would be
// absorbed and P would come out 1 instead of 1 / T.
//
// The bf16 entry (nsp_rel_attention_bf16; q, k, v, p, o bf16, m and l
// float32) computes what the TPU kernel computed for bf16 inputs: the
// scores in float32 (`preferred_element_type=jnp.float32`), the bias formed
// from p in float32, the softmax in float32, P normalised and then rounded
// to the input type before P v (`(e / sum(e)).astype(q.dtype)`), P v
// accumulated in float32 and the output rounded to the input type. Its
// products are one bf16 mma.sync m16n8k16 per 16-deep slice
// (rel_attention_common.cuh); k and v stream in tiles of 64 keys, 16-byte
// pieces of eight bf16 by cp.async, through the same two-stage ring, with
// no (hi, lo) split and no scratch; P feeds P v from registers. To round
// P after the 1 / l it sweeps the keys three times (k alone for m, k alone
// for l, then k and v), two q k^T products more than the float32 entry's
// single online sweep. At B 32, H 8, T 750 the function's bound is 0.034
// ms of products at the bf16 tensor-core peak (989 TFLOP/s), below its
// 0.05 ms of bytes.

#include "rel_attention_common.cuh"

#include <math.h>

namespace {

using namespace nsp_rel;

// The rel-PE bias and the key mask on a tile of scores s (the C fragments
// of a warp's rows rows[0..1] and keys k0 .. k0 + 8 N - 1), in float32
// registers: a tile whose keys every row of the warp may attend and whose
// 16 rows and keys are all at distance >= R - 1 adds one far-bucket value
// per row (far); other tiles mask each key outside its row's range (rk:
// RowKeys with a window, PadKeys without) and look each score's bucket up
// in the block's rows of p (prows = row q0), at the distance |i + qoff -
// j|.
template <int N, class E, class K>
__device__ __forceinline__ void bias_tile(float (&s)[N][4], const int (&rows)[2],
                                          const K& rk, const float (&far)[2],
                                          const E* prows, int q0, int w0, int k0, int qoff,
                                          int Tq, int Tk, int R, int t) {
  const bool plain = k0 >= rk.wlo && k0 + 8 * N <= rk.whi &&
                     min_distance(w0 + qoff, 16, k0, 8 * N) >= R - 1;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, i = rows[r], j = k0 + n * 8 + 2 * t + (e & 1);
      if (plain) {
        s[n][e] += far[r];
      } else if (j >= Tk) {
        s[n][e] = -INFINITY;  // not a key at all
      } else if (!rk.allowed(r, j)) {
        s[n][e] = kNeg;       // masked key, like apply_mask_logits
      } else if (i < Tq) {
        s[n][e] += rel_bias(prows + (i - q0) * R, i + qoff, j, R);
      }
    }
}

// The online softmax over a tile of biased scores s: s = exp(s - m) against
// the new running max m_run, this lane's share of the row sums l_run moves
// on, and alpha is the factor that rescales what was summed against the
// old max. Each quad of lanes shares its two rows.
template <int N>
__device__ __forceinline__ void online_tile(float (&s)[N][4], float (&m_run)[2],
                                            float (&l_run)[2], float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tile_max = -INFINITY;
#pragma unroll
    for (int n = 0; n < N; ++n) tile_max = fmaxf(tile_max, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    const float m_new = fmaxf(m_run[r], quad_max(tile_max));  // finite: key k0 < T
    alpha[r] = __expf(m_run[r] - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = __expf(s[n][2 * r + c] - m_new);
        s[n][2 * r + c] = e;
        psum += e;
      }
    l_run[r] = l_run[r] * alpha[r] + psum;
    m_run[r] = m_new;
  }
}

template <int DK, bool WIN, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_fwd_kernel(const float* __restrict__ q, const float2* __restrict__ kp,
                         const float2* __restrict__ vp, const float* __restrict__ p,
                         const int* __restrict__ klens, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, int H, int Tq,
                         int Tk, int R, Window win, Drop drop) {
  if constexpr (!WIN) Tk = Tq;  // offline: as many keys as queries
  extern __shared__ float4 smem4[];
  float2* ring = reinterpret_cast<float2*>(smem4);  // 2 stages x (K, V) split tiles
  float* ps = reinterpret_cast<float*>(ring + 4 * Tile<DK>::kPairs);  // [64][R <= kSmemR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float2* kb = kp + bh * Tk * DK;
  const float2* vb = vp + bh * Tk * DK;
  const float* pb = p + bh * Tq * R;

  // this thread's two query rows and their keys; the key tiles the block
  // visits: those some row may attend, or all when a row may attend none
  // (klens[b] = 0, or a window past it: uniform weights over every key)
  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const auto rk = row_keys<WIN>(win, rows, klens[b], Tq, Tk);
  int kt0, n_tiles;
  key_tiles<WIN, kStep, true>(rk, rows, Tq, Tk, kt0, n_tiles);
  const int qoff = WIN ? win.qoff : 0;  // a constant 0 offline

  load_pairs_async<DK>(ring, kb, kt0, Tk);
  load_pairs_async<DK>(ring + Tile<DK>::kPairs, vb, kt0, Tk);
  cp_async_commit();
  const float* prows = stage_p_rows<kRows>(ps, pb, q0, Tq, R);  // row q0 of p

  // their far-bucket bias, and the warp's 16 rows of q as split A
  // fragments, held for the whole key loop
  float far[2];
  FragA qa[DK / 8];
  {
    const float* qr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = rows[e] < Tq;
      far[e] = in ? pb[(size_t)rows[e] * R + R - 1] : 0.0f;
      qr[e] = in ? q + (bh * Tq + rows[e]) * DK : nullptr;
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
  // with dropout, the flat index of each row's key 0 in [B, H, Tq, Tk]
  // (mod 2^32, as the uint32 counter)
  uint32_t drow[2] = {0u, 0u};
  if constexpr (DROP)
#pragma unroll
    for (int e = 0; e < 2; ++e) drow[e] = static_cast<uint32_t>((bh * Tq + rows[e]) * Tk);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      float2* next = ring + ((it + 1) & 1) * 2 * Tile<DK>::kPairs;
      load_pairs_async<DK>(next, kb, kt0 + (it + 1) * kStep, Tk);
      load_pairs_async<DK>(next + Tile<DK>::kPairs, vb, kt0 + (it + 1) * kStep, Tk);
    }
    cp_async_commit();
    const float2* ks = ring + (it & 1) * 2 * Tile<DK>::kPairs;
    const float2* vs = ks + Tile<DK>::kPairs;
    const int k0 = kt0 + it * kStep;

    float s[kStep / 8][4];
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt<DK>(s, [&](int kk) { return qa[kk]; }, ks, g, t);
    bias_tile(s, rows, rk, far, prows, q0, w0, k0, qoff, Tq, Tk, R, t);
    float alpha[2];
    online_tile(s, m_run, l_run, alpha);
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // dropout: the kept exp(s - m) scaled, the dropped ones out of P v;
    // the row sums l (online_tile) stay those of the undropped P
    if constexpr (DROP)
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= drop_scale(drop, drow[e >> 1] + (uint32_t)(k0 + n * 8 + 2 * t + (e & 1)));
    product_pn<DK>(acc, s, vs, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    const float l = quad_sum(l_run[r]);
    if (i >= Tq) continue;
    if (t == 0) {
      m_out[bh * Tq + i] = m_run[r];
      l_out[bh * Tq + i] = l;
    }
    const float inv = 1.0f / l;
    float* orow = o + (bh * Tq + i) * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int DK, bool WIN, bool DROP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* p,
                   const int* klens, float* o, float* m, float* l, float2* kvp, int B, int H,
                   int Tq, int Tk, int R, Window win, Drop drop, cudaStream_t stream) {
  const size_t n = (size_t)B * H * Tk * DK;
  const int smem = 4 * Tile<DK>::kPairs * (int)sizeof(float2) +  // 2 x (K, V), p rows
                   kRows * kSmemR * (int)sizeof(float);
  cudaError_t err = allow_smem<rel_attention_fwd_kernel<DK, WIN, DROP>>(smem);
  if (err == cudaSuccess) err = split_pairs(k, v, kvp, n, stream);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kRows - 1) / kRows, H, B);
  rel_attention_fwd_kernel<DK, WIN, DROP><<<grid, kThreads, smem, stream>>>(
      q, kvp, kvp + n, p, klens, o, m, l, H, Tq, Tk, R, win, drop);
  return cudaGetLastError();
}

// The bf16 forward with a window on the keys (or against cached keys; the
// offline one, rel_attention_fwd_bf16 below, sweeps the same way): one
// block of 4 warps per (64 queries, head, batch), as the float32 kernel; q
// held as bf16 A fragments in registers, k and v streamed in STEP-key
// bf16 tiles. Three sweeps over the key tiles through one cp.async ring: the first reads k alone and takes each row's max m,
// the second k alone and the sum l of exp(s - m) at that m, the third k and
// v: it forms P = exp(s - m) / l, rounds it to bf16 and accumulates P v.
// So P is rounded where the TPU kernel rounded it, after the normalisation
// (`(e / sum(e)).astype(q.dtype)`); a single online sweep would round
// exp(s - m) before the 1 / l, and with near-uniform attention, where every
// P of a row rounds the same way, the two points give coherently different
// outputs. And l is the sum of exactly the exponentials K1b recomputes from
// m: an online l (rescaled as the running max grows) is off by a rounding
// that points one way in every row, so K1b's P summed to 1 + eps, and
// ds = P (dP - D) kept a residual D eps in each row that the attention
// query and key gradients added up over all rows (at bf16, up to 2.7
// times the plain path's distance from float32 on a ragged microbatch of
// trained weights).
template <int DK, int STEP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_fwd_bf16_window(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ p,
                              const int* __restrict__ klens, bf16* __restrict__ o,
                              float* __restrict__ m_out, float* __restrict__ l_out, int H,
                              int Tq, int Tk, int R, Window win) {
  constexpr int W = TileB<DK>::kWords, kTile = STEP * W;
  extern __shared__ float4 smem4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem4);    // 2 stages x (K, V) tiles
  bf16* ps = reinterpret_cast<bf16*>(ring + 4 * kTile);  // [64][R <= kSmemR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k + bh * Tk * DK);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v + bh * Tk * DK);
  const bf16* pb = p + bh * Tq * R;

  // the rows' keys and the key tiles the block visits, as the float32
  // kernel: the same in each of the three sweeps
  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const auto rk = row_keys<true>(win, rows, klens[b], Tq, Tk);
  int kt0, n_tiles;
  key_tiles<true, STEP, true>(rk, rows, Tq, Tk, kt0, n_tiles);
  const int qoff = win.qoff;

  // step `it` of the three sweeps: key tile it % n_tiles, its v in the third
  const auto load = [&](int it) {
    uint32_t* dst = ring + (it & 1) * 2 * kTile;
    const int k0 = kt0 + (it % n_tiles) * STEP;
    load_async<STEP, DK / 2, W>(dst, kb, k0, Tk);
    if (it >= 2 * n_tiles) load_async<STEP, DK / 2, W>(dst + kTile, vb, k0, Tk);
  };
  // waits for step it's tiles, starts the next step's copy; returns the
  // stage holding step it's k (its v kTile words on)
  const auto advance = [&](int it) -> const uint32_t* {
    cp_async_wait_all();
    __syncthreads();  // step `it` has landed; every warp is done with it - 1
    if (it + 1 < 3 * n_tiles) load(it + 1);
    cp_async_commit();
    return ring + (it & 1) * 2 * kTile;
  };
  load(0);
  cp_async_commit();
  const bf16* prows = stage_p_rows<kRows>(ps, pb, q0, Tq, R);  // row q0 of p

  float far[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    far[e] = rows[e] < Tq ? __bfloat162float(pb[(size_t)rows[e] * R + R - 1]) : 0.0f;
  uint32_t qa[DK / 16][4];
  load_a_rows<DK>(qa, q + bh * Tq * DK, w0, Tq, g, t);

  // first sweep: the row max; second: the sum of exp(s - max)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t* ks = advance(it);
    float s[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);
    bias_tile(s, rows, rk, far, prows, q0, w0, kt0 + it * STEP, qoff, Tq, Tk, R, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int n = 0; n < STEP / 8; ++n)
        tile_max = fmaxf(tile_max, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m_run[r] = fmaxf(m_run[r], quad_max(tile_max));
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t* ks = advance(n_tiles + it);
    float s[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);
    bias_tile(s, rows, rk, far, prows, q0, w0, kt0 + it * STEP, qoff, Tq, Tk, R, t);
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l_run[e >> 1] += __expf(s[n][e] - m_run[e >> 1]);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = 1.0f / l;
    if (rows[r] < Tq && t == 0) {
      m_out[bh * Tq + rows[r]] = m_run[r];
      l_out[bh * Tq + rows[r]] = l;
    }
  }

  // third sweep: P v with P normalised, then rounded to bf16
  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t* ks = advance(2 * n_tiles + it);
    float s[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);
    bias_tile(s, rows, rk, far, prows, q0, w0, kt0 + it * STEP, qoff, Tq, Tk, R, t);
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - m_run[e >> 1]) * inv[e >> 1];
    product_pn_bf16<DK, STEP / 8>(acc, s, ks + kTile, lane);  // P rounded to bf16 there
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + (bh * Tq + rows[r]) * DK);
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) orow[n * 4 + t] = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// The offline bf16 forward (no window, as many keys as queries): the same
// three sweeps with the padding's klen test alone, kept as its own kernel.
// Compiled from the windowed kernel's body with PadKeys it took 156
// registers against these 144 (DK 64) and ran 5% slower at B 32, H 8, T
// 750 (NVIDIA H100 80GB HBM3, 700 W; rel_attention_times.py in turns).
template <int N, class E>
__device__ __forceinline__ void bias_tile_pad(float (&s)[N][4], const int (&rows)[2],
                                              const float (&far)[2], const E* prows, int q0,
                                              int w0, int k0, int klen, int T, int R, int t) {
  const bool plain = k0 + 8 * N <= min(klen, T) && min_distance(w0, 16, k0, 8 * N) >= R - 1;
#pragma unroll
  for (int n = 0; n < N; ++n)
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
}

template <int DK, int STEP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ p,
                       const int* __restrict__ klens, bf16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out, int H, int T,
                       int R) {
  constexpr int W = TileB<DK>::kWords, kTile = STEP * W;
  extern __shared__ float4 smem4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem4);    // 2 stages x (K, V) tiles
  bf16* ps = reinterpret_cast<bf16*>(ring + 4 * kTile);  // [64][R <= kSmemR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k + bh * T * DK);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v + bh * T * DK);
  const bf16* pb = p + bh * T * R;

  const int klen = klens[b];
  const int kend = (klen > 0) ? min(klen, T) : T;
  const int n_tiles = (kend + STEP - 1) / STEP;

  // step `it` of the three sweeps: key tile it % n_tiles, its v in the third
  const auto load = [&](int it) {
    uint32_t* dst = ring + (it & 1) * 2 * kTile;
    const int k0 = (it % n_tiles) * STEP;
    load_async<STEP, DK / 2, W>(dst, kb, k0, T);
    if (it >= 2 * n_tiles) load_async<STEP, DK / 2, W>(dst + kTile, vb, k0, T);
  };
  // waits for step it's tiles, starts the next step's copy; returns the
  // stage holding step it's k (its v kTile words on)
  const auto advance = [&](int it) -> const uint32_t* {
    cp_async_wait_all();
    __syncthreads();  // step `it` has landed; every warp is done with it - 1
    if (it + 1 < 3 * n_tiles) load(it + 1);
    cp_async_commit();
    return ring + (it & 1) * 2 * kTile;
  };
  load(0);
  cp_async_commit();
  const bf16* prows = stage_p_rows<kRows>(ps, pb, q0, T, R);  // row q0 of p

  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  float far[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    far[e] = rows[e] < T ? __bfloat162float(pb[(size_t)rows[e] * R + R - 1]) : 0.0f;
  uint32_t qa[DK / 16][4];
  load_a_rows<DK>(qa, q + bh * T * DK, w0, T, g, t);

  // first sweep: the row max; second: the sum of exp(s - max)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t* ks = advance(it);
    float s[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);
    bias_tile_pad(s, rows, far, prows, q0, w0, it * STEP, klen, T, R, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int n = 0; n < STEP / 8; ++n)
        tile_max = fmaxf(tile_max, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      m_run[r] = fmaxf(m_run[r], quad_max(tile_max));
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t* ks = advance(n_tiles + it);
    float s[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);
    bias_tile_pad(s, rows, far, prows, q0, w0, it * STEP, klen, T, R, t);
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l_run[e >> 1] += __expf(s[n][e] - m_run[e >> 1]);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = 1.0f / l;
    if (rows[r] < T && t == 0) {
      m_out[bh * T + rows[r]] = m_run[r];
      l_out[bh * T + rows[r]] = l;
    }
  }

  // third sweep: P v with P normalised, then rounded to bf16
  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t* ks = advance(2 * n_tiles + it);
    float s[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);
    bias_tile_pad(s, rows, far, prows, q0, w0, it * STEP, klen, T, R, t);
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - m_run[e >> 1]) * inv[e >> 1];
    product_pn_bf16<DK, STEP / 8>(acc, s, ks + kTile, lane);  // P rounded to bf16 there
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + (bh * T + rows[r]) * DK);
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) orow[n * 4 + t] = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int DK, bool WIN>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* p,
                        const int* klens, bf16* o, float* m, float* l, int B, int H, int Tq,
                        int Tk, int R, Window win, cudaStream_t stream) {
  constexpr int STEP = kStepB;
  const int smem = 4 * STEP * TileB<DK>::kWords * (int)sizeof(uint32_t) +  // 2 x (K, V), p rows
                   kRows * kSmemR * (int)sizeof(bf16);
  dim3 grid((Tq + kRows - 1) / kRows, H, B);
  if constexpr (WIN) {
    cudaError_t err = allow_smem<rel_attention_fwd_bf16_window<DK, STEP>>(smem);
    if (err != cudaSuccess) return err;
    rel_attention_fwd_bf16_window<DK, STEP><<<grid, kThreads, smem, stream>>>(
        q, k, v, p, klens, o, m, l, H, Tq, Tk, R, win);
  } else {
    cudaError_t err = allow_smem<rel_attention_fwd_bf16<DK, STEP>>(smem);
    if (err != cudaSuccess) return err;
    rel_attention_fwd_bf16<DK, STEP><<<grid, kThreads, smem, stream>>>(q, k, v, p, klens, o, m, l,
                                                                     H, Tq, R);
  }
  return cudaGetLastError();
}

// The window of the keys (rel_attention_common.cuh's Window): nc = 0 for
// none, nl, nr; the queries sit at key positions Tk - Tq on; keys below
// kstart are masked.
Window make_window(int Tq, int Tk, int nc, int nl, int nr, int kstart) {
  return Window{nc, nl, nr, Tk - Tq, kstart};
}

// Whether a call takes the windowed kernels (RowKeys); the offline calls
// run the kernels of the padding alone (PadKeys, and the bf16 forward's
// own offline kernel).
bool windowed(const Window& w, int Tq, int Tk) {
  return w.nc > 0 || w.kstart > 0 || Tq != Tk;
}

bool bad_shape(int B, int H, int Tq, int Tk, int R, int nc, int nr, int kstart) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk < Tq || R <= 0 || H > 65535 || B > 65535 || nc < 0 ||
         nr < 0 || kstart < 0;
}

// The dropout of the attention probabilities: keep = 1 - rate (as a
// float32, the threshold JAX compares against) and the key words; keep >=
// 1 for none.
Drop make_drop(float keep, unsigned k0, unsigned k1) {
  return Drop{k0, k1, keep, 1.0f / keep};
}

}  // namespace

// q, o: [B, H, Tq, dk]; k, v: [B, H, Tk, dk] (Tq <= Tk); p: [B, H, Tq, R];
// klens: [B] int32; m, l: [B, H, Tq] row statistics; kvp: scratch [2, B,
// H, Tk, dk, 2] for the split k and v; the window nc (0: none), nl, nr
// and the first valid key kstart; the dropout of the attention
// probabilities: keep = 1 - rate (1: none) and its two key words. All
// contiguous and 16-byte aligned, on the device of `stream`. Returns a
// cudaError_t.
extern "C" int nsp_rel_attention_f32(const void* q, const void* k, const void* v,
                                     const void* p, const void* klens, void* o, void* m,
                                     void* l, void* kvp, int B, int H, int Tq, int Tk, int R,
                                     int dk, int nc, int nl, int nr, int kstart, float keep,
                                     unsigned k0, unsigned k1, void* stream) {
  if (bad_shape(B, H, Tq, Tk, R, nc, nr, kstart) || !(keep > 0.0f && keep <= 1.0f))
    return (int)cudaErrorInvalidValue;
  const Window win = make_window(Tq, Tk, nc, nl, nr, kstart);
  const Drop drop = make_drop(keep, k0, k1);
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
  // dropout runs in its own instantiation of the windowed kernel (which
  // takes any window, or none), so the others keep their code
#define NSP_LAUNCH(D)                                                                          \
  (keep < 1.0f ? launch<D, true, true>(qf, kf, vf, pf, kl, of, mf, lf, kvpf, B, H, Tq, Tk, R,  \
                                       win, drop, s)                                           \
   : windowed(win, Tq, Tk)                                                                     \
       ? launch<D, true, false>(qf, kf, vf, pf, kl, of, mf, lf, kvpf, B, H, Tq, Tk, R, win,    \
                                drop, s)                                                       \
       : launch<D, false, false>(qf, kf, vf, pf, kl, of, mf, lf, kvpf, B, H, Tq, Tk, R, win,   \
                                 drop, s))
  switch (dk) {
    case 16: return (int)NSP_LAUNCH(16);
    case 32: return (int)NSP_LAUNCH(32);
    case 64: return (int)NSP_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NSP_LAUNCH
}

// The bf16 entry: q, k, v, p, o bf16 (shapes as above), m, l float32
// [B, H, Tq], klens [B] int32; no scratch. All contiguous, q, k, v 16-byte
// aligned, on the device of `stream`. Returns a cudaError_t.
extern "C" int nsp_rel_attention_bf16(const void* q, const void* k, const void* v,
                                      const void* p, const void* klens, void* o, void* m,
                                      void* l, int B, int H, int Tq, int Tk, int R, int dk, int nc,
                                      int nl, int nr, int kstart, void* stream) {
  using nsp_rel::bf16;
  if (bad_shape(B, H, Tq, Tk, R, nc, nr, kstart)) return (int)cudaErrorInvalidValue;
  const Window win = make_window(Tq, Tk, nc, nl, nr, kstart);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* pb = static_cast<const bf16*>(p);
  const int* kl = static_cast<const int*>(klens);
  bf16* ob = static_cast<bf16*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NSP_LAUNCH(D)                                                                   \
  (windowed(win, Tq, Tk)                                                                \
       ? launch_bf16<D, true>(qb, kb, vb, pb, kl, ob, mf, lf, B, H, Tq, Tk, R, win, s)  \
       : launch_bf16<D, false>(qb, kb, vb, pb, kl, ob, mf, lf, B, H, Tq, Tk, R, win, s))
  switch (dk) {
    case 16: return (int)NSP_LAUNCH(16);
    case 32: return (int)NSP_LAUNCH(32);
    case 64: return (int)NSP_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NSP_LAUNCH
}
