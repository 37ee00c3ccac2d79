// K1b: relative-position self-attention backward, float32 and bf16
// entries, for sm_90a.
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
// With a window on the keys (rel_attention_common.cuh's Window; causal or
// chunkwise, no query offset), pass 1 visits the key tiles some row of
// its block may attend, and pass 2 the query tiles whose rows' ranges
// meet its keys, together with every row that may attend no key: such a
// row has uniform P over all T keys and ds = 0, so it adds P^T dO to
// every key's dv, past klens too (query_span). Each staged query tile
// carries its rows' key ranges beside their statistics.
// Fewer queries than keys (the Transformer-XL's segment against its
// memory: query i sits at key position i + Tk - Tq, Window's qoff) take
// the windowed passes: pass 1's blocks own Tq query rows and stream Tk
// keys, pass 2's own Tk keys and stream Tq query rows. Dropout of the
// attention probabilities runs in its own instantiation of them: each
// pass hashes the keep mask of an element where it uses it
// (rel_attention_common.cuh's Drop), dP = (dO v^T) M in both, and pass 2
// feeds dv += (P M)^T dO from a masked copy of P^T (D = rowsum(dO o) is
// unchanged, o being the dropped forward's output).
// Both passes reuse one scratch for the split operands. S and dP are
// formed in both passes: seven products where five suffice. FA2's single
// key-major pass would need dq summed across blocks with float32 atomics,
// whose order changes from run to run; this design keeps the result
// deterministic instead.
//
// The bf16 entry (nsp_rel_attention_bwd_bf16, in rel_attention_bwd_bf16.cu,
// which shares rel_attention_bwd_common.cuh with this one; q, k, v, o, dO,
// dq, dk, dv, p, dp bf16; m, l float32) runs the same two passes on bf16
// mma.sync
// m16n8k16 products with float32 accumulation, and rounds where the TPU
// kernel did (`aws_lp`, `ds_lp`): P and ds in float32 registers, rounded
// to bf16 only as the A operand of dv += P^T dO, dq += ds k and dk += ds^T
// q. D = sum dO o is taken in float32 from the bf16 o and dO. A block keeps
// its warps' 16 rows of (q, dO) or (k, v) as bf16 A fragments in registers
// and streams the other pair in 64-row tiles by cp.async, with no split
// and no scratch for it. dp's bucket sums are float32, in shared memory
// when R <= 16 (else in a float32 scratch of the caller), each bucket's
// adds onto zero as in the float32 pass, and are written as bf16 once the
// block's pass is done: deterministic. Bound at B 32, H 8, T 750: 0.085 ms
// of products at the bf16 peak against 0.12 ms of bytes. With dropout the
// bf16 passes run their own instantiation (DROP) of the windowed ones:
// dP = (dO v^T) M in both, and dv += (P M)^T dO with P rounded to bf16
// before the mask, as the plain bf16 version.

#include "rel_attention_bwd_common.cuh"

#include <math.h>

namespace {

using namespace nsp_rel;

template <int DK, bool WIN, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attn_bwd_dq(const float* __restrict__ q, const float2* __restrict__ kp,
                const float2* __restrict__ vp, const float* __restrict__ p,
                const int* __restrict__ klens, const float* __restrict__ o,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ dout, float* __restrict__ dq,
                float* __restrict__ dp, float* __restrict__ delta, int H, int Tq, int Tk, int R,
                Window win, Drop drop) {
  if constexpr (!WIN) Tk = Tq;  // offline: as many keys as queries
  const int T = Tq;             // the query rows this pass owns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // raw [64][DK + 4]
  float* dos = qs + Tile<DK>::kRaw;             // raw [64][DK + 4]
  float2* ring = reinterpret_cast<float2*>(dos + Tile<DK>::kRaw);  // 2 x (K, V) split
  float* ps = reinterpret_cast<float*>(ring + 4 * Tile<DK>::kPairs);  // [64][R <= kSmemR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float2* kb = kp + bh * Tk * DK;
  const float2* vb = vp + bh * Tk * DK;
  const float* pb = p + bh * T * R;
  float* dpb = dp + bh * T * R;
  const int qoff = WIN ? win.qoff : 0;  // query i sits at key i + qoff

  // the key tiles some row of the block may attend (a row with none has
  // ds = 0)
  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const auto rk = row_keys<WIN>(win, rows, klens[b], T, Tk);
  int kt0, n_tiles;
  key_tiles<WIN, kStep, false>(rk, rows, T, Tk, kt0, n_tiles);
  uint32_t drow[2] = {0u, 0u};  // with dropout: flat index of (row, key 0)
  if constexpr (DROP)
#pragma unroll
    for (int e = 0; e < 2; ++e) drow[e] = static_cast<uint32_t>((bh * T + rows[e]) * Tk);

  load_raw_async<DK>(qs, q + bh * T * DK, q0, T);
  load_raw_async<DK>(dos, dout + bh * T * DK, q0, T);
  if (n_tiles > 0) {
    load_pairs_async<DK>(ring, kb, kt0, Tk);
    load_pairs_async<DK>(ring + Tile<DK>::kPairs, vb, kt0, Tk);
  }
  cp_async_commit();

  const float* prows = stage_p_rows<kRows>(ps, pb, q0, T, R);  // row q0 of p
  // the block's rows of dp start at zero (only this block touches them)
  for (int idx = threadIdx.x; idx < kRows * R; idx += kThreads)
    if (q0 + idx / R < T) dpb[(size_t)q0 * R + idx] = 0.0f;

  // D of this warp's 16 rows, a row per pass of the warp
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
      load_pairs_async<DK>(next, kb, kt0 + (it + 1) * kStep, Tk);
      load_pairs_async<DK>(next + Tile<DK>::kPairs, vb, kt0 + (it + 1) * kStep, Tk);
    }
    cp_async_commit();
    const float2* ks = ring + (it & 1) * 2 * Tile<DK>::kPairs;
    const float2* vs = ks + Tile<DK>::kPairs;
    const int k0 = kt0 + it * kStep;

    float s[kStep / 8][4], dpv[kStep / 8][4];
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.0f;
    product_nt<DK>(s, [&](int kk) { return load_a<DK>(qs, 16 * warp, kk * 8, g, t); }, ks, g,
                   t);
    product_nt<DK>(dpv, [&](int kk) { return load_a<DK>(dos, 16 * warp, kk * 8, g, t); }, vs,
                   g, t);

    ds_tile<DROP>(s, dpv, far_ds, dpb + (size_t)q0 * R, rows, rk, far_p, mr, inv_l, dr, prows,
                  q0, w0, k0, qoff, T, R, t, drop, drow);
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

template <int DK, bool WIN>
__device__ __forceinline__ void load_query_stage(float2* stage, const float2* qb,
                                                 const float2* dob, const float* mb,
                                                 const float* lb, const float* db,
                                                 const float* pb, int i0, int T, int Tk, int R,
                                                 const Window& w, int klen) {
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
    if constexpr (WIN) stage_keys(st + 4 * kStep, kStep, r, i, w, klen, T, Tk);
  }
  stage_p_rows<kStep>(st + kStatsRows<WIN> * kStep, pb, i0, T, R);
}

template <int DK, bool WIN, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attn_bwd_dkdv(const float2* __restrict__ qp, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ p,
                  const int* __restrict__ klens, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ delta,
                  const float2* __restrict__ dop, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int Tq, int Tk, int R, Window win, Drop drop) {
  if constexpr (!WIN) Tk = Tq;  // offline: as many keys as queries
  const int T = Tq;             // the query rows streamed
  const int qoff = WIN ? win.qoff : 0;
  constexpr int kStage = 2 * Tile<DK>::kPairs + kRowStats<WIN> / 2;  // in pairs
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
  // the query tiles whose weights reach this block's keys: without a
  // window all of them below klen (all for keys of a batch row with no
  // valid key: uniform P); with one, query_span's
  int it0, n_tiles;
  query_tiles<WIN, kStep>(win, j0, klen, T, Tk, it0, n_tiles);

  if (n_tiles > 0) {
    load_raw_async<DK>(ks, k + bh * Tk * DK, j0, Tk);
    load_raw_async<DK>(vs, v + bh * Tk * DK, j0, Tk);
    load_query_stage<DK, WIN>(ring, qb, dob, m + bh * T, l + bh * T, delta + bh * T, pb,
                            it0 * kStep, T, Tk, R, win, klen);
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
      load_query_stage<DK, WIN>(ring + ((it + 1) & 1) * kStage, qb, dob, m + bh * T, l + bh * T,
                              delta + bh * T, pb, (it0 + it + 1) * kStep, T, Tk, R, win, klen);
    cp_async_commit();
    const float2* qs = ring + (it & 1) * kStage;
    const float2* dos = qs + Tile<DK>::kPairs;
    const float* st = reinterpret_cast<const float*>(dos + Tile<DK>::kPairs);
    const int i0 = (it0 + it) * kStep;
    const float* prows =
        R <= kSmemR ? st + kStatsRows<WIN> * kStep : pb + (size_t)i0 * R;  // row i0 of p

    float sp[kStep / 8][4];  // S^T, then P^T
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) sp[n][0] = sp[n][1] = sp[n][2] = sp[n][3] = 0.0f;
    product_nt<DK>(sp, [&](int kk) { return load_a<DK>(ks, 16 * warp, kk * 8, g, t); }, qs, g,
                   t);

    p_tile_t<WIN>(sp, st, prows, keys, i0, c0, klen, T, Tk, qoff, R, t);
    // with dropout: the flat index of (row i0, key 0) in [B, H, Tq, Tk]
    const uint32_t drow0 = DROP ? static_cast<uint32_t>((bh * T + i0) * Tk) : 0u;
    if constexpr (DROP) {
      float pm[kStep / 8][4];  // P^T times the scaled keep mask
      drop_tile_t<false>(pm, sp, keys, t, drop, drow0, Tk);
      product_pn<DK>(acc_v, pm, dos, g, t);  // dv += (P M)^T dO
    } else {
      product_pn<DK>(acc_v, sp, dos, g, t);  // dv += P^T dO
    }

    float dpv[kStep / 8][4];  // dP^T, then ds^T
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) dpv[n][0] = dpv[n][1] = dpv[n][2] = dpv[n][3] = 0.0f;
    product_nt<DK>(dpv, [&](int kk) { return load_a<DK>(vs, 16 * warp, kk * 8, g, t); }, dos,
                   g, t);
    ds_tile_t<WIN, DROP>(dpv, sp, st, keys, klen, t, drop, drow0, Tk);
    product_pn<DK>(acc_k, dpv, qs, g, t);  // dk += ds^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = keys[r];
    if (j >= Tk) continue;
    float* dkrow = dk + (bh * Tk + j) * DK;
    float* dvrow = dv + (bh * Tk + j) * DK;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      *reinterpret_cast<float2*>(dkrow + n * 8 + 2 * t) =
          make_float2(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dvrow + n * 8 + 2 * t) =
          make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int DK, bool WIN, bool DROP>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* p,
                       const int* klens, const float* o, const float* m, const float* l,
                       const float* dout, float* dq, float* dk, float* dv, float* dp,
                       float* delta, float2* pairs, int B, int H, int Tq, int Tk, int R,
                       Window win, Drop drop, cudaStream_t s) {
  const size_t nq = (size_t)B * H * Tq * DK, nk = (size_t)B * H * Tk * DK;
  const int smem_dq = 2 * Tile<DK>::kRaw * (int)sizeof(float) +  // Q, dO; 2 x (K, V); p rows
                      4 * Tile<DK>::kPairs * (int)sizeof(float2) +
                      kRows * kSmemR * (int)sizeof(float);
  const int smem_dkdv = 2 * Tile<DK>::kRaw * (int)sizeof(float) +  // K, V; 2 x (Q, dO, stats)
                        2 * (2 * Tile<DK>::kPairs * (int)sizeof(float2) +
                             kRowStats<WIN> * (int)sizeof(float));
  cudaError_t err = allow_smem<rel_attn_bwd_dq<DK, WIN, DROP>>(smem_dq);
  if (err == cudaSuccess) err = allow_smem<rel_attn_bwd_dkdv<DK, WIN, DROP>>(smem_dkdv);
  // pass 1 streams split k and v, pass 2 split q and dO, through the same
  // scratch (in stream order; sized for Tk >= Tq rows)
  if (err == cudaSuccess) err = split_pairs(k, v, pairs, nk, s);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Tq + kRows - 1) / kRows, H, B), grid_k((Tk + kRows - 1) / kRows, H, B);
  rel_attn_bwd_dq<DK, WIN, DROP><<<grid_q, kThreads, smem_dq, s>>>(
      q, pairs, pairs + nk, p, klens, o, m, l, dout, dq, dp, delta, H, Tq, Tk, R, win, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = split_pairs(q, dout, pairs, nq, s)) != cudaSuccess) return err;
  rel_attn_bwd_dkdv<DK, WIN, DROP><<<grid_k, kThreads, smem_dkdv, s>>>(
      pairs, k, v, p, klens, m, l, delta, pairs + nq, dk, dv, H, Tq, Tk, R, win, drop);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: [B, H, Tq, dk]; k, v, dk, dv: [B, H, Tk, dk] (Tq <= Tk:
// query i sits at key position i + Tk - Tq, the Transformer-XL's segment
// against its memory); p, dp: [B, H, Tq, R]; klens [B] int32; m, l (the
// forward's row statistics) and the scratch delta: [B, H, Tq]; pairs:
// scratch [2, B, H, Tk, dk, 2] for split operands; the window nc (0:
// none), nl, nr (rel_attention_common.cuh); the dropout of the attention
// probabilities: keep = 1 - rate (1: none) and its two key words, as the
// forward took them. All contiguous, the [.., dk] ones 16-byte aligned,
// on the device of `stream`. Returns a cudaError_t.
extern "C" int nsp_rel_attention_bwd_f32(const void* q, const void* k, const void* v,
                                         const void* p, const void* klens, const void* o,
                                         const void* m, const void* l, const void* dout,
                                         void* dq, void* dk, void* dv, void* dp, void* delta,
                                         void* pairs, int B, int H, int Tq, int Tk, int R,
                                         int dk_, int nc, int nl, int nr, float keep,
                                         unsigned k0, unsigned k1, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < Tq || R <= 0 || H > 65535 || B > 65535 || nc < 0 ||
      nr < 0 || !(keep > 0.0f && keep <= 1.0f))
    return (int)cudaErrorInvalidValue;
  const nsp_rel::Window win{nc, nl, nr, Tk - Tq, 0};
  const nsp_rel::Drop drop{k0, k1, keep, 1.0f / keep};
  // the windowed passes take a window, fewer queries than keys and
  // dropout (its own instantiation); the offline ones the padding alone
  const bool drops = keep < 1.0f, win_any = nc > 0 || Tq != Tk;
#define NSP_ARGS_W(D, WIN, DROP)                                                               \
  launch_bwd<D, WIN, DROP>(static_cast<const float*>(q), static_cast<const float*>(k),         \
                           static_cast<const float*>(v), static_cast<const float*>(p),         \
                           static_cast<const int*>(klens), static_cast<const float*>(o),       \
                           static_cast<const float*>(m), static_cast<const float*>(l),         \
                           static_cast<const float*>(dout), static_cast<float*>(dq),           \
                           static_cast<float*>(dk), static_cast<float*>(dv),                   \
                           static_cast<float*>(dp), static_cast<float*>(delta),                \
                           static_cast<float2*>(pairs), B, H, Tq, Tk, R, win, drop,            \
                           static_cast<cudaStream_t>(stream))
#define NSP_ARGS(D)                                         \
  (drops ? NSP_ARGS_W(D, true, true)                        \
         : win_any ? NSP_ARGS_W(D, true, false) : NSP_ARGS_W(D, false, false))
  switch (dk_) {
    case 16: return (int)NSP_ARGS(16);
    case 32: return (int)NSP_ARGS(32);
    case 64: return (int)NSP_ARGS(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NSP_ARGS
#undef NSP_ARGS_W
}
