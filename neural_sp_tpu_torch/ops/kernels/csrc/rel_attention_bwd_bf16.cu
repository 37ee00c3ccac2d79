// K1b's bf16 entry (nsp_rel_attention_bwd_bf16), for sm_90a: the two
// passes of rel_attention_bwd.cu (whose header gives the design and the
// rounding points) on bf16 mma.sync m16n8k16 products, with and without
// dropout of the attention probabilities, each its own instantiation. A
// source of its own, so that its nvcc runs beside the float32 entry's.

#include "rel_attention_bwd_common.cuh"

#include <math.h>

namespace {

using namespace nsp_rel;

// Pass 1 at bf16: a block per (64 queries, head, batch); q and dO as A
// fragments in registers; k and v streamed in STEP-key tiles.
template <int DK, int STEP, bool WIN, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ p,
                     const int* __restrict__ klens, const bf16* __restrict__ o,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dp,
                     float* __restrict__ dp32, float* __restrict__ delta, int H, int Tq, int Tk,
                     int R, Window win, Drop drop) {
  if constexpr (!WIN) Tk = Tq;  // offline: as many keys as queries
  const int T = Tq;             // the query rows this pass owns
  const int qoff = WIN ? win.qoff : 0;
  constexpr int W = TileB<DK>::kWords, kTile = STEP * W;
  extern __shared__ float4 smem4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem4);          // 2 x (K, V) tiles
  float* dps = reinterpret_cast<float*>(ring + 4 * kTile);       // [64][R <= kSmemR] sums
  bf16* ps = reinterpret_cast<bf16*>(dps + kRows * kSmemR);      // [64][R <= kSmemR] of p

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k + bh * Tk * DK);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v + bh * Tk * DK);
  const bf16* pb = p + bh * T * R;

  // the key tiles some row of the block may attend (a row with none has
  // ds = 0)
  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const auto rk = row_keys<WIN>(win, rows, klens[b], T, Tk);
  int kt0, n_tiles;
  key_tiles<WIN, STEP, false>(rk, rows, T, Tk, kt0, n_tiles);
  uint32_t drow[2] = {0u, 0u};  // with dropout: flat index of (row, key 0)
  if constexpr (DROP)
#pragma unroll
    for (int e = 0; e < 2; ++e) drow[e] = static_cast<uint32_t>((bh * T + rows[e]) * Tk);

  if (n_tiles > 0) {
    load_async<STEP, DK / 2, W>(ring, kb, kt0, Tk);
    load_async<STEP, DK / 2, W>(ring + kTile, vb, kt0, Tk);
  }
  cp_async_commit();
  const bf16* prows = stage_p_rows<kRows>(ps, pb, q0, T, R);  // row q0 of p
  // float32 sums of the block's rows of dp (only this block touches them)
  float* dpacc = R <= kSmemR ? dps : dp32 + (bh * T + q0) * R;
  for (int idx = threadIdx.x; idx < kRows * R; idx += kThreads)
    if (q0 + idx / R < T) dpacc[idx] = 0.0f;

  // D of this warp's 16 rows in float32, a row per pass of the warp
  float d_mine = 0.0f;  // D of row w0 + lane (lanes 0..15)
  for (int rr = 0; rr < 16; ++rr) {
    const int i = w0 + rr;
    float sum = 0.0f;
    if (i < T)
      for (int d = lane; d < DK; d += 32)
        sum += __bfloat162float(o[(bh * T + i) * DK + d]) *
               __bfloat162float(dout[(bh * T + i) * DK + d]);
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
    far_p[e] = in ? __bfloat162float(pb[(size_t)rows[e] * R + R - 1]) : 0.0f;
  }
  uint32_t qa[DK / 16][4], doa[DK / 16][4];
  load_a_rows<DK>(qa, q + bh * T * DK, w0, T, g, t);
  load_a_rows<DK>(doa, dout + bh * T * DK, w0, T, g, t);

  float acc[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      uint32_t* next = ring + ((it + 1) & 1) * 2 * kTile;
      load_async<STEP, DK / 2, W>(next, kb, kt0 + (it + 1) * STEP, Tk);
      load_async<STEP, DK / 2, W>(next + kTile, vb, kt0 + (it + 1) * STEP, Tk);
    }
    cp_async_commit();
    const uint32_t* ks = ring + (it & 1) * 2 * kTile;
    const uint32_t* vs = ks + kTile;
    const int k0 = kt0 + it * STEP;

    float s[STEP / 8][4], dpv[STEP / 8][4];
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(s, qa, ks, g, t);     // S = Q K^T
    product_nt_bf16<DK, STEP / 8>(dpv, doa, vs, g, t);  // dP = dO V^T

    ds_tile<DROP>(s, dpv, far_ds, dpacc, rows, rk, far_p, mr, inv_l, dr, prows, q0, w0, k0,
                  qoff, T, R, t, drop, drow);
    product_pn_bf16<DK, STEP / 8>(acc, s, ks, lane);  // dq += ds K, ds rounded to bf16
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    const float far = quad_sum(far_ds[r]);
    if (i >= T) continue;
    if (t == 0) dpacc[(i - q0) * R + R - 1] = far;
    uint32_t* dqrow = reinterpret_cast<uint32_t*>(dq + (bh * T + i) * DK);
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) dqrow[n * 4 + t] = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  __syncthreads();  // every bucket of the block's rows is summed
  bf16* dpb = dp + (bh * T + q0) * R;
  for (int idx = threadIdx.x; idx < kRows * R; idx += kThreads)
    if (q0 + idx / R < T)
      dpb[idx] = __float2bfloat16(R <= kSmemR ? dpacc[idx] : __ldcg(dpacc + idx));
}

// Per streamed query tile of pass 2 at bf16, beside its Q and dO tiles: the
// rows' m, 1 / l, D and far-bucket bias (float32), their key ranges (lo,
// hi as ints), then their rows of p (bf16) when R <= kSmemR. In 32-bit
// words:
template <int STEP, bool WIN>
struct RowStatsB {
  static constexpr int kWords = kStatsRows<WIN> * STEP + STEP * kSmemR / 2;
};

template <int DK, int STEP, bool WIN>
__device__ __forceinline__ void load_query_stage_bf16(uint32_t* stage, const uint32_t* qb,
                                                      const uint32_t* dob, const float* mb,
                                                      const float* lb, const float* db,
                                                      const bf16* pb, int i0, int T, int Tk,
                                                      int R, const Window& w, int klen) {
  constexpr int W = TileB<DK>::kWords, kTile = STEP * W;
  load_async<STEP, DK / 2, W>(stage, qb, i0, T);
  load_async<STEP, DK / 2, W>(stage + kTile, dob, i0, T);
  float* st = reinterpret_cast<float*>(stage + 2 * kTile);
  for (int r = threadIdx.x; r < STEP; r += kThreads) {
    const int i = i0 + r;
    const bool in = i < T;
    st[r] = in ? mb[i] : 0.0f;
    st[STEP + r] = in ? 1.0f / lb[i] : 0.0f;
    st[2 * STEP + r] = in ? db[i] : 0.0f;
    st[3 * STEP + r] = in ? __bfloat162float(pb[(size_t)i * R + R - 1]) : 0.0f;
    if constexpr (WIN) stage_keys(st + 4 * STEP, STEP, r, i, w, klen, T, Tk);
  }
  stage_p_rows<STEP>(reinterpret_cast<bf16*>(st + kStatsRows<WIN> * STEP), pb, i0, T, R);
}

// Pass 2 at bf16: a block per (64 keys, head, batch); k and v as A
// fragments in registers; q and dO streamed in STEP-query tiles.
template <int DK, int STEP, bool WIN, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
rel_attn_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ p,
                       const int* __restrict__ klens, const float* __restrict__ m,
                       const float* __restrict__ l, const float* __restrict__ delta,
                       const bf16* __restrict__ dout, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Tq, int Tk, int R, Window win,
                       Drop drop) {
  if constexpr (!WIN) Tk = Tq;  // offline: as many keys as queries
  const int T = Tq;             // the query rows streamed
  const int qoff = WIN ? win.qoff : 0;
  constexpr int W = TileB<DK>::kWords, kTile = STEP * W;
  constexpr int kStage = 2 * kTile + RowStatsB<STEP, WIN>::kWords;
  extern __shared__ float4 smem4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem4);  // 2 x (Q, dO, stats)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t* qb = reinterpret_cast<const uint32_t*>(q + bh * T * DK);
  const uint32_t* dob = reinterpret_cast<const uint32_t*>(dout + bh * T * DK);
  const bf16* pb = p + bh * T * R;
  const int klen = klens[b];
  // the query tiles whose weights reach this block's keys, as the float32
  // pass
  int it0, n_tiles;
  query_tiles<WIN, STEP>(win, j0, klen, T, Tk, it0, n_tiles);

  if (n_tiles > 0)
    load_query_stage_bf16<DK, STEP, WIN>(ring, qb, dob, m + bh * T, l + bh * T, delta + bh * T, pb,
                                    it0 * STEP, T, Tk, R, win, klen);
  cp_async_commit();

  // this thread's two keys (rows of the transposed products)
  const int c0 = j0 + 16 * warp;
  const int keys[2] = {c0 + g, c0 + g + 8};
  uint32_t ka[DK / 16][4], va[DK / 16][4];
  load_a_rows<DK>(ka, k + bh * Tk * DK, c0, Tk, g, t);
  load_a_rows<DK>(va, v + bh * Tk * DK, c0, Tk, g, t);
  float acc_k[DK / 8][4], acc_v[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // stage `it` has landed; every warp is done with it - 1
    if (it + 1 < n_tiles)
      load_query_stage_bf16<DK, STEP, WIN>(ring + ((it + 1) & 1) * kStage, qb, dob, m + bh * T,
                                      l + bh * T, delta + bh * T, pb, (it0 + it + 1) * STEP, T,
                                      Tk, R, win, klen);
    cp_async_commit();
    const uint32_t* qs = ring + (it & 1) * kStage;
    const uint32_t* dos = qs + kTile;
    const float* st = reinterpret_cast<const float*>(dos + kTile);
    const int i0 = (it0 + it) * STEP;
    const bf16* prows = R <= kSmemR
                            ? reinterpret_cast<const bf16*>(st + kStatsRows<WIN> * STEP)
                            : pb + (size_t)i0 * R;  // row i0 of p

    float sp[STEP / 8][4];  // S^T, then P^T
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) sp[n][0] = sp[n][1] = sp[n][2] = sp[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(sp, ka, qs, g, t);

    p_tile_t<WIN>(sp, st, prows, keys, i0, c0, klen, T, Tk, qoff, R, t);
    // with dropout: the flat index of (row i0, key 0) in [B, H, Tq, Tk]
    const uint32_t drow0 = DROP ? static_cast<uint32_t>((bh * T + i0) * Tk) : 0u;
    if constexpr (DROP) {
      float pm[STEP / 8][4];  // P^T rounded to bf16, times the scaled keep mask
      drop_tile_t<true>(pm, sp, keys, t, drop, drow0, Tk);
      product_pn_bf16<DK, STEP / 8>(acc_v, pm, dos, lane);  // dv += (P M)^T dO
    } else {
      product_pn_bf16<DK, STEP / 8>(acc_v, sp, dos, lane);  // dv += P^T dO, P rounded to bf16
    }

    float dpv[STEP / 8][4];  // dP^T, then ds^T
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n) dpv[n][0] = dpv[n][1] = dpv[n][2] = dpv[n][3] = 0.0f;
    product_nt_bf16<DK, STEP / 8>(dpv, va, dos, g, t);
    ds_tile_t<WIN, DROP>(dpv, sp, st, keys, klen, t, drop, drow0, Tk);
    product_pn_bf16<DK, STEP / 8>(acc_k, dpv, qs, lane);  // dk += ds^T Q, ds rounded to bf16
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = keys[r];
    if (j >= Tk) continue;
    uint32_t* dkrow = reinterpret_cast<uint32_t*>(dk + (bh * Tk + j) * DK);
    uint32_t* dvrow = reinterpret_cast<uint32_t*>(dv + (bh * Tk + j) * DK);
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      dkrow[n * 4 + t] = pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      dvrow[n * 4 + t] = pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int DK, bool WIN, bool DROP>
cudaError_t launch_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* p,
                            const int* klens, const bf16* o, const float* m, const float* l,
                            const bf16* dout, bf16* dq, bf16* dk, bf16* dv, bf16* dp,
                            float* dp32, float* delta, int B, int H, int Tq, int Tk, int R,
                            Window win, Drop drop, cudaStream_t s) {
  constexpr int STEP = kStepB;
  constexpr int kTileBytes = STEP * TileB<DK>::kWords * (int)sizeof(uint32_t);
  const int smem_dq = 4 * kTileBytes +  // 2 x (K, V); dp sums, p rows
                      kRows * kSmemR * (int)(sizeof(float) + sizeof(bf16));
  const int smem_dkdv =  // 2 x (Q, dO, stats)
      2 * (2 * kTileBytes + RowStatsB<STEP, WIN>::kWords * (int)sizeof(uint32_t));
  cudaError_t err = allow_smem<rel_attn_bwd_dq_bf16<DK, STEP, WIN, DROP>>(smem_dq);
  if (err == cudaSuccess)
    err = allow_smem<rel_attn_bwd_dkdv_bf16<DK, STEP, WIN, DROP>>(smem_dkdv);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Tq + kRows - 1) / kRows, H, B), grid_k((Tk + kRows - 1) / kRows, H, B);
  rel_attn_bwd_dq_bf16<DK, STEP, WIN, DROP><<<grid_q, kThreads, smem_dq, s>>>(
      q, k, v, p, klens, o, m, l, dout, dq, dp, dp32, delta, H, Tq, Tk, R, win, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rel_attn_bwd_dkdv_bf16<DK, STEP, WIN, DROP><<<grid_k, kThreads, smem_dkdv, s>>>(
      q, k, v, p, klens, m, l, delta, dout, dk, dv, H, Tq, Tk, R, win, drop);
  return cudaGetLastError();
}

}  // namespace

// The bf16 entry: q, k, v, p, o, dout, dq, dk, dv, dp bf16 (shapes as the
// float32 entry's, rel_attention_bwd.cu), m, l and the scratch delta
// float32 [B, H, Tq], klens [B] int32;
// dp32: float32 scratch [B, H, Tq, R] for dp's bucket sums when R > 16
// (unread otherwise); the dropout as the float32 entry's. All contiguous,
// the [.., dk] ones 16-byte aligned, on the device of `stream`. Returns a
// cudaError_t.
extern "C" int nsp_rel_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* p, const void* klens, const void* o,
                                          const void* m, const void* l, const void* dout,
                                          void* dq, void* dk, void* dv, void* dp, void* dp32,
                                          void* delta, int B, int H, int Tq, int Tk, int R,
                                          int dk_, int nc, int nl, int nr, float keep,
                                          unsigned k0, unsigned k1, void* stream) {
  using nsp_rel::bf16;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < Tq || R <= 0 || H > 65535 || B > 65535 || nc < 0 ||
      nr < 0 || !(keep > 0.0f && keep <= 1.0f))
    return (int)cudaErrorInvalidValue;
  const nsp_rel::Window win{nc, nl, nr, Tk - Tq, 0};
  const nsp_rel::Drop drop{k0, k1, keep, 1.0f / keep};
  const bool drops = keep < 1.0f, win_any = nc > 0 || Tq != Tk;
#define NSP_ARGS_W(D, WIN, DROP)                                                             \
  launch_bwd_bf16<D, WIN, DROP>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),         \
                     static_cast<const bf16*>(v), static_cast<const bf16*>(p),            \
                     static_cast<const int*>(klens), static_cast<const bf16*>(o),         \
                     static_cast<const float*>(m), static_cast<const float*>(l),          \
                     static_cast<const bf16*>(dout), static_cast<bf16*>(dq),              \
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dp), \
                     static_cast<float*>(dp32), static_cast<float*>(delta), B, H, Tq, Tk, \
                     R, win, drop, static_cast<cudaStream_t>(stream))
  // dropout in its own instantiation of the windowed passes, as the
  // float32 entry's
#define NSP_ARGS(D)                                  \
  (drops ? NSP_ARGS_W(D, true, true)                 \
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
