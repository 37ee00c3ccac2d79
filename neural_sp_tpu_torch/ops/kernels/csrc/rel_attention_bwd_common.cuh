// Pieces of K1b (the relative-position attention's backward) shared by its
// float32 entry (rel_attention_bwd.cu, whose header says what the passes
// compute) and its bf16 entry (rel_attention_bwd_bf16.cu): the per-tile
// work of pass 1 (ds and dp's buckets) and of pass 2 (P^T, ds^T, the
// dropped P^T), and the statistics a streamed query tile carries. Each
// entry compiles in a source of its own, so the two nvcc runs of a build
// go side by side.
#pragma once

#include "rel_attention_common.cuh"

namespace nsp_rel {

// Pass 1's work on a tile, in float32 registers: s (S = Q K^T) and dpv
// (dP = dO V^T) of a warp's rows rows[0..1] and keys k0 .. k0 + 8 N - 1;
// s becomes ds = P (dP - D), P = exp(s + bias - m) / l, and 0 for keys
// outside the row's range (rk: RowKeys with a window, PadKeys without).
// dp's buckets from ds: the far one summed per row in far_ds, the near
// ones (r < R - 1) added into dp_rows, the block's rows of dp's sums from
// row q0: the keys i - r and i + r are a near bucket's
// only addends, added onto zero, so the order of the two adds does not
// change the sum. Both entries run it, on tiles of 32 (float32) or 64
// (bf16) keys.
template <bool DROP, int N, class E, class K>
__device__ __forceinline__ void ds_tile(float (&s)[N][4], const float (&dpv)[N][4],
                                        float (&far_ds)[2], float* dp_rows, const int (&rows)[2],
                                        const K& rk, const float (&far_p)[2],
                                        const float (&mr)[2], const float (&inv_l)[2],
                                        const float (&dr)[2], const E* prows, int q0, int w0,
                                        int k0, int qoff, int Tq, int R, int t, const Drop& drop,
                                        const uint32_t (&drow)[2]) {
  const bool plain = k0 >= rk.wlo && k0 + 8 * N <= rk.whi &&
                     min_distance(w0 + qoff, 16, k0, 8 * N) >= R - 1;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, i = rows[r], j = k0 + n * 8 + 2 * t + (e & 1);
      // dP = dO v^T, times the scaled keep mask with dropout
      float dpe = dpv[n][e];
      if constexpr (DROP) dpe *= drop_scale(drop, drow[r] + (uint32_t)j);
      float ds;
      if (plain) {
        ds = __expf(s[n][e] + far_p[r] - mr[r]) * inv_l[r] * (dpe - dr[r]);
        far_ds[r] += ds;
      } else if (i < Tq && rk.allowed(r, j)) {
        const int dist = min(abs(i + qoff - j), R - 1);
        ds = __expf(s[n][e] + to_float(prows[(i - q0) * R + dist]) - mr[r]) * inv_l[r] *
             (dpe - dr[r]);
        if (dist == R - 1) far_ds[r] += ds;
        else atomicAdd(dp_rows + (i - q0) * R + dist, ds);
      } else {
        ds = 0.0f;
      }
      s[n][e] = ds;
    }
}

// Whether key j is allowed for query column c of a staged tile: with a
// window (WIN) by the row's range staged beside its statistics (lo, hi as
// ints from st + 4 S), without one by the padding alone, j < klen.
template <bool WIN>
__device__ __forceinline__ bool staged_allowed(const float* st, int S, int c, int j, int klen) {
  if constexpr (WIN) {
    const int* lo = reinterpret_cast<const int*>(st + 4 * S);
    return j >= lo[c] && j < lo[S + c];
  } else {
    return j < klen;
  }
}

// Pass 2's weights, in float32 registers: sp (S^T = K Q^T, a warp's keys
// keys[0..1] by the tile's queries i0 .. i0 + 8 N - 1) becomes P^T, P =
// exp(s + bias - m) / l from the tile's row statistics st (m, 1 / l, D and
// the far-bucket bias, 8 N each; with a window then each row's key range)
// and its rows of p (prows = row i0); a query or key past T gives 0, a key
// the query may not attend the masked score.
template <bool WIN, int N, class E>
__device__ __forceinline__ void p_tile_t(float (&sp)[N][4], const float* st, const E* prows,
                                         const int (&keys)[2], int i0, int c0, int klen, int Tq,
                                         int Tk, int qoff, int R, int t) {
  constexpr int S = 8 * N;
  const bool far_tile = min_distance(i0 + qoff, S, c0, 16) >= R - 1;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * t + (e & 1), i = i0 + c, j = keys[e >> 1];
      float P = 0.0f;
      if (i < Tq && j < Tk) {
        float sv;
        if (!staged_allowed<WIN>(st, S, c, j, klen)) sv = kNeg;
        else if (far_tile) sv = sp[n][e] + st[3 * S + c];
        else sv = sp[n][e] + rel_bias(prows + c * R, i + qoff, j, R);
        P = __expf(sv - st[c]) * st[S + c];
      }
      sp[n][e] = P;
    }
}

// dpv (dP^T = V dO^T) becomes ds^T = P^T (dP^T - D) for the keys each
// query may attend, 0 for masked ones.
template <bool WIN, bool DROP, int N>
__device__ __forceinline__ void ds_tile_t(float (&dpv)[N][4], const float (&sp)[N][4],
                                          const float* st, const int (&keys)[2], int klen,
                                          int t, const Drop& drop, uint32_t drow0, int Tk) {
  constexpr int S = 8 * N;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * t + (e & 1);
      float dpe = dpv[n][e];
      if constexpr (DROP)
        dpe *= drop_scale(drop, drow0 + (uint32_t)c * (uint32_t)Tk + (uint32_t)keys[e >> 1]);
      dpv[n][e] = staged_allowed<WIN>(st, S, c, keys[e >> 1], klen)
                      ? sp[n][e] * (dpe - st[2 * S + c])
                      : 0.0f;
    }
}

// P^T of a staged tile (keys by queries) times the scaled keep mask: the
// dropped weights that dv += P^T dO takes. drow0 is the flat index of
// (row i0, key 0) in [B, H, Tq, Tk]. ROUND (the bf16 entry): P rounded to
// bf16 before the mask, as the forward's P v took it.
template <bool ROUND, int N>
__device__ __forceinline__ void drop_tile_t(float (&pm)[N][4], const float (&sp)[N][4],
                                            const int (&keys)[2], int t, const Drop& drop,
                                            uint32_t drow0, int Tk) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * t + (e & 1);
      pm[n][e] = (ROUND ? round_bf16(sp[n][e]) : sp[n][e]) *
                 drop_scale(drop, drow0 + (uint32_t)c * (uint32_t)Tk + (uint32_t)keys[e >> 1]);
    }
}

// Per streamed query tile, beside its split Q and dO tiles: the rows' m,
// 1 / l, D and far-bucket bias, with a window (WIN) their key ranges (lo, hi
// as ints), then their rows of p when R <= kSmemR.
template <bool WIN>
constexpr int kStatsRows = WIN ? 6 : 4;  // rows of statistics before p's rows
template <bool WIN>
constexpr int kRowStats = kStatsRows<WIN> * kStep + kStep * kSmemR;

// The key range [lo, hi) of query row i of Tq (keys of Tk) into st[r] and
// st[S + r] (ints; rows past Tq none).
__device__ __forceinline__ void stage_keys(float* st, int S, int r, int i, const Window& w,
                                           int klen, int Tq, int Tk) {
  int lo = 0, hi = 0;
  if (i < Tq) key_range(w, i, klen, Tk, lo, hi);
  st[r] = __int_as_float(lo);
  st[S + r] = __int_as_float(hi);
}

}  // namespace nsp_rel
