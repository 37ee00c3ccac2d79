// K3b: backward of the teacher-forced LAS scan (LSTM layer 0 + location
// attention, K3 in las_step.cu), float32, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of neural_sp_tpu/ops/
// las_scan_pallas.py (last present at 63255ae~1), reached through `_bwd`.
// It walks the steps in reverse, carrying dh, dc, dctx and daw, and per
// step t (rows n in parallel):
//   dctx  = dctx_out[t] + dctx_carry           (saved: dctx_tot[t])
//   daw   = (daw_carry + values . dctx) m_t    (m_t: the attention dropout
//           scale of step t, 1 without; the context and the next step's
//           location conv read aw_t m_t, K3 keeps the raw aw_t)
//   de    = aw_t (daw - sum(aw_t daw)), 0 on masked frames
//   z     = kc + q_t + loc W_f^T,  s = tanh(z) (recomputed; loc from
//           aw_{t-1} m_{t-1})
//   dz    = de v (1 - s^2):  dkc += dz, dq_t = sum_T dz, dv += de s,
//           dW_f += dz loc, dloc = dz W_f
//   daw_carry = conv^T(dloc)                   dconv += dloc x aw_{t-1} m_{t-1}
//   dh    = dh_out[t] + (dq_t W_q) keep_t + dh_carry   (query from h * keep)
//           or, with the decoder's projection p = relu(h keep W_p^T + b_p)
//           as the query (and the readout's input), dpre_t = (dq_t W_q +
//           dp_out[t]) [p_t > 0] (saved) and dh = dh_out[t] + (dpre_t W_p)
//           keep_t + dh_carry
//   LSTM adjoint from the saved gates and c:  dy_t [4H], dc_carry = dc f
//   dh_carry = dy_t W_h^T,  dctx_carry = dy_t W_ctx^T  (split-K product)
// dy_t, dq_t and dctx_tot[t] are streamed out; the step-invariant weight
// gradients dW_h, dW_ctx, b, dW_q and dvalues = sum_t aw_t m_t (x) dctx_tot[t]
// are single products over all steps outside (las_scan.py), as the Pallas
// `_bwd` reduced its d_toep outside. dv, dW_f and dconv are summed into
// per-block partial buffers (each block owns its slot across the steps; a
// buffer per step instead would take U x B x T x A x C floats) and reduced
// outside; dkc is accumulated in place. Both take their per-step addends
// as fire-and-forget adds (red.global.add): no load waits on memory, and
// as each element receives one add per launch and the launches are
// ordered, the sums are the same in every run.
//
// What bounds it on the H100: a step is small (B rows). Its largest
// piece of work is the recurrent product dy_t [B, 4H] x [W_ctx; W_h]^T,
// which must read the 25 MB of gate weights once per step; the attention
// part reads kc and values over the valid frames and rewrites dkc there.
// Every kernel of the step is short, so latency (a block's chain of
// dependent loads and barriers), not bandwidth, sets its time: the design
// prefetches with cp.async, adds into accumulators without loading them,
// and keeps three blocks per SM. The per-step chain is four kernels from
// a host loop (three at step 0), each spread over at least 256 blocks at
// the flagship's training shape (B = 32, T = 188, H = 1024):
//   bwd_attention  the attention adjoint, a block per (16 frames, row);
//                the softmax's row sum needs no pass of its own (ctx_t .
//                dctx, from K3's saved context), and blocks past a row's
//                length stop at once;
//   bwd_conv     the conv transpose, and dq_t summed once from the
//                attention blocks' parts (disjoint slices of A per block);
//   bwd_cell     dquery = dq_t W_q (a block per 16 units x 8 rows, W_q's
//                columns staged in shared memory, each dot product split
//                four ways) and the LSTM adjoint;
//   bwd_recurrent  split-K: a block per (64 weight rows, 256 gate columns,
//                32 rows n) streams its disjoint tile of W once with
//                cp.async double buffering against all rows of dy_t
//                (their columns arriving with W's), and writes its
//                partial sum. The next step's consumers (bwd_cell for dh,
//                bwd_attention for dctx) add the partials in a fixed
//                order: deterministic, no atomics.
//
// The additive energy (C = 0; the decoder's `add` and triggered
// attention: z = kc + q_t, no location conv) runs instantiations of its
// own (kLoc false): no W_f, conv_w or aw_prev read, no loc, dloc, dW_f or
// dconv, and bwd_conv only sums dq_t; daw_carry stays zero, since nothing
// but the context reads the weights. Triggered attention's window is a
// per-step length (klens [U, N], step t's row read at t).

#include "las_common.cuh"

namespace {

using namespace nsp_las;

constexpr int kDzPad = 16;      // dz rows A + 16 apart: two frames' rows on other banks
// bwd_cell: a block per (kCellUnits units, kCellRows rows), the dot
// product over A of each (row, unit) split across kCellSplit threads
constexpr int kCellUnits = 16;
constexpr int kCellRows = 8;
constexpr int kCellSplit = 4;
constexpr int kCellThreads = kCellUnits * kCellRows * kCellSplit;
// bwd_recurrent: a block per (kRecRows weight rows, kRecK gate columns,
// kRecN rows n); W streamed kRecSub columns at a time
constexpr int kRecRows = 64;
constexpr int kRecK = 256;
constexpr int kRecSub = 64;
constexpr int kRecN = 32;
constexpr int kRecThreads = 128;
constexpr int kDyStride = kRecK + 4;   // 16-byte rows, conflict-free float4 reads
constexpr int kWStride = kRecSub + 4;

// dctx[n, d] = dctx_out[n, d] + the n_part split-K partials of the
// recurrent product's context rows (part [n_part, N, D + H], columns < D).
__device__ __forceinline__ float dctx_total(const float* __restrict__ dctx_out,
                                            const float* __restrict__ part, int n_part, int n,
                                            int d, int N, int D, int R) {
  float s = dctx_out[(size_t)n * D + d];
#pragma unroll 16
  for (int p = 0; p < n_part; ++p) s += part[((size_t)p * N + n) * R + d];
  return s;
}

// Shared memory of bwd_attention, in floats.
__host__ __device__ inline size_t attention_bwd_smem_floats(int D, int A, int C, int K) {
  return (size_t)D + (size_t)A * C + (size_t)C * K + (kFrames + K - 1) + (size_t)kFrames * C +
         kFrames + (size_t)kFrames * (A + kDzPad) + kWarps;
}

// bwd_attention's per-channel phases take kGroupC channels at a time: the
// first group inline, the rest (C > kGroupC) in calls that keep their
// registers out of the kernel's frame loop. loc, dloc [kFrames][C]; wf
// [A][C]; the dz rows kDz = A + kDzPad apart.

// dloc[tl, c0 + c] = sum_a dz[tl, a] wf[a, c0 + c] on the nf valid frames:
// a half-warp per frame, units a = part16 + 16 i (the half-warp's reads of
// wf on distinct banks).
__device__ __forceinline__ void dloc_group(const float* dzs, const float* wf, float* dloc, int c0,
                                           int nf, int A, int C) {
  const int tl = threadIdx.x >> 4, part16 = threadIdx.x & 15;
  float acc[kGroupC];
#pragma unroll
  for (int c = 0; c < kGroupC; ++c) acc[c] = 0.0f;
  if (tl < nf) {
    for (int a = part16; a < A; a += 16) {
      const float dz = dzs[tl * (A + kDzPad) + a];
#pragma unroll
      for (int c = 0; c < kGroupC; ++c)
        if (c0 + c < C) acc[c] += dz * wf[a * C + c0 + c];
    }
  }
#pragma unroll
  for (int c = 0; c < kGroupC; ++c) {
    if (c0 + c >= C) break;
    const float s = half_warp_sum(acc[c]);
    if (tl < nf && part16 == c) dloc[tl * C + c0 + c] = s;
  }
}

__device__ __noinline__ void dloc_rest(const float* dzs, const float* wf, float* dloc, int nf,
                                       int A, int C) {
  for (int c0 = kGroupC; c0 < C; c0 += kGroupC) dloc_group(dzs, wf, dloc, c0, nf, A, C);
}

// The channels past the first group add their loc W_f^T to the kc rows
// (z = kc + q + loc W_f^T), so that the frame loop holds kGroupC channels.
// Unit a stays with thread a % kThreads here, in the frame loop and in
// dwf_rest: no barrier between them.
__device__ __noinline__ void features_rest(const float* loc, const float* wf, float* dzs, int nf,
                                           int A, int C) {
  for (int a = threadIdx.x; a < A; a += kThreads)
    for (int tl = 0; tl < nf; ++tl) {
      float f = 0.0f;
      for (int c = kGroupC; c < C; ++c) f += loc[tl * C + c] * wf[a * C + c];
      dzs[tl * (A + kDzPad) + a] += f;
    }
}

// dW_f of the channels past the first group from the stored dz, into the
// block's partial dwp [C][A].
__device__ __noinline__ void dwf_rest(const float* dzs, const float* loc, float* dwp, int nf,
                                      int A, int C) {
  for (int a = threadIdx.x; a < A; a += kThreads)
    for (int c0 = kGroupC; c0 < C; c0 += kGroupC) {
      float acc[kGroupC];
#pragma unroll
      for (int c = 0; c < kGroupC; ++c) acc[c] = 0.0f;
      for (int tl = 0; tl < nf; ++tl) {
        const float dz = dzs[tl * (A + kDzPad) + a];
#pragma unroll
        for (int c = 0; c < kGroupC; ++c)
          if (c0 + c < C) acc[c] += dz * loc[tl * C + c0 + c];
      }
#pragma unroll
      for (int c = 0; c < kGroupC; ++c)
        if (c0 + c < C) atomicAdd(dwp + (size_t)(c0 + c) * A + a, acc[c]);
    }
}

// The attention adjoint of step t. A block per (kFrames frames, row n);
// blocks whose frames all lie past klens[n] only write their row's dctx
// (tb = 0) and stop: de, dz and dloc are 0 there.
//   dctx  = dctx_out + the recurrent product's partials    (-> dctx_tot)
//   rs    = sum_t' aw_t daw = sum_t' aw_t m_t daw_carry + ctx_t . dctx
//           (ctx_t = sum_t' aw_t m_t values, saved by K3: no pass over
//           values)
//   de    = aw_t (m_t (daw_carry + values . dctx) - rs)  a warp per two frames
//   loc   = conv(aw_prev m_{t-1})  a half-warp per frame, lanes along K
//   a thread per two attention units (a, a + 256), frame by frame with
//   the frame's loc in registers: z, s = tanh(z), dz (to shared memory,
//   over the frame's kc); dkc += dz; its sums over the frames of dq
//   (dq_part, per step), dv and dW_f[a, :] (into the block's own
//   partials, dW_f's stored [C][A] so that the adds are coalesced)
//   dloc = dz W_f                a half-warp per frame, lanes along A
// W_f, conv_w and aw_prev's window come by cp.async while dctx is summed,
// the frames' kc (a second group) while the row sum and loc are formed.
// The block is latency-bound (a row of 16 frames is little work), so each
// phase keeps many independent loads in flight, and no load waits on an
// accumulator (red.add). The frame loop holds the first kGroupC channels
// of W_f and dW_f in registers; the channels past them (C > kGroupC) add
// their loc W_f^T to the kc rows before it, and their dW_f is summed after
// it from the stored dz. akeep (m_t) and pkeep (m_{t-1}) [N, T] may be
// null (pkeep at t = 0); they are read in the kDrop instantiation only
// (attention dropout), so the other keeps the code it had without. kLoc
// false: the additive energy (see the top of the file).
template <bool kDrop, bool kLoc>
__global__ void __launch_bounds__(kThreads, 3)  // three blocks (their shared memory) per SM
bwd_attention(const float* __restrict__ dctx_out, const float* __restrict__ part, int n_part,
              const float* __restrict__ daw_c, const float* __restrict__ values,
              const float* __restrict__ aw, const float* __restrict__ ctx,
              const int* __restrict__ klens, const float* __restrict__ q,
              const float* __restrict__ aw_prev, const float* __restrict__ akeep,
              const float* __restrict__ pkeep, const float* __restrict__ conv_w,
              const float* __restrict__ w_f, const float* __restrict__ v,
              const float* __restrict__ kc, float* __restrict__ dctx_tot,
              float* __restrict__ dkc, float* __restrict__ dloc, float* __restrict__ dq_part,
              float* __restrict__ dv_part, float* __restrict__ dwf_part, int N, int T, int D,
              int H, int A, int C, int K) {
  static_assert(kThreads == 16 * kFrames, "a half-warp per frame");
  extern __shared__ float smem[];
  const int kDz = A + kDzPad;
  // the cp.async targets first: 16-byte aligned when A and D are multiples of 4
  float* dzs = smem;                         // [kFrames][kDz]
  float* wf = dzs + (size_t)kFrames * kDz;   // [A][C], as w_f
  float* dctx = wf + (size_t)A * C;          // [D]
  float* cw = dctx + D;                      // [C][K]
  float* awp = cw + (size_t)C * K;           // [kFrames + K - 1]: aw_prev at t0 - left + i
  float* loc = awp + (kFrames + K - 1);      // [kFrames][C]
  float* des = loc + (size_t)kFrames * C;    // [kFrames]
  float* red = des + kFrames;                // [kWarps]

  const int n = blockIdx.y, tb = blockIdx.x;
  const int t0 = tb * kFrames;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int klen = min(klens[n], T);
  const bool active = t0 < klen;
  const int nf = min(kFrames, klen - t0);    // the block's valid frames, if active
  if (active) {
    if (kLoc) {
      copy_async(wf, w_f, A * C);
      copy_async(cw, conv_w, C * K);
      window_async(awp, aw_prev, n, t0, T, K);
    }
    cp_async_commit();
  }
  // dctx, and the thread's share of the row sum's ctx_t . dctx
  float rs = 0.0f;
  for (int d = tid; d < D; d += kThreads) {
    const float x = dctx_total(dctx_out, part, n_part, n, d, N, D, D + H);
    dctx[d] = x;
    if (tb == 0) dctx_tot[(size_t)n * D + d] = x;
    rs += ctx[(size_t)n * D + d] * x;
  }
  if (!active) return;
  // kc of the valid frames, into the rows dz will overwrite in place
  for (int tl = 0; tl < nf; ++tl)
    copy_async(dzs + tl * kDz, kc + ((size_t)n * T + t0 + tl) * A, A);
  cp_async_commit();
  const float* awr = aw + (size_t)n * T;
  const float* dacr = daw_c + (size_t)n * T;
  const float* kr = kDrop && akeep != nullptr ? akeep + (size_t)n * T : nullptr;
  if (kr != nullptr) {
    for (int t = tid; t < klen; t += kThreads) rs += awr[t] * kr[t] * dacr[t];
  } else {
    for (int t = tid; t < klen; t += kThreads) rs += awr[t] * dacr[t];
  }
  rs = warp_sum(rs);
  if (lane == 0) red[warp] = rs;
  cp_async_wait_one();  // W_f, conv_w, aw_prev's window
  if (kLoc && kDrop && pkeep != nullptr) scale_window(awp, pkeep, n, t0, T, K);  // this thread's copies
  __syncthreads();
  // values . dctx of the block's frames: a warp per two frames (warp and
  // warp + kWarps), their loads interleaved
  {
    static_assert(kFrames == 2 * kWarps, "two frames per warp");
    const int ta = warp, tc = warp + kWarps;
    const float* va_row = values + ((size_t)n * T + t0 + min(ta, nf - 1)) * D;
    const float* vc_row = values + ((size_t)n * T + t0 + min(tc, nf - 1)) * D;
    float sa = 0.0f, sc = 0.0f;
#pragma unroll 8
    for (int d = lane; d < D; d += 32) {
      const float x = dctx[d];
      sa += va_row[d] * x;
      sc += vc_row[d] * x;
    }
    sa = warp_sum(sa);
    sc = warp_sum(sc);
    if (lane == 0) {
      des[ta] = sa;
      des[tc] = sc;
    }
  }
  // loc[tl, c] = sum_k aw_prev[t0 + tl + k - left] conv[c, k]
  if (kLoc) {
    loc_group(awp, cw, loc, 0, C, K);
    if (C > kGroupC) loc_rest(awp, cw, loc, C, K);
  }
  __syncthreads();
  rs = 0.0f;
  for (int w = 0; w < kWarps; ++w) rs += red[w];
  if (tid < nf) {
    const int t = t0 + tid;
    const float m = kr != nullptr ? kr[t] : 1.0f;
    des[tid] = awr[t] * (m * (dacr[t] + des[tid]) - rs);
  }
  cp_async_wait_none();  // kc
  __syncthreads();
  if (kLoc && C > kGroupC) features_rest(loc, wf, dzs, nf, A, C);
  const size_t nb = (size_t)n * gridDim.x + tb;
  for (int a0 = tid; a0 < A; a0 += 2 * kThreads) {
    const int a1 = a0 + kThreads;
    const bool two = a1 < A;
    const int a1c = two ? a1 : a0;             // a1's loads stay in bounds
    float wf0[kGroupC], wf1[kGroupC], dwf0[kGroupC], dwf1[kGroupC];
#pragma unroll
    for (int c = 0; c < kGroupC; ++c) {
      wf0[c] = kLoc && c < C ? wf[a0 * C + c] : 0.0f;
      wf1[c] = kLoc && c < C ? wf[a1c * C + c] : 0.0f;
      dwf0[c] = dwf1[c] = 0.0f;
    }
    const float q0 = q[(size_t)n * A + a0], q1 = q[(size_t)n * A + a1c];
    const float v0 = v[a0], v1 = v[a1c];
    float* dk = dkc + ((size_t)n * T + t0) * A;
    float dq0 = 0.0f, dq1 = 0.0f, dv0 = 0.0f, dv1 = 0.0f;
    for (int tl = 0; tl < nf; ++tl) {
      float lc[kGroupC];
      float f0 = 0.0f, f1 = 0.0f;
#pragma unroll
      for (int c = 0; c < kGroupC; ++c) {
        lc[c] = kLoc && c < C ? loc[tl * C + c] : 0.0f;
        f0 += lc[c] * wf0[c];
        f1 += lc[c] * wf1[c];
      }
      float* zr = dzs + tl * kDz;              // holds kc; dz replaces it
      const float e = des[tl];
      const float s0 = tanh_fast(zr[a0] + q0 + f0);
      const float s1 = tanh_fast(zr[a1c] + q1 + f1);
      const float dz0 = e * v0 * (1.0f - s0 * s0);
      const float dz1 = two ? e * v1 * (1.0f - s1 * s1) : 0.0f;
      atomicAdd(dk + (size_t)tl * A + a0, dz0);
      if (two) atomicAdd(dk + (size_t)tl * A + a1, dz1);
      dq0 += dz0;
      dq1 += dz1;
      dv0 += e * s0;
      dv1 += e * s1;
#pragma unroll
      for (int c = 0; c < kGroupC; ++c) {
        dwf0[c] += dz0 * lc[c];
        dwf1[c] += dz1 * lc[c];
      }
      zr[a0] = dz0;
      if (two) zr[a1] = dz1;
    }
    dq_part[((size_t)tb * N + n) * A + a0] = dq0;
    atomicAdd(dv_part + nb * A + a0, dv0);
    float* dwp = dwf_part + nb * C * A;        // [C][A]
#pragma unroll
    for (int c = 0; c < kGroupC; ++c)
      if (kLoc && c < C) atomicAdd(dwp + (size_t)c * A + a0, dwf0[c]);
    if (two) {
      dq_part[((size_t)tb * N + n) * A + a1] = dq1;
      atomicAdd(dv_part + nb * A + a1, dv1);
#pragma unroll
      for (int c = 0; c < kGroupC; ++c)
        if (kLoc && c < C) atomicAdd(dwp + (size_t)c * A + a1, dwf1[c]);
    }
  }
  if (!kLoc) return;  // no location conv: nothing reads dloc
  if (C > kGroupC) dwf_rest(dzs, loc, dwf_part + nb * C * A, nf, A, C);
  __syncthreads();
  // dloc[t, c] = sum_a dz[t, a] W_f[a, c] on the valid frames
  float* dl = dloc + ((size_t)n * T + t0) * C;
  dloc_group(dzs, wf, dl, 0, nf, A, C);
  if (C > kGroupC) dloc_rest(dzs, wf, dl, nf, A, C);
}

// Shared memory of bwd_conv, in floats.
__host__ __device__ inline size_t conv_bwd_smem_floats(int C, int K) {
  return (size_t)C * K + (size_t)C * (kFrames + K - 1) + (kFrames + K - 1);
}

// A block per (kFrames frames, row n): daw_carry[n, tau] = sum_c sum_k
// dloc[n, tau + left - k, c] conv[c, k] for the block's frames tau (a
// half-warp per frame, lanes along K), and the block's sum of dconv[c, k]
// = sum_t' dloc[n, t', c] aw_prev[n, t' + k - left] (into its own partial;
// nothing to add past klens[n], where dloc is 0 and bwd_attention wrote
// none). Besides, dq_t[n, a] = the sum of the attention blocks' parts
// (those with valid frames), in order, for the block's slice of a; dconv
// kGroupC channels at a time. pkeep [N, T] (may be null): aw_prev's
// attention dropout scale (dconv reads aw_prev pkeep), read in the kDrop
// instantiation only. kLoc false (the additive energy): dq_t alone.
template <bool kDrop, bool kLoc>
__global__ void __launch_bounds__(kThreads)
bwd_conv(const float* __restrict__ dloc, const float* __restrict__ aw_prev,
         const float* __restrict__ pkeep, const float* __restrict__ conv_w,
         const int* __restrict__ klens,
         const float* __restrict__ dq_part, float* __restrict__ daw_c,
         float* __restrict__ dconv_part, float* __restrict__ dq, int N, int T, int A, int C,
         int K) {
  extern __shared__ float smem[];
  const int W = kFrames + K - 1;
  float* cw = smem;                       // [C][K]
  float* win = cw + (size_t)C * K;        // [C][W]: dloc at frames w0 + i
  float* awp = win + (size_t)C * W;       // [W]: aw_prev at frames t0 - left + i
  const int n = blockIdx.y, tb = blockIdx.x;
  const int t0 = tb * kFrames;
  const int left = (K - 1) / 2;
  const int w0 = t0 + left - (K - 1);
  const int tid = threadIdx.x;
  const int klen = min(klens[n], T);
  if (kLoc) {
    copy_async(cw, conv_w, C * K);
    for (int i = tid; i < C * W; i += kThreads) {  // along dloc's rows
      const int c = i % C, fi = i / C, f = w0 + fi;
      const bool in = f >= 0 && f < klen;
      cp_async4(win + (size_t)c * W + fi, dloc + (in ? ((size_t)n * T + f) * C + c : 0), in);
    }
    window_async(awp, aw_prev, n, t0, T, K);
    cp_async_commit();
  }
  const int n_valid = (klen + kFrames - 1) / kFrames;  // attention blocks with parts
  const int slice = (A + gridDim.x - 1) / gridDim.x;
  for (int a = tb * slice + tid; a < min(A, (tb + 1) * slice); a += kThreads) {
    float s = 0.0f;
#pragma unroll 4
    for (int p = 0; p < n_valid; ++p) s += dq_part[((size_t)p * N + n) * A + a];
    dq[(size_t)n * A + a] = s;
  }
  if (!kLoc) return;
  cp_async_wait_none();
  if (kDrop && pkeep != nullptr) scale_window(awp, pkeep, n, t0, T, K);  // this thread's copies
  __syncthreads();
  // frame tau = t0 + tl takes dloc at frame tau + left - k = window index
  // tl + K - 1 - k
  {
    const int tl = tid >> 4, part16 = tid & 15;
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float* x = win + (size_t)c * W + tl + K - 1;
      for (int kk = part16; kk < K; kk += 16) s += x[-kk] * cw[c * K + kk];
    }
    s = half_warp_sum(s);
    if (part16 == 0 && t0 + tl < T) daw_c[(size_t)n * T + t0 + tl] = s;
  }
  if (t0 >= klen) return;
  const size_t nb = (size_t)n * gridDim.x + tb;
  // frame t' = t0 + tl sits at window index tl + K - 1 - left; a thread
  // per tap kk, its C sums added to the partial at once
  const float* x = win + K - 1 - left;
  for (int kk = tid; kk < K; kk += kThreads) {
    float* dst = dconv_part + nb * C * K + kk;
    for (int c0 = 0; c0 < C; c0 += kGroupC) {
      float s[kGroupC];
#pragma unroll
      for (int c = 0; c < kGroupC; ++c) s[c] = 0.0f;
#pragma unroll 4
      for (int tl = 0; tl < kFrames; ++tl) {
        const float y = awp[tl + kk];
#pragma unroll
        for (int c = 0; c < kGroupC; ++c)
          if (c0 + c < C) s[c] += x[(size_t)(c0 + c) * W + tl] * y;
      }
#pragma unroll
      for (int c = 0; c < kGroupC; ++c)
        if (c0 + c < C) atomicAdd(dst + (size_t)(c0 + c) * K, s[c]);
    }
  }
}

// The decoder's projection (P > 0): dpre[n, k] = (sum_a dq[n, a] w_q[a, k]
// + dp_out[n, k]) where p[n, k] > 0, else 0 (the relu's adjoint), w_q [A,
// P]. A thread per (row, unit k): the weight reads are coalesced along k,
// dq's row is read by broadcast.
__global__ void __launch_bounds__(kThreads)
bwd_proj(const float* __restrict__ dq, const float* __restrict__ w_q,
         const float* __restrict__ dp_out, const float* __restrict__ p, float* __restrict__ dpre,
         int N, int A, int P) {
  const int n = blockIdx.y, k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= P) return;
  const float* dr = dq + (size_t)n * A;
  float s = dp_out[(size_t)n * P + k];
  for (int a = 0; a < A; ++a) s = fmaf(dr[a], w_q[(size_t)a * P + k], s);
  dpre[(size_t)n * P + k] = p[(size_t)n * P + k] > 0.0f ? s : 0.0f;
}

__device__ __forceinline__ float sig_d(float g) { return g * (1.0f - g); }

// Shared memory of bwd_cell, in floats: W_q's kCellUnits columns [A][16],
// the block's rows of dq_t [kCellRows][A + 4] (two rows read by one warp
// fall in different banks) and the split dot products' parts.
__host__ __device__ inline size_t cell_smem_floats(int A) {
  return (size_t)A * kCellUnits + (size_t)kCellRows * (A + 4) + kCellThreads;
}

// A block per (kCellUnits units, kCellRows rows); kCellSplit threads per
// (row, unit) share dquery = dq_t W_q (a quarter of A each, so that short
// chains keep the SM busy), then the first of them forms dh = dh_out +
// dquery keep + dh_carry (the sum of the recurrent product's n_part
// partials, in order) and the LSTM cell adjoint: dy_t and the dc carry.
// W_q's columns and dq_t come by cp.async while the thread gathers its
// own (row, unit)'s inputs.
__global__ void __launch_bounds__(kCellThreads)
bwd_cell(const float* __restrict__ dq, const float* __restrict__ w_q,
         const float* __restrict__ gates, const float* __restrict__ c_t,
         const float* __restrict__ c_prev, const float* __restrict__ keep,
         const float* __restrict__ dh_out, const float* __restrict__ part, int n_part,
         float* __restrict__ dc_c, float* __restrict__ dy, int N, int H, int D, int A) {
  extern __shared__ float smem[];
  float* wq = smem;                              // [A][kCellUnits]
  float* dqs = wq + (size_t)A * kCellUnits;      // [kCellRows][A + 4]
  float* parts = dqs + (size_t)kCellRows * (A + 4);  // [kCellSplit][rows x units]
  const int j0 = blockIdx.x * kCellUnits, n0 = blockIdx.y * kCellRows;
  const int tid = threadIdx.x;
  for (int i = tid; i < A * kCellUnits; i += kCellThreads) {
    const int a = i / kCellUnits, u = i % kCellUnits;
    const bool in = j0 + u < H;
    cp_async4(wq + i, w_q + (in ? (size_t)a * H + j0 + u : 0), in);
  }
  for (int i = tid; i < kCellRows * A; i += kCellThreads) {
    const int r = i / A, a = i % A;
    const bool in = n0 + r < N;
    cp_async4(dqs + r * (A + 4) + a, dq + (in ? (size_t)(n0 + r) * A + a : 0), in);
  }
  cp_async_commit();
  const int ru = tid % (kCellUnits * kCellRows), quarter = tid / (kCellUnits * kCellRows);
  const int u = ru % kCellUnits, r = ru / kCellUnits;
  const int j = j0 + u, n = n0 + r;
  const bool mine = j < H && n < N;
  const int R = D + H, G = 4 * H;
  // the first thread of each (row, unit) gathers its inputs meanwhile
  float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f, ct = 0.0f, cp = 0.0f, kp = 0.0f,
        dho = 0.0f, dcc = 0.0f, dh_c = 0.0f;
  if (quarter == 0 && mine) {
    const size_t at = (size_t)n * H + j;
    const float* g = gates + (size_t)n * G + j;
    gi = g[0], gf = g[H], gg = g[2 * H], go = g[3 * H];
    ct = c_t[at];
    cp = (c_prev != nullptr) ? c_prev[at] : 0.0f;
    kp = keep[at], dho = dh_out[at], dcc = dc_c[at];
#pragma unroll 8
    for (int p = 0; p < n_part; ++p) dh_c += part[((size_t)p * N + n) * R + D + j];
  }
  cp_async_wait_none();
  __syncthreads();
  const float* dr = dqs + r * (A + 4);
  const int a_end = min(A, (quarter + 1) * ((A + kCellSplit - 1) / kCellSplit));
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int a = quarter * ((A + kCellSplit - 1) / kCellSplit);
  for (; a + 4 <= a_end; a += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += dr[a + i] * wq[(a + i) * kCellUnits + u];
  }
  for (; a < a_end; ++a) acc[0] += dr[a] * wq[a * kCellUnits + u];
  parts[tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (quarter > 0 || !mine) return;
  float dquery = 0.0f;
#pragma unroll
  for (int p = 0; p < kCellSplit; ++p) dquery += parts[p * kCellUnits * kCellRows + ru];
  const float dh = dho + dquery * kp + dh_c;
  const float tc = tanhf(ct);
  const float dc = dcc + dh * go * (1.0f - tc * tc);
  float* dyb = dy + (size_t)n * G + j;
  dyb[0] = dc * gg * sig_d(gi);
  dyb[H] = dc * cp * sig_d(gf);
  dyb[2 * H] = dc * gi * (1.0f - gg * gg);
  dyb[3 * H] = dh * tc * sig_d(go);
  dc_c[(size_t)n * H + j] = dc * gf;
}

// Shared memory of bwd_recurrent, in floats: dy's kRecN rows of the
// block's kRecK columns, and two stages of kRecRows weight rows x kRecSub
// columns.
constexpr size_t kRecSmemFloats = (size_t)kRecN * kDyStride + 2 * (size_t)kRecRows * kWStride;

// part[s, n, r] = sum over the block's gate columns g of chunk s of
// dy[n, g] W[r, g], W = [W_ctx; W_h] ([D + H, 4H]). A block per (kRecRows
// rows r, chunk s of kRecK columns, kRecN rows n); a thread holds a 4 x 4
// tile (n = tn + 8 i, r = tr + 16 j) and reads 4 columns of each operand
// per float4 load. Columns past 4H and rows past N or D + H are zeros.
__global__ void __launch_bounds__(kRecThreads)
bwd_recurrent(const float* __restrict__ dy, const float* __restrict__ w_ctx,
              const float* __restrict__ w_h, float* __restrict__ part, int N, int D, int H) {
  extern __shared__ float4 rec_smem[];  // float4: 16-byte aligned for cp.async
  float* ys = reinterpret_cast<float*>(rec_smem);  // [kRecN][kDyStride]
  float* ws = ys + (size_t)kRecN * kDyStride;   // [2][kRecRows][kWStride]
  const int G = 4 * H, R = D + H;
  const int r0 = blockIdx.x * kRecRows, g0 = blockIdx.y * kRecK, n0 = blockIdx.z * kRecN;
  const int kn = min(kRecK, G - g0);            // a multiple of 4
  const int tid = threadIdx.x;
  // a stage: W's kRecSub columns into the ring, and dy's same columns
  auto load_w = [&](int stage, int sub) {
    float* dst = ws + (size_t)stage * kRecRows * kWStride;
    const int k0 = sub * kRecSub;
    for (int c = tid; c < kRecN * (kRecSub / 4); c += kRecThreads) {
      const int nn = c / (kRecSub / 4), col = k0 + (c % (kRecSub / 4)) * 4;
      const bool in = n0 + nn < N && col < kn;
      cp_async16(ys + nn * kDyStride + col, in ? dy + (size_t)(n0 + nn) * G + g0 + col : dy, in);
    }
    for (int c = tid; c < kRecRows * (kRecSub / 4); c += kRecThreads) {
      const int rr = c / (kRecSub / 4), col = (c % (kRecSub / 4)) * 4;
      const int r = r0 + rr;
      const bool in = r < R && k0 + col < kn;
      const float* row = (r < D) ? w_ctx + (size_t)r * G : w_h + (size_t)(r - D) * G;
      cp_async16(dst + rr * kWStride + col, in ? row + g0 + k0 + col : w_h, in);
    }
  };
  const int n_sub = (kn + kRecSub - 1) / kRecSub;
  load_w(0, 0);
  cp_async_commit();
  const int tn = tid & 7, tr = tid >> 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub + 1 < n_sub) {
      load_w((sub + 1) & 1, sub + 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_none();
    }
    __syncthreads();
    const float* wb = ws + (size_t)(sub & 1) * kRecRows * kWStride;
    const float* yb = ys + sub * kRecSub;
#pragma unroll 4
    for (int k = 0; k < kRecSub; k += 4) {
      float4 y[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = *reinterpret_cast<const float4*>(yb + (tn + 8 * i) * kDyStride + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(wb + (tr + 16 * j) * kWStride + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(y[i].x, w[j].x, s);
          s = fmaf(y[i].y, w[j].y, s);
          s = fmaf(y[i].z, w[j].z, s);
          acc[i][j] = fmaf(y[i].w, w[j].w, s);
        }
    }
    __syncthreads();  // the stage is refilled next
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + tn + 8 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tr + 16 * j;
      if (r < R) part[((size_t)blockIdx.y * N + n) * R + r] = acc[i][j];
    }
  }
}

// The shared memory of one instantiation's bwd_attention and bwd_conv.
template <bool kDrop, bool kLoc>
cudaError_t allow_attention_smem(size_t att_smem, size_t c_smem) {
  const cudaError_t err = allow_smem<bwd_attention<kDrop, kLoc>>(att_smem);
  return err != cudaSuccess ? err : allow_smem<bwd_conv<kDrop, kLoc>>(c_smem);
}

}  // namespace

// Shared memory (bytes) the largest block of a backward step asks for.
extern "C" long long nsp_las_scan_bwd_smem_bytes(int T, int D, int A, int C, int K) {
  (void)T;
  const size_t f = max_of({attention_bwd_smem_floats(D, A, C, K), conv_bwd_smem_floats(C, K),
                           cell_smem_floats(A), kRecSmemFloats});
  return (long long)(sizeof(float) * f);
}

// The number of split-K partials of the recurrent product (the leading
// dimension of its scratch `part`) for H units.
extern "C" int nsp_las_scan_bwd_parts(int H) { return (4 * H + kRecK - 1) / kRecK; }

#define F(x) static_cast<const float*>(x)
#define W(x) static_cast<float*>(x)

// K3b over U steps, N rows, time-major as K3 (nsp_las_scan_f32).
// Inputs: the weights w_ctx [D, 4H], w_h [H, 4H], w_q [A, H], conv_w
// [C, K], w_f [A, C], v [A]; kc [N, T, A], values [N, T, D],
// klens [N] int32, keep [U, N, H], att_keep [U, N, T] or null (each step's
// attention dropout scale, as K3 took it); K3's saved gates [U, N, 4H], c_all
// [U, N, H], q_all [U, N, A], aw_all [U, N, T], ctx_all [U, N, D]; aw0
// [N, T] (the step-0 weights, zeros); the upstream gradients dh_out [U, N,
// H] (w.r.t. each step's undropped h) and dctx_out [U, N, D]; with the
// projection (P > 0; 0: none, and these may be null) w_p [P, H], K3's
// p_all [U, N, P], its gradient dp_out [U, N, P], and the output dpre_all
// [U, N, P] (the projection's pre-activation gradient, for dW_p and b_p
// after the loop; w_q is then [A, P]). Carries
// (zeroed by the caller): dc_c [N, H], daw_c [N, T]; scratch part
// [nsp_las_scan_bwd_parts(H), N, D + H], dloc [N, T, C], dq_part [ceil(T /
// 16), N, A]. Outputs: dy_all [U, N, 4H], dq_all [U, N, A], dctx_tot [U,
// N, D] (each step's total context gradient: dvalues = sum_t aw_t dctx_t
// is formed from it after the loop); accumulated into (zeroed by the
// caller) dkc [N, T, A], dv_part [N * ceil(T / 16), A], dwf_part [N *
// ceil(T / 16), C, A] (transposed), dconv_part [N * ceil(T / 16), C, K].
// klens is [N], or with klens_per_step 1 [U, N] (each step's lengths, as
// K3 took them); C = K = 0 (conv_w, w_f, dwf_part and dconv_part null):
// the additive energy.
// *launched (host memory) receives the number of kernels launched.
// Returns a cudaError_t.
extern "C" int nsp_las_scan_bwd_f32(
    const void* w_ctx, const void* w_h, const void* w_q, const void* conv_w, const void* w_f,
    const void* v, const void* kc, const void* values, const void* klens, const void* keep,
    const void* att_keep, const void* w_p, const void* p_all, const void* dp_out,
    void* dpre_all, const void* gates, const void* c_all, const void* q_all, const void* aw_all,
    const void* ctx_all, const void* aw0, const void* dh_out, const void* dctx_out, void* dc_c,
    void* daw_c, void* part, void* dloc, void* dq_part, void* dy_all, void* dq_all,
    void* dctx_tot, void* dkc, void* dv_part, void* dwf_part, void* dconv_part, void* launched,
    int U, int N, int T, int H, int D, int A, int C, int K, int P, int klens_per_step,
    void* stream) {
  int* count = static_cast<int*>(launched);
  *count = 0;
  if (U <= 0 || N <= 0 || T <= 0 || H <= 0 || D <= 0 || A <= 0 || C < 0 || K < 0 ||
      (C == 0) != (K == 0) || N > 65535 || P < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(klens);
  const int n_tb = (T + kFrames - 1) / kFrames;
  const int n_part = nsp_las_scan_bwd_parts(H);
  const size_t nh = (size_t)N * H, nt = (size_t)N * T, nd = (size_t)N * D, na = (size_t)N * A;
  const size_t att_smem = sizeof(float) * attention_bwd_smem_floats(D, A, C, K);
  const size_t c_smem = sizeof(float) * conv_bwd_smem_floats(C, K);
  // bwd_cell's product: dq_t W_q, or with the projection dpre_t W_p
  const int cell_a = P > 0 ? P : A;
  const size_t cell_smem = sizeof(float) * cell_smem_floats(cell_a);
  const size_t rec_smem = sizeof(float) * kRecSmemFloats;
  cudaError_t err;
  // attention dropout runs the kDrop instantiations, C = 0 the additive ones
  const bool drop = att_keep != nullptr, loc = C > 0;
  auto* attention = loc ? (drop ? bwd_attention<true, true> : bwd_attention<false, true>)
                        : (drop ? bwd_attention<true, false> : bwd_attention<false, false>);
  auto* conv = loc ? (drop ? bwd_conv<true, true> : bwd_conv<false, true>)
                   : (drop ? bwd_conv<true, false> : bwd_conv<false, false>);
  if ((err = loc ? (drop ? allow_attention_smem<true, true>(att_smem, c_smem)
                         : allow_attention_smem<false, true>(att_smem, c_smem))
                  : (drop ? allow_attention_smem<true, false>(att_smem, c_smem)
                          : allow_attention_smem<false, false>(att_smem, c_smem))) !=
      cudaSuccess)
    return (int)err;
  if ((err = allow_smem<bwd_cell>(cell_smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem<bwd_recurrent>(rec_smem)) != cudaSuccess) return (int)err;
  const dim3 att_grid(n_tb, N);
  const dim3 rec_grid((D + H + kRecRows - 1) / kRecRows, n_part, (N + kRecN - 1) / kRecN);
  const dim3 cell_grid((H + kCellUnits - 1) / kCellUnits, (N + kCellRows - 1) / kCellRows);
  for (int t = U - 1; t >= 0; --t) {
    const int* kl_t = kl + (klens_per_step ? (size_t)t * N : 0);
    const float* aw_prev = (t > 0) ? F(aw_all) + (size_t)(t - 1) * nt : F(aw0);
    const float* akeep = att_keep != nullptr ? F(att_keep) + (size_t)t * nt : nullptr;
    const float* pkeep = att_keep != nullptr && t > 0 ? F(att_keep) + (size_t)(t - 1) * nt
                                                      : nullptr;
    // the recurrent product's partials exist from the second step on
    const int parts = (t < U - 1) ? n_part : 0;
    attention<<<att_grid, kThreads, att_smem, s>>>(
        F(dctx_out) + t * nd, F(part), parts, F(daw_c), F(values), F(aw_all) + t * nt,
        F(ctx_all) + t * nd, kl_t, F(q_all) + t * na, aw_prev, akeep, pkeep, F(conv_w), F(w_f),
        F(v), F(kc),
        W(dctx_tot) + t * nd, W(dkc), W(dloc), W(dq_part), W(dv_part), W(dwf_part), N, T, D, H,
        A, C, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    conv<<<att_grid, kThreads, c_smem, s>>>(F(dloc), aw_prev, pkeep, F(conv_w), kl_t, F(dq_part),
                                            W(daw_c), W(dconv_part), W(dq_all) + t * na, N, T,
                                            A, C, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const float* dcell = F(dq_all) + t * na;
    if (P > 0) {
      const size_t np = (size_t)N * P;
      bwd_proj<<<dim3((P + kThreads - 1) / kThreads, N), kThreads, 0, s>>>(
          F(dq_all) + t * na, F(w_q), F(dp_out) + t * np, F(p_all) + t * np,
          W(dpre_all) + t * np, N, A, P);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      *count += 1;
      dcell = F(dpre_all) + t * np;
    }
    bwd_cell<<<cell_grid, kCellThreads, cell_smem, s>>>(
        dcell, P > 0 ? F(w_p) : F(w_q), F(gates) + t * nh * 4, F(c_all) + t * nh,
        (t > 0) ? F(c_all) + (t - 1) * nh : nullptr, F(keep) + t * nh, F(dh_out) + t * nh,
        F(part), parts, W(dc_c), W(dy_all) + t * nh * 4, N, H, D, cell_a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    *count += 3;
    if (t > 0) {
      bwd_recurrent<<<rec_grid, kRecThreads, rec_smem, s>>>(F(dy_all) + t * nh * 4, F(w_ctx),
                                                            F(w_h), W(part), N, D, H);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      *count += 1;
    }
  }
  return (int)cudaSuccess;
}

#undef F
#undef W
