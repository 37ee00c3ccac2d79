"""MoChA / monotonic (multihead) chunkwise attention (counterpart of
``neural_sp_tpu/models/modules/mocha.py``).

Plain functions on tensors over the last (frame) axis, and the modules
``MonotonicEnergy``, ``ChunkEnergy`` and ``MoChA`` with the JAX modules'
options and parameter names. On the card they run as PyTorch ops: the JAX
package computes MoChA in plain JAX, so there is no TPU kernel to port.

* Training (``mode="parallel"``): the closed-form expected alignment
  ``alpha[t] = p[t] cp[t] cumsum(alpha_prev / cp)[t]`` with ``cp`` the
  exclusive cumulative product of ``1 - p`` (clipped to [1e-10, 1], alpha
  to [0, 1], as JAX, with JAX's halved gradient at a bound), then the soft
  chunkwise weights by moving sums. ``moving_sum`` and
  ``exclusive_cumprod`` pad and slice where JAX gathers (``jnp.take``): a
  gather's backward would be an atomic ``index_add`` on the card, and the
  train step is the same bits in every run. Two roundings differ from JAX
  on purpose, the function being the same (ROADMAP C18): ``1 - p`` is
  ``sigmoid(-e)``, and a moving sum adds the window's terms instead of
  subtracting two cumulative sums. JAX's float32 forms lose the alignment
  to cancellation at a recipe's lengths (T in the hundreds, energies of
  a few tens); these stay within 2e-5 of float64 there
  (``tests/test_torch_mocha.py``).
* Decoding (``mode="hard"``): the first frame at or after the previous
  boundary whose ``sigmoid(e) >= 0.5``, then a softmax over the chunk
  behind it. As in JAX, a step where no head fires leaves alpha all zero
  and the next step searches from frame 0 again (ROADMAP C15).

The noise of the monotonic energies in training is the caller's: a
standard normal draw (``mocha_noise``, on the device from dropout's counter
hash) that ``MoChA`` scales by ``noise_std``. The JAX module draws it from
its flax rng, so the two packages draw different noise for one step
(ROADMAP C4).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import fast_uniform, key_words
from ...ops.masks import apply_mask_logits

EPS = 1e-10
# the clips' bounds as 0-dim CPU tensors, which act as scalars on any device
_EPS, _ZERO, _ONE = torch.tensor(EPS), torch.tensor(0.0), torch.tensor(1.0)


def _clip(x: torch.Tensor, lo: Optional[torch.Tensor],
          hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jnp.clip``: maximum, then minimum, so that at a tie with a bound
    the gradient is halved, as JAX's (``torch.clamp`` passes it whole)."""
    if lo is not None:
        x = torch.maximum(x, lo)
    return x if hi is None else torch.minimum(x, hi)


def safe_cumprod(x: torch.Tensor) -> torch.Tensor:
    """exp(cumsum(log(clip(x, EPS, 1)))) over the last axis."""
    return torch.exp(torch.cumsum(torch.log(_clip(x, _EPS, _ONE)), -1))


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """The cumulative product shifted right by one: [1, x0, x0 x1, ...]."""
    cp = safe_cumprod(x)
    return torch.cat([torch.ones_like(x[..., :1]), cp[..., :-1]], -1)


def moving_sum(x: torch.Tensor, back: int, forward: int) -> torch.Tensor:
    """y[t] = sum of x[t - back .. t + forward] over the last axis (zeros
    past either edge): the window's back + forward + 1 shifted slices of
    the padded x added, as the reference's convolution with ones. (JAX
    subtracts two cumulative sums, which loses the window to cancellation
    in float32 wherever earlier terms are large: ROADMAP C18.)"""
    t = x.shape[-1]
    xp = F.pad(x, (back, forward))
    out = xp[..., :t]
    for i in range(1, back + forward + 1):
        out = out + xp[..., i:i + t]
    return out


def parallel_monotonic_attention(p_choose: torch.Tensor,
                                 alpha_prev: torch.Tensor,
                                 one_minus_p: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The expected alignment of one decoder step: p_choose, alpha_prev
    [..., T] -> alpha [..., T]. ``one_minus_p`` is 1 - p_choose computed
    without its rounding (sigmoid(-e)), else 1 - p_choose is taken."""
    if one_minus_p is None:
        one_minus_p = 1.0 - p_choose
    cp = _clip(exclusive_cumprod(one_minus_p), _EPS, _ONE)
    alpha = p_choose * cp * torch.cumsum(alpha_prev / cp, -1)
    return _clip(alpha, _ZERO, _ONE)


def soft_chunkwise_attention(alpha: torch.Tensor, chunk_energy: torch.Tensor,
                             chunk_size: int) -> torch.Tensor:
    """beta[t] = sum_{k=t}^{t+w-1} alpha[k] exp(u[t]) / movsum(exp(u))[k]
    over the last axis; chunk_size -1 looks back to frame 0."""
    u = chunk_energy - chunk_energy.amax(-1, keepdim=True)
    exp_u = torch.exp(u)
    if chunk_size < 0:
        denom = torch.cumsum(exp_u, -1)
        ratio = alpha / _clip(denom, _EPS)
        return exp_u * torch.cumsum(ratio.flip(-1), -1).flip(-1)
    denom = moving_sum(exp_u, chunk_size - 1, 0)
    return exp_u * moving_sum(alpha / _clip(denom, _EPS), 0, chunk_size - 1)


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (JAX's ``argmax`` of a
    bool, which has no CUDA kernel here): 0 where none is True."""
    t = x.shape[-1]
    idx = torch.arange(t, device=x.device)
    first = torch.where(x, idx, torch.full_like(idx, t)).amin(-1)
    return torch.where(first < t, first, torch.zeros_like(first))


def hard_monotonic_attention(e_mono: torch.Tensor, alpha_prev: torch.Tensor,
                             eps_wait: int = -1) -> torch.Tensor:
    """One-hot boundaries [B, H, T] (all zero where no frame fires) from
    the energies e_mono [B, H, T] and the previous boundaries alpha_prev
    (one-hot, or all zero: search from frame 0). eps_wait >= 0 keeps each
    head at most eps_wait frames past the slowest head's boundary."""
    t = e_mono.shape[-1]
    t_idx = torch.arange(t, device=e_mono.device)
    p = torch.sigmoid(e_mono) >= 0.5
    has_prev = alpha_prev.sum(-1) > 0
    start = torch.where(has_prev, alpha_prev.argmax(-1),
                        torch.zeros_like(has_prev, dtype=torch.long))
    fire = p & (t_idx >= start[..., None])
    any_fire = fire.any(-1)
    t_new = _first_true(fire)
    if eps_wait >= 0:
        t_eff = torch.where(any_fire, t_new, torch.full_like(t_new, t - 1))
        slowest = t_eff.amin(1, keepdim=True)
        t_new = torch.minimum(t_new, slowest + eps_wait)
        any_fire = any_fire | any_fire.any(1, keepdim=True)
    return (t_idx == t_new[..., None]).to(e_mono.dtype) * \
        any_fire[..., None].to(e_mono.dtype)


def hard_chunkwise_attention(alpha: torch.Tensor, chunk_energy: torch.Tensor,
                             chunk_size: int) -> torch.Tensor:
    """A softmax over the window [t - w + 1, t] behind each boundary of the
    one-hot alpha [..., T] (from frame 0 at chunk_size -1); zero where no
    boundary fired."""
    t = alpha.shape[-1]
    t_idx = torch.arange(t, device=alpha.device)
    t_bd = alpha.argmax(-1, keepdim=True)
    fired = alpha.sum(-1, keepdim=True) > 0
    win = t_idx <= t_bd
    if chunk_size >= 0:
        win = win & (t_idx > t_bd - chunk_size)
    e = torch.where(win, chunk_energy, torch.full_like(chunk_energy, -1e30))
    return torch.softmax(e, -1) * fired.to(alpha.dtype)


def mocha_noise(gen: Optional[torch.Generator], shape, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal noise of ``shape`` for the monotonic energies (one
    draw for all decoder steps), made on ``device`` from dropout's counter
    hash under two key words of the step's generator: the Box-Muller
    transform sqrt(-2 log(1 - u)) cos(2 pi v) of two [0, 1) uniforms. The
    uniforms are the same bits on every device."""
    n = math.prod(int(s) for s in shape)
    u, v = fast_uniform(key_words(gen), (2, n), device)
    z = torch.sqrt(-2.0 * torch.log1p(-u)) * torch.cos((2.0 * math.pi) * v)
    return z.view(tuple(shape)).to(dtype)


class MonotonicEnergy(nn.Module):
    """The boundary energy: additive ``v . relu(k + w_query(q))`` (w_query
    without bias) or scaled-dot ``(q . k) / sqrt(adim)`` (both biased),
    plus the learned offset ``r`` (``init_r``). ``precompute`` projects the
    keys (``conv1d``: relu of a SAME width-5 conv first) unless they come
    projected (``external_key``)."""

    def __init__(self, kdim: int, qdim: int, adim: int, n_heads: int = 1,
                 atype: str = "add", init_r: float = -4.0,
                 conv1d: bool = False, external_key: bool = False):
        super().__init__()
        if atype not in ("add", "scaled_dot"):
            raise ValueError(f"MoChA energy {atype!r}: 'add' or 'scaled_dot'")
        self.adim, self.n_heads, self.atype = adim, n_heads, atype
        self.init_r = init_r
        self.external_key = external_key
        self.conv1d = conv1d and not external_key
        if not external_key:
            self.w_key = nn.Linear(kdim, adim * n_heads)
            if conv1d:
                self.conv = nn.Conv1d(kdim, kdim, 5, padding=2)
        self.w_query = nn.Linear(qdim, adim * n_heads,
                                 bias=atype == "scaled_dot")
        if atype == "add":
            self.v = nn.Parameter(torch.empty(n_heads, adim))
        self.r = nn.Parameter(torch.full((n_heads,), float(init_r)))

    def precompute(self, key: torch.Tensor) -> torch.Tensor:
        if self.external_key:
            return key
        if self.conv1d:
            key = torch.relu(self.conv(key.transpose(1, 2))).transpose(1, 2)
        return self.w_key(key)

    def forward(self, key_cache: torch.Tensor,
                query: torch.Tensor) -> torch.Tensor:
        """key_cache [B, T, H*A], query [B, qdim] -> e [B, H, T]."""
        return _energy(self, key_cache, query) + self.r[None, :, None]


class ChunkEnergy(nn.Module):
    """The chunkwise energy: additive ``v . relu(k + w_query(q))`` or
    scaled-dot, without an offset."""

    def __init__(self, kdim: int, qdim: int, adim: int, n_heads: int = 1,
                 atype: str = "add", external_key: bool = False):
        super().__init__()
        self.adim, self.n_heads, self.atype = adim, n_heads, atype
        self.external_key = external_key
        if not external_key:
            self.w_key = nn.Linear(kdim, adim * n_heads)
        self.w_query = nn.Linear(qdim, adim * n_heads,
                                 bias=atype == "scaled_dot")
        if atype == "add":
            self.v = nn.Parameter(torch.empty(n_heads, adim))

    def precompute(self, key: torch.Tensor) -> torch.Tensor:
        return key if self.external_key else self.w_key(key)

    def forward(self, key_cache: torch.Tensor,
                query: torch.Tensor) -> torch.Tensor:
        return _energy(self, key_cache, query)


def _energy(m, key_cache: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    bs, t, _ = key_cache.shape
    k = key_cache.view(bs, t, m.n_heads, m.adim)
    q = m.w_query(query).view(bs, 1, m.n_heads, m.adim)
    if m.atype == "add":
        return torch.einsum("ha,btha->bht", m.v, torch.relu(k + q))
    return torch.einsum("bha,btha->bht", q[:, 0], k) / math.sqrt(m.adim)


class MoChA(nn.Module):
    """One decoder step of MoChA (``n_heads_mono`` = ``n_heads_chunk`` = 1)
    or MMA: ``forward(key_cache, query, alpha_prev, mode, mask,
    trigger_points, noise) -> (ctx [B, kdim], alpha [B, H_ma, T], beta
    [B, H_ma, H_ca, T])``.

    ``key_cache`` is ``precompute(key)``'s dict: "mono" [B, T, H_ma*A],
    "chunk" [B, T, H_ck*A] (chunk_size != 1), "value" (the projected values
    of the multihead case [B, T, H_ma*H_ca*A], else the raw keys [B, T,
    kdim]). With ``external_keys`` the caller projects them (the LAS
    decoder's ``key_proj_*``), and the module has no key or value
    projection. ``chunk_size`` 1 is hard monotonic attention, -1 MoChA
    over every frame up to the boundary. The multihead context is each
    head's weighted value slice through ``w_out``; the single-head context
    is the raw values weighted directly.

    ``mask`` [B, T] bool (valid frames) masks both energies. In parallel
    mode ``noise`` [B, H_ma, T] (a standard normal draw, None for none) is
    scaled by ``noise_std``; ``no_denominator`` drops the division by the
    cumulative product; ``stableemit_weight`` scales alpha by ``1 - w``
    (the carry too); ``trigger_points`` [B] zero alpha past each row's
    trigger + ``decot_delta`` (DeCoT).
    """

    def __init__(self, kdim: int, qdim: int, adim: int, chunk_size: int = 1,
                 n_heads_mono: int = 1, n_heads_chunk: int = 1,
                 atype: str = "add", init_r: float = -4.0,
                 noise_std: float = 1.0, no_denominator: bool = False,
                 conv1d: bool = False, eps_wait: int = -1,
                 decot_delta: int = 2, stableemit_weight: float = 0.0,
                 share_ca: bool = False, external_keys: bool = False):
        super().__init__()
        self.kdim, self.adim, self.chunk_size = kdim, adim, chunk_size
        self.n_heads_mono, self.n_heads_chunk = n_heads_mono, n_heads_chunk
        self.noise_std, self.no_denominator = noise_std, no_denominator
        self.eps_wait, self.decot_delta = eps_wait, decot_delta
        self.stableemit_weight, self.share_ca = stableemit_weight, share_ca
        self.external_keys = external_keys
        self.monotonic_energy = MonotonicEnergy(
            kdim, qdim, adim, n_heads_mono, atype, init_r, conv1d=conv1d,
            external_key=external_keys)
        if chunk_size != 1:
            self.chunk_energy = ChunkEnergy(
                kdim, qdim, adim, self.n_chunk_energy_heads, atype,
                external_key=external_keys)
        self.multihead = n_heads_mono * n_heads_chunk > 1
        if self.multihead:
            if not external_keys:
                self.w_value = nn.Linear(
                    kdim, adim * n_heads_mono * n_heads_chunk)
            self.w_out = nn.Linear(adim * n_heads_mono * n_heads_chunk, kdim)

    @property
    def n_chunk_energy_heads(self) -> int:
        return self.n_heads_chunk if self.share_ca else \
            self.n_heads_mono * self.n_heads_chunk

    def precompute(self, key: torch.Tensor) -> dict:
        out = {"mono": self.monotonic_energy.precompute(key)}
        if self.chunk_size != 1:
            out["chunk"] = self.chunk_energy.precompute(key)
        out["value"] = self.w_value(key) if self.multihead and \
            not self.external_keys else key
        return out

    def init_alpha(self, bs: int, tmax: int, device=None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Attend frame 0: one-hot [B, H_ma, T]."""
        a = torch.zeros(bs, self.n_heads_mono, tmax, device=device,
                        dtype=dtype)
        a[:, :, 0] = 1.0
        return a

    def forward(self, key_cache: dict, query: torch.Tensor,
                alpha_prev: torch.Tensor, mode: str = "parallel",
                mask: Optional[torch.Tensor] = None,
                trigger_points: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None):
        bs, t = key_cache["mono"].shape[:2]
        h_ma, h_ca = self.n_heads_mono, self.n_heads_chunk
        e_mono = self.monotonic_energy(key_cache["mono"], query)
        if mask is not None:
            e_mono = apply_mask_logits(e_mono, mask[:, None, :])
        if mode == "parallel":
            if noise is not None and self.noise_std > 0:
                e_mono = e_mono + self.noise_std * noise
            p_choose = torch.sigmoid(e_mono)
            # 1 - p as sigmoid(-e): the same number, without the
            # cancellation of 1 - p where p is near 1 (ROADMAP C18)
            one_minus_p = torch.sigmoid(-e_mono)
            if self.no_denominator:
                alpha = p_choose * exclusive_cumprod(one_minus_p) * \
                    torch.cumsum(alpha_prev, -1)
            else:
                alpha = parallel_monotonic_attention(p_choose, alpha_prev,
                                                     one_minus_p)
            if self.stableemit_weight > 0:
                alpha = (1 - self.stableemit_weight) * alpha
            if trigger_points is not None:
                t_idx = torch.arange(t, device=alpha.device)
                lim = (trigger_points + self.decot_delta)[:, None, None]
                alpha = torch.where(t_idx <= lim, alpha,
                                    torch.zeros_like(alpha))
        elif mode == "hard":
            alpha = hard_monotonic_attention(e_mono, alpha_prev,
                                             self.eps_wait)
        else:
            raise ValueError(f"MoChA mode {mode!r}: 'parallel' or 'hard'")

        a4 = alpha[:, :, None, :]
        if self.chunk_size == 1:
            beta = a4.expand(bs, h_ma, h_ca, t)
        else:
            e_chunk = self.chunk_energy(key_cache["chunk"], query)
            if self.share_ca:
                e_chunk = e_chunk.view(bs, 1, h_ca, t).expand(
                    bs, h_ma, h_ca, t)
            else:
                e_chunk = e_chunk.view(bs, h_ma, h_ca, t)
            if mask is not None:
                e_chunk = apply_mask_logits(e_chunk, mask[:, None, None, :])
            chunkwise = soft_chunkwise_attention if mode == "parallel" \
                else hard_chunkwise_attention
            beta = chunkwise(a4.expand(bs, h_ma, h_ca, t), e_chunk,
                             self.chunk_size)

        if self.multihead:
            v = key_cache["value"].view(bs, t, h_ma * h_ca, self.adim)
            ctx = torch.einsum("bit,btid->bid",
                               beta.reshape(bs, h_ma * h_ca, t), v)
            ctx = self.w_out(ctx.reshape(bs, -1))
        else:
            ctx = torch.bmm(beta.reshape(bs, 1, t), key_cache["value"])[:, 0]
        return ctx, alpha, beta
