"""Transformer decoder (counterpart of
``neural_sp_tpu/models/decoders/transformer.py``): pre-norm blocks of
causal self-attention, source attention and an FFN; in training one
parallel pass under the causal mask, at decode one token per step with
per-layer self-attention key / value caches.

From ``mma_first_layer`` upward a block's source attention is MMA, the
monotonic multihead attention: the keys projected once per utterance
(``mma_key_mono``, ``mma_key_value``, ``mma_key_chunk``, no bias), then
``MMAStep`` (``MoChA`` with external keys) at each output position with the
alignment alpha [B, H_ma, T] carried from position to position, one-hot at
frame 0 before the first. As in JAX, training runs MoChA in parallel mode
(with the energies' noise, std 1.0) over a loop of the U+1 positions, and
``eval()`` (the dev loss, ``sequence_log_prob``) and decoding in hard mode;
the quantity loss (train() only) is |the alignment mass over the labels
and eos - (U + 1)|, its mean over B, averaged over the MMA layers. No
kernel: the JAX package computes all of it in plain JAX.

Decoding (``decode_step``, ``TransformerDecodeLoop``): caches are one dict
per layer, {"self": {"k", "v"} [N, steps so far, H, d_k]} and for an MMA
layer "alpha"; a beam's reorder selects rows of every entry. The positions
are the step index, added only for ``pe_type`` "add" (the recipes write
"1dconv3L", which the JAX module reads as none: ROADMAP C21).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import PAD
from ...ops.criterion import compute_accuracy, cross_entropy_lsm
from ...ops.dropout import Dropout
from ...ops.masks import causal_mask, make_pad_mask
from ..modules.conformer_convolution import LN_EPS
from ..modules.feed_forward import FFN
from ..modules.mocha import MMAStep, mocha_noise
from ..modules.multihead_attention import MultiheadAttention
from ..modules.positional_embedding import PositionalEncoding
from ..utils import append_sos_eos
from .las import DecodeLoop


class TransformerDecoderBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 dropout: float = 0.0, dropout_att: float = 0.0,
                 ffn_activation: str = "relu", src_atype: str = "mha",
                 mocha_chunk_size: int = 1, mocha_n_heads_mono: int = 1,
                 mocha_n_heads_chunk: int = 1, mocha_eps_wait: int = -1,
                 mocha_share_ca: bool = False):
        super().__init__()
        self.norm_self = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout_att)
        self.norm_src = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mma = src_atype == "mocha"
        if self.mma:
            h_ma = mocha_n_heads_mono or n_heads
            h_ca = mocha_n_heads_chunk
            adim = d_model // (h_ma * h_ca)
            self.mma_key_mono = nn.Linear(d_model, adim * h_ma, bias=False)
            self.mma_key_value = nn.Linear(d_model, adim * h_ma * h_ca,
                                           bias=False)
            if mocha_chunk_size != 1:
                h_ck = h_ca if mocha_share_ca else h_ma * h_ca
                self.mma_key_chunk = nn.Linear(d_model, adim * h_ck,
                                               bias=False)
            self.src_mma = MMAStep(
                kdim=d_model, qdim=d_model, adim=adim,
                chunk_size=mocha_chunk_size, n_heads_mono=h_ma,
                n_heads_chunk=h_ca, eps_wait=mocha_eps_wait,
                share_ca=mocha_share_ca)
        else:
            self.src_attn = MultiheadAttention(d_model, n_heads, dropout_att)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = FFN(d_model, d_ff, ffn_activation, 0, dropout)
        self.drop = Dropout(dropout)

    def src_keys(self, eouts: torch.Tensor) -> dict:
        """The source attention's keys of ``eouts`` [B, T, d_model]: {"k",
        "v"} [B, T, H, d_k], or for MMA ``MoChA``'s key cache ("mono",
        "value", and "chunk" when chunk_size != 1)."""
        if not self.mma:
            return self.src_attn.project_kv(eouts)
        kc = {"mono": self.mma_key_mono(eouts),
              "value": self.mma_key_value(eouts)}
        if hasattr(self, "mma_key_chunk"):
            kc["chunk"] = self.mma_key_chunk(eouts)
        return kc

    def forward(self, ys: torch.Tensor, self_mask: Optional[torch.Tensor],
                src_keys: dict, src_mask: torch.Tensor,
                self_cache: Optional[dict] = None,
                gen: Optional[torch.Generator] = None,
                alpha_prev: Optional[torch.Tensor] = None,
                mode: str = "parallel",
                noise: Optional[torch.Tensor] = None):
        """ys [B, U, d]; self_mask [1, U, U] (None: every cached key);
        src_keys from ``src_keys``; src_mask [B, T] bool, valid frames; for
        MMA alpha_prev [B, H_ma, T], the MoChA mode, and noise [B, U, H_ma,
        T] (None for none). Returns (ys, the new self-attention cache, the
        alignments [B, U, H_ma, T] of an MMA block, else None)."""
        h = self.norm_self(ys)
        h, kv = self.self_attn(h, h, mask=self_mask, cache=self_cache,
                               gen=gen)
        ys = ys + self.drop(h, gen)
        h = self.norm_src(ys)
        alphas = None
        if self.mma:
            ctxs, alphas, alpha = [], [], alpha_prev
            for u in range(h.shape[1]):
                alpha, ctx = self.src_mma(
                    alpha, h[:, u], src_keys, src_mask, mode,
                    None if noise is None else noise[:, u])
                ctxs.append(ctx)
                alphas.append(alpha)
            h, alphas = torch.stack(ctxs, 1), torch.stack(alphas, 1)
        else:
            h, _ = self.src_attn(h, mask=src_mask, cache=src_keys, gen=gen)
        ys = ys + self.drop(h, gen)
        ys = ys + self.drop(self.ff(self.norm_ff(ys), gen), gen)
        return ys, kv, alphas


class TransformerDecoder(nn.Module):
    def __init__(self, vocab: int, enc_n_units: int, d_model: int = 256,
                 d_ff: int = 2048, n_heads: int = 4, n_layers: int = 6,
                 pe_type: str = "add", dropout: float = 0.1,
                 dropout_att: float = 0.0, dropout_emb: float = 0.0,
                 lsm_prob: float = 0.0, ffn_activation: str = "relu",
                 backward: bool = False, mma_first_layer: int = 0,
                 mocha_chunk_size: int = 1, mocha_n_heads_mono: int = 1,
                 mocha_n_heads_chunk: int = 1, mocha_eps_wait: int = -1,
                 mocha_share_ca: bool = False,
                 quantity_loss_weight: float = 0.0):
        super().__init__()
        if backward:
            raise NotImplementedError(
                "the backward decoder is not ported yet, see ROADMAP")
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.lsm_prob = lsm_prob
        # the train CLI gates it by epoch (mocha_quantity_loss_start_epoch)
        self.quantity_loss_weight = quantity_loss_weight
        self.embed = nn.Embedding(vocab, d_model)
        self.pos_enc = PositionalEncoding(d_model, pe_type, dropout_emb)
        self.blocks = nn.ModuleList(
            TransformerDecoderBlock(
                d_model, d_ff, n_heads, dropout, dropout_att, ffn_activation,
                "mocha" if 0 < mma_first_layer <= lth + 1 else "mha",
                mocha_chunk_size, mocha_n_heads_mono, mocha_n_heads_chunk,
                mocha_eps_wait, mocha_share_ca)
            for lth in range(n_layers))
        self.norm_out = nn.LayerNorm(d_model, eps=LN_EPS)
        self.bridge = nn.Linear(enc_n_units, d_model) \
            if enc_n_units != d_model else None
        self.output = nn.Linear(d_model, vocab)

    def _bridge(self, eouts: torch.Tensor) -> torch.Tensor:
        return eouts if self.bridge is None else self.bridge(eouts)

    def _hidden(self, eouts, elens, ys_in, gen, mode: str):
        """The teacher-forced pass: (the last block's output [B, U+1, d],
        the MMA layers' alignments, each [B, U+1, H_ma, T]). The energies'
        noise is drawn in parallel mode in train() only. Under bf16 compute
        the energies compute in bf16 and the alignments (their carry and the
        noise) in float32, as the LAS decoder's MoChA (ROADMAP C39)."""
        bs, tmax = eouts.shape[:2]
        dev = eouts.device
        e = self._bridge(eouts)
        adt = torch.promote_types(e.dtype, torch.float32)
        src_mask = make_pad_mask(elens.to(dev), tmax)
        u1 = ys_in.shape[1]
        self_mask = causal_mask(u1, device=dev)[None]
        h = self.pos_enc(self.embed(ys_in), 0, gen)
        alphas = []
        for blk in self.blocks:
            alpha0 = noise = None
            if blk.mma:
                attn = blk.src_mma.mocha
                alpha0 = attn.init_alpha(bs, tmax, dev, adt)
                if mode == "parallel" and self.training and \
                        attn.noise_std > 0:
                    noise = mocha_noise(gen, (bs, u1, attn.n_heads_mono,
                                              tmax), dev, adt)
            h, _, aws = blk(h, self_mask, blk.src_keys(e), src_mask, None,
                            gen, alpha0, mode, noise)
            if aws is not None:
                alphas.append(aws)
        return h, alphas

    def forward(self, eouts: torch.Tensor, elens: torch.Tensor,
                ys: torch.Tensor, ylens: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                trigger_points: Optional[torch.Tensor] = None):
        """Label-smoothed cross entropy, teacher-forced (JAX
        ``TransformerDecoder.__call__``). eouts [B, T, enc_n_units]; elens
        [B]; ys [B, U] PAD-padded; ylens [B]. Returns (loss, {"loss_att",
        "acc_att", "ppl_att"} and with MMA in train() at a quantity-loss
        weight above 0 "loss_quantity"; as in JAX, "loss_att" is then the
        loss with the quantity term). ``trigger_points`` is not read."""
        dev = eouts.device
        ylens = ylens.to(dev)
        ys_in, ys_out, _ = append_sos_eos(ys.to(dev), ylens)
        h, alphas = self._hidden(eouts, elens, ys_in, gen,
                                 "parallel" if self.training else "hard")
        logits = self.output(self.norm_out(h))
        loss, nll = cross_entropy_lsm(logits, ys_out, self.lsm_prob,
                                      ignore_index=PAD)
        acc = compute_accuracy(logits, ys_out, ignore_index=PAD)
        obs = {"loss_att": loss, "acc_att": acc, "ppl_att": torch.exp(nll)}
        if alphas and self.quantity_loss_weight > 0 and self.training:
            u1 = ys_in.shape[1]
            valid = (torch.arange(u1, device=dev)[None]
                     < (ylens + 1)[:, None]).float()
            qty = torch.zeros(ys.shape[0], device=dev)
            for a in alphas:
                mass = a.float().sum((2, 3)) / a.shape[2]
                qty = qty + ((mass * valid).sum(1) - (ylens + 1).float()).abs()
            obs["loss_quantity"] = qty.mean() / len(alphas)
            loss = loss + self.quantity_loss_weight * obs["loss_quantity"]
            obs["loss_att"] = loss
        return loss, obs

    def sequence_log_prob(self, eouts, elens, ys, ylens) -> torch.Tensor:
        """Teacher-forced sum of the labels' and eos's log-probabilities per
        utterance [B], MMA in hard mode (JAX's deterministic pass; dropout
        as the module's mode: call it in eval())."""
        dev = eouts.device
        ys_in, ys_out, _ = append_sos_eos(ys.to(dev), ylens.to(dev))
        h, _ = self._hidden(eouts, elens, ys_in, None, "hard")
        lp = torch.log_softmax(self.output(self.norm_out(h)).float(), -1)
        tok = lp.gather(-1, ys_out.clamp(min=0)[..., None].long())[..., 0]
        return torch.where(ys_out != PAD, tok, torch.zeros_like(tok)).sum(1)

    # ---- incremental decoding ----
    def init_cache(self, bs: int, tmax: int, device=None,
                   dtype: torch.dtype = torch.float32) -> list:
        """Empty self-attention caches; an MMA layer's alpha one-hot at
        frame 0."""
        dk = self.d_model // self.n_heads
        caches = []
        for blk in self.blocks:
            z = torch.zeros(bs, 0, self.n_heads, dk, device=device,
                            dtype=dtype)
            c = {"self": {"k": z, "v": z}}
            if blk.mma:
                c["alpha"] = blk.src_mma.mocha.init_alpha(bs, tmax, device,
                                                          dtype)
            caches.append(c)
        return caches

    def precompute_src(self, eouts: torch.Tensor) -> list:
        """Each layer's source keys of ``eouts`` (after the bridge), once
        per utterance: the source attention's {"k", "v"}, an MMA layer's
        key cache (JAX projects those every step)."""
        e = self._bridge(eouts)
        return [blk.src_keys(e) for blk in self.blocks]

    def decode_step(self, caches: list, src_caches: list, y_t: torch.Tensor,
                    src_mask: torch.Tensor, offset: int):
        """One token step: y_t [N] at position ``offset`` (the step index);
        src_mask [N, T] bool, valid frames. Returns (new caches, logits
        [N, vocab])."""
        h = self.pos_enc(self.embed(y_t[:, None]), offset)
        new = []
        for blk, cache, src in zip(self.blocks, caches, src_caches):
            h, kv, aws = blk(h, None, src, src_mask, cache["self"], None,
                             cache.get("alpha"), "hard")
            c = {"self": kv}
            if aws is not None:
                c["alpha"] = aws[:, -1]
            new.append(c)
        return new, self.output(self.norm_out(h))[:, 0]

    def decode_loop(self, eouts: torch.Tensor, klens: torch.Tensor):
        """A ``TransformerDecodeLoop`` over eouts [N, T, D] and the valid
        frames klens [N]."""
        return TransformerDecodeLoop(self, eouts, klens)


def select_rows(caches: list, rows: torch.Tensor) -> list:
    """Every tensor of ``caches`` at ``rows`` (a beam's reorder)."""
    def sel(x):
        return {k: sel(v) for k, v in x.items()} if isinstance(x, dict) \
            else x.index_select(0, rows)
    return [sel(c) for c in caches]


class TransformerDecodeLoop:
    """``DecodeLoop``'s interface for the transformer decoder: the source
    keys projected once, the caches kept by the loop (a beam's ``parent``
    rows selected before the step), the step index as the position. Its
    steps count in ``DecodeLoop.steps``."""

    def __init__(self, dec: TransformerDecoder, eouts: torch.Tensor,
                 klens: torch.Tensor):
        self.dec = dec
        self.src = dec.precompute_src(eouts)
        self.mask = make_pad_mask(klens.to(eouts.device), eouts.shape[1])
        self.caches = dec.init_cache(eouts.shape[0], eouts.shape[1],
                                     eouts.device, eouts.dtype)
        self.offset = 0

    def step(self, y_t: torch.Tensor, parent=None):
        """Tokens y_t [N] (and a beam's parent rows [N]) -> (logits [N,
        vocab], None)."""
        DecodeLoop.steps += 1
        if parent is not None:
            self.caches = select_rows(self.caches, torch.as_tensor(
                parent, device=y_t.device).long())
        self.caches, logits = self.dec.decode_step(
            self.caches, self.src, y_t, self.mask, self.offset)
        self.offset += 1
        return logits, None
