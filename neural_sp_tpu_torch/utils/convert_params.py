"""Carry the JAX package's weights into the port.

``convert_params`` takes a Flax param tree as nested dicts of numpy arrays,
e.g. ``jax.tree.map(np.asarray, variables["params"])``, and returns the
port's ``state_dict``. Load it with ``load_state_dict(..., strict=True)``:
every converted leaf then has to land on a port tensor and every port
tensor has to be filled, so no weight of the slice is dropped or left at
its initial value. Leaves of modules the port does not have on purpose are
listed in ``IGNORED`` and skipped.

Layout rules (flax -> torch):
  * Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
  * LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
  * Conv ``kernel`` HWIO -> OIHW (2-D) and [K, I/groups, O] -> [O, I/groups,
    K] (1-D, including depthwise and the attention's location conv);
  * flax ``OptimizedLSTMCell`` ``i{g}`` / ``h{g}`` denses (any module
    holding an ``ii`` dense), gates in (i, f, g, o) order, the hidden
    side owning the bias: the LAS decoder's ``cells_0`` -> one ``w_ih``
    [in, 4H], ``w_hh`` [H, 4H] and ``bias`` [4H]; an ``RNNLayer``'s cells
    ``fwd`` / ``bwd`` (an RNNLM's ``rnns_0/fwd``, an RNN encoder's
    ``rnn0/fwd`` and ``rnn0/bwd``) -> its ``nn.LSTM``'s ``weight_ih_l0``
    [4H, in], ``weight_hh_l0`` [4H, H] and ``bias_hh_l0`` [4H], with
    ``_reverse`` for ``bwd`` (its input-side bias is a zero buffer);
  * list members ``blocks_3`` / ``block0`` / ``cells_0`` / ``rnns_0`` /
    ``projs_0`` -> ``blocks.3`` / ``blocks.0`` / ``cells.0`` / ``rnns.0`` /
    ``projs.0``, an RNN encoder's ``rnn2`` / ``proj2`` (its layers' cells
    ``fwd`` and ``bwd``, the latency-controlled BLSTM's as ``RNNLayer``'s)
    -> ``rnns.2`` / ``projs.2``, a transducer's prediction network
    ``pred_rnns_1`` / ``pred_projs_1`` -> ``pred_rnns.1`` /
    ``pred_projs.1`` (its ``w_pred`` has no bias), and nested ones
    ``tails_1_0`` -> ``tails.1.0``;
  * a ``LinearGLUBlock``'s ``glu/Dense_0`` -> ``glu.fc``;
  * the language models: a TransformerLM's and a Transformer-XL's blocks
    ``blocks_3`` (``self_attn``, ``ff``, the norms) as above, the XL's
    attention ``u_bias`` / ``v_bias`` [H, d_k] as they are and its
    ``w_pos`` (no bias) by the Dense rule; a GCNN's blocks (``bn_in``,
    ``conv`` [K, I, O] -> [O, I, K], ``bn_out``) and its width changes
    ``resizes_2`` -> ``resizes.2`` (a block whose width does not change
    has none, in both trees);
  * a free parameter at the top of the tree (an RNNLM's ``output_bias``)
    keeps its name, and so do MoChA's energy parameters ``v`` [H, A] and
    ``r`` [H] (``step/attn/monotonic_energy/v`` ->
    ``step.attn.monotonic_energy.v``); the MoChA decoder's key projections
    ``key_proj_mono`` / ``key_proj_chunk`` / ``key_proj_value`` and
    ``mono_conv`` and the step's ``attn/w_out`` follow the Dense and Conv
    rules;
  * the transformer encoder's and decoder's blocks (``mha``, ``self_attn``,
    ``src_attn`` with ``w_query`` / ``w_key`` / ``w_value`` / ``w_out``,
    ``ff/w1`` / ``ff/w2``, the norms) and an MMA block's ``mma_key_mono``
    / ``mma_key_value`` / ``mma_key_chunk`` and ``src_mma/mocha/...`` (the
    scanned ``MMAStep``'s parameters, one set for all positions) follow the
    rules above unchanged.

``convert_checkpoint`` carries a whole JAX training checkpoint (params,
the Adam state and the epoch controller's state) into the port's
checkpoint format, for ``--resume`` and ``--recog_model``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# Leaves with no port tensor by design: the LAS attention's own key
# projection is skipped whenever keys come precomputed (always at decode,
# RNNDecoder.key_proj holds them), so the port has no w_key there.
IGNORED = (re.compile(r"^dec_fwd/step/attn/w_key/"),)

_LSTM_GATES = "ifgo"


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _torch_name(path: str) -> str:
    parts = []
    for p in path.split("/"):
        m = re.fullmatch(
            r"((?:pred_)?(?:blocks|cells|rnns|projs|tails|resizes))((?:_\d+)+)",
            p)
        if m:
            parts += [m.group(1)] + m.group(2).split("_")[1:]
        elif re.fullmatch(r"(block|rnn|proj)\d+", p):
            # the conv front end's blocks, an RNN encoder's layers and
            # projections
            m = re.fullmatch(r"([a-z]+)(\d+)", p)
            parts += [m.group(1) + "s", m.group(2)]
        elif p == "Dense_0" and parts and parts[-1] == "glu":
            parts.append("fc")
        else:
            parts.append(p)
    return ".".join(parts)


def _leaf(path: str, x: np.ndarray) -> tuple[str, np.ndarray]:
    if "/" not in path:
        return path, x
    parent, name = path.rsplit("/", 1)
    tname = _torch_name(parent)
    if name == "kernel":
        if x.ndim == 2:
            return f"{tname}.weight", x.T
        if x.ndim == 3:
            return f"{tname}.weight", x.transpose(2, 1, 0)
        if x.ndim == 4:
            return f"{tname}.weight", x.transpose(3, 2, 0, 1)
        raise ValueError(f"{path}: kernel of rank {x.ndim}")
    if name in ("scale", "embedding"):
        return f"{tname}.weight", x
    if name == "bias":
        return f"{tname}.bias", x
    if name in ("v", "r"):              # MoChA's energies
        return f"{tname}.{name}", x
    if name in ("u_bias", "v_bias"):    # the Transformer-XL's global biases
        return f"{tname}.{name}", x
    raise ValueError(f"{path}: unknown leaf name {name!r}")


def _lstm(cell_path: str, leaves: dict[str, np.ndarray]) -> dict:
    tname = _torch_name(cell_path)
    get = leaves.pop
    w_ih = np.concatenate(
        [get(f"{cell_path}/i{g}/kernel") for g in _LSTM_GATES], axis=-1)
    w_hh = np.concatenate(
        [get(f"{cell_path}/h{g}/kernel") for g in _LSTM_GATES], axis=-1)
    bias = np.concatenate(
        [get(f"{cell_path}/h{g}/bias") for g in _LSTM_GATES], axis=-1)
    layer, _, cell = tname.rpartition(".")
    if cell in ("fwd", "bwd"):              # an RNNLayer's nn.LSTM
        lstm = f"{layer}.lstm" if layer else "lstm"
        sfx = "" if cell == "fwd" else "_reverse"
        return {f"{lstm}.weight_ih_l0{sfx}": w_ih.T,
                f"{lstm}.weight_hh_l0{sfx}": w_hh.T,
                f"{lstm}.bias_hh_l0{sfx}": bias}
    return {f"{tname}.w_ih": w_ih, f"{tname}.w_hh": w_hh,
            f"{tname}.bias": bias}


def convert_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> the port's state_dict
    (float32 CPU tensors)."""
    leaves = {p: x for p, x in _flatten(flax_params).items()
              if not any(r.search(p) for r in IGNORED)}
    out: dict[str, np.ndarray] = {}
    cells = sorted({m.group(1) for p in leaves
                    for m in [re.match(r"^(.*)/ii/kernel$", p)] if m})
    for cell in cells:
        out.update(_lstm(cell, leaves))
    for path, x in leaves.items():
        name, arr = _leaf(path, x)
        out[name] = arr
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def _get(state, name):
    """A field of an optax state as the caller has it: a NamedTuple, or
    the dict that orbax restores one as (fields by name, never by
    position: orbax sorts a restored namedtuple's fields)."""
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _has(state, name) -> bool:
    return name in state if isinstance(state, dict) else \
        hasattr(state, name)


def _adam_state(chain):
    """The ScaleByAdamState (count, mu, nu) inside an optax chain's state
    (tuples, or the lists orbax restores them as; None for EmptyState)."""
    if chain is None:
        return None
    if _has(chain, "mu") and _has(chain, "nu"):
        return chain
    if isinstance(chain, (list, tuple)):
        for s in chain:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _leafless(state) -> bool:
    """True for an optax state with no array in it (EmptyStates, as a live
    tuple or as the Nones orbax restores them as)."""
    if state is None:
        return True
    if isinstance(state, dict):
        return all(map(_leafless, state.values()))
    if isinstance(state, (list, tuple)):
        return all(map(_leafless, state))
    return False


def _plain(v):
    """numpy scalars (and lists of them) -> Python numbers."""
    if isinstance(v, (np.ndarray, np.generic)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def convert_checkpoint(flax_params: dict, opt_state=None,
                       controller: dict | None = None) -> dict:
    """A JAX checkpoint -> the port's checkpoint payload
    (``trainers/checkpoint.py``), which ``--resume`` and ``--recog_model``
    accept.

    ``flax_params``, ``opt_state`` and ``controller`` are the JAX
    checkpoint's "params", "opt_state" and "controller" as numpy trees,
    e.g. from the JAX package's ``load_checkpoint`` with ``jax.tree.map(
    np.asarray, ...)``. ``opt_state`` is the state of the JAX
    ``build_optimizer``'s adam / noam chain: the accumulation state
    (mini_step, gradient_step, inner_opt_state, acc_grads) when it
    accumulates, else the chain itself; the moments and the accumulator
    are converted as the parameters are. A state with no array in it is
    the clipped SGD's the JAX CLI switches to (``convert_to_sgd_epoch``):
    it becomes the port's ``SGD`` state."""
    out = {"model": convert_params(flax_params)}
    if opt_state is not None and _leafless(opt_state):
        out["optimizer"] = {"optimizer": "sgd"}
    elif opt_state is not None:
        if _has(opt_state, "inner_opt_state"):
            inner = _get(opt_state, "inner_opt_state")
            mini_step = int(np.asarray(_get(opt_state, "mini_step")))
            acc = convert_params(_get(opt_state, "acc_grads"))
        else:
            inner, mini_step = opt_state, 0
            acc = {k: torch.zeros_like(v) for k, v in out["model"].items()}
        adam = _adam_state(inner)
        if adam is None:
            raise ValueError("opt_state holds no Adam state (count, mu, nu)")
        out["optimizer"] = {
            "count": int(np.asarray(_get(adam, "count"))),
            "mini_step": mini_step,
            "mu": convert_params(_get(adam, "mu")),
            "nu": convert_params(_get(adam, "nu")),
            "acc": acc}
    if controller is not None:
        ctl = {k: _plain(v) for k, v in controller.items()}
        ctl["topk"] = [(float(v), int(e)) for v, e in ctl["topk"]]
        out["controller"] = ctl
    return out
