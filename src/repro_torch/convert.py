"""Carry weights, decode caches and round states across between nested
numpy trees (the layout ``jax.device_get`` gives of the reference's
pytrees) and the port's flat ``dict[str, Tensor]`` with ``/``-joined names.

A nested dict ``{"c1": {"w": a}}`` becomes ``{"c1/w": tensor(a)}``; an
empty tuple (the reference's SGD state) becomes ``{}``.  The reference's LM
parameters (``init_lm``) become ``embed/tok``, ``blocks/s0_mix/w_z`` (with
the stacked block axis), ``blocks/s0_mix/wq``, ``blocks/s0_ffn/w_gate``
and so on, and its decode cache (``init_cache``, ``prefill``)
``s0/state``, ``s0/conv_x`` (Mamba) or the ring buffers ``s0/k``, ``s0/v``
(attention) and so on; whisper's (``init_encdec``) become ``pos_dec``,
``enc/attn/wq``, ``enc/mlp/b_up``, ``dec/self/wq``, ``dec/cross/wk``,
``dec/n3/scale``, ``enc_norm/scale`` and so on (the stacked layer axis
leading), its decode cache ``self/k``, ``self/v``, ``cross_k`` and
``cross_v``, and a VLM's projector ``patch_proj/w``; the LLM algorithms'
client-stacked parameters (leaves (K, ...), ``core.llm_algorithms``) cross
the same way, leading client axis and all.  numpy has no bfloat16
of its own: the reference's bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays, cross through float32 (exact) and land as ``torch.bfloat16``; on
the way back a bf16 tensor becomes a float32 array (exact as well).  The
reference's round state is read by attribute (``.clients.params`` and so
on), so this module needs nothing of the reference package."""
from __future__ import annotations

import numpy as np
import torch

from .core.algorithms import ClientState, RoundState, ServerState


def flatten_tree(tree, prefix: str = "", out=None) -> dict:
    """Nested dicts/tuples of arrays -> flat ``{"a/b": ndarray}``."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten_tree(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flatten_tree(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def from_numpy_tree(tree, device) -> dict:
    """Nested numpy tree -> flat ``{"a/b": Tensor}`` on ``device`` (copied:
    the tensors share no memory with the arrays)."""
    return {k: _tensor(v, device) for k, v in flatten_tree(tree).items()}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":      # ml_dtypes.bfloat16, via float32
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def to_numpy_tree(flat: dict) -> dict:
    """Flat ``{"a/b": Tensor}`` -> nested dict of numpy arrays."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        v = v.detach().cpu()
        node[leaf] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def round_state_from_numpy(state, device) -> RoundState:
    """The reference's RoundState (numpy leaves) -> the port's."""
    c, s = state.clients, state.server
    return RoundState(
        clients=ClientState(*(from_numpy_tree(getattr(c, f), device)
                              for f in ("params", "model_state", "opt_update",
                                        "opt_distill"))),
        server=ServerState(*(from_numpy_tree(getattr(s, f), device)
                             for f in ("params", "model_state",
                                       "opt_distill"))))


def round_state_to_numpy(state: RoundState) -> dict:
    """The port's RoundState -> ``{"clients": {...}, "server": {...}}`` of
    nested numpy trees, field by field."""
    return {part: {f: to_numpy_tree(getattr(getattr(state, part), f))
                   for f in getattr(state, part).__dataclass_fields__}
            for part in ("clients", "server")}
