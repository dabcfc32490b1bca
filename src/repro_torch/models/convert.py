"""Carry LM, GNN and recsys parameters and optimizer state across
frameworks.

The reference's ``init_lm`` returns a dict ``{"embed", "final_norm",
"layers": {name: (L, ...) stacked}, "unembed"?}``, its ``init_gnn``
``{"embed_w", "embed_b", "layers": {U, V, C, D, E, ln_h, ln_e stacked},
"head_w", "head_b"}``, its recsys inits the module's parameter names as
``train.optimizer.stacks`` nests them (BERT4Rec's ``layers`` stacked,
DIEN's ``gru1``/``gru2`` dicts); the tests convert them with
``numpy.asarray`` and load them here, so both packages run the same weights (``torch.Generator``
cannot reproduce ``jax.random``). Values pass through float32, which holds
every bfloat16 exactly. The optimizer state is the reference's ``{"step",
"leaves"}`` tree in both packages (``train.optimizer``); :func:`param_tree`
gives a model's parameters in the reference's tree as tensors, so a
training checkpoint ``(param_tree(model), opt_state)`` restores in either
package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..train.optimizer import OptConfig, opt_init, stacks
from . import recsys
from .gnn import LAYER_MATS, LAYER_NORMS, GatedGCN, GNNConfig
from .transformer import LM, LMConfig


def tensor_from_numpy(a, dtype: torch.dtype, device="cuda") -> torch.Tensor:
    """A numpy (or array-like, bfloat16 included) array as a ``dtype``
    tensor on ``device``, through float32."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def lm_from_numpy(params: Dict, cfg: LMConfig, device="cuda") -> LM:
    """An :class:`LM` on ``device`` holding the reference's parameters."""
    return load_lm_tree(LM(cfg, device), params)


def lm_to_numpy(model: LM) -> Dict:
    """The reference's parameter tree as float32 numpy arrays (cast them to
    the config's dtype on the JAX side: the round trip is exact)."""

    def f32(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    names = [name for name, _ in model.layers[0].named_parameters()]
    out = {
        "embed": f32(model.embed),
        "final_norm": f32(model.final_norm),
        "layers": {name: np.stack([f32(getattr(blk, name))
                                   for blk in model.layers])
                   for name in names},
    }
    if not model.cfg.tied_embed:
        out["unembed"] = f32(model.unembed)
    return out


def lm_tree(model: LM) -> Dict:
    """The parameters in the reference's tree, as tensors in the model's
    dtype on its device (the layers stacked: a copy)."""
    names = [name for name, _ in model.layers[0].named_parameters()]
    out = {"embed": model.embed.detach(),
           "final_norm": model.final_norm.detach(),
           "layers": {name: torch.stack([getattr(blk, name).detach()
                                         for blk in model.layers])
                      for name in names}}
    if not model.cfg.tied_embed:
        out["unembed"] = model.unembed.detach()
    return out


@torch.no_grad()
def load_lm_tree(model: LM, tree: Dict) -> LM:
    """Copy a parameter tree in the reference's layout (tensors or numpy
    arrays, e.g. a restored checkpoint) into ``model`` in place."""

    _put(model.embed, tree["embed"])
    _put(model.final_norm, tree["final_norm"])
    if not model.cfg.tied_embed:
        _put(model.unembed, tree["unembed"])
    for name, stacked in tree["layers"].items():
        for i, blk in enumerate(model.layers):
            _put(getattr(blk, name), stacked[i])
    return model


def _put(dst: torch.Tensor, src) -> None:
    src = (src if isinstance(src, torch.Tensor)
           else tensor_from_numpy(src, dst.dtype, dst.device))
    dst.copy_(src)


def gnn_tree(model: GatedGCN) -> Dict:
    """The GNN's parameters in the reference's tree, as tensors in the
    model's dtype on its device (the layers stacked: a copy)."""
    out = {name: getattr(model, name).detach()
           for name in ("embed_w", "embed_b", "head_w", "head_b")}
    out["layers"] = {name: torch.stack([getattr(lp, name).detach()
                                        for lp in model.layers])
                     for name in LAYER_MATS + LAYER_NORMS}
    return out


@torch.no_grad()
def load_gnn_tree(model: GatedGCN, tree: Dict) -> GatedGCN:
    """Copy a parameter tree in the reference's layout (tensors or numpy
    arrays) into ``model`` in place."""
    for name in ("embed_w", "embed_b", "head_w", "head_b"):
        _put(getattr(model, name), tree[name])
    for name, stacked in tree["layers"].items():
        for i, lp in enumerate(model.layers):
            _put(getattr(lp, name), stacked[i])
    return model


def gnn_from_numpy(params: Dict, cfg: GNNConfig, device="cuda") -> GatedGCN:
    """A :class:`GatedGCN` on ``device`` holding the reference's
    parameters."""
    return load_gnn_tree(GatedGCN(cfg, device), params)


def gnn_to_numpy(model: GatedGCN) -> Dict:
    """The reference's parameter tree as float32 numpy arrays."""
    tree = gnn_tree(model)
    return {key: ({k: v.float().cpu().numpy() for k, v in val.items()}
                  if isinstance(val, dict) else val.float().cpu().numpy())
            for key, val in tree.items()}


def recsys_tree(model) -> Dict:
    """A recsys model's parameters in the reference's tree, as tensors in
    the model's dtype on its device (BERT4Rec's blocks stacked: a
    copy)."""

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        if isinstance(node, list):
            return torch.stack([p.detach() for p in node])
        return node.detach()

    return conv(stacks(model))


@torch.no_grad()
def load_recsys_tree(model, tree: Dict):
    """Copy a recsys parameter tree in the reference's layout (tensors or
    numpy arrays) into ``model`` in place; the keys must match."""

    def fill(dst: Dict, src: Dict) -> None:
        if set(dst) != set(src):
            raise ValueError(f"recsys tree keys differ: {sorted(dst)} vs "
                             f"{sorted(src)}")
        for key, val in dst.items():
            if isinstance(val, dict):
                fill(val, src[key])
            elif isinstance(val, list):
                for i, p in enumerate(val):
                    _put(p, src[key][i])
            else:
                _put(val, src[key])

    fill(stacks(model), tree)
    return model


def recsys_from_numpy(params: Dict, cfg, device="cuda"):
    """The recsys module of ``cfg`` on ``device`` holding the reference's
    parameters."""
    return load_recsys_tree(recsys.family(cfg).cls(cfg, device), params)


def recsys_to_numpy(model) -> Dict:
    """The reference's parameter tree as float32 numpy arrays."""

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        return node.float().cpu().numpy()

    return conv(recsys_tree(model))


def param_tree(model) -> Dict:
    """The model's parameters in the reference's tree (:func:`lm_tree`,
    :func:`gnn_tree` or :func:`recsys_tree`): a training checkpoint's
    parameter half."""
    if isinstance(model, GatedGCN):
        return gnn_tree(model)
    if isinstance(model, recsys.MODELS):
        return recsys_tree(model)
    return lm_tree(model)


def load_param_tree(model, tree: Dict):
    """Load a :func:`param_tree` into ``model`` in place."""
    if isinstance(model, GatedGCN):
        return load_gnn_tree(model, tree)
    if isinstance(model, recsys.MODELS):
        return load_recsys_tree(model, tree)
    return load_lm_tree(model, tree)


def opt_state_from_numpy(ref_state: Dict, model: LM, opt_cfg: OptConfig
                         ) -> Dict:
    """The reference's optimizer state (``{"step", "leaves"}``, stacked
    ``m``/``v`` or ``vr``/``vc``/``v``, as numpy) as the port's, on the
    model's device in ``opt_cfg.state_dtype``; every shape is checked
    against ``opt_init(model, opt_cfg)``'s."""
    state = opt_init(model, opt_cfg)

    def fill(dst: Dict, src: Dict) -> None:
        if set(dst) != set(src):
            raise ValueError(f"optimizer state keys differ: {sorted(dst)} "
                             f"vs {sorted(src)}")
        for key, val in dst.items():
            if isinstance(val, dict):
                fill(val, src[key])
            else:
                val.copy_(tensor_from_numpy(src[key], val.dtype, val.device))

    fill(state["leaves"], ref_state["leaves"])
    state["step"].fill_(int(np.asarray(ref_state["step"])))
    return state


def opt_state_to_numpy(state: Dict) -> Dict:
    """The port's optimizer state as the reference's tree of numpy arrays:
    ``step`` int32, the moments float32 (cast them to the state dtype on
    the JAX side: the round trip is exact)."""

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        return node.detach().float().cpu().numpy()

    return {"step": np.asarray(int(state["step"]), dtype=np.int32),
            "leaves": conv(state["leaves"])}
