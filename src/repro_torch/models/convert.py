"""Carry LM parameters across frameworks as numpy arrays.

The reference's ``init_lm`` returns a dict ``{"embed", "final_norm",
"layers": {name: (L, ...) stacked}, "unembed"?}``; the tests convert it
with ``numpy.asarray`` and load it here, so both packages run the same
weights (``torch.Generator`` cannot reproduce ``jax.random``). Values pass
through float32, which holds every bfloat16 exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .transformer import LM, LMConfig


def tensor_from_numpy(a, dtype: torch.dtype, device="cuda") -> torch.Tensor:
    """A numpy (or array-like, bfloat16 included) array as a ``dtype``
    tensor on ``device``, through float32."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def lm_from_numpy(params: Dict, cfg: LMConfig, device="cuda") -> LM:
    """An :class:`LM` on ``device`` holding the reference's parameters."""
    model = LM(cfg, device)
    with torch.no_grad():
        model.embed.copy_(tensor_from_numpy(params["embed"], cfg.dtype,
                                            device))
        model.final_norm.copy_(tensor_from_numpy(params["final_norm"],
                                                 cfg.dtype, device))
        if not cfg.tied_embed:
            model.unembed.copy_(tensor_from_numpy(params["unembed"],
                                                  cfg.dtype, device))
        for name, stacked in params["layers"].items():
            t = tensor_from_numpy(stacked, cfg.dtype, device)
            for i, blk in enumerate(model.layers):
                getattr(blk, name).copy_(t[i])
    return model


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
