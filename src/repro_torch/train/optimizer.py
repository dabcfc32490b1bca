"""AdamW and Adafactor (factored second moment) on one device, the
reference's ``repro.train.optimizer`` in PyTorch.

The state is the reference's tree: ``{"step": int32 scalar, "leaves":
{...}}`` with one entry per parameter leaf of the reference's parameter
tree, where the transformer blocks' parameters are *stacked* over layers:
``leaves["layers"][name]`` holds ``{"m", "v"}`` (AdamW) or ``{"vr", "vc"}``
/ ``{"v"}`` (Adafactor, plus ``"m"`` with momentum) of shape (L, ...). The
port keeps its parameters per block (``layers.{i}.{name}``); the update
sees each stack as the reference does, so Adafactor's rank-based factoring
and its RMS clip follow the stacked shapes:

- a 2-D stack, such as the norm scales (L, d), is factored across layers:
  ``vr`` (L,), ``vc`` (d,);
- the update clip takes the RMS over the whole stack, except for stacks of
  rank ≥ 3 with L ≥ 8, which the reference updates layer by layer
  (``lax.map``) and so clips per layer; the port then updates one block's
  slice at a time, as the reference does, to keep the f32 temporaries to
  one layer.

Parameters and state are updated in place (the reference returns new
arrays); the math runs in float32 and is stored back in the parameters'
dtype and ``state_dtype``. The global gradient norm sums the leaves in the
port's order, an ulp-level difference from the reference's.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory
    # adafactor
    factored: bool = True
    momentum: bool = False  # adafactor first moment off by default
    warmup_steps: int = 100


_STACKED = re.compile(r"layers\.(\d+)\.(.+)")
# stacks of at least this many layers (and rank >= 3) update layer by layer
MAP_LAYERS = 8
EPS1 = 1e-30


def stacks(model: nn.Module) -> Dict:
    """The model's parameters in the reference's tree: ``layers.{i}.{name}``
    gathered into ``tree["layers"][name]`` as a list over i (one stacked
    leaf), a submodule's parameter ``a.b`` at ``tree["a"]["b"]`` (DIEN's
    ``gru1.wx``), every other parameter a leaf under its own name."""
    tree: Dict = {}
    layers: Dict[str, List[Tuple[int, nn.Parameter]]] = {}
    for name, p in model.named_parameters():
        hit = _STACKED.fullmatch(name)
        if hit:
            layers.setdefault(hit.group(2), []).append((int(hit.group(1)), p))
        else:
            _set(tree, tuple(name.split(".")), p)
    if layers:
        tree["layers"] = {name: [p for _, p in sorted(ps, key=lambda t: t[0])]
                          for name, ps in layers.items()}
    return tree


def _leaf_items(tree: Dict, prefix=()):
    """(path, leaf) pairs in sorted-key order, a stacked leaf as a list."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaf_items(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _get(tree: Dict, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Dict, path, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def _stacked_shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    # rank-based only, as the reference's
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def _leaf_state(shape, cfg: OptConfig, device) -> Dict[str, torch.Tensor]:
    def zeros(s):
        return torch.zeros(s, dtype=cfg.state_dtype, device=device)

    if cfg.name == "adamw":
        return {"m": zeros(shape), "v": zeros(shape)}
    st = {}
    if cfg.factored and _factored_dims(shape) is not None:
        st["vr"] = zeros(shape[:-1])
        st["vc"] = zeros(shape[:-2] + shape[-1:])
    else:
        st["v"] = zeros(shape)
    if cfg.momentum:
        st["m"] = zeros(shape)
    return st


def opt_init(model: nn.Module, cfg: OptConfig) -> Dict:
    """Zero state in the reference's tree (stacked over layers)."""
    leaves: Dict = {}
    device = None
    for path, leaf in _leaf_items(stacks(model)):
        device = (leaf[0] if isinstance(leaf, list) else leaf).device
        _set(leaves, path, _leaf_state(_stacked_shape(leaf), cfg, device))
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "leaves": leaves}


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """lr · min(1, (step + 1) / warmup) in float32 on the step's device, as
    the reference's (no host sync)."""
    warm = torch.clamp_max((step.float() + 1.0)
                           / float(max(cfg.warmup_steps, 1)), 1.0)
    return cfg.lr * warm


def _global_norm(grads) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in grads)
    return torch.sqrt(sq)


def _adamw(p, g, st, cfg: OptConfig, lr, t: torch.Tensor):
    """One AdamW step on f32 ``g`` (clipped): returns the new parameter
    (f32) and writes the state."""
    m = st["m"].float() * cfg.b1 + g * (1 - cfg.b1)
    v = st["v"].float() * cfg.b2 + g * g * (1 - cfg.b2)
    mh = m / (1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t))
    vh = v / (1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t))
    pf = p.float()
    upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
    st["m"].copy_(m)
    st["v"].copy_(v)
    return pf - lr * upd


def _adafactor(p, g, st, cfg: OptConfig, lr, t: torch.Tensor):
    """One Adafactor step on f32 ``g`` (clipped) over the whole of ``p``
    (a stack or one layer's slice): factored second moment when the state
    has ``vr``/``vc``, the RMS update clip over all of ``p``."""
    decay = 1.0 - torch.pow(t + 1.0, -0.8)
    gg = g * g + EPS1
    if "vr" in st:
        vr = st["vr"].float() * decay + gg.mean(-1) * (1 - decay)
        vc = st["vc"].float() * decay + gg.mean(-2) * (1 - decay)
        denom = (vr[..., None]
                 / torch.clamp_min(vr.mean(-1, keepdim=True), EPS1)[..., None]
                 * vc[..., None, :])
        upd = g * torch.rsqrt(denom + EPS1)
        st["vr"].copy_(vr)
        st["vc"].copy_(vc)
    else:
        v = st["v"].float() * decay + g * g * (1 - decay)
        upd = g * torch.rsqrt(v + EPS1)
        st["v"].copy_(v)
    rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
    upd = upd / torch.clamp_min(rms, 1.0)
    if cfg.momentum:
        m = st["m"].float() * cfg.b1 + upd * (1 - cfg.b1)
        st["m"].copy_(m)
        upd = m
    pf = p.float()
    return pf - lr * (upd + cfg.weight_decay * pf)


@torch.no_grad()
def opt_update(model: nn.Module, grads: Dict[str, torch.Tensor], state: Dict,
               cfg: OptConfig):
    """One step: clip by the global norm, then AdamW or Adafactor with
    decoupled weight decay. ``grads`` maps ``model.named_parameters()``
    names to gradients (any float dtype). Updates the parameters and
    ``state`` in place and returns ``(model, state)``."""
    state["step"] += 1
    t = state["step"].float()
    lr = _schedule(cfg, state["step"])
    names = {id(p): n for n, p in model.named_parameters()}
    gnorm = _global_norm(grads[names[id(p)]] for p in model.parameters())
    scale = (torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
             if cfg.grad_clip else torch.ones((), device=gnorm.device))
    leaf_fn = _adamw if cfg.name == "adamw" else _adafactor

    def run(p, g, st):
        return leaf_fn(p, g.float() * scale, st, cfg, lr, t)

    for path, leaf in _leaf_items(stacks(model)):
        st = _get(state["leaves"], path)
        if not isinstance(leaf, list):
            leaf.copy_(run(leaf, grads[names[id(leaf)]], st))
        elif cfg.name == "adamw" or (len(leaf[0].shape) >= 2
                                     and len(leaf) >= MAP_LAYERS):
            # elementwise, or the reference's per-layer lax.map: one
            # layer's slice of parameter, gradient and state at a time
            for i, p in enumerate(leaf):
                p.copy_(run(p, grads[names[id(p)]],
                            {k: s[i] for k, s in st.items()}))
        else:  # the whole stack at once
            new = run(torch.stack(list(leaf)),
                      torch.stack([grads[names[id(p)]] for p in leaf]), st)
            for p, row in zip(leaf, new):
                p.copy_(row)
    return model, state
