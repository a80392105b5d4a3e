"""Checkpoint and resume.

Counterpart of ``dist_gnn_tpu/training/checkpoint.py``: one dependency-free
``.npz`` holding the model's ``state_dict``, the optimizer's per-parameter
state (Adam's moments and its 0-d ``step``) and the training step, each
leaf under its ``/``-joined key path, restored with every leaf's shape and
dtype checked against a template: the model and optimizer of the
restoring run, built with the same config.  As in the JAX package the
hyperparameters (learning rate, betas, weight decay) are config, not
state: they stay the template optimizer's.

Leaves whose dtype ``np.savez`` cannot round-trip (bfloat16, the float8
types) are stored as a uint8 view of their bytes with dtype and shape
sidecar entries.  The byte view is taken of the flattened leaf, so a 0-d
leaf round-trips: the JAX package's ``arr.view(np.uint8)`` raises on a
0-d bf16 leaf (``checkpoint.py:38``), and torch's Adam keeps a 0-d
``step`` per parameter.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_DTYPE_KEY = "__dtype__/"
_SHAPE_KEY = "__shape__/"
_BYTE_DTYPES = {torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2}


def _optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-parameter state by parameter index, as ``state_dict()`` numbers
    them.  A parameter the optimizer has not stepped yet gets Adam's
    initial state (a 0-d ``step`` and zero moments, ``torch.optim.Adam``'s
    own layout), so a fresh optimizer is a template; other optimizers must
    have stepped."""
    state = optimizer.state_dict()["state"]
    out, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            if index in state:
                out[str(index)] = state[index]
            elif isinstance(optimizer, torch.optim.Adam):
                on_dev = group.get("capturable") or group.get("fused")
                scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
                s = {"step": torch.zeros((), dtype=scalar, device=p.device if on_dev else "cpu"),
                     "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
                if group.get("amsgrad"):
                    s["max_exp_avg_sq"] = torch.zeros_like(p)
                out[str(index)] = s
            else:
                raise ValueError(f"parameter {index} has no optimizer state to serve as a template")
            index += 1
    return out


def _leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, torch.Tensor]:
    leaves = {f"model/{k}": v for k, v in model.state_dict().items()}
    for i, s in _optimizer_state(optimizer).items():
        for name, v in s.items():
            if not isinstance(v, torch.Tensor):
                raise ValueError(f"optimizer state {i}/{name} is not a tensor: {v!r}")
            leaves[f"optimizer/state/{i}/{name}"] = v
    return leaves


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int) -> None:
    """Write the model, the optimizer's state and ``step`` to
    ``path + ".npz"`` (``path`` is a file prefix)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"step": np.asarray(int(step), np.int64)}
    for key, leaf in _leaves(model, optimizer).items():
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _BYTE_DTYPES:
            flat[_DTYPE_KEY + key] = np.array(str(t.dtype).removeprefix("torch."))
            flat[_SHAPE_KEY + key] = np.array(tuple(t.shape), dtype=np.int64)
            t = t.reshape(-1).view(torch.uint8)  # 0-d leaves too: one element
        flat[key] = t.numpy()
    np.savez(path + ".npz", **flat)


def _restore(data, key: str, tmpl: torch.Tensor) -> torch.Tensor:
    """The saved leaf at ``key``, checked against the template leaf."""
    if key not in data:
        raise KeyError(f"checkpoint missing {key}")
    t = torch.from_numpy(np.array(data[key]))
    if _DTYPE_KEY + key in data:
        shape = tuple(int(s) for s in data[_SHAPE_KEY + key])
        t = t.view(getattr(torch, str(data[_DTYPE_KEY + key]))).reshape(shape)
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"checkpoint shape mismatch at {key}: saved {tuple(t.shape)} vs template {tuple(tmpl.shape)}"
            " — was it written by a different model/optimizer config?"
        )
    if t.dtype != tmpl.dtype:
        raise ValueError(
            f"checkpoint dtype mismatch at {key}: saved {t.dtype} vs template {tmpl.dtype}"
            " — was it written by a different param_dtype config?"
        )
    return t.to(tmpl.device)


def load_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int:
    """Restore ``path + ".npz"`` into ``model`` and ``optimizer`` and return
    the saved step.  Every leaf is checked against the template's first (a
    leaf of another shape or dtype raises, and nothing is loaded)."""
    with np.load(path + ".npz") as data:
        restored = {key: _restore(data, key, tmpl) for key, tmpl in _leaves(model, optimizer).items()}
        step = int(data["step"])
    model.load_state_dict({k.removeprefix("model/"): v for k, v in restored.items() if k.startswith("model/")})
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, v in restored.items():
        if key.startswith("optimizer/state/"):
            i, name = key.removeprefix("optimizer/state/").split("/", 1)
            state.setdefault(int(i), {})[name] = v
    optimizer.load_state_dict({"state": state, "param_groups": optimizer.state_dict()["param_groups"]})
    return step
