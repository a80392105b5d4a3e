"""Parameter conversion between the JAX package's pytrees and the port.

``dist_gnn_tpu`` keeps SAGE params as ``{"layer{l}": {"w_self", "w_neigh",
"b"}}`` of ``[d_in, d_out]`` matrices and GAT params as ``{"layer{l}":
{"w", "a_l", "a_r", "b"}}``; the port's ``SAGE`` and ``GAT`` use the same
names and layouts, so the conversion is a flattening of names.  It takes
nested dicts of numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(params_np: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    return {
        f"{layer}.{name}": torch.from_numpy(np.array(value))
        for layer, leaves in params_np.items()
        for name, value in leaves.items()
    }


def sage_params_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """JAX SAGE params (nested dicts of numpy arrays) -> a state_dict for
    ``dist_gnn_tpu_torch.models.SAGE``, dtypes kept."""
    return _flatten(params_np)


def gat_params_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """JAX GAT params (nested dicts of numpy arrays) -> a state_dict for
    ``dist_gnn_tpu_torch.models.GAT``, dtypes kept."""
    return _flatten(params_np)
