"""Weights carried over from the JAX package's pytrees to a torch state_dict.

Counterpart of the key naming and layouts of hippie_tpu/train/checkpoint.py
(``flatten_interleaved``, ``_to_torch_layout``), copied rather than imported.
The JAX package keeps its parameters and BatchNorm state as nested dicts in
torch registration order; flattening them interleaved (a BatchNorm emits
weight, bias, running_mean, running_var, num_batches_tracked) gives the keys
of the port's ``state_dict`` in the same order.

Layouts: conv  [K, C_in, C_out] -> [C_out, C_in, K]; dense [in, out] -> [out, in];
embeddings, biases and BN vectors unchanged; num_batches_tracked int64.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

_BN_PARAM_KEYS = ("weight", "bias")
_BN_STATE_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _is_bn_params(node: Any) -> bool:
    return (
        isinstance(node, dict)
        and set(node.keys()) == {"weight", "bias"}
        and getattr(node["weight"], "ndim", None) == 1
    )


def flatten_interleaved(params: dict, state: Optional[dict]) -> Dict[str, Any]:
    """Flatten params + BN state into torch state_dict key order."""
    out: Dict[str, Any] = {}

    def walk(p: Any, s: Any, prefix: str):
        if _is_bn_params(p) and isinstance(s, dict) and "running_mean" in s:
            for k in _BN_PARAM_KEYS:
                out[prefix + k] = p[k]
            for k in _BN_STATE_KEYS:
                out[prefix + k] = s[k]
            return
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, s.get(k, {}) if isinstance(s, dict) else {}, prefix + k + ".")
        else:
            out[prefix[:-1]] = p

    walk(params, state or {}, "")
    return out


def _to_torch_layout(key: str, x: np.ndarray) -> np.ndarray:
    if x.ndim == 3:  # conv kernel [K, I, O] -> [O, I, K]
        return np.transpose(x, (2, 1, 0))
    if x.ndim == 2 and "embedding" not in key:  # dense [in, out] -> [out, in]
        return np.transpose(x, (1, 0))
    return x


def state_dict_from_jax(params: dict, state: Optional[dict]) -> "OrderedDict[str, torch.Tensor]":
    """JAX (params, bn_state) nested dicts of arrays -> the port's state_dict.

    Leaves may be numpy arrays or anything ``np.asarray`` reads. The result
    loads with ``model.load_state_dict(sd, strict=True)``.
    """
    sd = OrderedDict()
    for k, v in flatten_interleaved(params, state).items():
        arr = np.asarray(v)
        if k.endswith("num_batches_tracked"):
            arr = arr.astype(np.int64)
        sd[k] = torch.from_numpy(np.array(_to_torch_layout(k, arr), order="C"))
    return sd
