"""Weight bridge from the JAX package's Flax variables to the port's modules.

The port's modules carry Flax's names (see ``blocks.py``), so a parameter
``UpBlock_0.ConvTranspose_0.kernel`` is the Flax leaf
``params/UpBlock_0/ConvTranspose_0/kernel``, and a buffer ``...mean`` /
``...var`` is the same path under ``batch_stats``. Layouts are the same on
both sides, so the bridge is a name match and a copy, in either direction.
It imports no JAX: nested dicts of numpy arrays go in and come out.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch


def flatten(tree: Optional[Mapping[str, Any]], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': leaf}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in (tree or {}).items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def _copy(dst: Dict[str, torch.Tensor], src: Dict[str, np.ndarray], what: str) -> None:
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"{what}: leaves missing from the Flax tree {missing}, "
                       f"Flax leaves with no counterpart {extra}")
    for name, t in dst.items():
        arr = np.array(src[name], dtype=np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{what} '{name}': Flax shape {arr.shape} != port shape "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(arr))


def load_flax_variables(model: torch.nn.Module, params: Mapping[str, Any],
                        batch_stats: Optional[Mapping[str, Any]] = None) -> None:
    """Copy Flax ``params`` (and ``batch_stats``) into ``model`` in place.
    Every name and shape is checked; a leaf missing on either side raises."""
    _copy({n.replace(".", "/"): p for n, p in model.named_parameters()},
          flatten(params), "params")
    _copy({n.replace(".", "/"): b for n, b in model.named_buffers()},
          flatten(batch_stats), "batch_stats")


def _nest(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().float().cpu().numpy().copy()
    return tree


def export_flax_variables(model: torch.nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, batch_stats)`` of ``model`` as nested dicts of float32
    numpy arrays under Flax's names: the inverse of ``load_flax_variables``."""
    return _nest(model.named_parameters()), _nest(model.named_buffers())
