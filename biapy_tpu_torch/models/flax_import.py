"""Weight bridge from the JAX package's Flax variables to the port's modules.

The port's modules carry Flax's names (see ``blocks.py``), so a parameter
``UpBlock_0.ConvTranspose_0.kernel`` is the Flax leaf
``params/UpBlock_0/ConvTranspose_0/kernel``, and a buffer ``...mean`` /
``...var`` is the same path under ``batch_stats``. Layouts are the same on
both sides, so the bridge is a name match and a copy, in either direction.
It imports no JAX: nested dicts of numpy arrays go in and come out.

``load_flax_variables`` holds the two sides to the same leaves exactly;
``apply_checkpoint_params`` loads a checkpoint the way the JAX package's
``utils/misc.py::apply_checkpoint_params`` merges one (MODEL.
SKIP_UNMATCHED_LAYERS); ``export_flax_variables`` gives the trees that
``utils/misc.py::save_model`` writes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

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


def apply_checkpoint_params(model: torch.nn.Module, params, batch_stats=None,
                            skip_unmatched: bool = True) -> None:
    """Copy a checkpoint's weights into ``model`` in place (reference:
    load_model_checkpoint partial loading, misc.py:516). A model leaf the
    checkpoint lacks, or holds at another shape, raises unless
    ``skip_unmatched`` (MODEL.SKIP_UNMATCHED_LAYERS), which keeps the model's
    value; checkpoint leaves the model lacks are ignored. ``batch_stats``,
    where the checkpoint has any, follow the same rule."""
    loaded = 0
    skipped: List[str] = []
    pairs = [(model.named_parameters(), params)]
    if batch_stats:
        pairs.append((model.named_buffers(), batch_stats))
    for named, tree in pairs:
        src = flatten(tree)
        for name, t in named:
            path = name.replace(".", "/")
            if path not in src:
                if not skip_unmatched:
                    raise ValueError(
                        f"Checkpoint missing parameter {path} (set MODEL.SKIP_UNMATCHED_LAYERS "
                        "to finetune across architecture changes)")
                skipped.append(path)
                continue
            v = src[path]
            arr = v.float() if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, dtype=np.float32))
            if tuple(arr.shape) != tuple(t.shape):
                if not skip_unmatched:
                    raise ValueError(f"Shape mismatch at {path}: {tuple(arr.shape)} vs "
                                     f"{tuple(t.shape)}")
                skipped.append(path)
                continue
            with torch.no_grad():
                t.copy_(arr)
            loaded += 1
    if skipped:
        print(f"Checkpoint load: {loaded} tensors loaded, {len(skipped)} skipped "
              f"(first skipped: {skipped[:5]})")


def unflatten(names: Iterable[str], leaf: Callable[[str], Any]) -> Dict[str, Any]:
    """Nested dict under Flax's path of each module name (its ``.``-separated
    parts), the leaf ``leaf(name)``: the inverse of ``flatten``."""
    tree: Dict[str, Any] = {}
    for name in names:
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf(name)
    return tree


def export_flax_variables(model: torch.nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, batch_stats)`` of ``model`` as nested dicts of float32
    numpy arrays under Flax's names: the inverse of ``load_flax_variables``."""
    def tree(named):
        named = dict(named)
        return unflatten(named, lambda n: named[n].detach().float().cpu().numpy().copy())

    return tree(model.named_parameters()), tree(model.named_buffers())
