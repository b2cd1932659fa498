"""Process-level helpers of the runtime: rank, world size, barrier and the
object gather.

Counterpart of ``biapy_tpu/parallel/__init__.py:138-195``
(``is_main_process``, ``process_count``, ``barrier``,
``all_gather_objects``; ``process_index`` is ``jax.process_index``). Over
``torch.distributed`` when a process group is initialised, a single
process otherwise. The by-chunks engine shares its tiles out by these, and
the detection and synapse workflows gather their per-tile points with
``all_gather_objects``; distributed training (DDP) is not ported yet
(ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if _distributed() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (``name`` labels the
    point, as in the JAX package)."""
    if process_count() > 1:
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, in rank order (reference analog:
    ``dist.all_gather_object``); ranks may hold different structures, such
    as ragged per-tile point lists or an empty dict on a rank without
    tiles. One process: ``[obj]``."""
    n = process_count()
    if n <= 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj)
    return out
