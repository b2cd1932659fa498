"""Process-level helpers of the runtime: rank, world size and barrier.

Counterpart of ``biapy_tpu/parallel/__init__.py:138-190``
(``is_main_process``, ``process_count``, ``barrier``; ``process_index`` is
``jax.process_index``). Over ``torch.distributed`` when a process group is
initialised, a single process otherwise. The by-chunks engine shares its
tiles out by these; distributed training (DDP) and the object gather of the
instance merge are not ported yet (ROADMAP queue 1 items 8 and 9).
"""

from __future__ import annotations

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

