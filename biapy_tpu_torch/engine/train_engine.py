"""Train and eval steps.

Counterpart of ``biapy_tpu/engine/train_engine.py``: one function
``(state, batch, generator) -> (state, metrics)`` per batch. PyTorch runs
eagerly, so there is nothing to compile and the state is updated in place
(the JAX step donates its input state for the same effect); the step reads
nothing back to the host, so consecutive steps queue on the device.

Mixed precision as the JAX step has it: float32 master weights, the forward
and backward in bf16 through the modules' own ``kernel.to(x.dtype)`` casts
(not ``torch.autocast``, whose per-op casting differs), outputs cast to
float32 before the loss, float32 gradients and update.

A loss with ``needs_rng``, ``extra_batch_rep_keys`` and ``aux_out_fn``
belong to the contrastive head and come with it (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from biapy_tpu_torch.engine.schedulers import Optimizer, PlateauController
from biapy_tpu_torch.models.blocks import dropout_generator


@dataclass
class TrainState:
    """Model + optimizer state. ``step`` counts every call of the train
    step; the optimizer's own count skips the updates the NaN guard
    dropped."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    plateau: Optional[PlateauController] = None


def resolve_mixed_precision(setting, device) -> bool:
    """TRAIN.MIXED_PRECISION: True/False or 'auto' (bf16 compute on a CUDA
    device, f32 elsewhere). Params, optimizer state and gradients stay f32;
    the forward and backward run in bf16."""
    if isinstance(setting, str):
        s = setting.lower()
        if s == "auto":
            return torch.device(device).type == "cuda"
        return s in ("1", "true", "yes")
    return bool(setting)


def map_outputs(fn: Callable, outputs):
    """``fn`` over a model's outputs: a tensor, or the dict of a model with a
    class head (``{"pred": ..., "class": ...}``)."""
    if isinstance(outputs, dict):
        return {k: fn(v) for k, v in outputs.items()}
    return fn(outputs)


def _to_device(batch: Dict, model: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = next(model.parameters()).device
    return tuple(torch.as_tensor(batch[k]).to(dev) for k in ("x", "y"))


def loss_and_grads(model: torch.nn.Module, loss_fn: Callable, x: torch.Tensor, y: torch.Tensor,
                   mixed_precision: bool = False,
                   generator: Optional[torch.Generator] = None):
    """Forward in training mode (BatchNorm statistics advance), loss, and
    the float32 gradients of the trainable parameters by name. Returns
    ``(loss, outputs, grads)``; outputs (a tensor, or a dict of them) are
    float32 and detached."""
    model.train()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    # no TF32 in the library convolutions, forward or backward: float32
    # training is float32 (the flag is read when each convolution runs)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with dropout_generator(generator):
            outputs = model(x.to(torch.bfloat16) if mixed_precision else x)
        # losses and metrics accumulate in f32
        outputs = map_outputs(lambda o: o.float(), outputs)
        loss = loss_fn(outputs, y)
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return (loss.detach(), map_outputs(lambda o: o.detach(), outputs),
            {n: g for (n, _), g in zip(named, grads)})


def make_train_step(loss_fn: Callable, metric_fns: Optional[Dict[str, Callable]] = None,
                    mixed_precision: bool = False):
    """Build the train step ``step(state, batch, generator=None)``.

    ``loss_fn(outputs, targets) -> 0-d tensor``; ``metric_fns`` maps names to
    ``fn(outputs, targets) -> 0-d tensor``. ``batch`` holds ``x`` and ``y``
    (tensors or numpy arrays, moved to the model's device); ``generator``
    feeds dropout. Returns the (same, updated) state and the metrics as 0-d
    tensors on the device.

    NaN guard: a non-finite loss leaves the weights and the optimizer state
    as they were, while the step count and the BatchNorm statistics still
    advance; the host sees it in ``metrics['loss']``."""
    metric_fns = metric_fns or {}

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
        x, y = _to_device(batch, state.model)
        loss, outputs, grads = loss_and_grads(state.model, loss_fn, x, y, mixed_precision,
                                              generator)
        state.optimizer.update(grads, ok=torch.isfinite(loss))
        state.step += 1
        metrics = {"loss": loss}
        with torch.no_grad():
            for name, fn in metric_fns.items():
                metrics[name] = fn(outputs, y)
        return state, metrics

    return step


def make_eval_step(loss_fn: Callable, metric_fns: Optional[Dict[str, Callable]] = None):
    """Build the eval step ``step(state, batch) -> metrics``: the model in
    eval mode (running statistics, no dropout), float32, nothing updated."""
    metric_fns = metric_fns or {}

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        x, y = _to_device(batch, state.model)
        state.model.eval()
        with torch.no_grad():
            outputs = state.model(x)
            metrics = {"loss": loss_fn(outputs, y)}
            for name, fn in metric_fns.items():
                metrics[name] = fn(outputs, y)
        return metrics

    return step
