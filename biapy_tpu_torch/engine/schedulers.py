"""Learning-rate schedules and the optimizer factory.

Counterpart of ``biapy_tpu/engine/schedulers.py``, which builds optax
transformations; here the same update rules are written out on torch
tensors, so that a step from the same weights and gradients gives the same
weights:

- SGD: L2 in the gradient (``g + wd * p``), momentum 0.9 with Nesterov's
  look-ahead in optax's form (``t = g + 0.9 t; u = g + 0.9 t``);
- ADAM: L2 in the gradient, then Adam with bias correction, eps 1e-8
  outside the root;
- ADAMW: Adam on the raw gradient, then ``u + wd * p`` on every parameter
  (``optax.adamw`` without a mask decays biases and norm scales too);
- ``TRAIN.GRADIENT_CLIP_NORM`` scales the gradients by
  ``clip / max(norm, clip)`` before anything else;
- the learning rate of an update is the schedule at the optimizer's own
  count of updates made so far (0 for the first), as
  ``optax.inject_hyperparams`` evaluates it;
- ``MODEL.FREEZE_LAYERS_MATCHING`` takes the matching parameters out of
  training altogether (no gradient, no decay, not in the clip norm).

Warm-up cosine and one-cycle are functions of the count, evaluated on the
device; the two plateau schedules are host-side controllers that set the
optimizer's learning rate after each validation.

Everything an update changes lives in tensors on the parameters' device,
and ``Optimizer.update`` takes an ``ok`` flag (a 0-d bool tensor): where it
is false the weights and the whole optimizer state stay as they were,
without the host reading the flag.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from biapy_tpu_torch.models.flax_import import flatten, unflatten

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _min_lr(sch, head: int) -> float:
    """MIN_LR indexed per optimizer head."""
    v = sch.MIN_LR
    if isinstance(v, (list, tuple)):
        v = v[min(head, len(v) - 1)] if len(v) else -1.0
    return float(v)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: init -> end over ``transition_steps``."""
    def schedule(count):
        c = torch.clamp(count, 0, transition_steps)
        return (init_value - end_value) * (1 - c / transition_steps) + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear warm-up to the peak,
    then a cosine to ``end_value`` at ``decay_steps`` (counted from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count):
        c = torch.clamp(count - warmup_steps, max=cos_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / cos_steps))
        decayed = peak_value * ((1 - alpha) * cosine + alpha)
        return torch.where(count < warmup_steps, warm(count), decayed)

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """``optax.cosine_onecycle_schedule``: cosine from peak/25 up to the peak
    at 30% of the steps, cosine down to peak/25e4 at the end."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    init = peak_value / div_factor
    values = [init, init * div_factor, init * div_factor / (div_factor * final_div_factor)]

    def schedule(count):
        out = torch.zeros_like(count)
        for i in range(2):
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            interp = values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                torch.cos(math.pi * pct) + 1)
            inside = (count >= bounds[i]) & (count < bounds[i + 1])
            out = torch.where(inside, interp, out)
        return torch.where(count >= bounds[-1], torch.full_like(out, values[-1]), out)

    return schedule


def build_schedule(cfg, lr: float, steps_per_epoch: int, head: int = 0):
    """Return (schedule-or-float, plateau controller or None, warmup steps).
    The warmup-step count is consumed by build_optimizer for the plateau
    variant, whose lr is a host-mutable scalar rather than a schedule."""
    sch = cfg.TRAIN.LR_SCHEDULER
    name = (sch.NAME or "").lower()
    epochs = cfg.TRAIN.EPOCHS
    if not name:
        return lr, None, 0
    if name == "warmupcosine":
        min_lr = _min_lr(sch, head)
        warm_e = sch.WARMUP_COSINE_DECAY_EPOCHS
        warm_steps = max(1, warm_e * steps_per_epoch)
        total = max(warm_steps + 1, epochs * steps_per_epoch)
        floor = min_lr if min_lr != -1.0 else 0.0
        return (warmup_cosine_decay_schedule(floor, lr, warm_steps, total, floor), None, 0)
    if name == "onecycle":
        total = max(2, epochs * steps_per_epoch)
        return cosine_onecycle_schedule(total, lr), None, 0
    if name in ("reduceonplateau", "warmupreduceonplateau"):
        warm = 0
        if name == "warmupreduceonplateau":
            warm = max(1, sch.WARMUP_COSINE_DECAY_EPOCHS * steps_per_epoch)
        ctrl = PlateauController(
            factor=float(sch.REDUCEONPLATEAU_FACTOR),
            patience=int(sch.REDUCEONPLATEAU_PATIENCE),
            min_lr=_min_lr(sch, head),
            base_lr=lr,
        )
        return lr, ctrl, warm
    raise ValueError(f"Unknown LR scheduler: {name}")


class PlateauController:
    """Host-side ReduceLROnPlateau, stepped with each epoch's validation
    loss."""

    def __init__(self, factor: float = 0.5, patience: int = 10, min_lr: float = 0.0,
                 base_lr: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.min_lr = max(min_lr, 0.0) if min_lr != -1.0 else 0.0
        self.lr = base_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, val_loss: float) -> float:
        """Update with the epoch's validation loss; returns the current lr.
        Improvement uses torch ReduceLROnPlateau's default RELATIVE
        threshold (1e-4): noise-level drifts must not reset patience."""
        if val_loss < self.best * (1 - 1e-4):
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class Optimizer:
    """One optimizer over named parameters (see the module docstring for
    the rules). ``state`` maps a name to the tensors the update carries:
    ``count`` (updates made), ``lr`` (the learning rate of the last update,
    or the one the host set), per parameter ``trace`` (SGD) or ``mu`` /
    ``nu`` (Adam). ``optax_state_dict`` / ``load_optax_state_dict`` move it
    to and from the JAX package's checkpoint layout."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], name: str, lr: float,
                 schedule: Optional[Schedule] = None, b1: float = 0.9, b2: float = 0.999,
                 weight_decay: float = 0.0, clip_norm: float = 0.0,
                 b1_schedule: Optional[Schedule] = None, ramp: Optional[Schedule] = None,
                 momentum: float = 0.9, eps: float = 1e-8, freeze: bool = False):
        self.name = name.upper()
        if self.name not in ("SGD", "ADAM", "ADAMW"):
            raise ValueError(f"Unknown optimizer: {name} (expected SGD/ADAM/ADAMW)")
        named = list(named_params)
        # every parameter's name, frozen ones included, and whether freezing
        # patterns were given: the optax state's layout depends on both
        self.names = [n for n, _ in named]
        self.freeze = freeze
        self.params: Dict[str, torch.Tensor] = {n: p for n, p in named if p.requires_grad}
        if not self.params:
            raise ValueError("Optimizer: no trainable parameter")
        self.schedule, self.b1_schedule, self.ramp = schedule, b1_schedule, ramp
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        dev = next(iter(self.params.values())).device
        count = torch.zeros((), dtype=torch.float32, device=dev)
        first_lr = schedule(count) if schedule is not None else torch.full_like(count, lr)
        self.state: Dict[str, torch.Tensor] = {"count": count, "lr": first_lr.clone()}
        moments = ("trace",) if self.name == "SGD" else ("mu", "nu")
        for n, p in self.params.items():
            for m in moments:
                self.state[f"{m}/{n}"] = torch.zeros_like(p)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], ok: Optional[torch.Tensor] = None) -> None:
        """Apply one update from ``grads`` (name -> gradient, float32). Where
        the 0-d bool tensor ``ok`` is false, nothing changes."""
        st = self.state
        count = st["count"]
        lr = self.schedule(count) if self.schedule is not None else st["lr"]
        new: Dict[str, torch.Tensor] = {"count": count + 1, "lr": lr}
        gs = {n: grads[n] for n in self.params}
        if self.clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in gs.values()))
            scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
            gs = {n: g * scale for n, g in gs.items()}
        wd = self.weight_decay
        if self.name != "SGD":
            b1 = self.b1_schedule(count) if self.b1_schedule is not None else self.b1
            corr1 = 1 - b1 ** new["count"]
            corr2 = 1 - self.b2 ** new["count"]
        step_size = lr if self.ramp is None else lr * self.ramp(count)
        for n, p in self.params.items():
            g = gs[n]
            if self.name == "SGD":
                if wd:
                    g = g + wd * p
                trace = g + self.momentum * st[f"trace/{n}"]
                new[f"trace/{n}"] = trace
                u = g + self.momentum * trace
            else:
                if wd and self.name == "ADAM":
                    g = g + wd * p
                mu = b1 * st[f"mu/{n}"] + (1 - b1) * g
                nu = self.b2 * st[f"nu/{n}"] + (1 - self.b2) * (g * g)
                new[f"mu/{n}"], new[f"nu/{n}"] = mu, nu
                u = (mu / corr1) / (torch.sqrt(nu / corr2) + self.eps)
                if wd and self.name == "ADAMW":
                    u = u + wd * p
            new[f"p/{n}"] = p - step_size * u
        for k, v in new.items():
            old = self.params[k[2:]] if k.startswith("p/") else st[k]
            old.copy_(v if ok is None else torch.where(ok, v, old))


def build_optimizer(cfg, steps_per_epoch: int,
                    named_params: Iterable[Tuple[str, torch.Tensor]], head: int = 0):
    """Build the optimizer (+ optional plateau controller) for loss head
    ``head`` over ``named_params``. Parameters whose Flax path (the name
    with ``.`` read as ``/``) matches a ``MODEL.FREEZE_LAYERS_MATCHING``
    regex are frozen here (``requires_grad_(False)``)."""
    name = cfg.TRAIN.OPTIMIZER[min(head, len(cfg.TRAIN.OPTIMIZER) - 1)].upper()
    lr = float(cfg.TRAIN.LR[min(head, len(cfg.TRAIN.LR) - 1)])
    wd = float(cfg.TRAIN.W_DECAY)
    betas = cfg.TRAIN.OPT_BETAS
    if betas and isinstance(betas[0], (list, tuple)):
        betas = betas[min(head, len(betas) - 1)]
    b1, b2 = (betas[0], betas[1]) if betas and len(betas) >= 2 else (0.9, 0.999)

    schedule, plateau, warm_steps = build_schedule(cfg, lr, steps_per_epoch, head)
    if plateau is not None or not callable(schedule):
        # lr is a mutable scalar the host scales after validation
        schedule = None
    b1_schedule = None
    if (cfg.TRAIN.LR_SCHEDULER.NAME or "").lower() == "onecycle" and name != "SGD":
        # torch OneCycleLR also cycles momentum in antiphase with the LR
        # (cycle_momentum default): beta1 0.95 -> 0.85 at peak -> 0.95
        lr_sched = schedule
        b1_schedule = lambda count: 0.95 - 0.10 * lr_sched(count) / max(lr, 1e-12)
    # per-iteration warmup for warmupreduceonplateau: the UPDATES are scaled
    # by a 0 -> 1 ramp so the host-mutable plateau lr stays a plain scalar
    ramp = linear_schedule(0.0, 1.0, warm_steps) if plateau is not None and warm_steps else None

    named = list(named_params)
    regs = [re.compile(p) for p in (cfg.MODEL.FREEZE_LAYERS_MATCHING or [])]
    for n, p in named:
        if any(r.search(n.replace(".", "/")) for r in regs):
            p.requires_grad_(False)
    opt = Optimizer(named, name, lr, schedule=schedule, b1=float(b1), b2=float(b2),
                    weight_decay=wd, clip_norm=float(cfg.TRAIN.GRADIENT_CLIP_NORM or 0.0),
                    b1_schedule=b1_schedule, ramp=ramp, freeze=bool(regs))
    return opt, plateau


def _multihead_not_ported(*args, **kwargs):
    raise NotImplementedError("per-head optimizers (list-valued TRAIN.OPTIMIZER / TRAIN.LR on a "
                              "multi-head model) are not ported to biapy_tpu_torch yet (ROADMAP "
                              "queue 1 item 9, other workflows: the multi-head ones need them)")


head_param_labels = build_multihead_optimizer = _multihead_not_ported


def set_learning_rate(optimizer: Optimizer, new_lr: float) -> Optimizer:
    """Set the learning rate the next updates use (the plateau
    controllers'). Without effect under a count-driven schedule, which
    evaluates its own."""
    optimizer.state["lr"].fill_(float(new_lr))
    return optimizer


def get_learning_rate(optimizer: Optimizer) -> Optional[float]:
    """The learning rate of the last update (before the first: the one it
    will use)."""
    return float(optimizer.state["lr"])


# --------------------------------------------------------------------------
# the optimizer state in the JAX package's checkpoint layout
# --------------------------------------------------------------------------
def optax_state_dict(opt: Optimizer) -> Dict:
    """``flax.serialization.to_state_dict`` of the optax state that
    ``biapy_tpu/engine/schedulers.py::build_optimizer`` builds for the same
    config, after the same updates: ``inject_hyperparams`` around the SGD /
    ADAM / ADAMW chain (count, the learning rate and b1 of the last update,
    the counts of count-driven schedules), inside the warm-up ramp, the clip
    and the freeze mask where the config has them. A frozen parameter's
    moments are empty dicts, as optax's masked nodes serialize."""
    st = opt.state
    count = np.asarray(int(st["count"]), np.int32)

    def moments(m):
        return unflatten(opt.names, lambda n: (
            st[f"{m}/{n}"].detach().float().cpu().numpy() if n in opt.params else {}))

    if opt.name == "SGD":
        inner = {"0": {}, "1": {"0": {"trace": moments("trace")}, "1": {}}}
    else:
        adam = {"count": count, "mu": moments("mu"), "nu": moments("nu")}
        inner = ({"0": {}, "1": {"0": adam, "1": {}}} if opt.name == "ADAM"
                 else {"0": adam, "1": {}, "2": {}})
    hp_states = {}
    if opt.schedule is not None:
        hp_states["learning_rate"] = {"count": count}
    b1 = opt.b1
    if opt.b1_schedule is not None:
        hp_states["b1"] = {"count": count}
        # the hyperparameters of the last update (of the first, before any)
        b1 = float(opt.b1_schedule(torch.clamp(st["count"] - 1, min=0)))
    sd = {"count": count,
          "hyperparams": {"learning_rate": np.asarray(float(st["lr"]), np.float32),
                          "b1": np.asarray(b1, np.float32)},
          "hyperparams_states": hp_states, "inner_state": inner}
    if opt.ramp is not None:
        sd = {"0": sd, "1": {"count": count}}
    if opt.clip_norm > 0:
        sd = {"0": {}, "1": sd}
    if opt.freeze:
        sd = {"inner_states": {"train": {"inner_state": sd}, "frozen": {"inner_state": {}}}}
    return sd


def load_optax_state_dict(opt: Optimizer, sd: Dict) -> None:
    """Restore ``opt``'s state (count, learning rate, momentum or moments)
    from the layout ``optax_state_dict`` gives, as a checkpoint of either
    package holds it. Raises ``KeyError`` / ``ValueError`` where the layout
    or a shape does not match; nothing changes then."""
    if opt.freeze:
        sd = sd["inner_states"]["train"]["inner_state"]
    if opt.clip_norm > 0:
        sd = sd["1"]
    if opt.ramp is not None:
        sd = sd["0"]
    inner = sd["inner_state"]
    if opt.name == "SGD":
        trees = {"trace": inner["1"]["0"]["trace"]}
    else:
        adam = inner["1"]["0"] if opt.name == "ADAM" else inner["0"]
        trees = {"mu": adam["mu"], "nu": adam["nu"]}
    new = {"count": float(np.asarray(sd["count"])),
           "lr": float(np.asarray(sd["hyperparams"]["learning_rate"]))}
    for m, tree in trees.items():
        flat = flatten(tree)
        for n, p in opt.params.items():
            v = flat[n.replace(".", "/")]
            t = v.float() if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, dtype=np.float32))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state {m}/{n}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            new[f"{m}/{n}"] = t
    with torch.no_grad():
        for k, v in new.items():
            if isinstance(v, float):
                opt.state[k].fill_(v)
            else:
                opt.state[k].copy_(v)
