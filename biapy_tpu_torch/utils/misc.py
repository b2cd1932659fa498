"""Runtime utilities: checkpoints, metric logging, seeding.

Counterpart of the JAX package's ``utils/misc.py`` (reference analog:
biapy/utils/misc.py: save_model:328, load_model_checkpoint:516,
get_checkpoint_path:463, MetricLogger:916, SmoothedValue:863, set_seed:272,
TensorboardLogger:760).

Checkpoints are the JAX package's ``.ckpt`` files, read and written by
``utils/flax_msgpack.py`` (no ``msgpack`` package): one msgpack tree
{cfg, biapy_tpu_version, epoch, params, batch_stats, model_build_kwargs,
opt_state?} written atomically, the config embedded as YAML text so that a
checkpoint alone rebuilds the workflow. ``params`` / ``batch_stats`` are
nested dicts under Flax's names (``models/flax_import.py``); ``opt_state``
is the layout ``flax.serialization.to_state_dict`` gives for the optax
optimizer (``engine/schedulers.py::optax_state_dict``). Either package reads
the other's files.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import random
import tempfile
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional

import numpy as np
import torch

import biapy_tpu_torch
from biapy_tpu_torch.utils.flax_msgpack import msgpack_restore, msgpack_serialize

CKPT_EXT = ".ckpt"


def set_seed(seed: int = 42) -> None:
    """Seed python, numpy and torch's CPU generator (reference: misc.py:272
    set_seed); the data pipeline and dropout take explicit generators
    seeded from the same value."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------
def save_model(
    cfg,
    checkpoint_dir: str,
    job_identifier: str,
    params,
    epoch: int,
    batch_stats=None,
    opt_state=None,
    model_build_kwargs: Optional[Dict] = None,
    metric: str = "",
) -> str:
    """Write a checkpoint; ``metric`` tags best checkpoints (reference:
    save_model, misc.py:328). ``params`` / ``batch_stats`` are nested dicts of
    arrays (``export_flax_variables``), ``opt_state`` an optax state dict."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    tag = f"{job_identifier}-checkpoint-{metric if metric else str(epoch)}"
    path = os.path.join(checkpoint_dir, tag + CKPT_EXT)
    tree = {
        "cfg": cfg.dump(),
        "biapy_tpu_version": biapy_tpu_torch.__version__,
        "epoch": int(epoch),
        "params": params,
        "batch_stats": batch_stats or {},
        # JSON-encoded: Flax packs with msgpack's strict types, which reject
        # tuples, and the kwargs are plain config values anyway
        "model_build_kwargs": json.dumps(model_build_kwargs or {}),
    }
    if opt_state is not None:
        tree["opt_state"] = opt_state
    blob = msgpack_serialize(tree)
    fd, tmp = tempfile.mkstemp(dir=checkpoint_dir, suffix=".part")
    with os.fdopen(fd, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    if str(cfg.MODEL.OUT_CHECKPOINT_FORMAT) == "safetensors":
        # the JAX package writes a weights-only .safetensors beside the .ckpt
        # when the safetensors package is there and skips it otherwise
        print("safetensors export skipped: not ported to biapy_tpu_torch yet")
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def get_checkpoint_path(cfg, job_identifier: str) -> Optional[str]:
    """Resolve which checkpoint to load: explicit path / 'best' / 'last' /
    epoch number (reference: get_checkpoint_path, misc.py:463)."""
    if cfg.PATHS.CHECKPOINT_FILE:
        return cfg.PATHS.CHECKPOINT_FILE
    d = cfg.PATHS.CHECKPOINT
    which = cfg.MODEL.LOAD_CHECKPOINT_EPOCH  # 'best_on_val' | 'last_on_train' | int
    candidates = sorted(glob.glob(os.path.join(d, f"{job_identifier}-checkpoint-*{CKPT_EXT}")))
    if not candidates:
        return None
    if which == "best_on_val":
        best = [c for c in candidates if c.endswith(f"-best{CKPT_EXT}")]
        if best:
            return best[0]
        which = "last_on_train"
    if which == "last_on_train":
        numbered = [(int(os.path.basename(c).rsplit("-", 1)[1][: -len(CKPT_EXT)]), c)
                    for c in candidates
                    if os.path.basename(c).rsplit("-", 1)[1][: -len(CKPT_EXT)].isdigit()]
        if numbered:
            return max(numbered)[1]
        return candidates[-1]
    tagged = os.path.join(d, f"{job_identifier}-checkpoint-{which}{CKPT_EXT}")
    return tagged if os.path.exists(tagged) else None


# --------------------------------------------------------------------------
# metric logging
# --------------------------------------------------------------------------
class SmoothedValue:
    """Windowed + global average tracker (reference: misc.py:863)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value, max=max(self.deque) if self.deque else 0.0,
        )


class MetricLogger:
    """Progress printer with ETA (reference: MetricLogger.log_every,
    misc.py:916-1054)."""

    def __init__(self, delimiter: str = "  ", verbose: bool = True):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.verbose = verbose

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in ("meters", "delimiter", "verbose"):
            raise AttributeError(attr)
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if self.verbose and (i % print_freq == 0 or (n and i == n - 1)):
                if n:
                    eta = iter_time.global_avg * (n - i - 1)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{n}] eta: {eta_s} {self} time: {iter_time}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        total = time.time() - start
        if self.verbose:
            print(f"{header} Total time: {str(datetime.timedelta(seconds=int(total)))}")


class JsonLogger:
    """Append-per-epoch JSON-lines training log (reference:
    base_workflow.py:1173)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def write(self, record: Dict[str, Any]):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class TensorboardLogger:
    """Minimal TensorBoard event writer (scalar-only). The reference wraps
    tensorboardX (misc.py:760); here events are written directly in the
    TF-record/event format so no dependency is needed."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.step = 0
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.biapy_tpu_torch"
        self._file = open(os.path.join(log_dir, fname), "ab")
        self._write_event(0.0, 0, file_version="brain.Event:2")

    @staticmethod
    def _masked_crc(data: bytes) -> int:
        import zlib

        crc = zlib.crc32(data) & 0xFFFFFFFF
        return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF

    def _write_event(self, wall_time: float, step: int, file_version: str = "",
                     tag: str = "", value: float = 0.0):
        if self._file is None:
            return
        import struct

        # hand-rolled protobuf encoding for tensorflow.Event
        def key(field, wire):
            return bytes([(field << 3) | wire])

        body = key(1, 1) + struct.pack("<d", wall_time or time.time())
        if file_version:
            fv = file_version.encode()
            body += key(3, 2) + bytes([len(fv)]) + fv
        else:
            body += key(2, 0) + _varint(step)
            sv = key(1, 2)
            tag_b = tag.encode()
            val_b = key(1, 2) + bytes([len(tag_b)]) + tag_b + key(2, 5) + struct.pack("<f", value)
            summary = sv + _varint(len(val_b)) + val_b
            body += key(5, 2) + _varint(len(summary)) + summary
        hdr = struct.pack("<Q", len(body))
        self._file.write(hdr + struct.pack("<I", self._masked_crc(hdr)))
        self._file.write(body + struct.pack("<I", self._masked_crc(body)))
        self._file.flush()

    def update(self, step: Optional[int] = None, **kwargs):
        if self._file is None:
            return
        if step is not None:
            self.step = step
        else:
            self.step += 1
        for k, v in kwargs.items():
            if v is not None:
                self._write_event(time.time(), self.step, tag=k, value=float(v))

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])
