"""Training callbacks, copied from the JAX package's ``utils/callbacks.py``
(reference analog: biapy/utils/callbacks.py, EarlyStopping:20).
"""

from __future__ import annotations


class EarlyStopping:
    """Stop when validation loss stops improving (reference:
    callbacks.py:20; TRAIN.PATIENCE)."""

    def __init__(self, patience: int = 20, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.counter = 0
        self.stop = False

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.patience >= 0 and self.counter >= self.patience:
                self.stop = True
        return self.stop
