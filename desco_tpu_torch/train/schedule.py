"""Host-side ReduceLROnPlateau controller, copied from
``desco_tpu/train/schedule.py`` (host-only code; the port imports nothing
of desco_tpu).

Mirrors torch.optim.lr_scheduler.ReduceLROnPlateau with DeSCo's settings
(mode='min', factor=0.5, patience=20, min_lr=1e-5). The learning rate is
a plain float handed to every optimizer step, so its fields save into a
checkpoint's JSON and restore on resume.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.5
    patience: int = 20
    min_lr: float = 1e-5
    threshold: float = 1e-4  # relative, torch default
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        """Update with this epoch's monitored metric; returns current lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
