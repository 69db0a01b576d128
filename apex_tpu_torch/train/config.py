"""``TrainConfig`` — counterpart of ``apex_tpu/train/config.py``.

The step geometry (``batch`` cut into ``grad_shards`` fixed micro-shards
whose gradients are summed in shard-index order), the learning rate and
the AMP policy. The fields of the JAX config that belong to later slices
of the port (data and tensor parallelism, checkpointing, telemetry and
tracing, the watchdog, and the overflow-storm guard) are kept with the
value that leaves them off; any other value raises
``NotImplementedError`` naming the field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

AMP_MODES = ("off", "dynamic")

# fields whose JAX features are not ported yet, with the value that leaves
# them off
_LATER = {"world": 1, "tp": 1, "checkpoint_dir": None, "save_every": 0,
          "telemetry_jsonl": None, "trace_jsonl": None,
          "watchdog_timeout_s": None, "max_consecutive_overflows": None,
          "scale_floor": None}


@dataclasses.dataclass
class TrainConfig:
    """What :class:`~apex_tpu_torch.train.Trainer` reads."""

    steps: int = 8
    batch: int = 8
    seq: int = 16
    lr: float = 1e-2
    grad_shards: int = 1
    # "dynamic": loss scaling through DynamicGradScaler; "off": unscaled
    amp: str = "dynamic"
    init_scale: float = 2.0 ** 12
    # later slices of the port (ROADMAP.md): any other value raises
    world: int = 1
    tp: int = 1
    max_consecutive_overflows: Optional[int] = None
    scale_floor: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    save_every: int = 0
    telemetry_jsonl: Optional[str] = None
    trace_jsonl: Optional[str] = None
    watchdog_timeout_s: Optional[float] = None

    def validate(self) -> "TrainConfig":
        for name, off in _LATER.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r}: not "
                    f"ported yet — data / tensor parallelism, "
                    f"checkpointing, telemetry, tracing, the watchdog and "
                    f"the overflow-storm guard come in later slices of the "
                    f"port (ROADMAP.md)")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.seq < 2:
            raise ValueError(
                f"seq must be >= 2 (next-token pairs), got {self.seq}")
        if self.grad_shards < 1:
            raise ValueError(
                f"grad_shards must be >= 1, got {self.grad_shards}")
        if self.batch % self.grad_shards:
            raise ValueError(f"grad_shards {self.grad_shards} must divide "
                             f"batch {self.batch}")
        if self.amp not in AMP_MODES:
            raise ValueError(f"amp must be one of {AMP_MODES}, "
                             f"got {self.amp!r}")
        return self
