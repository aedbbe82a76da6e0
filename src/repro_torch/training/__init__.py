"""Training on one device (``repro/training``): the data pipeline, AdamW,
checkpoints in the reference's format, and the fault-tolerant trainer."""
from .checkpoint import Checkpointer
from .data import Prefetcher, SyntheticLM
from .optimizer import AdamWConfig, OptState, init, update
from .trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "Checkpointer", "OptState", "Prefetcher",
           "SyntheticLM", "Trainer", "TrainerConfig", "init", "update"]
