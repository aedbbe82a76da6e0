from .engine import (Engine, EngineConfig, ShardHealth, StepMetrics,
                     stub_modality_embed)
from ..core.request import MMItem
from .request import Request, SamplingParams, Status
from .sampler import TIE_EPS, greedy_token, rid_hash
from .scheduler import ScheduledSeq, Scheduler, SchedulerConfig, StepPlan
from .runner import ModelRunner, StepHandle

__all__ = ["Engine", "EngineConfig", "MMItem", "ModelRunner", "Request",
           "SamplingParams", "ScheduledSeq", "Scheduler", "SchedulerConfig",
           "ShardHealth", "Status", "StepHandle", "StepMetrics", "StepPlan",
           "TIE_EPS", "greedy_token", "rid_hash", "stub_modality_embed"]
