from .engine import (Engine, EngineConfig, ShardHealth, StepMetrics,
                     stub_modality_embed)
from ..core.request import MMItem
from .request import Request, SamplingParams, Status
from .sampler import TIE_EPS, greedy_token, host_sample, rid_hash
from .scheduler import ScheduledSeq, Scheduler, SchedulerConfig, StepPlan
from .runner import ModelRunner, StepHandle
from .router import (ROUTE_CACHE_AWARE, ROUTE_LEAST_LOADED,
                     ROUTE_ROUND_ROBIN, Placement, Router, RouterConfig,
                     prefix_match_tokens)
from .dp_engine import DPEngine, EngineShard
from .spec_decode import SpecDecodeConfig, SpecDecodeEngine

__all__ = ["DPEngine", "Engine", "EngineConfig", "EngineShard", "MMItem",
           "ModelRunner", "Placement", "ROUTE_CACHE_AWARE",
           "ROUTE_LEAST_LOADED", "ROUTE_ROUND_ROBIN", "Request", "Router",
           "RouterConfig", "SamplingParams", "ScheduledSeq", "Scheduler",
           "SchedulerConfig", "ShardHealth", "SpecDecodeConfig",
           "SpecDecodeEngine", "Status", "StepHandle", "StepMetrics",
           "StepPlan", "TIE_EPS", "greedy_token", "host_sample",
           "prefix_match_tokens", "rid_hash", "stub_modality_embed"]
