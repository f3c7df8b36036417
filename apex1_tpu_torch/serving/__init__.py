"""Continuous-batching serving over the paged KV pool."""

from apex1_tpu_torch.serving.engine import (Engine, EngineConfig,
                                            RequestResult,
                                            derive_request_seed)
from apex1_tpu_torch.serving.kv_pool import (PageAllocator, PagedKVPool,
                                             PagedPrefix, PrefixPage,
                                             RadixIndex)
from apex1_tpu_torch.serving.metrics import RequestRecord, ServingMetrics
from apex1_tpu_torch.serving.scheduler import (Backpressure, Request,
                                               Scheduler, new_request_id)

__all__ = ["Engine", "EngineConfig", "RequestResult", "derive_request_seed",
           "PageAllocator", "PagedKVPool", "PagedPrefix", "PrefixPage",
           "RadixIndex", "RequestRecord", "ServingMetrics", "Backpressure",
           "Request", "Scheduler", "new_request_id"]
