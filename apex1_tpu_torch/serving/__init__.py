"""Continuous-batching serving (the port of ``apex1_tpu/serving``): the
engine over the paged or the dense KV pool, supervised replicas, the
multi-replica frontend and the disaggregated prefill/decode frontend.

Quick start (single engine)::

    from apex1_tpu_torch import llama_decoder
    from apex1_tpu_torch.serving import Engine, EngineConfig

    engine = Engine(*llama_decoder(model), EngineConfig(max_slots=8,
                                                        max_len=512))
    rid = engine.submit(prompt_ids, max_new_tokens=64)
    engine.run()
    print(engine.results[rid].tokens)

Multi-replica front::

    from apex1_tpu_torch.serving import FrontendConfig, ServingFrontend

    front = ServingFrontend(make_my_engine, FrontendConfig(n_replicas=2))
    rid = front.submit(prompt_ids, max_new_tokens=64, qos="guaranteed")
    front.run_until_drained()
    print(front.poll(rid).tokens)
"""

from apex1_tpu_torch.serving.engine import (Engine, EngineConfig,
                                            RequestResult,
                                            derive_request_seed)
from apex1_tpu_torch.serving.frontend import (MODES, DegradeProfile,
                                              FrontendConfig,
                                              ServingFrontend)
from apex1_tpu_torch.serving.kv_pool import (KVPool, PageAllocator,
                                             PagedKVPool, PagedPrefix,
                                             PrefixPage, RadixIndex)
from apex1_tpu_torch.serving.lora import LoraAdapterStore
from apex1_tpu_torch.serving.metrics import RequestRecord, ServingMetrics
from apex1_tpu_torch.serving.replica import (PoisonedRequest, ReplicaConfig,
                                             ReplicaKilled,
                                             ReplicaSupervisor, Submission)
from apex1_tpu_torch.serving.scheduler import (QOS_CLASSES, Backpressure,
                                               Request, Scheduler,
                                               new_request_id)
from apex1_tpu_torch.serving.spec import ngram_propose
from apex1_tpu_torch.serving.disagg import (DisaggConfig,  # noqa: E402
                                            DisaggFrontend, HandoffError,
                                            KVPage)

__all__ = ["Engine", "EngineConfig", "RequestResult", "derive_request_seed",
           "MODES", "DegradeProfile", "FrontendConfig", "ServingFrontend",
           "KVPool", "PageAllocator", "PagedKVPool", "PagedPrefix",
           "PrefixPage", "RadixIndex", "LoraAdapterStore", "RequestRecord",
           "ServingMetrics", "PoisonedRequest", "ReplicaConfig",
           "ReplicaKilled", "ReplicaSupervisor", "Submission", "QOS_CLASSES",
           "Backpressure", "Request", "Scheduler", "new_request_id",
           "ngram_propose", "DisaggConfig", "DisaggFrontend", "HandoffError",
           "KVPage"]
