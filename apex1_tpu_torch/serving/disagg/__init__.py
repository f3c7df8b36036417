"""Disaggregated prefill/decode serving: phase-aware pools with
manifest-verified KV handoff (the port of ``apex1_tpu/serving/disagg``).
`DisaggFrontend` is the drop-in two-pool frontend; `kv_transfer` is the
digest-gated page transport it rides."""

from apex1_tpu_torch.serving.disagg.frontend import (DisaggConfig,
                                                     DisaggFrontend)
from apex1_tpu_torch.serving.disagg.kv_transfer import (HandoffError,
                                                        KVPage,
                                                        extract_page,
                                                        install_page,
                                                        tree_entries,
                                                        verify_page)

__all__ = [
    "DisaggConfig",
    "DisaggFrontend",
    "HandoffError",
    "KVPage",
    "extract_page",
    "install_page",
    "tree_entries",
    "verify_page",
]
