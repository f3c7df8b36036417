from apex1_tpu_torch.core.policy import POLICIES, PrecisionPolicy, get_policy

__all__ = ["POLICIES", "PrecisionPolicy", "get_policy"]
