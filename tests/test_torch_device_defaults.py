"""Public modules run on the card unless the caller names another
device: `SyncBatchNorm`, `FusedLayerNorm`, `FusedRMSNorm`,
`DynamicLossScaler` and `LossScaler`, built without ``device=``, put
their tensors on CUDA, or raise a RuntimeError naming CUDA where there
is none (the form of ``test_torch_moe.py::test_moe_mlp_defaults_to_
cuda``); with ``device="cpu"`` they stay on the CPU.
`convert_syncbn_model` keeps each batch norm's own device: a CPU model
stays on the CPU, also where a batch norm holds no tensor at all.
"""

import pytest
import torch

from apex1_tpu_torch.fp16_utils import DynamicLossScaler, LossScaler
from apex1_tpu_torch.ops.layer_norm import FusedLayerNorm, FusedRMSNorm
from apex1_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    st = obj.state
    return [st.scale, st.growth_count, st.overflow_count,
            st.hysteresis_left]


MAKERS = {
    "SyncBatchNorm": lambda **kw: SyncBatchNorm(8, **kw),
    "SyncBatchNorm_no_affine": lambda **kw: SyncBatchNorm(8, affine=False,
                                                          **kw),
    "FusedLayerNorm": lambda **kw: FusedLayerNorm((4, 8), **kw),
    "FusedLayerNorm_no_affine": lambda **kw: FusedLayerNorm(
        8, elementwise_affine=False, **kw),
    "FusedRMSNorm": lambda **kw: FusedRMSNorm(8, **kw),
    "DynamicLossScaler": lambda **kw: DynamicLossScaler(**kw),
    "LossScaler": lambda **kw: LossScaler(128.0, **kw),
}


@pytest.mark.parametrize("name", list(MAKERS))
def test_defaults_to_cuda(name):
    make = MAKERS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    else:
        assert {t.device.type for t in _tensors(make())} == {"cuda"}
    assert {t.device.type for t in _tensors(make(device="cpu"))} == {"cpu"}


@pytest.mark.parametrize("affine,track", [(True, True), (False, True),
                                          (False, False)])
def test_convert_syncbn_model_keeps_a_cpu_model_on_the_cpu(affine, track):
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 1),
        torch.nn.BatchNorm2d(4, affine=affine, track_running_stats=track))
    conv = convert_syncbn_model(net, axis_name=None)
    assert isinstance(conv[1], SyncBatchNorm)
    assert {t.device.type for t in _tensors(conv)} == {"cpu"}
    x = torch.randn(2, 3, 5, 5)
    assert conv(x).device.type == "cpu"
    bare = torch.nn.BatchNorm1d(4, affine=False, track_running_stats=False)
    assert not list(bare.parameters()) and not list(bare.buffers())
    assert {t.device.type for t in _tensors(
        convert_syncbn_model(bare, axis_name=None))} == {"cpu"}
