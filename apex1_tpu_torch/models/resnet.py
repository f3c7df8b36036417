"""ResNet-50 (the port of ``apex1_tpu/models/resnet.py``; reference
``examples/imagenet/main_amp.py``: torchvision's resnet50 under amp
with ``convert_syncbn_model``).

The input is (B, H, W, 3) as in JAX; the model takes it as a
channels-last NCHW view (a ``permute``, no copy), so every activation
stays channels-last. Convolutions are ``F.conv2d`` (cuDNN on the
card): the JAX package computes them outside any Pallas kernel, and so
does its batch norm (`parallel.sync_batchnorm`, plain PyTorch here).
The loss goes through the fused cross-entropy kernel
(`ops.softmax_cross_entropy_loss`, TPU rows 18-19).

Padding is flax's ``SAME``: ceil(n / s) outputs, the total padding
split with the extra row and column at the end. The 7x7 stride-2 stem
on an even size pads (2, 3), a 3x3 stride-2 conv (0, 1) and the 3x3
stride-2 max pool (0, 1) with -inf, which ``F.conv2d(padding=k // 2)``
would shift by one; such pads go through ``F.pad``.

Parameters (fp32, ``named_parameters()``): ``stem_conv.weight``
(OIHW), ``stem_bn.{scale,bias}``, ``stage{i}_block{j}.{conv1,conv2,
conv3,downsample_conv}.weight``, ``...{bn1,bn2,bn3,downsample_bn}.
{scale,bias}``, ``fc.weight`` (out, in) and ``fc.bias``. The running
statistics are buffers (``...bn1.mean``, ``...bn1.var``), never
params: a training forward returns their new values, and
`resnet_loss_fn` carries them in and out of the amp step as its aux,
as the JAX bench carries ``batch_stats``.

Spatial parallelism (the reference's ``SpatialBottleneck``): a
`Bottleneck` with ``spatial_axis_name`` takes its activation split
along H over that group (a mesh axis of `parallel_state` or a process
group), its 3x3 convolution exchanges one halo row with each neighbour
(`parallel.halo.halo_exchange`) and runs VALID on H, the 1x1
convolutions stay local, and the batch statistics reduce over the batch
norm's group and the spatial group together, so they cover the whole
activation. Stride 1 only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex1_tpu_torch.parallel.halo import halo_exchange
from apex1_tpu_torch.parallel.specs import P
from apex1_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """``bn_axis_name``: the group the batch statistics are synced over
    (None: local batch norm); ``bn_group_size``: subgroups of it."""

    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # resnet-50
    num_classes: int = 1000
    width: int = 64
    bn_axis_name: Optional[str] = None
    bn_group_size: Optional[int] = None
    policy: PrecisionPolicy = dataclasses.field(
        default_factory=lambda: get_policy("O0"))

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "ResNetConfig":
        defaults = dict(stage_sizes=(1, 1), num_classes=10, width=8)
        defaults.update(kw)
        return ResNetConfig(**defaults)


def same_pads(n: int, k: int, s: int) -> tuple:
    """flax/XLA ``SAME`` padding of one spatial axis: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A bias-free square convolution with SAME padding; ``weight``
    OIHW fp32, run in the compute dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k,
                                               dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        w = self.weight.to(dtype)
        pads = same_pads(x.shape[2], w.shape[2], self.stride) + \
            same_pads(x.shape[3], w.shape[3], self.stride)
        t, b, l, r = pads
        if t == b and l == r:
            return F.conv2d(x, w, stride=self.stride, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), "SAME")``: -inf padding."""
    t, b = same_pads(x.shape[2], k, s)
    l, r = same_pads(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), k, s)


def _bn(cfg: ResNetConfig, c: int, device, spatial=None) -> SyncBatchNorm:
    axes = tuple(a for a in (cfg.bn_axis_name, spatial) if a is not None)
    return SyncBatchNorm(c, feature_axis=1,
                         axis_name=axes if len(axes) > 1 else (
                             axes[0] if axes else None),
                         group_size=cfg.bn_group_size, device=device)


def _norm(bn: SyncBatchNorm, name: str, x, train: bool, stats: dict):
    y, new = bn.stats_forward(x, use_running_average=not train)
    if train:
        stats[f"{name}.mean"], stats[f"{name}.var"] = new["mean"], new["var"]
    return y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with an identity or projection
    shortcut (the reference's fused NHWC bottleneck); with
    ``spatial_axis_name`` the H-split block (see the module's
    docstring)."""

    def __init__(self, cfg: ResNetConfig, cin: int, features: int,
                 strides: int = 1, spatial_axis_name=None, device=None):
        super().__init__()
        if spatial_axis_name is not None and strides != 1:
            raise ValueError("spatial parallelism supports stride 1 only")
        self.cfg = cfg
        self.spatial = spatial_axis_name
        f = features
        self.conv1 = Conv(cin, f, 1, device=device)
        self.bn1 = _bn(cfg, f, device, self.spatial)
        self.conv2 = Conv(f, f, 3, strides, device=device)
        self.bn2 = _bn(cfg, f, device, self.spatial)
        self.conv3 = Conv(f, 4 * f, 1, device=device)
        self.bn3 = _bn(cfg, 4 * f, device, self.spatial)
        # the JAX block projects the shortcut where its shape differs
        # from the output's: more channels, or a stride
        self.project = cin != 4 * f or strides != 1
        if self.project:
            self.downsample_conv = Conv(cin, 4 * f, 1, strides,
                                        device=device)
            self.downsample_bn = _bn(cfg, 4 * f, device, self.spatial)

    def forward(self, x, *, train: bool, stats: dict, prefix: str):
        dt = self.cfg.policy.compute_dtype
        y = F.relu(_norm(self.bn1, f"{prefix}.bn1", self.conv1(x, dt),
                         train, stats))
        if self.spatial is None:
            y = self.conv2(y, dt)
        else:
            # one halo row from each neighbour: VALID on H, SAME on W
            y = halo_exchange(y, self.spatial, halo=1, dim=2)
            y = F.conv2d(y, self.conv2.weight.to(dt), padding=(0, 1))
        y = F.relu(_norm(self.bn2, f"{prefix}.bn2", y, train, stats))
        y = _norm(self.bn3, f"{prefix}.bn3", self.conv3(y, dt), train, stats)
        residual = x
        if self.project:
            residual = _norm(self.downsample_bn, f"{prefix}.downsample_bn",
                             self.downsample_conv(x, dt), train, stats)
        return F.relu(y + residual)


def _draw_weights(module: nn.Module, seed: int) -> None:
    """Every ``weight`` normal with variance 1 / fan_in (the JAX
    package's LeCun scale), from ``seed``; ``fc.bias`` 0."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight"):
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        / math.sqrt(fan_in))
            elif name == "fc.bias":
                p.zero_()


class ResNet(nn.Module):
    """ResNet on (B, H, W, 3) images; returns fp32 logits (B, classes),
    and in training the new running statistics: ``(logits,
    {buffer name: tensor})``. Parameters are fp32 on ``device`` (CUDA
    unless named), drawn from ``seed`` (convolutions and the head
    normal with variance 1 / fan_in, the JAX package's LeCun scale; γ 1,
    β 0, running mean 0 and variance 1)."""

    def __init__(self, cfg: ResNetConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.stem_conv = Conv(3, cfg.width, 7, 2, device=dev)
        self.stem_bn = _bn(cfg, cfg.width, dev)
        cin = cfg.width
        self.blocks = []
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                f = cfg.width * 2 ** i
                name = f"stage{i}_block{j}"
                self.add_module(name, Bottleneck(
                    cfg, cin, f, 2 if i > 0 and j == 0 else 1, device=dev))
                self.blocks.append(name)
                cin = 4 * f
        self.fc = nn.Linear(cin, cfg.num_classes, device=dev,
                            dtype=torch.float32)
        _draw_weights(self, seed)

    def forward(self, x: torch.Tensor, *, train: bool = True):
        cfg, dt = self.cfg, self.cfg.policy.compute_dtype
        stats: dict = {}
        x = x.permute(0, 3, 1, 2).to(dt)   # a channels-last NCHW view
        x = self.stem_conv(x, dt)
        x = F.relu(_norm(self.stem_bn, "stem_bn", x, train, stats))
        x = max_pool_same(x)
        for name in self.blocks:
            x = getattr(self, name)(x, train=train, stats=stats,
                                    prefix=name)
        x = x.mean((2, 3))
        logits = F.linear(x, self.fc.weight.to(dt),
                          self.fc.bias.to(dt)).float()
        return (logits, stats) if train else logits


def resnet_loss_fn(model: ResNet):
    """``loss_fn(params, images, labels, batch_stats) -> (loss,
    new_batch_stats)`` for ``Amp.make_train_step(loss_fn,
    has_aux=True)``, the JAX bench's step: the mean fused cross-entropy
    of the fp32 logits, the model run in training mode on ``params``
    (the amp step's casts) and ``batch_stats`` (``{buffer name:
    tensor}``, e.g. ``dict(model.named_buffers())``) through
    ``torch.func.functional_call``."""

    def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor,
                batch_stats: dict):
        logits, new = torch.func.functional_call(
            model, {**params, **batch_stats}, (images,), {"train": True})
        loss = softmax_cross_entropy_loss(logits.float(), labels).mean()
        return loss, new

    return loss_fn


def SpatialBottleneck(cfg: ResNetConfig, features: int,
                      spatial_axis_name="cp", *, cin: Optional[int] = None,
                      device=None, seed: int = 0) -> Bottleneck:
    """The reference's H-split bottleneck: a stride-1 `Bottleneck` with
    ``spatial_axis_name`` set (one implementation), its weights drawn
    from ``seed`` as `ResNet` draws them, on ``device`` (CUDA unless
    named). ``cin`` defaults to ``4 * features``, the identity
    shortcut."""
    block = Bottleneck(cfg, 4 * features if cin is None else cin, features,
                       1, spatial_axis_name=spatial_axis_name,
                       device=resolve_device(device))
    _draw_weights(block, seed)
    return block


def param_specs(params: dict, *, default=None) -> dict:
    """Every parameter replicated (``default``, else ``P()``): a conv
    net scales by data parallelism, synced statistics and spatial
    parallelism, not by sharding its weights, as in the JAX package."""
    return {k: default or P() for k in params}
