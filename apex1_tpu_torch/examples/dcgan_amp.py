"""DCGAN mixed-precision training (the port of ``examples/dcgan_amp.py``;
reference ``examples/dcgan/main_amp.py``: two models and two optimizers
sharing the amp machinery).

One `Amp` a network, each with ``fused_adam(2e-4, b1=0.5)``, its fp32
masters and its loss-scale state; NHWC images (32 x 32 x 3) and noise
(1 x 1 x ``--zdim``), synthetic data. The batch norm statistics ride as
the steps' aux state: D's step runs D on the real batch and then on the
fake one, the statistics chained through the two; G's step runs D in
eval mode on D's running statistics.

The modules compute what the JAX script's flax modules compute, in
their layouts and conventions (`interop.dcgan_params_from_jax` carries
flax's variables over as they are):

- kernels HWIO (flax's), used as convolutions of NCHW activations;
- ``nn.ConvTranspose`` (``transpose_kernel=False``) is
  ``lax.conv_transpose``: the input dilated by the stride, padded
  (``"SAME"`` or ``"VALID"``, lax's rule), then cross-correlated with
  the kernel unflipped; `conv_transpose` runs it as
  ``F.conv_transpose2d`` of the kernel flipped in space;
- ``nn.BatchNorm``: the biased variance E[x²] - E[x]² (clipped at 0),
  statistics in fp32, the output fp32, running statistics updated as
  0.99 · running + 0.01 · batch (not `parallel.sync_batchnorm`'s Apex
  convention: momentum 0.1 and the unbiased variance);
- each convolution in the policy's compute dtype.

``python -m apex1_tpu_torch.examples.dcgan_amp [--opt-level O2]
[--steps N] [--device cpu]``. The weights come from `init_weights`
(seed 0; the tests pass the JAX package's); the batches from
``np.random.default_rng(0)``. `main` returns each step's D and G loss,
the step walls, both loss scales and the final states.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import StepRecord
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import fused_adam

#: flax ``nn.BatchNorm``'s defaults
BN_MOMENTUM, BN_EPS = 0.99, 1e-5


def transpose_padding(k: int, s: int, padding: str) -> tuple:
    """(before, after) padding of the dilated input, lax's
    ``conv_transpose`` rule for one spatial dimension."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return pad_a, pad_len - pad_a


def conv_transpose(x: torch.Tensor, kernel: torch.Tensor, stride: int,
                   padding: str) -> torch.Tensor:
    """flax ``nn.ConvTranspose`` of NCHW ``x`` with an HWIO ``kernel``
    (``transpose_kernel=False``): `transpose_padding`'s lax rule, the
    kernel unflipped. ``F.conv_transpose2d`` flips its (I, O, kH, kW)
    weight, so it gets the kernel flipped back."""
    k = kernel.shape[0]
    a, b = transpose_padding(k, stride, padding)
    if not 0 <= b - a < stride or a > k - 1:
        raise ValueError(f"padding ({a}, {b}) has no conv_transpose2d form")
    w = kernel.permute(2, 3, 0, 1).flip(2, 3)
    return F.conv_transpose2d(x, w, stride=stride, padding=k - 1 - a,
                              output_padding=b - a)


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
         padding: str) -> torch.Tensor:
    """flax ``nn.Conv`` of NCHW ``x`` with an HWIO ``kernel`` (even
    kernels: ``"SAME"`` pads (k - s) / 2 a side when that is whole)."""
    k = kernel.shape[0]
    pad = 0 if padding == "VALID" else (k - stride) // 2
    if padding == "SAME" and (k - stride) % 2:
        raise ValueError("SAME padding here needs k - stride even")
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride,
                    padding=pad)


def batch_norm(x, scale, bias, mean, var, train: bool):
    """flax ``nn.BatchNorm(dtype=float32)`` over NCHW ``x``: returns (y
    fp32, new running mean, new running var)."""
    if train:
        xf = x.float()
        mu = xf.mean((0, 2, 3))
        var_b = torch.clamp((xf * xf).mean((0, 2, 3)) - mu * mu, min=0.0)
        new_mean = BN_MOMENTUM * mean + (1.0 - BN_MOMENTUM) * mu
        new_var = BN_MOMENTUM * var + (1.0 - BN_MOMENTUM) * var_b
    else:
        mu, var_b, new_mean, new_var = mean, var, mean, var

    def c(t):
        return t.reshape(1, -1, 1, 1)

    mul = torch.rsqrt(c(var_b) + BN_EPS) * c(scale)
    y = (x - c(mu)) * mul + c(bias)
    return y.float(), new_mean, new_var


class _Kernel(nn.Module):
    def __init__(self, k: int, cin: int, cout: int, dev):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, k, cin, cout, device=dev))


class _Norm(nn.Module):
    def __init__(self, c: int, dev):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=dev))
        self.bias = nn.Parameter(torch.zeros(c, device=dev))


def _stats(model: nn.Module, n: int, dev) -> dict:
    out = {}
    for i in range(n):
        c = getattr(model, f"BatchNorm_{i}").scale.shape[0]
        out[f"BatchNorm_{i}.mean"] = torch.zeros(c, device=dev)
        out[f"BatchNorm_{i}.var"] = torch.ones(c, device=dev)
    return out


class Generator(nn.Module):
    """z (B, 1, 1, zdim) -> image (B, 32, 32, channels): ConvTranspose,
    BatchNorm, ReLU three times (4 x 4 VALID stride 4, then SAME stride
    2), a last ConvTranspose and tanh. Parameters ``ConvTranspose_i.
    kernel`` and ``BatchNorm_i.{scale,bias}``; the running statistics
    (`init_stats`) travel beside them."""

    def __init__(self, zdim: int = 100, features: int = 64,
                 channels: int = 3, dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = resolve_device(device)
        f = features
        chans = [zdim, f * 4, f * 2, f, channels]
        for i in range(4):
            self.add_module(f"ConvTranspose_{i}",
                            _Kernel(4, chans[i], chans[i + 1], dev))
        for i in range(3):
            self.add_module(f"BatchNorm_{i}", _Norm(chans[i + 1], dev))
        self.dtype = dtype

    def init_stats(self) -> dict:
        return _stats(self, 3, self.BatchNorm_0.scale.device)

    def forward(self, z, stats: dict, train: bool = True):
        """Returns (images (B, 32, 32, channels) in the compute dtype,
        the new running statistics)."""
        dt, new = self.dtype, {}
        x = z.to(dt).permute(0, 3, 1, 2)
        for i, stride in enumerate((4, 2, 2)):
            x = conv_transpose(
                x.to(dt), getattr(self, f"ConvTranspose_{i}").kernel.to(dt),
                stride, "SAME" if i else "VALID")
            bn = getattr(self, f"BatchNorm_{i}")
            x, m, v = batch_norm(x, bn.scale, bn.bias,
                                 stats[f"BatchNorm_{i}.mean"],
                                 stats[f"BatchNorm_{i}.var"], train)
            new[f"BatchNorm_{i}.mean"], new[f"BatchNorm_{i}.var"] = m, v
            x = F.relu(x)
        x = conv_transpose(x.to(dt), self.ConvTranspose_3.kernel.to(dt), 2,
                           "SAME")
        return torch.tanh(x).permute(0, 2, 3, 1), new


class Discriminator(nn.Module):
    """image (B, 32, 32, channels) -> logit (B,): strided Conv and
    LeakyReLU(0.2), BatchNorm after the second and third, a last 4 x 4
    VALID Conv. Parameters ``Conv_i.kernel`` and ``BatchNorm_i.{scale,
    bias}``."""

    def __init__(self, features: int = 64, channels: int = 3,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = resolve_device(device)
        f = features
        chans = [channels, f, f * 2, f * 4, 1]
        for i in range(4):
            self.add_module(f"Conv_{i}", _Kernel(4, chans[i], chans[i + 1],
                                                 dev))
        for i in range(2):
            self.add_module(f"BatchNorm_{i}", _Norm(chans[i + 2], dev))
        self.dtype = dtype

    def init_stats(self) -> dict:
        return _stats(self, 2, self.BatchNorm_0.scale.device)

    def forward(self, x, stats: dict, train: bool = True):
        """Returns (logits (B,), the new running statistics)."""
        dt, new = self.dtype, dict(stats)
        x = x.to(dt).permute(0, 3, 1, 2)
        for i in range(3):
            x = conv(x.to(dt), getattr(self, f"Conv_{i}").kernel.to(dt), 2,
                     "SAME")
            if i:
                bn = getattr(self, f"BatchNorm_{i - 1}")
                x, m, v = batch_norm(x, bn.scale, bn.bias,
                                     stats[f"BatchNorm_{i - 1}.mean"],
                                     stats[f"BatchNorm_{i - 1}.var"], train)
                new[f"BatchNorm_{i - 1}.mean"] = m
                new[f"BatchNorm_{i - 1}.var"] = v
            x = F.leaky_relu(x, 0.2)
        x = conv(x.to(dt), self.Conv_3.kernel.to(dt), 1, "VALID")
        return x.reshape(x.shape[0]), new


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random kernels at flax's default scale (lecun normal: std fan_in
    ** -0.5, fan_in = kh · kw · in), drawn on the model's device from
    ``torch.Generator(device).manual_seed(seed)``; batch norm scales 1
    and biases 0. (The JAX package's draws differ: load its variables
    with `interop.dcgan_params_from_jax` to compare the two.)"""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            kh, kw, cin = p.shape[:3]
            p.normal_(0.0, (kh * kw * cin) ** -0.5, generator=gen)
    return model


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy with logits, fp32 (the reference's BCELoss
    on an fp32 sigmoid)."""
    x = logits.float()
    return torch.mean(torch.clamp(x, min=0) - x * target
                      + torch.log1p(torch.exp(-x.abs())))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--zdim", type=int, default=100)
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def main(argv=None, *, gen: Generator = None, disc: Discriminator = None,
         stats: tuple = None) -> dict:
    """``gen``, ``disc`` and their initial running statistics ``stats``
    ((G's, D's)) in place of the ones from `init_weights` (seeds 0 and
    1) and `init_stats`."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dt = get_policy(args.opt_level).compute_dtype
    if gen is None:
        gen = init_weights(Generator(args.zdim, dtype=dt, device=dev), 0)
        disc = init_weights(Discriminator(dtype=dt, device=dev), 1)
    g_bn, d_bn = stats or (gen.init_stats(), disc.init_stats())
    rng = np.random.default_rng(0)
    # one Amp a (model, optimizer) pair, each with its own loss scale
    amp_g = Amp(fused_adam(2e-4, b1=0.5, b2=0.999), opt_level=args.opt_level)
    amp_d = Amp(fused_adam(2e-4, b1=0.5, b2=0.999), opt_level=args.opt_level)
    gstate = amp_g.init(dict(gen.named_parameters()))
    dstate = amp_d.init(dict(disc.named_parameters()))

    def d_loss_fn(d_params, real, fake, d_bn):
        """errD = BCE(D(real), 1) + BCE(D(G(z)), 0), the statistics
        chained through the two applies."""
        logits_r, upd = torch.func.functional_call(disc, d_params,
                                                   (real, d_bn))
        logits_f, upd = torch.func.functional_call(disc, d_params,
                                                   (fake, upd))
        return bce_logits(logits_r, 1.0) + bce_logits(logits_f, 0.0), upd

    def g_loss_fn(g_params, z, g_bn, d_params, d_bn):
        """errG = BCE(D(G(z)), 1), D in eval mode."""
        fake, upd = torch.func.functional_call(gen, g_params, (z, g_bn))
        logits, _ = torch.func.functional_call(disc, d_params, (fake, d_bn),
                                               {"train": False})
        return bce_logits(logits, 1.0), upd

    d_step = amp_d.make_train_step(d_loss_fn, has_aux=True)
    g_step = amp_g.make_train_step(g_loss_fn, has_aux=True)

    @torch.no_grad()
    def make_fake(g_params, g_bn, z):
        return torch.func.functional_call(gen, g_params, (z, g_bn),
                                          {"train": False})[0]

    rec, losses_g = StepRecord(dev), []
    t0 = time.time()
    for i in range(args.steps):
        real = torch.from_numpy(rng.normal(size=(args.batch, 32, 32, 3))
                                .astype(np.float32)).to(dev)
        z = torch.from_numpy(rng.normal(size=(args.batch, 1, 1, args.zdim))
                             .astype(np.float32)).to(dev)
        fake = make_fake(gstate.params, g_bn, z)
        dstate, d_metrics = d_step(dstate, real, fake, d_bn)
        d_bn = d_metrics["aux"]
        gstate, g_metrics = g_step(gstate, z, g_bn, dstate.params, d_bn)
        g_bn = g_metrics["aux"]
        losses_g.append(g_metrics["loss"].detach())
        rec(d_metrics)                  # the iteration's wall, D's loss
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: errD={d_metrics['loss'].item():.4f} "
                  f"errG={g_metrics['loss'].item():.4f} "
                  f"scaleD={dstate.loss_scale.scale.item():.0f}")
    print(f"done in {time.time() - t0:.1f}s")
    d = rec.result()
    return {"losses_d": d["losses"],
            "losses_g": [float(x) for x in losses_g],
            "step_ms": d["step_ms"],
            "scale_d": dstate.loss_scale.scale.item(),
            "scale_g": gstate.loss_scale.scale.item(),
            "gstate": gstate, "dstate": dstate, "g_bn": g_bn, "d_bn": d_bn}


if __name__ == "__main__":
    main()
