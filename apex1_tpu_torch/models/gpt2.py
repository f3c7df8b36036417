"""GPT-2 (the port of ``apex1_tpu/models/gpt2.py``): pre-LN transformer
with learned positions, tanh-GELU MLP and a weight-tied LM head.

Two forwards: the CACHED one (``cache=`` given): the chunk-decode and
decode steps the paged engine drives, and `generate`'s flash prefill
and decode steps on a dense cache; and the uncached one, which
training runs (`gpt2_loss_fn`): causal flash attention with
``use_flash=True`` (the default; packed batches through
``segment_ids``/``positions``), or the materialized scores through the
fused causal softmax with ``use_flash=False``; its loss takes the final
hidden states through the fused LM-head cross-entropy
(``fuse_head=True``) or the logits (``fuse_head=False``). Training
dropout (``cfg.dropout > 0`` with ``dropout_seeds``, flash only) drops
attention probabilities in the flash kernels and runs both residual
adds through `fused_bias_dropout_add` (TPU rows 14-15); the seeds are
BERT's (`ops.stochastic.layer_seeds`, site salts 0, 1, 2 a block).

Policy-aware as in the JAX package: parameters are stored fp32,
activations and matmuls run in ``policy.compute_dtype`` (cast on use),
norms keep fp32 γ/β when ``keep_norms_fp32``, and the head returns fp32
logits over ``padded_vocab`` (bf16 inputs, fp32 output, never rounded
to bf16).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch.core.mesh import gathered
from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.layer_norm import layer_norm
from apex1_tpu_torch.ops.linear_xent import linear_cross_entropy
from apex1_tpu_torch.ops.softmax import scaled_upper_triang_masked_softmax
from apex1_tpu_torch.ops.stochastic import (fold_seed, fused_bias_dropout_add,
                                            layer_seeds)
from apex1_tpu_torch.ops.xentropy import (masked_next_token_mean,
                                          softmax_cross_entropy_loss)
from apex1_tpu_torch.parallel.specs import P, specs_from_rules


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    use_flash: bool = True
    policy: PrecisionPolicy = dataclasses.field(
        default_factory=lambda: get_policy("O0"))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128; the padded rows exist
        only in the embedding table."""
        return ((self.vocab_size + 127) // 128) * 128

    @staticmethod
    def gpt2_125m(**kw) -> "GPT2Config":
        return GPT2Config(**kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        defaults = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                        num_heads=4, hidden_size=128)
        defaults.update(kw)
        return GPT2Config(**defaults)


class _TiedHead(torch.autograd.Function):
    """fp32 logits ``h2 @ w.T`` from compute-dtype (R, H) ``h2`` and
    (V, H) ``w``. Forward: products of half values summed in fp32
    (``preferred_element_type=f32``); CUDA asks the matmul for an fp32
    output, the CPU upcasts, which gives the same numbers. Backward as
    JAX's transpose rule: the fp32 cotangent against the upcast other
    operand, summed in fp32, rounded to the compute dtype."""

    @staticmethod
    def forward(ctx, h2, w):
        ctx.save_for_backward(h2, w)
        if h2.is_cuda and h2.dtype != torch.float32:
            return torch.mm(h2, w.t(), out_dtype=torch.float32)
        return h2.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        h2, w = ctx.saved_tensors
        dh = (g @ w.float()).to(h2.dtype) if ctx.needs_input_grad[0] \
            else None
        dw = (g.t() @ h2.float()).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return dh, dw


def head_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits over ``w``'s rows for (B, S, H) ``h`` and (V, H)
    ``w`` in the compute dtype (no rounding of the result to half)."""
    B, S, H = h.shape
    return _TiedHead.apply(h.reshape(B * S, H), w).reshape(B, S, -1)


def _linear(fan_in: int, fan_out: int, device) -> nn.Linear:
    """A zero-filled fp32 ``nn.Linear`` (made on the meta device first,
    so the global RNG is never drawn from)."""
    lin = nn.Linear(fan_in, fan_out, device="meta").to_empty(device=device)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs, kernel and bias cast to the
    compute dtype on use."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(device=device, dtype=torch.float32)
        self.ln1_scale = nn.Parameter(torch.ones(h, **kw))
        self.ln1_bias = nn.Parameter(torch.zeros(h, **kw))
        self.qkv = _linear(h, 3 * h, device)
        self.proj = _linear(h, h, device)
        self.ln2_scale = nn.Parameter(torch.ones(h, **kw))
        self.ln2_bias = nn.Parameter(torch.zeros(h, **kw))
        self.fc_in = _linear(h, cfg.mlp_ratio * h, device)
        self.fc_out = _linear(cfg.mlp_ratio * h, h, device)

    def _norm(self, name: str, z: torch.Tensor) -> torch.Tensor:
        gamma = getattr(self, f"{name}_scale")
        beta = getattr(self, f"{name}_bias")
        if not self.cfg.policy.keep_norms_fp32:
            dt = self.cfg.policy.compute_dtype
            gamma, beta = gamma.to(dt), beta.to(dt)
        return layer_norm(z, gamma, beta)

    def forward(self, x, cache, cache_index, chunk_decode, *,
                segment_ids=None, valid_start=None, seed=None):
        """``seed``: this block's int32 dropout seed in training with
        ``cfg.dropout > 0`` (uncached), else None."""
        from apex1_tpu_torch.models.generate import cached_attention
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        active = seed is not None
        if active and not cfg.use_flash:
            raise ValueError("dropout > 0 needs use_flash=True (the "
                             "composite path has no fused dropout)")
        h, nh = cfg.hidden_size, cfg.num_heads
        hd = h // nh
        B, S = x.shape[0], x.shape[1]
        qkv = _dense(self.qkv, self._norm("ln1", x), dtype)
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
        new_cache = None
        if cache is not None:
            attn, new_cache = cached_attention(
                q, k, v, cache, cache_index, sm_scale=1.0 / math.sqrt(hd),
                segment_ids=segment_ids, valid_start=valid_start,
                chunk_decode=chunk_decode)
        elif cfg.use_flash:
            attn = flash_attention(q, k, v, causal=True,
                                   segment_ids=segment_ids,
                                   sm_scale=1.0 / math.sqrt(hd),
                                   dropout_p=cfg.dropout if active else 0.0,
                                   dropout_seed=(fold_seed(seed, 0)
                                                 if active else None))
        else:
            if segment_ids is not None:
                raise ValueError("packed batches need use_flash=True")
            # fp32 scores of the compute-dtype q, k (the upcast products
            # are exact in fp32, as preferred_element_type=f32 gives
            # them), the fused causal softmax, probs back to the compute
            # dtype for PV
            scores = q.float() @ k.float().transpose(-1, -2)
            probs = scaled_upper_triang_masked_softmax(
                scores, scale=1.0 / math.sqrt(hd))
            attn = probs.to(dtype) @ v
        attn = attn.transpose(1, 2).reshape(B, S, h)
        proj = _dense(self.proj, attn, dtype)
        if active:
            x = fused_bias_dropout_add(proj, x, p=cfg.dropout,
                                       seed=fold_seed(seed, 1))
        else:
            x = x + proj
        y = _dense(self.fc_in, self._norm("ln2", x), dtype)
        y = _dense(self.fc_out, F.gelu(y, approximate="tanh"), dtype)
        if active:
            return (fused_bias_dropout_add(y, x, p=cfg.dropout,
                                           seed=fold_seed(seed, 2)),
                    new_cache)
        return x + y, new_cache


class GPT2(nn.Module):
    """GPT-2. Parameters are fp32 on ``device`` (CUDA unless the caller
    names another; asking for CUDA without a card raises),
    zero-initialized apart from the LN scales: load weights with
    `apex1_tpu_torch.interop.gpt2_params_from_jax`, or make random ones
    from a seed with `init_params`. They take gradients; serving runs
    under ``torch.inference_mode``/``no_grad`` and pays for none."""

    def __init__(self, cfg: GPT2Config, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, dtype=torch.float32)
        self.wte = nn.Parameter(
            torch.zeros(cfg.padded_vocab, cfg.hidden_size, **kw))
        self.wpe = nn.Parameter(
            torch.zeros(cfg.max_seq_len, cfg.hidden_size, **kw))
        self.h = nn.ModuleList(Block(cfg, dev)
                               for _ in range(cfg.num_layers))
        self.lnf_scale = nn.Parameter(torch.ones(cfg.hidden_size, **kw))
        self.lnf_bias = nn.Parameter(torch.zeros(cfg.hidden_size, **kw))

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def forward(self, tokens, *, positions=None, segment_ids=None,
                cache=None, cache_index=None, valid_start=None,
                chunk_decode=False, return_hidden=False,
                deterministic=True, dropout_seeds=None):
        """(B, S) tokens -> fp32 logits over ``padded_vocab`` (or the
        final hidden states in the compute dtype with
        ``return_hidden``).

        Without ``cache``: the whole sequence, causal, returns the
        logits alone. ``segment_ids`` (B, S) with ``positions`` (B, S)
        run a packed batch (`runtime.pack_documents`): tokens attend
        within their segment (``use_flash=True`` only). With
        ``cache``/``cache_index`` (scalar or per-row (B,)): returns
        ``(logits, new_cache)``; there ``segment_ids``/``valid_start``
        carry the ragged left-padded prompt masking of
        ``generate(prompt_lens=...)``. ``positions`` gathers the learned
        positions per row; positions outside the table read NaN, as the
        JAX package's fill mode does. ``deterministic=False`` with
        ``cfg.dropout > 0`` (uncached) is training dropout: it needs
        ``dropout_seeds``, per-layer seeds or one int base seed
        (`ops.stochastic.layer_seeds`), where the JAX package draws from
        its ``dropout`` rng."""
        cfg = self.cfg
        seeds = [None] * cfg.num_layers
        if cfg.dropout > 0.0 and not deterministic and cache is None:
            if dropout_seeds is None:
                raise ValueError("training dropout (deterministic=False, "
                                 "cfg.dropout > 0) needs dropout_seeds")
            seeds = layer_seeds(dropout_seeds, cfg.num_layers)
        dtype = cfg.policy.compute_dtype
        B, S = tokens.shape
        dev = self.device
        if positions is None and cache is None:
            pos_emb = self.wpe[:S][None]
        else:
            if positions is None:
                start = torch.as_tensor(cache_index, dtype=torch.int64,
                                        device=dev)
                positions = (start.reshape(-1, 1)
                             + torch.arange(S, device=dev)).expand(B, S)
            positions = torch.as_tensor(positions, device=dev).long()
            inside = (positions >= 0) & (positions < cfg.max_seq_len)
            pos_emb = self.wpe[positions.clamp(0, cfg.max_seq_len - 1)]
            pos_emb = torch.where(inside[..., None], pos_emb, float("nan"))
        x = self.wte[tokens.long()].to(dtype) + pos_emb.to(dtype)
        new_cache = {}
        for i, blk in enumerate(self.h):
            x, new_cache[f"layer{i}"] = blk(
                x, None if cache is None else cache[f"layer{i}"],
                cache_index, chunk_decode, segment_ids=segment_ids,
                valid_start=valid_start, seed=seeds[i])
        x = layer_norm(x, self.lnf_scale, self.lnf_bias)
        out = (x.to(dtype) if return_hidden
               else head_logits(x.to(dtype), self.wte.to(dtype)))
        return out if cache is None else (out, new_cache)


def init_params(cfg: GPT2Config, seed: int) -> dict:
    """Random GPT-2 parameters from ``seed`` as a numpy tree in the JAX
    package's flax layout (Dense kernels (in, out)): wte normal(0.02),
    wpe normal(0.01), Dense kernels normal at the lecun scale
    1/sqrt(fan_in), biases zero, LN scales one and biases zero."""
    rng = np.random.default_rng(seed)
    H, F_ = cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            std)

    def dense(fan_in, fan_out):
        return {"kernel": normal((fan_in, fan_out), fan_in ** -0.5),
                "bias": np.zeros((fan_out,), np.float32)}

    params = {"wte": normal((cfg.padded_vocab, H), 0.02),
              "wpe": normal((cfg.max_seq_len, H), 0.01),
              "lnf_scale": np.ones((H,), np.float32),
              "lnf_bias": np.zeros((H,), np.float32)}
    for i in range(cfg.num_layers):
        params[f"h{i}"] = {
            "ln1_scale": np.ones((H,), np.float32),
            "ln1_bias": np.zeros((H,), np.float32),
            "qkv": dense(H, 3 * H), "proj": dense(H, H),
            "ln2_scale": np.ones((H,), np.float32),
            "ln2_bias": np.zeros((H,), np.float32),
            "fc_in": dense(H, F_), "fc_out": dense(F_, H)}
    return params


# Megatron's tensor-parallel split as name rules (`parallel.specs`): the
# JAX package's table for the port's names. qkv and fc_in are column
# parallel (output features split, their bias with them), proj and
# fc_out row parallel (input features split, bias whole), the token
# embedding split on the vocabulary. The port's ``nn.Linear`` weight is
# the flax kernel transposed, so a kernel's P(None, "tp") is P("tp",
# None) here.
_TP_RULES = (
    (r"wte$", P("tp", None)),
    (r"wpe$", P()),
    (r"(qkv|fc_in)\.weight$", P("tp", None)),
    (r"(qkv|fc_in)\.bias$", P("tp")),
    (r"(proj|fc_out)\.weight$", P(None, "tp")),
    (r"(proj|fc_out)\.bias$", P()),
)


def param_specs(params: dict, *, rules=_TP_RULES, default=P()) -> dict:
    """``{name: PartitionSpec}`` for a GPT-2's parameters (tensor
    parallel over ``tp``; the first matching rule wins): the reference's
    ``set_tensor_model_parallel_attributes`` as data."""
    return specs_from_rules(params, rules, default=default)


def gpt2_loss_fn(model: GPT2, *, fuse_head: bool = True):
    """``loss_fn(params, tokens, segment_ids=None, positions=None,
    dropout_rng=None) -> scalar`` for `Amp.make_train_step`: the mean
    next-token cross-entropy (fp32 in the kernel), with the model run
    on ``params`` (``{name: tensor}`` keyed like
    ``model.named_parameters()``, usually the amp step's compute-dtype
    casts) through ``torch.func.functional_call``. With ``segment_ids``
    (a packed batch) the mean is over the targets inside a document
    (`masked_next_token_mean`).

    ``fuse_head=True`` (the default, as in JAX): the final hidden states
    and the tied embedding go through `linear_cross_entropy`, the head
    product fused into the cross-entropy, so no (B, S, V) logits exist.
    ``fuse_head=False``: the materialized fp32 logits through
    `softmax_cross_entropy_loss` (the JAX package's parity gold).
    ``dropout_rng`` (per-layer int32 seeds or one int base seed, see
    `ops.stochastic.layer_seeds`; the JAX package's key) turns training
    dropout on when ``cfg.dropout > 0``; with ``cfg.dropout == 0`` it
    raises ValueError, as in JAX."""

    def loss_fn(params: dict, tokens: torch.Tensor, segment_ids=None,
                positions=None, dropout_rng=None) -> torch.Tensor:
        if dropout_rng is not None and model.cfg.dropout == 0.0:
            raise ValueError("dropout_rng passed but cfg.dropout == 0: "
                             "the key would be silently unused")
        kw = dict(segment_ids=segment_ids, positions=positions,
                  deterministic=dropout_rng is None,
                  dropout_seeds=dropout_rng)
        if fuse_head:
            h = torch.func.functional_call(
                model, params, (tokens,), dict(return_hidden=True, **kw))
            h, wte = gathered(h, params["wte"])
            losses = linear_cross_entropy(
                h[:, :-1], wte.to(h.dtype), tokens[:, 1:],
                num_classes=model.cfg.vocab_size)
        else:
            logits = torch.func.functional_call(model, params, (tokens,),
                                                kw)
            losses = softmax_cross_entropy_loss(
                logits[:, :-1].float(), tokens[:, 1:],
                num_classes=model.cfg.vocab_size)
        if segment_ids is not None:
            return masked_next_token_mean(losses, segment_ids)
        return losses.mean()

    return loss_fn
