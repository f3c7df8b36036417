"""BERT (the port of ``apex1_tpu/models/bert.py``): the post-LN encoder
(x = LN(x + Sublayer(x))) with the MLM (weight-tied decoder) and NSP
pretraining heads.

Built from the port's kernels: `layer_norm`, non-causal `flash_attention`
with padding as segment ids (``attention_mask`` 1 = real token: real
tokens form segment 1, pads segment 0, so pads never mix into real
positions), and in `bert_pretrain_loss_fn` the fused LM-head
cross-entropy (`linear_cross_entropy`) for MLM and the cross-entropy
kernels for NSP. With ``cfg.dropout > 0`` in training, attention-
probability dropout rides the flash kernels and the two residual
epilogues run `fused_dropout_add_layer_norm` (TPU rows 14-15).

As in the JAX package: parameters are fp32 masters named after the flax
tree (``bert.word_embeddings``, ``bert.layer{i}.qkv``, ...,
``mlm_transform``, ``mlm_bias``, ``nsp``); Dense layers are
``nn.Linear`` (their weights (out, in), transposed by `interop`) run in
``policy.compute_dtype``; norm γ/β keep fp32 when ``keep_norms_fp32``;
GELU is flax's default tanh approximation.

Dropout seeds: flax draws one rng per layer (``make_rng("dropout")``)
and folds site salts 0, 1, 2 off its seed. The port's forward takes
``dropout_seeds`` instead, a (num_layers,) tensor of per-layer int32
seeds or one int base seed whose layer i seed is ``fold_seed(base, i)``
(`ops.stochastic.layer_seeds`); each layer folds the same site salts.

`param_specs` gives the JAX package's tensor-parallel rules for the
port's names: each ``nn.Linear`` weight is the flax kernel transposed,
so a kernel's P(None, "tp") is P("tp", None) here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch.core.mesh import gathered
from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.models.gpt2 import _dense, _linear, head_logits
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.layer_norm import layer_norm
from apex1_tpu_torch.ops.linear_xent import linear_cross_entropy
from apex1_tpu_torch.ops.stochastic import (fold_seed,
                                            fused_dropout_add_layer_norm,
                                            layer_seeds)
from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex1_tpu_torch.parallel.specs import P, specs_from_rules


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    intermediate_size: int = 3072
    dropout: float = 0.0
    policy: PrecisionPolicy = dataclasses.field(
        default_factory=lambda: get_policy("O0"))

    @staticmethod
    def bert_base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def bert_large(**kw) -> "BertConfig":
        defaults = dict(num_layers=24, num_heads=16, hidden_size=1024,
                        intermediate_size=4096)
        defaults.update(kw)
        return BertConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        defaults = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                        num_heads=4, hidden_size=64, intermediate_size=128)
        defaults.update(kw)
        return BertConfig(**defaults)


def _norm_param_pair(h: int, device):
    kw = dict(device=device, dtype=torch.float32)
    return nn.Parameter(torch.ones(h, **kw)), nn.Parameter(torch.zeros(h, **kw))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, I = cfg.hidden_size, cfg.intermediate_size
        self.qkv = _linear(E, 3 * E, device)
        self.attn_out = _linear(E, E, device)
        self.attn_ln_scale, self.attn_ln_bias = _norm_param_pair(E, device)
        self.ffn_in = _linear(E, I, device)
        self.ffn_out = _linear(I, E, device)
        self.ffn_ln_scale, self.ffn_ln_bias = _norm_param_pair(E, device)

    def _norm_params(self, name: str):
        g = getattr(self, f"{name}_scale")
        b = getattr(self, f"{name}_bias")
        if not self.cfg.policy.keep_norms_fp32:
            dt = self.cfg.policy.compute_dtype
            g, b = g.to(dt), b.to(dt)
        return g, b

    def forward(self, x: torch.Tensor, seg_mask: torch.Tensor,
                seed=None) -> torch.Tensor:
        """``seed``: this layer's int32 dropout seed (training with
        ``cfg.dropout > 0``), or None for no dropout."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        E, H = cfg.hidden_size, cfg.num_heads
        D = E // H
        B, S = x.shape[0], x.shape[1]
        active = seed is not None

        def heads(t):
            return t.reshape(B, S, H, D).transpose(1, 2)

        q, k, v = _dense(self.qkv, x, dtype).split(E, dim=-1)
        # attention-probability dropout rides the flash kernels: no S x S
        # tensor exists
        attn = flash_attention(heads(q), heads(k), heads(v),
                               segment_ids=seg_mask,
                               sm_scale=1.0 / math.sqrt(D),
                               dropout_p=cfg.dropout if active else 0.0,
                               dropout_seed=(fold_seed(seed, 0) if active
                                             else None))
        attn = _dense(self.attn_out,
                      attn.transpose(1, 2).reshape(B, S, E), dtype)
        g, b = self._norm_params("attn_ln")
        if active:
            x = fused_dropout_add_layer_norm(
                attn, x, g, b, p=cfg.dropout,
                seed=fold_seed(seed, 1)).to(dtype)
        else:
            x = layer_norm(x + attn, g, b).to(dtype)
        h = _dense(self.ffn_in, x, dtype)
        h = _dense(self.ffn_out, F.gelu(h, approximate="tanh"), dtype)
        g, b = self._norm_params("ffn_ln")
        if active:
            return fused_dropout_add_layer_norm(
                h, x, g, b, p=cfg.dropout, seed=fold_seed(seed, 2)).to(dtype)
        return layer_norm(x + h, g, b).to(dtype)


class Bert(nn.Module):
    """The encoder: returns (sequence output (B, S, E), pooled output
    (B, E)), both in the compute dtype. Parameters are fp32 on
    ``device`` (CUDA unless the caller names another), zero apart from
    the norm scales: load weights with `interop.bert_params_from_jax` or
    draw them with `init_weights`."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        E = cfg.hidden_size
        kw = dict(device=dev, dtype=torch.float32)
        self.word_embeddings = nn.Parameter(
            torch.zeros(cfg.vocab_size, E, **kw))
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_seq_len, E, **kw))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(cfg.type_vocab_size, E, **kw))
        self.emb_ln_scale, self.emb_ln_bias = _norm_param_pair(E, dev)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", BertLayer(cfg, dev))
        self.pooler = _linear(E, E, dev)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.device

    def forward(self, tokens, token_types=None, attention_mask=None,
                dropout_seeds=None):
        """``dropout_seeds`` (see the module docstring) turns training
        dropout on when ``cfg.dropout > 0``; None runs deterministic."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        S = tokens.shape[1]
        tokens = tokens.long()
        token_types = (torch.zeros_like(tokens) if token_types is None
                       else token_types.long())
        x = (self.word_embeddings[tokens] + self.position_embeddings[:S][None]
             + self.token_type_embeddings[token_types]).to(dtype)
        x = layer_norm(x, self.emb_ln_scale, self.emb_ln_bias).to(dtype)
        seg = (torch.ones_like(tokens) if attention_mask is None
               else attention_mask).to(torch.int32)
        seeds = (layer_seeds(dropout_seeds, cfg.num_layers)
                 if cfg.dropout > 0.0 and dropout_seeds is not None
                 else [None] * cfg.num_layers)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer{i}")(x, seg, seeds[i])
        pooled = torch.tanh(_dense(self.pooler, x[:, 0], dtype))
        return x, pooled


class BertPretrain(nn.Module):
    """MLM (decoder tied to ``bert.word_embeddings``, plus ``mlm_bias``)
    and NSP heads over `Bert`."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        E = cfg.hidden_size
        self.bert = Bert(cfg, device=dev)
        self.mlm_transform = _linear(E, E, dev)
        self.mlm_ln_scale, self.mlm_ln_bias = _norm_param_pair(E, dev)
        self.mlm_bias = nn.Parameter(
            torch.zeros(cfg.vocab_size, device=dev, dtype=torch.float32))
        self.nsp = _linear(E, 2, dev)

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    def forward(self, tokens, token_types=None, attention_mask=None,
                return_mlm_hidden=False, dropout_seeds=None):
        """(fp32 MLM logits (B, S, V), fp32 NSP logits (B, 2)); with
        ``return_mlm_hidden`` the MLM head's hidden states in the compute
        dtype in place of the logits (for the fused LM-head
        cross-entropy: no (B, S, V) logits)."""
        dtype = self.cfg.policy.compute_dtype
        seq, pooled = self.bert(tokens, token_types, attention_mask,
                                dropout_seeds)
        h = F.gelu(_dense(self.mlm_transform, seq, dtype), approximate="tanh")
        h = layer_norm(h, self.mlm_ln_scale, self.mlm_ln_bias)
        nsp_logits = _dense(self.nsp, pooled, dtype).float()
        if return_mlm_hidden:
            return h.to(dtype), nsp_logits
        logits = head_logits(h.to(dtype), self.bert.word_embeddings.to(dtype))
        return logits + self.mlm_bias, nsp_logits


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights at the JAX package's init scales, drawn on the
    model's device from ``torch.Generator(device).manual_seed(seed)``:
    normal(0.02) for the embeddings, Dense kernels normal at the lecun
    scale 1/sqrt(fan_in), biases zero, norm scales one. (The JAX
    package's draws differ: load its params with
    `interop.bert_params_from_jax` to compare the two.)"""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_scale"):
                p.fill_(1.0)
            elif name.endswith("embeddings"):
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith(".weight"):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            else:
                p.zero_()
    return model


_TP_RULES = (
    (r"word_embeddings$", P("tp", None)),
    (r"(position|token_type)_embeddings$", P()),
    (r"(qkv|ffn_in)\.weight$", P("tp", None)),
    (r"(qkv|ffn_in)\.bias$", P("tp")),
    (r"(attn_out|ffn_out)\.weight$", P(None, "tp")),
    (r"(attn_out|ffn_out)\.bias$", P()),
    (r"mlm_bias$", P("tp")),
)


def param_specs(params: dict, *, rules=_TP_RULES, default=P()) -> dict:
    """``{name: PartitionSpec}`` for a `Bert` or `BertPretrain`'s
    parameters (tensor parallel over ``tp``; the first matching rule
    wins)."""
    return specs_from_rules(params, rules, default=default)


def bert_pretrain_loss_fn(model: BertPretrain, *, ignore_index: int = -1,
                          fuse_head: bool = True):
    """``loss_fn(params, batch) -> scalar`` for `Amp.make_train_step`:
    the MLM cross-entropy over the masked tokens (labels ``ignore_index``
    elsewhere; fp32 in the kernels) plus the mean NSP cross-entropy, the
    model run on ``params`` (``{name: tensor}`` keyed like
    ``model.named_parameters()``) through ``torch.func.functional_call``.

    ``batch``: a dict with ``tokens``, ``mlm_labels``, ``nsp_labels``,
    optional ``token_types`` and ``attention_mask``, and optional
    ``dropout_rng``: per-layer seeds or one int base seed (see the
    module docstring), whose presence turns the model's dropout on
    (``cfg.dropout > 0``), as the key does in the JAX package.

    ``fuse_head=True`` (the default): the tied MLM head through
    `linear_cross_entropy`, the decoder bias folded in as a ones column
    on the hidden states and the bias as one more weight column (width
    H + 1), so the (B, S, V) logits never exist. Both then take zero
    columns up to a multiple of 8 (776 for BERT-base, 1032 for
    BERT-large), so that a row is a whole number of 16-byte copies for
    the kernels; the zeros add nothing to any product, and the
    concatenation's backward drops their gradients. (The JAX package
    keeps width H + 1.) ``False``: the materialized fp32 logits through
    `softmax_cross_entropy_loss` (the parity gold)."""

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        labels = batch["mlm_labels"]
        n_masked = torch.clamp((labels != ignore_index).sum(), min=1)
        kw = dict(token_types=batch.get("token_types"),
                  attention_mask=batch.get("attention_mask"),
                  dropout_seeds=batch.get("dropout_rng"))
        if fuse_head:
            h, nsp_logits = torch.func.functional_call(
                model, params, (batch["tokens"],),
                dict(return_mlm_hidden=True, **kw))
            h, nsp_logits, emb, mlm_bias = gathered(
                h, nsp_logits, params["bert.word_embeddings"],
                params["mlm_bias"])
            emb = emb.to(h.dtype)
            pad = -(h.shape[-1] + 1) % 8
            w = torch.cat([emb, mlm_bias.to(h.dtype)[:, None],
                           emb.new_zeros(emb.shape[0], pad)], dim=1)
            ones = h.new_zeros(h.shape[:-1] + (1 + pad,))
            ones[..., 0] = 1.0
            mlm_losses = linear_cross_entropy(torch.cat([h, ones], dim=-1),
                                              w, labels,
                                              padding_idx=ignore_index)
        else:
            mlm_logits, nsp_logits = torch.func.functional_call(
                model, params, (batch["tokens"],), kw)
            mlm_losses = softmax_cross_entropy_loss(
                mlm_logits.float(), torch.clamp(labels, min=0)) * (
                    labels != ignore_index)
        mlm = mlm_losses.sum() / n_masked
        nsp = softmax_cross_entropy_loss(nsp_logits,
                                         batch["nsp_labels"]).mean()
        return mlm + nsp

    return loss_fn
