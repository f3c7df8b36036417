"""T5 (the port of ``apex1_tpu/models/t5.py``): the encoder-decoder with
pre-norm blocks, RMSNorm, no attention scaling, a learned relative-
position bias shared by the layers of each stack, a ReLU or gated-GELU
FFN and a tied (d_model**-0.5 logit scale) or untied LM head.

Built from the port's kernels: `rms_norm` (RMS mode of the norm
kernels); `flash_attention` for every attention, the stack's (1, H, S,
S) relative-position bias riding its additive ``bias`` operand (the
table's gradient through the dbias kernel, TPU row 6), the decoder's
causality through its causal flag and the encoder's key padding
(``enc_pad_mask``) through its segment ids; and in `t5_loss_fn` the
fused LM-head cross-entropy (`linear_cross_entropy`).

As in the JAX package: parameters are fp32 masters named after the flax
tree (``shared_embedding``, ``{encoder,decoder}.rel_pos.rel_bias``,
``{encoder,decoder}.layer{i}.{self,cross,ffn}_norm``,
``...{self,cross}_attn.w{q,k,v,o}``, ``...ffn.{wi,wi_0,wi_1,wo}``,
``{encoder,decoder}.final_norm``, ``lm_head``) with the projections in
flax's (in, out) layout, so interop is a copy; activations and matmuls
run in ``policy.compute_dtype``; ``remat`` recomputes each block in the
backward under ``remat_policy``.

The stack's bias is made from its table once a forward, in fp32 and
contiguous, and every layer reads that one tensor: the layers' dbias
sum in fp32 before they reach the table. The table lookup is a product
with the (Sq·Sk, buckets) one-hot matrix of the bucket map: exact in
the forward (one term a row), and its backward is one GEMM where a
gather's backward would scatter 4.2 M values into 512 cells (49.8 ms
of a 182 ms T5 step on an H100, PERF.md §5). The bucket map is computed
on the CPU (where it equals the JAX package's bit for bit), and the
one-hot matrix kept per shape and device (32 MiB at 512 x 512 with 32
buckets).

The cached decode (``T5.decode(cache=, cache_index=)``, driven by
`models.generate.t5_generate`) runs the decoder's self-attention
through `cached_attention`: one (1, H, 1, S_max) bias row at the cache
index over every cache slot (the slots past the index masked by the
horizon, not by the bias), remat off under a cache. Cross-attention
recomputes its K/V from the memory at each step through flash, as in
the JAX package.

`param_specs` gives the JAX package's tensor-parallel rules; the
projections keep the flax (in, out) layout, so its specs carry over as
they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch.core.mesh import gathered
from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.models.gpt2 import head_logits
from apex1_tpu_torch.models.generate import cached_attention
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.layer_norm import rms_norm
from apex1_tpu_torch.ops.linear_xent import linear_cross_entropy
from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex1_tpu_torch.parallel.specs import P, specs_from_rules
from apex1_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint_module, checkpoint_policy)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    num_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    rel_pos_buckets: int = 32
    rel_pos_max_dist: int = 128
    norm_eps: float = 1e-6
    gated_act: bool = False      # True = gated-GELU (t5.1.1)
    tie_word_embeddings: bool = True
    remat: bool = False
    #: a ``jax.checkpoint_policies`` name (see
    #: `transformer.tensor_parallel.random`)
    remat_policy: str = "nothing_saveable"
    policy: PrecisionPolicy = dataclasses.field(
        default_factory=lambda: get_policy("O0"))

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)  # fail fast on a typo
        # the log-spaced buckets divide by log(max_distance / max_exact),
        # max_exact = buckets // 2 (// 4 in the bidirectional encoder):
        # max_distance <= max_exact would wrap garbage bucket indices
        if self.rel_pos_max_dist <= self.rel_pos_buckets // 2:
            raise ValueError(
                f"rel_pos_max_dist ({self.rel_pos_max_dist}) must exceed "
                f"rel_pos_buckets // 2 ({self.rel_pos_buckets // 2}): the "
                f"log-spaced tail of relative_position_bucket needs "
                f"max_distance > max_exact")

    @staticmethod
    def t5_small(**kw) -> "T5Config":
        return T5Config(**kw)

    @staticmethod
    def t5_large(**kw) -> "T5Config":
        defaults = dict(d_model=1024, num_heads=16, head_dim=64, d_ff=4096,
                        num_encoder_layers=24, num_decoder_layers=24)
        defaults.update(kw)
        return T5Config(**defaults)

    @staticmethod
    def tiny(**kw) -> "T5Config":
        defaults = dict(vocab_size=256, d_model=64, num_heads=4, head_dim=16,
                        d_ff=128, num_encoder_layers=2, num_decoder_layers=2,
                        rel_pos_buckets=8, rel_pos_max_dist=16)
        defaults.update(kw)
        return T5Config(**defaults)


def relative_position_bucket(rel, *, bidirectional: bool,
                             num_buckets: int = 32, max_distance: int = 128):
    """T5's log-spaced relative-position buckets for ``rel`` = memory
    position - query position (an int tensor), computed as the JAX
    package computes them: exact below num_buckets // 2 (of the half a
    direction owns when bidirectional), then the fp32
    log(n / max_exact) / log(max_distance / max_exact) scaled and
    truncated to int32, saturating at the last bucket. A unidirectional
    (decoder) map sends every future position to bucket 0."""
    rel = torch.as_tensor(rel).to(torch.int32)
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(torch.int32) * num_buckets
        n = rel.abs()
    else:
        n = torch.clamp(-rel, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # the large branch is taken only where n >= max_exact: no log(0)
    nf = torch.clamp(n, min=1).to(torch.float32)
    den = torch.log(torch.tensor(max_distance / max_exact,
                                 dtype=torch.float32, device=rel.device))
    val_large = max_exact + (torch.log(nf / max_exact) / den
                             * (num_buckets - max_exact)).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _param(*shape, device, fill=0.0):
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32,
                                   device=device))


class RelPosBias(nn.Module):
    """The learned per-head relative-position bias of a stack: a
    (buckets, heads) table ``rel_bias``; ``forward(q_len, k_len)`` gives
    the (1, H, q_len, k_len) bias, fp32 and contiguous.
    ``q_positions`` (q_len,) ints: the queries' global positions (the
    cached decode asks for one row at the cache index), gathered from
    the table (no gradient flows in decoding)."""

    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.rel_bias = _param(cfg.rel_pos_buckets, cfg.num_heads,
                               device=device)
        self._one_hot: dict = {}

    def buckets(self, q_len: int, k_len: int,
                q_positions=None) -> torch.Tensor:
        """The (q_len, k_len) int32 bucket map, on the CPU."""
        qpos = (torch.arange(q_len) if q_positions is None else
                torch.as_tensor(q_positions, dtype=torch.int64).cpu())
        rel = torch.arange(k_len)[None, :] - qpos[:, None]
        return relative_position_bucket(
            rel, bidirectional=self.bidirectional,
            num_buckets=self.cfg.rel_pos_buckets,
            max_distance=self.cfg.rel_pos_max_dist)

    def one_hot(self, q_len: int, k_len: int) -> torch.Tensor:
        """The fp32 (q_len·k_len, buckets) one-hot matrix of the bucket
        map on the table's device, made once a shape."""
        key = (q_len, k_len, self.rel_bias.device)
        if key not in self._one_hot:
            hot = F.one_hot(self.buckets(q_len, k_len).long().reshape(-1),
                            self.cfg.rel_pos_buckets)
            self._one_hot[key] = hot.to(key[2], torch.float32)
        return self._one_hot[key]

    def forward(self, q_len: int, k_len: int,
                q_positions=None) -> torch.Tensor:
        if q_positions is None:
            bias = self.one_hot(q_len, k_len) @ self.rel_bias.float()
        else:
            idx = self.buckets(q_len, k_len, q_positions).long().to(
                self.rel_bias.device)
            bias = self.rel_bias.float()[idx.reshape(-1)]
        return bias.reshape(q_len, k_len, -1).permute(2, 0, 1).unsqueeze(
            0).contiguous()


class T5Attention(nn.Module):
    """Self- or cross-attention, T5 form: no 1/sqrt(d) scale and no
    projection biases; always the flash kernels."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        self.wq = _param(cfg.d_model, inner, device=device)
        self.wk = _param(cfg.d_model, inner, device=device)
        self.wv = _param(cfg.d_model, inner, device=device)
        self.wo = _param(inner, cfg.d_model, device=device)

    def forward(self, x, kv=None, bias=None, kv_keep=None, causal=False,
                cache=None, cache_index=None):
        """``x`` (B, Sq, E); ``kv`` (B, Sk, E) or None for
        self-attention; ``bias`` (1, H, Sq, Sk) through flash's bias
        operand; ``kv_keep`` (B, Sk) bool key padding, as the segment
        pair (zeros, where(keep, 0, 1)); ``causal`` through the kernels'
        causal flag (their diagonal tile skip kept). With ``cache`` (a
        layer's {"k", "v"} entry) the self-attention goes through
        `cached_attention` and the return is ``(out, new_entry)``."""
        if cache is not None and kv_keep is not None:
            raise NotImplementedError(
                "cached_attention has no key-padding channel (as in the "
                "JAX package): a silent drop would attend padded keys; "
                "mask upstream or extend the cache path")
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        H, D = cfg.num_heads, cfg.head_dim
        kv = x if kv is None else kv
        B, Sq, Sk = x.shape[0], x.shape[1], kv.shape[1]
        q = (x @ self.wq.to(dtype)).reshape(B, Sq, H, D).transpose(1, 2)
        k = (kv @ self.wk.to(dtype)).reshape(B, Sk, H, D).transpose(1, 2)
        v = (kv @ self.wv.to(dtype)).reshape(B, Sk, H, D).transpose(1, 2)
        segs = None
        if kv_keep is not None:
            segs = (torch.zeros(B, Sq, dtype=torch.int32, device=x.device),
                    torch.where(kv_keep, 0, 1).to(torch.int32))
        new_cache = None
        if cache is not None:
            attn, new_cache = cached_attention(q, k, v, cache, cache_index,
                                               sm_scale=1.0, bias=bias)
        else:
            attn = flash_attention(q, k, v, causal=causal, sm_scale=1.0,
                                   bias=bias, segment_ids=segs)
        attn = attn.transpose(1, 2).reshape(B, Sq, H * D)
        out = attn @ self.wo.to(dtype)
        return out if cache is None else (out, new_cache)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.gated_act:
            self.wi_0 = _param(cfg.d_model, cfg.d_ff, device=device)
            self.wi_1 = _param(cfg.d_model, cfg.d_ff, device=device)
        else:
            self.wi = _param(cfg.d_model, cfg.d_ff, device=device)
        self.wo = _param(cfg.d_ff, cfg.d_model, device=device)

    def forward(self, h):
        dtype = self.cfg.policy.compute_dtype
        if self.cfg.gated_act:
            y = (F.gelu(h @ self.wi_0.to(dtype), approximate="tanh")
                 * (h @ self.wi_1.to(dtype)))
        else:
            y = F.relu(h @ self.wi.to(dtype))
        return y @ self.wo.to(dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        E = cfg.d_model
        self.self_norm = _param(E, device=device, fill=1.0)
        self.self_attn = T5Attention(cfg, device)
        if is_decoder:
            self.cross_norm = _param(E, device=device, fill=1.0)
            self.cross_attn = T5Attention(cfg, device)
        self.ffn_norm = _param(E, device=device, fill=1.0)
        self.ffn = T5FFN(cfg, device)

    def _norm(self, g, z):
        cfg = self.cfg
        if not cfg.policy.keep_norms_fp32:
            g = g.to(cfg.policy.compute_dtype)
        return rms_norm(z, g, eps=cfg.norm_eps).to(cfg.policy.compute_dtype)

    def forward(self, x, bias, memory=None, kv_keep=None, cache=None,
                cache_index=None):
        """``kv_keep`` (B, S_enc) bool: the encoder's key padding, on the
        encoder's self-attention and the decoder's cross-attention.
        With ``cache`` the return is ``(out, new_entry)``."""
        h = self.self_attn(self._norm(self.self_norm, x), None, bias=bias,
                           kv_keep=None if self.is_decoder else kv_keep,
                           causal=self.is_decoder, cache=cache,
                           cache_index=cache_index)
        new_cache = None
        if cache is not None:
            h, new_cache = h
        x = x + h.to(x.dtype)
        if self.is_decoder:
            h = self.cross_attn(self._norm(self.cross_norm, x),
                                memory.to(self.cfg.policy.compute_dtype),
                                kv_keep=kv_keep)
            x = x + h.to(x.dtype)
        h = self.ffn(self._norm(self.ffn_norm, x))
        out = x + h.to(x.dtype)
        return out if cache is None else (out, new_cache)


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        self.rel_pos = RelPosBias(cfg, bidirectional=not is_decoder,
                                  device=device)
        n = cfg.num_decoder_layers if is_decoder else cfg.num_encoder_layers
        self.num_layers = n
        for i in range(n):
            self.add_module(f"layer{i}", T5Block(cfg, is_decoder, device))
        self.final_norm = _param(cfg.d_model, device=device, fill=1.0)

    def forward(self, x, memory=None, enc_pad_mask=None, cache=None,
                cache_index=None):
        """With ``cache`` ({"layer{i}": entry}) the return is ``(out,
        new_cache)``."""
        cfg = self.cfg
        S = x.shape[1]
        if cache is not None and S == 1:
            # decode: one bias row at the cache index against every slot
            # (cached_attention masks the slots past the index)
            s_max = cache["layer0"]["k"].shape[2]
            bias = self.rel_pos(1, s_max, q_positions=[int(cache_index)])
        else:
            # the pure rel-pos bias, once for every layer; the decoder's
            # causality rides the kernels' causal flag
            bias = self.rel_pos(S, S)
        new_cache = {}
        for i in range(self.num_layers):
            blk = getattr(self, f"layer{i}")
            if cache is not None:
                x, new_cache[f"layer{i}"] = blk(
                    x, bias, memory, enc_pad_mask, cache=cache[f"layer{i}"],
                    cache_index=cache_index)
            elif cfg.remat:
                x = checkpoint_module(blk, cfg.remat_policy, x, bias,
                                      memory, enc_pad_mask)
            else:
                x = blk(x, bias, memory, enc_pad_mask)
        g = self.final_norm
        if not cfg.policy.keep_norms_fp32:
            g = g.to(cfg.policy.compute_dtype)
        out = rms_norm(x, g, eps=cfg.norm_eps)
        return out if cache is None else (out, new_cache)


class T5(nn.Module):
    """The encoder-decoder: decoder logits (B, S_dec, vocab) in fp32, or
    the decoder's final hidden states in the compute dtype with
    ``return_hidden`` (for the fused LM-head cross-entropy). Parameters
    are fp32 on ``device`` (CUDA unless the caller names another; asking
    for CUDA without a card raises), zero apart from the norm scales:
    load weights with `interop.t5_params_from_jax` or draw them on the
    device with `init_weights`."""

    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.shared_embedding = _param(cfg.vocab_size, cfg.d_model,
                                       device=dev)
        self.encoder = T5Stack(cfg, False, dev)
        self.decoder = T5Stack(cfg, True, dev)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param(cfg.vocab_size, cfg.d_model, device=dev)

    @property
    def device(self) -> torch.device:
        return self.shared_embedding.device

    def encode(self, enc_tokens, enc_pad_mask=None):
        dtype = self.cfg.policy.compute_dtype
        x = self.shared_embedding[enc_tokens.long()].to(dtype)
        return self.encoder(x, enc_pad_mask=enc_pad_mask)

    def decode(self, dec_tokens, memory, enc_pad_mask=None,
               return_hidden=False, cache=None, cache_index=None):
        """``cache``/``cache_index`` run the KV-cached decode of the
        self-attention (see `models.generate.t5_generate`; the
        cross-attention recomputes its K/V from the memory each step);
        the return becomes ``(logits, new_cache)``."""
        dtype = self.cfg.policy.compute_dtype
        y = self.shared_embedding[dec_tokens.long()].to(dtype)
        h = self.decoder(y, memory=memory, enc_pad_mask=enc_pad_mask,
                         cache=cache, cache_index=cache_index)
        new_cache = None
        if cache is not None:
            h, new_cache = h
        h = h.to(dtype)
        out = h if return_hidden else head_logits(h, self.head_weight())
        return out if cache is None else (out, new_cache)

    def head_weight(self) -> torch.Tensor:
        """(vocab, d_model) head weight in the compute dtype; the tied
        form carries T5's d_model**-0.5 logit scale."""
        return _head_weight(self.cfg, self.shared_embedding,
                            getattr(self, "lm_head", None))

    def forward(self, enc_tokens, dec_tokens, enc_pad_mask=None,
                return_hidden=False):
        memory = self.encode(enc_tokens, enc_pad_mask)
        return self.decode(dec_tokens, memory, enc_pad_mask,
                           return_hidden=return_hidden)


def _head_weight(cfg: T5Config, shared, lm_head) -> torch.Tensor:
    if cfg.tie_word_embeddings:
        return (shared * cfg.d_model ** -0.5).to(cfg.policy.compute_dtype)
    return lm_head.to(cfg.policy.compute_dtype)


@torch.no_grad()
def init_weights(model: T5, seed: int) -> T5:
    """Random weights at the JAX package's init scales, drawn on the
    model's device from ``torch.Generator(device).manual_seed(seed)``:
    normal(1.0) for the shared embedding, normal(0.02) for the
    relative-position tables and an untied head, normal(d_model**-0.5)
    for the projections, ones for the norm scales. (The JAX package's
    draws differ: load its params with `interop.t5_params_from_jax` to
    compare the two.)"""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    std = model.cfg.d_model ** -0.5
    for name, p in model.named_parameters():
        if name.endswith("norm"):
            p.fill_(1.0)
        elif name == "shared_embedding":
            p.normal_(0.0, 1.0, generator=gen)
        elif name.endswith("rel_bias") or name == "lm_head":
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, std, generator=gen)
    return model


_TP_RULES = (
    (r"shared_embedding$", P("tp", None)),
    (r"lm_head$", P("tp", None)),
    (r"w[qkv]$", P(None, "tp")),
    (r"wo$", P("tp", None)),
    (r"wi(_[01])?$", P(None, "tp")),
    (r"rel_bias$", P()),
    (r".*norm$", P()),
)


def param_specs(params: dict, *, rules=_TP_RULES, default=P()) -> dict:
    """``{name: PartitionSpec}`` for a T5's parameters (tensor parallel
    over ``tp``; the first matching rule wins)."""
    return specs_from_rules(params, rules, default=default)


def t5_loss_fn(model: T5, *, fuse_head: bool = True,
               label_pad_id: Optional[int] = None):
    """``loss_fn(params, enc_tokens, dec_tokens, enc_pad_mask=None) ->
    scalar`` for `Amp.make_train_step`: the teacher-forced seq2seq
    cross-entropy (position t predicts ``dec_tokens[t + 1]``), the model
    run on ``params`` (``{name: tensor}`` keyed like
    ``model.named_parameters()``) through ``torch.func.functional_call``.
    ``label_pad_id`` targets are left out of the mean (zero loss and
    gradient in the kernels, ``padding_idx``).

    ``fuse_head=True`` (the default): the decoder's hidden states and
    the head weight through `linear_cross_entropy`, no (B, S, V) logits.
    ``fuse_head=False``: the materialized fp32 logits through
    `softmax_cross_entropy_loss` (the parity gold)."""

    cfg = model.cfg

    def loss_fn(params: dict, enc_tokens: torch.Tensor,
                dec_tokens: torch.Tensor, enc_pad_mask=None) -> torch.Tensor:
        labels = dec_tokens[:, 1:]
        args = (enc_tokens, dec_tokens[:, :-1])
        if fuse_head:
            h = torch.func.functional_call(
                model, params, args,
                dict(enc_pad_mask=enc_pad_mask, return_hidden=True))
            h, emb, head = gathered(h, params["shared_embedding"],
                                    params.get("lm_head"))
            losses = linear_cross_entropy(h, _head_weight(cfg, emb, head),
                                          labels, padding_idx=label_pad_id)
        else:
            logits = torch.func.functional_call(
                model, params, args, dict(enc_pad_mask=enc_pad_mask))
            losses = softmax_cross_entropy_loss(logits.float(), labels,
                                                padding_idx=label_pad_id)
        if label_pad_id is None:
            return losses.mean()
        keep = (labels != label_pad_id).float().sum()
        return losses.sum() / torch.clamp(keep, min=1.0)

    return loss_fn
