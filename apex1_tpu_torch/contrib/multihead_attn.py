"""Fused multi-head attention modules (the port of
``apex1_tpu/contrib/multihead_attn.py``; reference
``apex/contrib/multihead_attn/{self,encdec}_multihead_attn.py``).

Inputs are seq-first (S, B, E), as in the reference. The attention core
is always `flash_attention`: an additive ``attn_mask`` rides its
``bias`` operand (broadcast to (·, ·, Sq, Sk) in fp32; a mask takes no
gradient, so the dbias kernel never runs for it) and attention-
probability dropout rides its kernels. ``include_norm_add`` is the
reference's "norm_add" variant: a pre-LayerNorm on the input and
``residual + dropout(out)`` through `fused_bias_dropout_add`, at the
module's ``dropout`` rate.

Parameters are fp32, named and laid out as the flax module's
(``in_proj_weight`` (E, 3E) or ``{q,k,v}_weight`` (E, E),
``out_proj_weight`` (E, E), ``q_weight``/``kv_weight`` for the
encoder-decoder module, the optional ``in_proj_bias``/``out_proj_bias``
and ``lyr_nrm_{gamma,beta}_weights``): x @ W as in the JAX package, so
`interop.mha_params_from_jax` copies them. They are drawn at
construction (xavier-uniform, as flax's initializer, from
``torch.Generator(device).manual_seed(seed)``; biases zero, norm scale
one).

Dropout seeds: the JAX modules draw one int32 seed a call from their
``dropout`` rng (``seed_from_key``); the port has no such keys and takes
that seed as ``dropout_seed`` (required when ``dropout > 0`` in
training). Both fold it with the salts ``_SALT_ATTN = 0`` (the
probabilities) and ``_SALT_RESID = 1`` (the norm_add output).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.layer_norm import layer_norm
from apex1_tpu_torch.ops.stochastic import fold_seed, fused_bias_dropout_add

# per-site salts for fold_seed: the probability dropout and the norm_add
# output dropout draw disjoint streams from one seed
_SALT_ATTN = 0
_SALT_RESID = 1


def _attend(q, k, v, *, causal, mask_additive, dropout, deterministic,
            dropout_seed, sm_scale):
    """(B, H, S, D) attention, always the flash kernels: a short
    additive mask is broadcast to (·, ·, Sq, Sk) fp32 (its batch and
    head dimensions stay as they are) and rides the bias operand."""
    bias = mask_additive
    if bias is not None:
        sq, sk = q.shape[2], k.shape[2]
        while bias.dim() < 4:
            bias = bias[None]
        bias = bias.expand(bias.shape[:2] + (sq, sk)).float()
    p = 0.0 if deterministic else float(dropout)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           bias=bias, dropout_p=p,
                           dropout_seed=dropout_seed if p > 0.0 else None)


def _xavier(shape, gen, device):
    """flax's ``xavier_uniform`` for an (in, out) kernel."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(w.uniform_(-limit, limit, generator=gen))


class _MultiheadBase(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 bias: bool, include_norm_add: bool, impl: str, device,
                 seed: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = float(dropout)
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl  # the reference's parity knob: one path either way
        self._dev = resolve_device(device)
        self._gen = torch.Generator(device=self._dev).manual_seed(seed)
        E = embed_dim
        if include_norm_add:
            kw = dict(dtype=torch.float32, device=self._dev)
            self.lyr_nrm_gamma_weights = nn.Parameter(torch.ones(E, **kw))
            self.lyr_nrm_beta_weights = nn.Parameter(torch.zeros(E, **kw))

    def _w(self, fan_in: int, fan_out: int) -> nn.Parameter:
        return _xavier((fan_in, fan_out), self._gen, self._dev)

    def _zeros(self, n: int) -> nn.Parameter:
        return nn.Parameter(torch.zeros(n, dtype=torch.float32,
                                        device=self._dev))

    def _seeds(self, is_training: bool, dropout_seed):
        """(active, the attention seed, the residual seed)."""
        active = self.dropout > 0.0 and is_training
        if not active:
            return False, None, None
        if dropout_seed is None:
            raise ValueError("dropout > 0 in training needs an int32 "
                             "dropout_seed (the JAX module's "
                             "seed_from_key of its dropout rng)")
        return (True, fold_seed(dropout_seed, _SALT_ATTN),
                fold_seed(dropout_seed, _SALT_RESID))

    def _pre_norm(self, query):
        if not self.include_norm_add:
            return query
        return layer_norm(query, self.lyr_nrm_gamma_weights,
                          self.lyr_nrm_beta_weights).to(query.dtype)

    def _epilogue(self, ctx, residual, active, resid_seed):
        dtype = residual.dtype
        out = ctx @ self.out_proj_weight.to(dtype)
        if self.bias:
            out = out + self.out_proj_bias.to(dtype)
        if self.include_norm_add:
            # residual + dropout(out), the mask recomputed from the seed
            # in the backward; p = 0 is the plain add
            out = fused_bias_dropout_add(
                out, residual, p=self.dropout if active else 0.0,
                seed=resid_seed)
        return out


class SelfMultiheadAttn(_MultiheadBase):
    """``apex.contrib.multihead_attn.SelfMultiheadAttn``: Q, K and V
    from one (S, B, E) input through one packed (E, 3E) projection, or
    three (E, E) ones with ``separate_qkv_params``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False, impl: str = "fast", *,
                 device=None, seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, device, seed)
        self.separate_qkv_params = separate_qkv_params
        E = embed_dim
        if separate_qkv_params:
            self.q_weight = self._w(E, E)
            self.k_weight = self._w(E, E)
            self.v_weight = self._w(E, E)
        else:
            self.in_proj_weight = self._w(E, 3 * E)
        if bias:
            self.in_proj_bias = self._zeros(3 * E)
        self.out_proj_weight = self._w(E, E)
        if bias:
            self.out_proj_bias = self._zeros(E)

    def forward(self, query, *, attn_mask=None, causal: bool = False,
                is_training: bool = True, dropout_seed=None):
        """query (S, B, E); ``attn_mask`` additive, broadcastable to
        (B, H, S, S); ``dropout_seed`` the int32 seed of this call's
        dropout. Returns (S, B, E)."""
        E, H = self.embed_dim, self.num_heads
        D = E // H
        S, B = query.shape[0], query.shape[1]
        dtype = query.dtype
        residual = query
        query = self._pre_norm(query)
        if self.separate_qkv_params:
            w = torch.cat([self.q_weight, self.k_weight, self.v_weight],
                          dim=-1)
        else:
            w = self.in_proj_weight
        x = query @ w.to(dtype)
        if self.bias:
            x = x + self.in_proj_bias.to(dtype)
        q, k, v = x.split(E, dim=-1)

        def heads(t):  # (S, B, E) -> (B, H, S, D)
            return t.reshape(S, B, H, D).permute(1, 2, 0, 3)

        active, attn_seed, resid_seed = self._seeds(is_training,
                                                    dropout_seed)
        ctx = _attend(heads(q), heads(k), heads(v), causal=causal,
                      mask_additive=attn_mask, dropout=self.dropout,
                      deterministic=not is_training, dropout_seed=attn_seed,
                      sm_scale=1.0 / math.sqrt(D))
        ctx = ctx.permute(2, 0, 1, 3).reshape(S, B, E)
        return self._epilogue(ctx, residual, active, resid_seed)


class EncdecMultiheadAttn(_MultiheadBase):
    """``apex.contrib.multihead_attn.EncdecMultiheadAttn``: Q from the
    decoder stream (Sq, B, E), K and V from the encoder output
    (Sk, B, E) through one packed (E, 2E) projection."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", *, device=None, seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, device, seed)
        E = embed_dim
        self.q_weight = self._w(E, E)
        self.kv_weight = self._w(E, 2 * E)
        self.out_proj_weight = self._w(E, E)
        if bias:
            self.out_proj_bias = self._zeros(E)

    def forward(self, query, key, *, attn_mask=None,
                is_training: bool = True, dropout_seed=None):
        """query (Sq, B, E); key, the encoder output giving K and V
        (Sk, B, E). Returns (Sq, B, E)."""
        E, H = self.embed_dim, self.num_heads
        D = E // H
        Sq, B, Sk = query.shape[0], query.shape[1], key.shape[0]
        dtype = query.dtype
        residual = query
        query = self._pre_norm(query)
        q = query @ self.q_weight.to(dtype)
        k, v = (key @ self.kv_weight.to(dtype)).split(E, dim=-1)

        def heads(t, s):
            return t.reshape(s, B, H, D).permute(1, 2, 0, 3)

        active, attn_seed, resid_seed = self._seeds(is_training,
                                                    dropout_seed)
        ctx = _attend(heads(q, Sq), heads(k, Sk), heads(v, Sk),
                      causal=False, mask_additive=attn_mask,
                      dropout=self.dropout, deterministic=not is_training,
                      dropout_seed=attn_seed, sm_scale=1.0 / math.sqrt(D))
        ctx = ctx.permute(2, 0, 1, 3).reshape(Sq, B, E)
        return self._epilogue(ctx, residual, active, resid_seed)
