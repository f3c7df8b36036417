"""Llama-3 (the port of ``apex1_tpu/models/llama.py``): pre-norm decoder
with RMSNorm, rotary positions, grouped-query attention and a SwiGLU
MLP, untied input embedding and output head.

Built from the port's kernels: `rms_norm` (RMS mode of the norm
kernels), `apply_rotary_pos_emb` (``csrc/rope.cu``), causal GQA
`flash_attention`, `fused_glu` (``csrc/glu.cu``) with ``fused_mlp``,
and the fused LM-head cross-entropy (`linear_cross_entropy`, its wide
path at H = 4096) in `llama_loss_fn`.

As in the JAX package: parameters are fp32 masters named and laid out
as the flax tree (``tok_embeddings``, ``layer{i}.{attn_norm, wq, wk,
wv, wo, mlp_norm, w_gate, w_up, w_down}``, ``norm``, ``output``; the
projections (in, out)), so interop is a copy; activations and matmuls
run in ``policy.compute_dtype``; ``remat`` recomputes each block in the
backward under ``remat_policy``. The forward is uncached (training:
flash attention, packed batches through ``segment_ids``/``positions``)
or cached (``cache``/``cache_index``: the paged engine and `generate`).

With ``moe_every > 0`` every ``moe_every``-th block's MLP is a
top-k-routed `transformer.moe.MoEMLP` (``layer{i}.moe.{router, w1,
w2}``), whose Switch balance term `llama_loss_fn` adds to the loss as
the JAX model sows it. ``seq_shard_axis`` (a mesh axis name of
`parallel_state`'s mesh, or a process group) shards the sequence over a
context-parallel group: attention becomes `ring_attention`
(``cp_impl="ring"``) or `ulysses_attention` (``"ulysses"``), and the
rotary tables take the shard's global positions.

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
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.fused_dense import fused_glu
from apex1_tpu_torch.ops.layer_norm import rms_norm
from apex1_tpu_torch.ops.linear_xent import linear_cross_entropy
from apex1_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_tables
from apex1_tpu_torch.ops.xentropy import (masked_next_token_mean,
                                          softmax_cross_entropy_loss)
from apex1_tpu_torch.parallel.specs import P, specs_from_rules
from apex1_tpu_torch.transformer.moe import MoEConfig, MoEMLP
from apex1_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint_module, checkpoint_policy)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    max_seq_len: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    hidden_size: int = 4096
    ffn_size: int = 14336
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    remat: bool = False
    #: a ``jax.checkpoint_policies`` name (see
    #: `transformer.tensor_parallel.random`)
    remat_policy: str = "nothing_saveable"
    moe_every: int = 0
    num_experts: int = 8
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 1e-2
    cp_impl: str = "ring"
    #: the dense MLP's glu through `fused_glu` (one kernel pass over x)
    fused_mlp: bool = False
    policy: PrecisionPolicy = dataclasses.field(
        default_factory=lambda: get_policy("O0"))

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        defaults = dict(vocab_size=256, max_seq_len=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, hidden_size=64,
                        ffn_size=128)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    def __post_init__(self):
        if self.cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"cp_impl must be 'ring' or 'ulysses', got "
                             f"{self.cp_impl!r}")
        checkpoint_policy(self.remat_policy)  # fail fast on a typo

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def is_moe_layer(cfg: LlamaConfig, i: int) -> bool:
    """The MoE-layer placement rule: with ``moe_every > 0`` every
    ``moe_every``-th block, counting from the ``moe_every - 1``-th."""
    return cfg.moe_every > 0 and i % cfg.moe_every == cfg.moe_every - 1


def moe_config(cfg: LlamaConfig) -> MoEConfig:
    """The `MoEConfig` of ``cfg``'s expert-routed blocks."""
    return MoEConfig(num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor,
                     aux_loss_weight=cfg.moe_aux_loss_weight,
                     hidden_size=cfg.hidden_size, ffn_size=cfg.ffn_size)


def _seq_group(seq_shard_axis):
    """The process group behind ``seq_shard_axis`` (None: unsharded)."""
    if seq_shard_axis is None:
        return None
    from apex1_tpu_torch.transformer.parallel_state import resolve_group
    group = resolve_group(seq_shard_axis)
    if group is None:
        raise ValueError(f"seq_shard_axis={seq_shard_axis!r} names no "
                         f"group: initialize parallel_state first")
    return group


def _param(*shape, device, fill=0.0):
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32,
                                   device=device))


class LlamaBlock(nn.Module):
    """One block; ``use_moe`` swaps the MLP for `MoEMLP` (``moe``),
    ``seq_group`` (a process group) runs context-parallel attention."""

    def __init__(self, cfg: LlamaConfig, device=None, *,
                 use_moe: bool = False, seq_group=None):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        self.seq_group = seq_group
        E, F_ = cfg.hidden_size, cfg.ffn_size
        qd, kd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        kw = dict(device=device)
        self.attn_norm = _param(E, fill=1.0, **kw)
        self.wq = _param(E, qd, **kw)
        self.wk = _param(E, kd, **kw)
        self.wv = _param(E, kd, **kw)
        self.wo = _param(qd, E, **kw)
        self.mlp_norm = _param(E, fill=1.0, **kw)
        if use_moe:
            self.moe = MoEMLP(moe_config(cfg), dtype=cfg.policy.compute_dtype,
                              act=F.silu, device=device)
        else:
            self.w_gate = _param(E, F_, **kw)
            self.w_up = _param(E, F_, **kw)
            self.w_down = _param(F_, E, **kw)

    def _norm(self, g: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if not self.cfg.policy.keep_norms_fp32:
            g = g.to(self.cfg.policy.compute_dtype)
        return rms_norm(z, g, eps=self.cfg.norm_eps)

    def forward(self, x, cos, sin, segment_ids=None, cache=None,
                cache_index=None, valid_start=None, chunk_decode=False):
        """(B, S, E) -> ((B, S, E), the new cache entry or None, the MoE
        balance term or None)."""
        from apex1_tpu_torch.models.generate import cached_attention
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        B, S = x.shape[0], x.shape[1]
        h = self._norm(self.attn_norm, x).to(dtype)
        q = (h @ self.wq.to(dtype)).reshape(B, S, H, D)
        k = (h @ self.wk.to(dtype)).reshape(B, S, Hkv, D)
        v = (h @ self.wv.to(dtype)).reshape(B, S, Hkv, D)
        q = apply_rotary_pos_emb(q, cos, sin)
        k = apply_rotary_pos_emb(k, cos, sin)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        new_cache = None
        if cache is not None:
            attn, new_cache = cached_attention(
                q, k, v, cache, cache_index, segment_ids=segment_ids,
                valid_start=valid_start, chunk_decode=chunk_decode)
        elif self.seq_group is not None and cfg.cp_impl == "ulysses":
            from apex1_tpu_torch.parallel.ulysses import ulysses_attention
            attn = ulysses_attention(q, k, v, self.seq_group, causal=True,
                                     segment_ids=segment_ids)
        elif self.seq_group is not None:
            from apex1_tpu_torch.parallel.ring_attention import (
                ring_attention)
            attn = ring_attention(q, k, v, self.seq_group, causal=True,
                                  segment_ids=segment_ids)
        else:
            attn = flash_attention(q, k, v, causal=True,
                                   segment_ids=segment_ids)
        attn = attn.transpose(1, 2).reshape(B, S, H * D)
        x = x + (attn @ self.wo.to(dtype)).to(x.dtype)
        h = self._norm(self.mlp_norm, x).to(dtype)
        if self.use_moe:
            y, aux = self.moe(h, token_mask=(None if segment_ids is None
                                             else segment_ids >= 0))
            return x + y.to(x.dtype), new_cache, aux
        wg, wu = self.w_gate.to(dtype), self.w_up.to(dtype)
        if cfg.fused_mlp:
            y = fused_glu(h, wg, wu, activation="silu")
        else:
            y = F.silu(h @ wg) * (h @ wu)
        y = y @ self.w_down.to(dtype)
        return x + y.to(x.dtype), new_cache, None


class Llama(nn.Module):
    """Llama. Parameters are fp32 on ``device`` (CUDA unless the caller
    names another; asking for CUDA without a card raises), zero apart
    from the norm scales: load weights with
    `apex1_tpu_torch.interop.llama_params_from_jax`, or draw them on the
    device with `init_weights`."""

    def __init__(self, cfg: LlamaConfig, *,
                 seq_shard_axis: Optional[str] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.seq_group = _seq_group(seq_shard_axis)
        E, V = cfg.hidden_size, cfg.vocab_size
        self.tok_embeddings = _param(V, E, device=dev)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", LlamaBlock(
                cfg, dev, use_moe=is_moe_layer(cfg, i),
                seq_group=self.seq_group))
        self.norm = _param(E, fill=1.0, device=dev)
        self.output = _param(V, E, device=dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device

    def blocks(self):
        return [getattr(self, f"layer{i}")
                for i in range(self.cfg.num_layers)]

    def forward(self, tokens, *, positions=None, segment_ids=None,
                return_hidden=False, cache=None, cache_index=None,
                valid_start=None, chunk_decode=False, return_aux=False):
        """(B, S) tokens -> fp32 logits (B, S, vocab), or the final
        hidden states in the compute dtype with ``return_hidden``;
        ``return_aux`` also returns the MoE blocks' balance terms (a
        list, empty without MoE) as the last element.

        ``segment_ids`` (B, S) run a packed batch (tokens attend within
        their segment); pass per-segment ``positions`` (B, S) so the
        rotation restarts at each document. ``cache``/``cache_index``
        (scalar or per-row (B,)) run the cached forward and return
        ``(out, new_cache)``; there ``positions`` default to
        ``cache_index + arange(S)`` per row, and
        ``segment_ids``/``valid_start`` carry the ragged left-padded
        prompt masking of ``generate(prompt_lens=...)``."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        B, S = tokens.shape
        dev = self.device
        x = self.tok_embeddings[tokens.long()].to(dtype)
        if positions is None and cache is not None:
            start = torch.as_tensor(cache_index, dtype=torch.int64,
                                    device=dev)
            positions = (start.reshape(-1, 1)
                         + torch.arange(S, device=dev)).expand(B, S)
        if positions is None and self.seq_group is not None:
            import torch.distributed as dist
            # the local shard's global positions along the ring
            positions = (torch.arange(S, device=dev)
                         + dist.get_rank(self.seq_group) * S)
        if positions is not None and positions.dim() == 2:
            # (B, S) per-row positions -> per-row (B, S, half) tables
            cos, sin = rope_tables(torch.as_tensor(positions, device=dev)
                                   .reshape(-1), cfg.head_dim,
                                   base=cfg.rope_base)
            cos, sin = cos.reshape(B, S, -1), sin.reshape(B, S, -1)
        else:
            pos = (torch.arange(S, device=dev) if positions is None
                   else torch.as_tensor(positions, device=dev))
            cos, sin = rope_tables(pos, cfg.head_dim, base=cfg.rope_base)
        new_cache, auxes = {}, []
        for i, blk in enumerate(self.blocks()):
            if cfg.remat and cache is None:
                x, _, aux = checkpoint_module(blk, cfg.remat_policy, x, cos,
                                              sin, segment_ids)
            else:
                x, new_cache[f"layer{i}"], aux = blk(
                    x, cos, sin, segment_ids,
                    None if cache is None else cache[f"layer{i}"],
                    cache_index, valid_start, chunk_decode)
            if aux is not None:
                auxes.append(aux)
        g = self.norm
        if not cfg.policy.keep_norms_fp32:
            g = g.to(dtype)
        x = rms_norm(x, g, eps=cfg.norm_eps)
        out = (x.to(dtype) if return_hidden
               else head_logits(x.to(dtype), self.output.to(dtype)))
        res = (out,) if cache is None else (out, new_cache)
        if return_aux:
            res = res + (auxes,)
        return res[0] if len(res) == 1 else res


@torch.no_grad()
def init_weights(model: Llama, seed: int) -> Llama:
    """Random weights at the JAX package's init scales, drawn on the
    model's device from ``torch.Generator(device).manual_seed(seed)``:
    normal(0.02) for the embeddings, head and projections, ones for the
    norm scales. (The JAX package's draws differ: load its params with
    `interop.llama_params_from_jax` to compare the two.)"""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name == "norm" or name.endswith("_norm"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model


_TP_RULES = (
    (r"tok_embeddings$", P("tp", None)),          # vocab-split embedding
    (r"output$", P("tp", None)),                  # vocab-split head
    (r"w[qkv]$", P(None, "tp")),                  # column-parallel qkv
    (r"wo$", P("tp", None)),                      # row-parallel out proj
    (r"w_(gate|up)$", P(None, "tp")),             # column-parallel ffn in
    (r"w_down$", P("tp", None)),                  # row-parallel ffn out
    (r"moe\.w[12]$", P("ep", None, None)),        # expert-parallel FFNs
    (r"moe\.router$", P()),
    (r".*norm$", P()),                            # replicated norms
)


def param_specs(params: dict, *, rules=_TP_RULES, default=P()) -> dict:
    """``{name: PartitionSpec}`` for a Llama's parameters, the first
    matching rule winning: the reference's
    ``set_tensor_model_parallel_attributes`` on its column and row
    parallel weights, as data."""
    return specs_from_rules(params, rules, default=default)


def llama_loss_fn(model: Llama, *, fuse_head: bool = True):
    """``loss_fn(params, tokens, segment_ids=None, positions=None) ->
    scalar`` for `Amp.make_train_step`: the mean next-token
    cross-entropy, the model run on ``params`` (``{name: tensor}`` keyed
    like ``model.named_parameters()``) through
    ``torch.func.functional_call``. With ``segment_ids`` (a packed batch)
    the mean is over the targets inside a document.

    ``fuse_head=True`` (the default): the final hidden states and the
    head go through `linear_cross_entropy`, no (B, S, V) logits.
    ``fuse_head=False``: the materialized fp32 logits through
    `softmax_cross_entropy_loss` (the parity gold). With MoE blocks
    their Switch balance terms are added, as the JAX model sows them."""

    def loss_fn(params: dict, tokens: torch.Tensor, segment_ids=None,
                positions=None) -> torch.Tensor:
        kw = dict(segment_ids=segment_ids, positions=positions,
                  return_aux=True)
        if fuse_head:
            h, auxes = torch.func.functional_call(
                model, params, (tokens,), dict(return_hidden=True, **kw))
            h, out = gathered(h, params["output"])
            losses = linear_cross_entropy(
                h[:, :-1], out.to(h.dtype), tokens[:, 1:])
        else:
            logits, auxes = torch.func.functional_call(
                model, params, (tokens,), kw)
            losses = softmax_cross_entropy_loss(logits[:, :-1].float(),
                                                tokens[:, 1:])
        if segment_ids is not None:
            loss = masked_next_token_mean(losses, segment_ids)
        else:
            loss = losses.mean()
        for aux in auxes:
            loss = loss + aux
        return loss

    return loss_fn
