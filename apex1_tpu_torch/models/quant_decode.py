"""Weight-only int8 decode for the port's `Llama` and `GPT2` (the port of
``apex1_tpu/models/quant_decode.py``).

Weights are quantized once (`quantize_llama_params`,
`quantize_gpt2_params`: per-output-channel symmetric int8 through
`ops.quantized.quantize_int8`), into the JAX package's tree: every
matmul weight becomes ``{"q": int8 (out, in), "s": fp32 (out,)}``,
embeddings are kept in the compute dtype, norms (and GPT-2's dense
biases) in fp32. Every decode matmul then runs `ops.int8_matmul`, whose
kernel (``csrc/int8_matmul.cu``, TPU row 20) converts the int8 tiles
to bf16 on chip, so no bf16 weight matrix exists in device memory.

These are dedicated inference forwards mirroring the models' cached
paths (the same norm, RoPE and `cached_attention` calls; only the
weight matmuls differ). ``apply_fn(tokens, cache, cache_index, *,
positions, segment_ids, valid_start, chunk_decode)`` binds the
quantized params, as `generate.llama_decoder` binds its model, so it
plugs into `generate` and `Engine` unchanged. A tree quantized by the
JAX package serves as it is through `interop.quant_params_from_jax`.

MoE layers (``moe_every > 0``): the stacked expert FFNs quantize per
expert per output channel (``{"q": (E, out, in) int8, "s": (E, out)
fp32}``), the router gate stays fp32; the decode runs the dense-dispatch
`transformer.moe.router` (the same capacity and drop rules) and each
expert's two products through `int8_matmul`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from apex1_tpu_torch.models.generate import cached_attention, init_cache
from apex1_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex1_tpu_torch.ops.quantized import int8_matmul, quantize_int8
from apex1_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_tables


def _qt(w: torch.Tensor) -> dict:
    """An (out, in) weight -> its int8 leaf."""
    q, s = quantize_int8(w)
    return {"q": q, "s": s}


def _qt_experts(w: torch.Tensor) -> dict:
    """Stacked (E, in, out) expert weights -> per-expert int8 leaves
    (E, out, in) and scales (E, out)."""
    qs = [quantize_int8(w[e].t()) for e in range(w.shape[0])]
    return {"q": torch.stack([q for q, _ in qs]),
            "s": torch.stack([s for _, s in qs])}


def _positions(cache_index, B: int, S: int, device):
    """(B, S) positions of a cached forward: each row's cache index
    (scalar or (B,)) plus the chunk offset."""
    start = torch.as_tensor(cache_index, dtype=torch.int64, device=device)
    return (start.reshape(-1, 1)
            + torch.arange(S, device=device)).expand(B, S)


@torch.no_grad()
def quantize_llama_params(params: dict, cfg) -> dict:
    """Quantize a Llama's parameters (``{name: tensor}`` keyed like the
    port's ``named_parameters()``) for decode: the embedding in the
    compute dtype, the norms fp32, every projection (stored (in, out))
    transposed once into the kernel's (N, K) layout and quantized, the
    (vocab, hidden) head quantized as it lies; an MoE block's experts
    per expert (`_qt_experts`) beside its fp32 router."""
    from apex1_tpu_torch.models.llama import is_moe_layer
    dt = cfg.policy.compute_dtype
    out = {"tok_embeddings": params["tok_embeddings"].detach().to(dt),
           "norm": params["norm"].detach().clone()}
    for i in range(cfg.num_layers):
        p = f"layer{i}."
        dense = ("w_gate", "w_up", "w_down")
        moe = is_moe_layer(cfg, i)
        qlp = {"attn_norm": params[p + "attn_norm"].detach().clone(),
               "mlp_norm": params[p + "mlp_norm"].detach().clone(),
               **{n: _qt(params[p + n].t())
                  for n in ("wq", "wk", "wv", "wo") + (() if moe
                                                       else dense)}}
        if moe:
            qlp["moe"] = {
                "router": params[p + "moe.router"].detach().float().clone(),
                "w1": _qt_experts(params[p + "moe.w1"].detach()),
                "w2": _qt_experts(params[p + "moe.w2"].detach())}
        out[f"layer{i}"] = qlp
    out["output"] = _qt(params["output"])
    return out


def llama_quant_decoder(model, qparams=None):
    """(apply_fn, make_cache, qparams) for int8 decode of a `Llama`:
    ``qparams`` from `quantize_llama_params` of the model (or the tree
    given, e.g. `interop.quant_params_from_jax`), bound into
    ``apply_fn``, which has the `generate.llama_decoder` contract."""
    from apex1_tpu_torch.models.llama import is_moe_layer, moe_config
    from apex1_tpu_torch.transformer.moe import router
    cfg = model.cfg
    dt = cfg.policy.compute_dtype
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qp = (quantize_llama_params(dict(model.named_parameters()), cfg)
          if qparams is None else qparams)
    dev = model.device

    def mm(x, qw):
        return int8_matmul(x, qw["q"], qw["s"]).to(dt)

    def norm(x, g):
        if not cfg.policy.keep_norms_fp32:
            g = g.to(dt)
        return rms_norm(x, g, eps=cfg.norm_eps).to(dt)

    def moe_ffn(h, qm, segment_ids):
        """`MoEMLP`'s decode math (the same router, capacity and drops)
        with each expert's products through `int8_matmul`; the balance
        term is dropped (decode feeds no optimizer)."""
        lead, Hd = h.shape[:-1], h.shape[-1]
        x2 = h.reshape(-1, Hd)
        mask = (None if segment_ids is None
                else (segment_ids >= 0).reshape(-1))
        dispatch, combine, _ = router(x2, qm["router"], moe_config(cfg),
                                      mask)
        xe = torch.einsum("tec,th->ech", dispatch.to(dt), x2.to(dt))
        w1, w2 = qm["w1"], qm["w2"]
        ye = torch.stack([
            int8_matmul(F.silu(int8_matmul(xe[e], w1["q"][e],
                                           w1["s"][e]).to(dt)),
                        w2["q"][e], w2["s"][e])
            for e in range(xe.shape[0])])
        y = torch.einsum("tec,ech->th", combine.to(dt), ye.to(dt))
        return y.reshape(*lead, Hd)

    @torch.no_grad()
    def apply_fn(tokens, cache, cache_index, *, positions=None,
                 segment_ids=None, valid_start=None, chunk_decode=False):
        B, S = tokens.shape
        x = qp["tok_embeddings"][tokens.long()].to(dt)
        if positions is None:
            positions = _positions(cache_index, B, S, dev)
        cos, sin = rope_tables(torch.as_tensor(positions, device=dev)
                               .reshape(-1), D, base=cfg.rope_base)
        cos, sin = cos.reshape(B, S, -1), sin.reshape(B, S, -1)
        new_cache = {}
        for i in range(cfg.num_layers):
            lp = qp[f"layer{i}"]
            h = norm(x, lp["attn_norm"])
            q = apply_rotary_pos_emb(mm(h, lp["wq"]).reshape(B, S, H, D),
                                     cos, sin)
            k = apply_rotary_pos_emb(mm(h, lp["wk"]).reshape(B, S, Hkv, D),
                                     cos, sin)
            v = mm(h, lp["wv"]).reshape(B, S, Hkv, D)
            attn, new_cache[f"layer{i}"] = cached_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                cache[f"layer{i}"], cache_index, segment_ids=segment_ids,
                valid_start=valid_start, chunk_decode=chunk_decode)
            attn = attn.transpose(1, 2).reshape(B, S, H * D)
            x = x + mm(attn, lp["wo"]).to(x.dtype)
            h = norm(x, lp["mlp_norm"])
            if is_moe_layer(cfg, i):
                y = moe_ffn(h, lp["moe"], segment_ids)
            else:
                y = mm(F.silu(mm(h, lp["w_gate"])) * mm(h, lp["w_up"]),
                       lp["w_down"])
            x = x + y.to(x.dtype)
        x = norm(x, qp["norm"])
        logits = int8_matmul(x, qp["output"]["q"], qp["output"]["s"])
        return logits, new_cache

    def make_cache(batch: int, max_len: int, dtype=None):
        return init_cache(cfg.num_layers, batch, Hkv, max_len, D,
                          dtype or dt, device=dev)

    return apply_fn, make_cache, qp


@torch.no_grad()
def quantize_gpt2_params(model) -> dict:
    """Quantize a `GPT2` for decode. The tied ``wte`` is kept twice: in
    the compute dtype as the gather table and quantized as the LM head
    (``(padded_vocab, hidden)`` is already (N, K)); each dense weight
    (``nn.Linear``'s (out, in)) is quantized as it lies; LayerNorm
    scale and bias and the dense biases stay fp32."""
    dt = model.cfg.policy.compute_dtype
    out = {"wte": model.wte.detach().to(dt),
           "wpe": model.wpe.detach().to(dt),
           "lnf_scale": model.lnf_scale.detach().clone(),
           "lnf_bias": model.lnf_bias.detach().clone()}
    for i, blk in enumerate(model.h):
        leaf = {n: getattr(blk, n).detach().clone()
                for n in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")}
        for n in ("qkv", "proj", "fc_in", "fc_out"):
            lin = getattr(blk, n)
            leaf[n] = _qt(lin.weight)
            leaf[n + "_b"] = lin.bias.detach().clone()
        out[f"h{i}"] = leaf
    out["head"] = _qt(model.wte)
    return out


def gpt2_quant_decoder(model, qparams=None):
    """(apply_fn, make_cache, qparams) for int8 decode of a `GPT2`:
    LayerNorm with bias, fused qkv, cached attention at 1/sqrt(hd),
    tanh-GELU MLP, the tied padded-vocab head, every matmul through
    `int8_matmul` (its fp32 output plus the fp32 bias, then cast);
    positions outside the table read NaN, as the JAX package's fill
    mode does. The `generate.gpt2_decoder` contract."""
    cfg = model.cfg
    dt = cfg.policy.compute_dtype
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    qp = quantize_gpt2_params(model) if qparams is None else qparams
    dev = model.device
    n_pos = qp["wpe"].shape[0]

    def mm(x, qw, b):
        return (int8_matmul(x, qw["q"], qw["s"]) + b.float()).to(dt)

    def ln(x, g, b):
        if not cfg.policy.keep_norms_fp32:
            g, b = g.to(dt), b.to(dt)
        return layer_norm(x, g, b).to(dt)

    @torch.no_grad()
    def apply_fn(tokens, cache, cache_index, *, positions=None,
                 segment_ids=None, valid_start=None, chunk_decode=False):
        B, S = tokens.shape
        if positions is None:
            positions = _positions(cache_index, B, S, dev)
        positions = torch.as_tensor(positions, device=dev).long()
        inside = (positions >= 0) & (positions < n_pos)
        pe = qp["wpe"][positions.clamp(0, n_pos - 1)]
        pe = torch.where(inside[..., None], pe, float("nan"))
        x = (qp["wte"][tokens.long()] + pe).to(dt)
        new_cache = {}
        for i in range(cfg.num_layers):
            lp = qp[f"h{i}"]
            qkv = mm(ln(x, lp["ln1_scale"], lp["ln1_bias"]), lp["qkv"],
                     lp["qkv_b"])
            q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
                       for t in qkv.split(cfg.hidden_size, dim=-1))
            attn, new_cache[f"layer{i}"] = cached_attention(
                q, k, v, cache[f"layer{i}"], cache_index,
                sm_scale=1.0 / math.sqrt(hd), segment_ids=segment_ids,
                valid_start=valid_start, chunk_decode=chunk_decode)
            attn = attn.transpose(1, 2).reshape(B, S, nh * hd)
            x = x + mm(attn, lp["proj"], lp["proj_b"])
            y = ln(x, lp["ln2_scale"], lp["ln2_bias"])
            y = F.gelu(mm(y, lp["fc_in"], lp["fc_in_b"]), approximate="tanh")
            x = x + mm(y, lp["fc_out"], lp["fc_out_b"])
        x = ln(x, qp["lnf_scale"], qp["lnf_bias"])
        logits = int8_matmul(x, qp["head"]["q"], qp["head"]["s"])
        return logits, new_cache

    def make_cache(batch: int, max_len: int, dtype=None):
        return init_cache(cfg.num_layers, batch, nh, max_len, hd,
                          dtype or dt, device=dev)

    return apply_fn, make_cache, qp
