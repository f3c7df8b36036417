"""Llama under dp × pp × cp × ep × tp parallelism in one train step (the
port of ``apex1_tpu/models/llama_3d.py``).

Each rank holds its shards and runs the step on its own:

- the pipeline: `schedules.pipeline_apply` (``schedule="scan"``: every
  forward, then the backward in reverse tick order, remat per layer) or
  `schedules.one_f_one_b` (``"1f1b"``), over the pp group, with the
  chunk-major interleave at ``num_chunks`` > 1;
- inside a stage, Megatron tensor and sequence parallelism on the tp
  group (one sequence all-gather feeds q, k, v, one the gate and up
  products; a reduce-scatter after each row-parallel product), the
  port's `rms_norm`, `apply_rotary_pos_emb` and causal GQA
  `flash_attention` (`ring_attention` over the cp group when cp > 1,
  the rotary rows at the shard's global positions), and with ``moe``
  the expert FFN (`moe_shard_map_apply`, two all-to-alls over ep);
- the vocab-parallel embedding and the fused LM-head cross-entropy
  (`vocab_parallel_linear_cross_entropy`: the linear-xent shard
  kernels), both replicated over pp;
- fp32 masters, compute in the policy's dtype, the port's fused Adam,
  and under an fp16 policy the dynamic loss scale with one finite check
  over every rank (an overflowed step is skipped everywhere).

Gradients. Every rank back-propagates its own PARTIAL loss (the CE on
the last stage, zeros elsewhere, plus its stages' MoE balance terms).
The port's region collectives are Megatron's (an all-gather's backward
is a reduce-scatter, and so on), so the sharded matmul weights come out
exact; `combine_grads` does the rest, the JAX package's map:

- replicated leaves: mean over the data replicas (dp, ep, cp);
- norms and the router (each tp rank sees its own tokens): sum over tp;
- the ep-sharded experts: sum over tp, mean over (dp, cp), / ep (the
  all-to-all's backward already summed every ep rank's tokens);
- the embedding, head and final norm (first and last stage only): sum
  over pp, the embedding-group all-reduce.

The router's statistics are summed over (tp, dp, ep[, cp]) by an
all-reduce whose backward is an all-reduce (JAX's ``psum``), so every
rank seeding the balance term would count it tp·dp·ep·cp times where the
CE convention counts tp: each rank seeds aux/tp, and the rest of its
value rides along without gradient, so the logged loss is CE + aux.

Tokens and labels are global (M, S, mb·dp·ep) arrays, sequence-major;
each rank reads its shard (`shard_batch`: the sequence over cp, the
columns over (dp, ep)), as the JAX step's ``P(None, cp, (dp, ep))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex1_tpu_torch.core.mesh import (AXIS_CP, AXIS_DP, AXIS_EP, AXIS_PP,
                                       AXIS_TP, make_mesh)
from apex1_tpu_torch.models.llama import LlamaConfig
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.attention import flash_attention
from apex1_tpu_torch.ops.layer_norm import rms_norm
from apex1_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_tables
from apex1_tpu_torch.transformer.pipeline_parallel.schedules import (
    allreduce_embedding_grads, one_f_one_b, pipeline_apply)
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp
from apex1_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_linear_cross_entropy)
from apex1_tpu_torch.transformer.tensor_parallel.layers import (
    vocab_parallel_embedding)

#: the data layout of tokens and labels (M, S, mb): JAX's
#: ``P(None, cp, (dp, ep))``
DATA_SPEC = (None, AXIS_CP, (AXIS_DP, AXIS_EP))


@dataclasses.dataclass(frozen=True)
class Llama3DConfig:
    model: LlamaConfig
    dp: int = 1
    pp: int = 1
    tp: int = 1
    cp: int = 1                       # context parallel (ring attention)
    ep: int = 1                       # expert parallel (requires moe)
    moe: bool = False                 # every layer's FFN expert-routed
    num_chunks: int = 1               # V>1 = interleaved virtual pipeline
    num_microbatches: int = 4
    microbatch_size: int = 1          # sequences per (dp, ep) replica/mb
    learning_rate: float = 1e-4
    # "scan": pipeline_apply + autograd (remat bounds activation memory);
    # "1f1b": schedules.one_f_one_b, the staggered forward and backward
    # (with num_chunks > 1 the group-cycled interleave, which needs
    # num_microbatches % pp == 0)
    schedule: str = "scan"

    def __post_init__(self):
        m = self.model
        if self.schedule not in ("scan", "1f1b"):
            raise ValueError("schedule must be 'scan' or '1f1b'")
        if self.schedule == "1f1b" and self.num_chunks > 1:
            if self.num_microbatches % self.pp:
                raise ValueError(
                    "interleaved 1F1B requires num_microbatches % pp == "
                    "0 (the group-cycled chunk schedule; ≙ the "
                    "reference's microbatches % pp assertion)")
            if self.pp < 2:
                raise ValueError(
                    "interleaved 1F1B needs pipeline size >= 2")
        if m.num_layers % (self.pp * self.num_chunks):
            raise ValueError("num_layers must divide by pp * num_chunks")
        if m.num_heads % self.tp or m.num_kv_heads % self.tp:
            raise ValueError("head counts must divide by tp")
        if m.vocab_size % self.tp:
            raise ValueError("vocab_size must divide by tp")
        if m.max_seq_len % (self.tp * self.cp):
            raise ValueError(
                "seq len must divide by tp * cp (SP + ring shards)")
        if self.num_chunks > 1 and self.num_microbatches < self.pp:
            raise ValueError("interleaved pipeline needs M >= pp")
        if self.ep > 1 and not self.moe:
            raise ValueError("ep > 1 requires moe=True")
        if self.moe and m.num_experts % self.ep:
            raise ValueError("num_experts must divide by ep")

    @property
    def moe_cfg(self):
        from apex1_tpu_torch.models.llama import moe_config
        return moe_config(self.model)

    @property
    def layers_per_stage(self) -> int:
        """Layers per (chunk, stage) slot: model chunk c = v·pp + s holds
        layers [c·lps, (c+1)·lps)."""
        return self.model.num_layers // (self.pp * self.num_chunks)


def _layer_leaf_shapes(cfg: Llama3DConfig) -> dict:
    m = cfg.model
    E, F_ = m.hidden_size, m.ffn_size
    HD, KD = m.num_heads * m.head_dim, m.num_kv_heads * m.head_dim
    shapes = {"attn_norm": (E,), "mlp_norm": (E,),
              "wq": (E, HD), "wk": (E, KD), "wv": (E, KD), "wo": (HD, E)}
    if cfg.moe:
        n = m.num_experts
        shapes.update({"wg": (E, n), "w_moe1": (n, E, F_),
                       "w_moe2": (n, F_, E)})
    else:
        shapes.update({"w_gate": (E, F_), "w_up": (E, F_),
                       "w_down": (F_, E)})
    return shapes


def chunk_param_specs(cfg: Llama3DConfig) -> dict:
    """The sharding of the global (num_chunks, pp, layers_per_stage, ...)
    leaves, one entry a dimension (JAX's PartitionSpecs as tuples): the
    stage axis over pp, columns or rows over tp, experts over ep."""
    col = (None, AXIS_PP, None, None, AXIS_TP)
    row = (None, AXIS_PP, None, AXIS_TP, None)
    norm = (None, AXIS_PP, None, None)
    specs = {"attn_norm": norm, "mlp_norm": norm,
             "wq": col, "wk": col, "wv": col, "wo": row}
    if cfg.moe:
        specs.update({"wg": (None, AXIS_PP, None, None, None),
                      "w_moe1": (None, AXIS_PP, None, AXIS_EP, None, None),
                      "w_moe2": (None, AXIS_PP, None, AXIS_EP, None, None)})
    else:
        specs.update({"w_gate": col, "w_up": col, "w_down": row})
    return specs


def shared_param_specs() -> dict:
    return {"emb": (AXIS_TP, None), "head": (AXIS_TP, None),
            "final_norm": ()}


def init_params(cfg: Llama3DConfig, seed: int = 0, device=None):
    """The global (unsharded) trees ``(chunk, shared)``, fp32 on
    ``device`` (CUDA unless named), drawn as the JAX package draws them:
    ``np.random.default_rng(seed)``, normal(0.02) in the same order,
    norm scales 1, so both packages start from the same weights."""
    dev = resolve_device(device)
    m = cfg.model
    rng = np.random.default_rng(seed)
    lead = (cfg.num_chunks, cfg.pp, cfg.layers_per_stage)

    def leaf(k, shape):
        if "norm" in k:
            return torch.ones(lead + shape, dtype=torch.float32, device=dev)
        a = (rng.normal(size=lead + shape) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    chunk = {k: leaf(k, s) for k, s in _layer_leaf_shapes(cfg).items()}
    V, E = m.vocab_size, m.hidden_size
    shared = {
        "emb": torch.from_numpy(
            (rng.normal(size=(V, E)) * 0.02).astype(np.float32)).to(dev),
        "head": torch.from_numpy(
            (rng.normal(size=(V, E)) * 0.02).astype(np.float32)).to(dev),
        "final_norm": torch.ones((E,), dtype=torch.float32, device=dev)}
    return chunk, shared


def reshape_chunks(tree: dict, cfg_to: Llama3DConfig) -> dict:
    """Re-stack global chunk leaves for another pipeline layout (same
    model, other pp / num_chunks): layer (v·pp + s)·lps + j sits at slot
    (v, s, j), the row-major flattening of (V, PP, lps), so a reshape
    re-partitions the stack."""
    return {k: x.reshape((cfg_to.num_chunks, cfg_to.pp,
                          cfg_to.layers_per_stage) + tuple(x.shape[3:]))
            for k, x in tree.items()}


_FLAT_NAMES = {"wg": "moe.router", "w_moe1": "moe.w1", "w_moe2": "moe.w2"}


def from_llama_params(params: dict, cfg: Llama3DConfig):
    """A flat `models.llama.Llama`'s parameters (``{name: tensor}`` as
    ``named_parameters()`` gives them: ``layer{i}.wq``, ...,
    ``tok_embeddings``, ``output``, ``norm``) as the global stacked
    trees ``(chunk, shared)``."""
    L, PP, VC = cfg.layers_per_stage, cfg.pp, cfg.num_chunks

    def leaf(i, name):
        return params[f"layer{i}.{_FLAT_NAMES.get(name, name)}"]

    def stack(name):
        # model chunk c = v*PP + s holds layers [c*L, (c+1)*L)
        return torch.stack([torch.stack(
            [torch.stack([leaf((v * PP + s) * L + j, name)
                          for j in range(L)]) for s in range(PP)])
            for v in range(VC)])

    chunk = {k: stack(k) for k in _layer_leaf_shapes(cfg)}
    shared = {"emb": params["tok_embeddings"], "head": params["output"],
              "final_norm": params["norm"]}
    return chunk, shared


# ---- the mesh, shards and batches ------------------------------------------


def _mesh(cfg: Llama3DConfig, mesh=None):
    """``mesh``, else `parallel_state`'s, else a new one of ``cfg``'s
    degrees; its degrees must be ``cfg``'s."""
    if mesh is None:
        from apex1_tpu_torch.transformer import parallel_state
        mesh = (parallel_state.get_mesh()
                if parallel_state.model_parallel_is_initialized() else
                make_mesh(dp=cfg.dp, pp=cfg.pp, cp=cfg.cp, ep=cfg.ep,
                          tp=cfg.tp))
    want = {AXIS_DP: cfg.dp, AXIS_PP: cfg.pp, AXIS_CP: cfg.cp,
            AXIS_EP: cfg.ep, AXIS_TP: cfg.tp}
    got = {a: mesh.size(a) for a in want}
    if got != want:
        raise ValueError(f"the mesh's degrees {got} are not the config's "
                         f"{want}")
    return mesh


def shard_params(chunk: dict, shared: dict, cfg: Llama3DConfig,
                 mesh=None) -> dict:
    """This rank's shards of the global trees as the port's flat
    parameter dict: ``chunk.<name>`` leaves (num_chunks,
    layers_per_stage, ...) (the stage axis dropped) and ``shared.<name>``
    leaves, each a fresh contiguous fp32 tensor."""
    mesh = _mesh(cfg, mesh)
    cs, ss = chunk_param_specs(cfg), shared_param_specs()
    out = {f"chunk.{k}": mesh.local_shard(v, cs[k])[:, 0].contiguous()
           .float() for k, v in chunk.items()}
    out.update({f"shared.{k}": mesh.local_shard(v, ss[k]).contiguous()
                .float() for k, v in shared.items()})
    return out


def _unshard(mesh, x: torch.Tensor, spec) -> torch.Tensor:
    """`Mesh.local_shard`'s inverse: the global tensor from every rank's
    block, an all-gather along each dimension ``spec`` names (a tuple
    of axes the minor one first)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in reversed(ax if isinstance(ax, tuple) else (ax,)):
            if mesh.size(a) > 1:
                x = mp.all_gather(x, mesh.group(a), dim)
    return x


def gather_state(cfg: Llama3DConfig, state: dict, mesh=None) -> dict:
    """This rank's train state (`state_template`'s layout) as the global
    state every rank holds, in the JAX package's nesting: ``{"step",
    "params": {"chunk": {name: (V, PP, lps, ...)}, "shared": {...}},
    "opt": FusedAdamState(step, exp_avg, exp_avg_sq)[, "scale"]}``, the
    moments nested as the params. The stage axis `shard_params` drops is
    restored and every tp, pp and ep shard all-gathered (a collective
    call on every rank). The layout-canonical tree a checkpoint holds
    (`resilience.reshard_state` and `reshape_chunks` read it): the
    port's counterpart of ``jax.device_get`` of the global arrays."""
    from apex1_tpu_torch.optim.fused_adam import FusedAdamState
    mesh = _mesh(cfg, mesh)
    cs, ss = chunk_param_specs(cfg), shared_param_specs()

    def tree(flat: dict) -> dict:
        chunk, shared = _split(flat)
        return {"chunk": {k: _unshard(mesh, v.unsqueeze(1), cs[k])
                          for k, v in chunk.items()},
                "shared": {k: _unshard(mesh, v, ss[k])
                           for k, v in shared.items()}}

    opt = state["opt"]
    out = {"step": state["step"], "params": tree(state["params"]),
           "opt": FusedAdamState(step=opt.step, exp_avg=tree(opt.exp_avg),
                                 exp_avg_sq=tree(opt.exp_avg_sq))}
    if "scale" in state:
        out["scale"] = state["scale"]
    return out


def local_state(cfg: Llama3DConfig, global_state: dict, mesh=None) -> dict:
    """`gather_state`'s inverse: this rank's train state from the global
    one, sliced as `interop.llama3d_state_from_jax` slices, on the global
    leaves' device."""
    from apex1_tpu_torch.core.pytree import tree_map_with_path
    from apex1_tpu_torch.interop import llama3d_state_from_jax
    device = global_state["step"].device
    state = llama3d_state_from_jax(global_state["params"], cfg, mesh,
                                   opt_state=global_state["opt"],
                                   device=device)
    state["step"] = global_state["step"].to(device)
    if "scale" in global_state:
        state["scale"] = tree_map_with_path(lambda p, x: x.to(device),
                                            global_state["scale"])
    return state


def shard_batch(x: torch.Tensor, cfg: Llama3DConfig, mesh=None):
    """This rank's (M, S/cp, mb) shard of global (M, S, mb·dp·ep) tokens
    or labels."""
    return _mesh(cfg, mesh).local_shard(x, DATA_SPEC)


def _split(params: dict):
    chunk = {k[6:]: v for k, v in params.items() if k.startswith("chunk.")}
    shared = {k[7:]: v for k, v in params.items() if k.startswith("shared.")}
    return chunk, shared


class _Groups:
    def __init__(self, mesh):
        self.mesh = mesh
        self.tp, self.cp, self.ep, self.pp, self.dp = (
            mesh.group(a) for a in (AXIS_TP, AXIS_CP, AXIS_EP, AXIS_PP,
                                    AXIS_DP))
        P = mesh.size(AXIS_PP)
        self.is_first = mesh.index(AXIS_PP) == 0
        self.is_last = mesh.index(AXIS_PP) == P - 1


# ---- the model ---------------------------------------------------------------


def _stage_fn(cfg: Llama3DConfig, cos, sin, g: _Groups):
    """One pipeline stage over the LOCAL shards: x (S/(cp·tp), mb, E) in
    the compute dtype, the sequence sharded over cp (outer, ring
    attention) then tp (Megatron SP, (s, b, h) layout)."""
    m = cfg.model
    tp = cfg.tp
    Hl, Kl, D = m.num_heads // tp, m.num_kv_heads // tp, m.head_dim
    E = m.hidden_size
    dt = m.policy.compute_dtype
    stats = (g.tp, g.dp, g.ep) + ((g.cp,) if cfg.cp > 1 else ())
    cp_idx = g.mesh.index(AXIS_CP)

    def layer(x, lp):
        # attention: norm on seq shards, ONE seq all-gather feeds q/k/v
        h = rms_norm(x, lp["attn_norm"], eps=m.norm_eps).to(dt)
        h = mp.gather_from_sequence_parallel_region(h, g.tp, 0, True)
        S, mb = h.shape[0], h.shape[1]      # S = the cp-local sequence
        q = (h @ lp["wq"].to(dt)).reshape(S, mb, Hl, D)
        k = (h @ lp["wk"].to(dt)).reshape(S, mb, Kl, D)
        v = (h @ lp["wv"].to(dt)).reshape(S, mb, Kl, D)
        # the rotary rows at this cp shard's GLOBAL positions
        cos_l, sin_l = cos[cp_idx * S:(cp_idx + 1) * S], \
            sin[cp_idx * S:(cp_idx + 1) * S]
        q = apply_rotary_pos_emb(q.transpose(0, 1), cos_l, sin_l)
        k = apply_rotary_pos_emb(k.transpose(0, 1), cos_l, sin_l)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v.transpose(0, 1)))
        if cfg.cp > 1:
            from apex1_tpu_torch.parallel.ring_attention import (
                ring_attention)
            attn = ring_attention(q, k, v, g.cp, causal=True)
        else:
            attn = flash_attention(q, k, v, causal=True)
        attn = attn.permute(2, 0, 1, 3).reshape(S, mb, Hl * D)
        o = attn @ lp["wo"].to(dt)
        o = mp.reduce_scatter_to_sequence_parallel_region(o, g.tp, 0)
        x = x + o.to(x.dtype)

        h = rms_norm(x, lp["mlp_norm"], eps=m.norm_eps).to(dt)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.moe:
            # the expert FFN on the SEQ-SHARDED tokens: each (tp, dp, ep)
            # rank dispatches its own tokens over ep; the router's
            # statistics are summed over every group that shards the
            # microbatch, so aux is the global Switch term
            from apex1_tpu_torch.transformer.moe import moe_shard_map_apply
            S_l, mb = h.shape[0], h.shape[1]
            y2, aux = moe_shard_map_apply(
                h.reshape(-1, E), lp["wg"].to(dt), lp["w_moe1"],
                lp["w_moe2"], cfg.moe_cfg, axis_name=g.ep, act=F.silu,
                stats_axes=stats)
            y = y2.reshape(S_l, mb, E)
        else:
            # the dense MLP: one gather feeds gate and up
            h = mp.gather_from_sequence_parallel_region(h, g.tp, 0, True)
            y = (F.silu(h @ lp["w_gate"].to(dt))
                 * (h @ lp["w_up"].to(dt))) @ lp["w_down"].to(dt)
            y = mp.reduce_scatter_to_sequence_parallel_region(y, g.tp, 0)
        return x + y.to(x.dtype), aux

    if m.remat:
        from apex1_tpu_torch.transformer.tensor_parallel.random import (
            checkpoint_with_policy)
        layer = checkpoint_with_policy(layer, m.remat_policy)

    def stage(p_stage, x):
        # p_stage leaves: (layers_per_stage, ...); the layers' MoE terms
        # sum to the stage's (the pipeline's with_aux channel)
        auxes = []
        for j in range(cfg.layers_per_stage):
            x, aux = layer(x, {k: v[j] for k, v in p_stage.items()})
            auxes.append(aux)
        if cfg.moe:
            return x, torch.stack(auxes).sum()
        return x

    return stage


def _embed_microbatches(cfg: Llama3DConfig, emb_w, tokens, g: _Groups):
    """(M, S, mb) tokens -> (M, S/(cp·tp), mb, E) boundary activations:
    the vocab-parallel embedding in the compute dtype, scattered into
    the sequence-parallel region. Only stage 0 reads them; the other
    stages get zeros of the shape (their tp peers skip alike)."""
    dt = cfg.model.policy.compute_dtype
    M, S, mb = tokens.shape
    if not g.is_first:
        return torch.zeros((M, S // cfg.tp, mb, cfg.model.hidden_size),
                           dtype=dt, device=emb_w.device)
    w = emb_w.to(dt)
    return torch.stack([mp.scatter_to_sequence_parallel_region(
        vocab_parallel_embedding(t.long(), w, group=g.tp), g.tp, 0)
        for t in tokens])


def _head_ce(cfg, g, final_norm, head, y, labels):
    """The mean CE of the last stage's outputs ``y`` (..., S_loc, mb, E)
    with ``labels`` (..., S, mb) in the CE's gathered (tp-major) order."""
    m = cfg.model
    dt = m.policy.compute_dtype
    o = rms_norm(y, final_norm, eps=m.norm_eps).to(dt)
    E = o.shape[-1]
    if o.dim() == 4:
        # local tokens seq-major-first, so the CE's tp all-gather
        # rebuilds the global order
        M, S_loc, mb, _ = o.shape
        x_tok = o.transpose(0, 1).reshape(-1, E)
        lbl = labels.reshape(M, cfg.tp, S_loc, mb).permute(1, 2, 0, 3)
    else:
        S_loc, mb, _ = o.shape
        x_tok = o.reshape(-1, E)
        lbl = labels.reshape(cfg.tp, S_loc, mb)
    ce = vocab_parallel_linear_cross_entropy(
        x_tok, head.to(dt), lbl.reshape(-1), group=g.tp,
        sequence_parallel_input=True)
    return ce.mean()


def _aux_term(cfg, moe_aux):
    """The balance term seeded aux/tp (see the module docstring), its
    value whole."""
    inv = 1.0 / cfg.tp
    return moe_aux * inv + moe_aux.detach() * (1.0 - inv)


def loss_fn(cfg: Llama3DConfig, chunk_local: dict, shared_local: dict,
            tokens, labels, cos, sin, mesh=None):
    """This rank's PARTIAL loss (its sum over pp is the global mean CE
    plus the balance terms): ``chunk_local`` leaves (num_chunks,
    layers_per_stage, ...), ``shared_local`` this rank's embedding, head
    and final norm, ``tokens``/``labels`` this rank's (M, S/cp, mb)
    shard. Differentiable."""
    g = _Groups(_mesh(cfg, mesh))
    stage = _stage_fn(cfg, cos, sin, g)
    h_mb = _embed_microbatches(cfg, shared_local["emb"], tokens, g)
    # the bubble-skip contract: ring attention hops inside the stage
    outs = pipeline_apply(stage, chunk_local, h_mb,
                          num_chunks=cfg.num_chunks, axis_name=g.pp,
                          broadcast_outputs=False, skip_bubbles=cfg.cp == 1,
                          with_aux=cfg.moe)
    if cfg.moe:
        outs, moe_aux = outs
    if g.is_last:
        loss = _head_ce(cfg, g, shared_local["final_norm"],
                        shared_local["head"], outs, labels)
    else:
        # zeros off the last stage, still on the pipeline's graph so its
        # backward runs here too
        loss = outs.float().sum() * 0.0
    if cfg.moe:
        loss = loss + _aux_term(cfg, moe_aux) / tokens.shape[0]
    return loss


def loss_and_grads_1f1b(cfg: Llama3DConfig, params: dict, tokens, labels,
                        cos, sin, scale_val, mesh=None):
    """The forward and backward on the TRUE 1F1B schedule: the same
    objective and grads as autograd over `loss_fn`, with the staggered
    forward and backward (at most O(V·P) microbatches alive, and no
    remat recompute beyond the layers' own). Returns ``(grads,
    loss_part)``: ``grads`` (a dict keyed as ``params``) SCALED by
    ``scale_val``, ``loss_part`` this rank's unscaled partial loss.

    The final norm and the vocab-parallel CE run per microbatch on the
    last stage inside ``loss_mb`` (the reference's
    ``post_language_model_processing``), {final_norm, head} as the
    schedule's ``loss_params``; the embedding's backward replays from the
    schedule's ``dmicrobatches`` (real on stage 0)."""
    g = _Groups(_mesh(cfg, mesh))
    stage = _stage_fn(cfg, cos, sin, g)
    M = tokens.shape[0]
    chunk_local, shared_local = _split(params)
    emb = shared_local["emb"].detach().requires_grad_()
    with torch.enable_grad():
        h_mb = _embed_microbatches(cfg, emb, tokens, g)
    VC = cfg.num_chunks
    stage_local = {k: (v[0] if VC == 1 else v)
                   for k, v in chunk_local.items()}
    lp = {"final_norm": shared_local["final_norm"],
          "head": shared_local["head"]}

    def loss_mb(lp_, y, mi):
        return scale_val * _head_ce(cfg, g, lp_["final_norm"], lp_["head"],
                                    y, labels[mi]) / M

    skip = cfg.cp == 1                 # ring attention: the contract
    kw = dict(loss_params=lp, num_chunks=VC, skip_idle=skip,
              axis_name=g.pp)
    if cfg.moe:
        loss_p, g_stage, dmb, dlp, aux_sum = one_f_one_b(
            stage, stage_local, h_mb.detach(), loss_mb, with_aux=True,
            aux_cotangent=scale_val / (cfg.tp * M), **kw)
    else:
        loss_p, g_stage, dmb, dlp = one_f_one_b(
            stage, stage_local, h_mb.detach(), loss_mb, **kw)
    if g.is_first:
        (demb,) = torch.autograd.grad(h_mb, [emb], dmb.to(h_mb.dtype))
    else:
        demb = torch.zeros_like(emb)
    grads = {f"chunk.{k}": (v[None] if VC == 1 else v)
             for k, v in g_stage.items()}
    grads.update({"shared.emb": demb, "shared.head": dlp["head"],
                  "shared.final_norm": dlp["final_norm"]})
    loss_part = loss_p / scale_val     # the scale is a power of 2: exact
    if cfg.moe:
        loss_part = loss_part + aux_sum / M
    return grads, loss_part


def _all_reduce(x, group, mean: bool = False):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = mp.all_reduce(x, group)
    return x / n if mean else x


def combine_grads(g_chunk: dict, g_shared: dict, cfg: Llama3DConfig,
                  mesh=None):
    """The combination map (module docstring) over this rank's raw
    grads; returns ``(g_chunk, g_shared)``."""
    g = _Groups(_mesh(cfg, mesh))
    data = (g.dp, g.ep, g.cp)

    def pmean(x, groups):
        for grp in groups:
            x = _all_reduce(x, grp, mean=True)
        return x

    def chunk_one(k, x):
        if cfg.moe and k in ("w_moe1", "w_moe2"):
            x = _all_reduce(x, g.tp)          # token subsets sum
            return pmean(x, (g.dp, g.cp)) / cfg.ep
        x = pmean(x, data)
        if "norm" in k or k == "wg":
            x = _all_reduce(x, g.tp)          # SP / token-subset partials
        return x

    g_chunk = {k: chunk_one(k, v) for k, v in g_chunk.items()}
    g_shared = {k: pmean(v, data) for k, v in g_shared.items()}
    # final_norm: computed on seq shards (tp-partial) on the last stage
    g_shared["final_norm"] = _all_reduce(g_shared["final_norm"], g.tp)
    # the embedding group: emb on stage 0, head and final norm on the
    # last stage; the sum over pp completes them
    g_shared = allreduce_embedding_grads(g_shared, g.pp)
    return g_chunk, g_shared


def _make_tx(cfg: Llama3DConfig):
    from apex1_tpu_torch.optim.fused_adam import fused_adam
    return fused_adam(cfg.learning_rate)


def _make_scaler(cfg: Llama3DConfig):
    """The policy's loss-scale machine, or None for unscaled policies."""
    if cfg.model.policy.loss_scale is None:
        return None
    from apex1_tpu_torch.core import loss_scale as ls
    return ls.make_loss_scale(cfg.model.policy.loss_scale)


def state_template(cfg: Llama3DConfig, params: dict, device=None) -> dict:
    """The train state over this rank's flat ``params`` (`shard_params`):
    ``{"step", "params", "opt"[, "scale"]}``, fused Adam's fp32 moments
    at zero, the loss scale's initial state under an fp16 policy."""
    tx = _make_tx(cfg)
    dev = next(iter(params.values())).device if device is None else device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "params": params, "opt": tx.init(params)}
    scaler = _make_scaler(cfg)
    if scaler is not None:
        state["scale"] = scaler.init(dev)
    return state


def global_state_template(cfg: Llama3DConfig, device=None) -> dict:
    """`gather_state`'s global tree with no mesh and no collective: empty
    fp32 params and moments of the global (num_chunks, pp,
    layers_per_stage, ...) and shared shapes on ``device`` (CUDA unless
    named; ``"meta"`` for shapes only), the step counts int32, the loss
    scale's initial state under an fp16 policy. The template a restore
    or a reshard of a global checkpoint reads on any fleet (the JAX
    package's mesh-free ``state_template``)."""
    from apex1_tpu_torch.optim.fused_adam import FusedAdamState
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    m = cfg.model
    lead = (cfg.num_chunks, cfg.pp, cfg.layers_per_stage)
    V, E = m.vocab_size, m.hidden_size

    def tree() -> dict:
        return {"chunk": {k: torch.empty(lead + s, device=dev)
                          for k, s in _layer_leaf_shapes(cfg).items()},
                "shared": {"emb": torch.empty((V, E), device=dev),
                           "head": torch.empty((V, E), device=dev),
                           "final_norm": torch.empty((E,), device=dev)}}

    def count():
        return torch.zeros((), dtype=torch.int32, device=dev)

    state = {"step": count(), "params": tree(),
             "opt": FusedAdamState(step=count(), exp_avg=tree(),
                                   exp_avg_sq=tree())}
    scaler = _make_scaler(cfg)
    if scaler is not None:
        state["scale"] = scaler.init(dev)
    return state


def abstract_state(cfg: Llama3DConfig, mesh=None):
    """The state and the (M, S, mb·dp·ep) data as tensors on
    ``torch.device("meta")``: this rank's shapes and dtypes without
    memory (JAX's ShapeDtypeStruct template)."""
    m = cfg.model
    meta = torch.device("meta")
    mesh = _mesh(cfg, mesh)
    chunk = {k: torch.empty((cfg.num_chunks, cfg.pp, cfg.layers_per_stage)
                            + s, device=meta)
             for k, s in _layer_leaf_shapes(cfg).items()}
    V, E = m.vocab_size, m.hidden_size
    shared = {"emb": torch.empty((V, E), device=meta),
              "head": torch.empty((V, E), device=meta),
              "final_norm": torch.empty((E,), device=meta)}
    state = state_template(cfg, shard_params(chunk, shared, cfg, mesh),
                           device=meta)
    data = torch.empty((cfg.num_microbatches, m.max_seq_len,
                        cfg.microbatch_size * cfg.dp * cfg.ep),
                       dtype=torch.int32, device=meta)
    return state, data


def rope_for(cfg: Llama3DConfig, device):
    """The (cos, sin) tables of the whole sequence."""
    m = cfg.model
    return rope_tables(torch.arange(m.max_seq_len, device=device),
                       m.head_dim, base=m.rope_base)


def loss_and_grads(cfg: Llama3DConfig, params: dict, tokens, labels, *,
                   mesh=None, scale=None, tables=None):
    """One forward and backward on this rank: ``params`` its flat shards
    (`shard_params`), ``tokens``/``labels`` the GLOBAL (M, S, mb·dp·ep)
    batch. Returns ``(loss, grads)``: the global loss (a 0-d fp32
    tensor, the same on every rank) and the combined grads of the loss
    times ``scale`` (a 0-d tensor, default 1), keyed as ``params``."""
    mesh = _mesh(cfg, mesh)
    g = _Groups(mesh)
    dev = next(iter(params.values())).device
    cos, sin = rope_for(cfg, dev) if tables is None else tables
    tok = shard_batch(tokens, cfg, mesh).to(dev)
    lbl = shard_batch(labels, cfg, mesh).to(dev)
    scale_val = (torch.ones((), dtype=torch.float32, device=dev)
                 if scale is None else scale)
    if cfg.schedule == "1f1b":
        grads, loss_part = loss_and_grads_1f1b(cfg, params, tok, lbl, cos,
                                               sin, scale_val, mesh)
    else:
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        chunk, shared = _split(leaves)
        with torch.enable_grad():
            loss_part = loss_fn(cfg, chunk, shared, tok, lbl, cos, sin, mesh)
            got = torch.autograd.grad(loss_part * scale_val,
                                      list(leaves.values()),
                                      allow_unused=True)
        grads = {k: (torch.zeros_like(v) if d is None else d)
                 for (k, v), d in zip(leaves.items(), got)}
        loss_part = loss_part.detach()
    loss = _all_reduce(loss_part.float(), g.pp)
    for grp in (g.dp, g.ep, g.cp):
        loss = _all_reduce(loss, grp, mean=True)
    g_chunk, g_shared = combine_grads(*_split(grads), cfg, mesh)
    grads = {**{f"chunk.{k}": v for k, v in g_chunk.items()},
             **{f"shared.{k}": v for k, v in g_shared.items()}}
    return loss, grads


def build_step(cfg: Llama3DConfig, mesh=None):
    """``step(state, tokens, labels) -> (state, loss)`` on this rank:
    ``tokens``/``labels`` global (M, S, mb·dp·ep) (each rank reads its
    shard), the loss the global one on every rank (a 0-d fp32 tensor).
    Returns ``(step, tx)``. Under an fp16 policy: the partial loss
    scaled, the grads unscaled after they combine, one finite check over
    every rank, the update skipped on overflow, the scale adjusted."""
    from apex1_tpu_torch.core import loss_scale as ls
    from apex1_tpu_torch.optim import apply_updates
    mesh = _mesh(cfg, mesh)
    tx = _make_tx(cfg)
    scaler = _make_scaler(cfg)
    tables = {}

    def train_step(state, tokens, labels):
        params = state["params"]
        dev = next(iter(params.values())).device
        if dev not in tables:
            tables[dev] = rope_for(cfg, dev)
        loss, grads = loss_and_grads(
            cfg, params, tokens, labels, mesh=mesh, tables=tables[dev],
            scale=None if scaler is None else state["scale"].scale)
        if scaler is not None:
            grads = scaler.unscale(grads, state["scale"])
            finite = ls.all_finite(grads).to(torch.int32)
            if dist.get_world_size() > 1:
                finite = mp.all_reduce(finite, None, dist.ReduceOp.MIN)
            finite = finite.bool()
        updates, new_opt = tx.update(grads, state["opt"], params)
        new_params = apply_updates(params, updates)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt": new_opt}
        if scaler is not None:
            new_state["params"] = ls.select_tree(finite, new_params, params)
            new_state["opt"] = ls.select_tree(finite, new_opt, state["opt"])
            new_state["scale"] = scaler.adjust(state["scale"], finite)
        return new_state, loss

    return train_step, tx


def make_train_step(cfg: Llama3DConfig, mesh=None, params=None,
                    device=None, seed: int = 0):
    """Returns ``(step, state, data_spec)``: `build_step`'s step and this
    rank's initial state (fused Adam on fp32 masters) from the global
    ``params`` ``{"chunk", "shared"}`` (e.g. `from_llama_params`), or
    from `init_params(cfg, seed)`."""
    mesh = _mesh(cfg, mesh)
    step, _ = build_step(cfg, mesh)
    if params is None:
        chunk, shared = init_params(cfg, seed, device)
    else:
        chunk, shared = params["chunk"], params["shared"]
    state = state_template(cfg, shard_params(chunk, shared, cfg, mesh))
    return step, state, DATA_SPEC
