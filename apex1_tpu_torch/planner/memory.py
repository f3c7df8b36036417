"""Analytic per-device memory model: the planner's pre-filter (the port
of ``apex1_tpu/planner/memory.py``, the same formulas and messages).

Two memory checks gate a layout, at very different prices:

1. THIS module: a closed-form byte count over the layout's shards,
   microseconds a candidate, run before anything is built. It is a
   GATING model: coarse and monotone in the degrees.
2. `step_memory_analysis`: the peak ``torch.cuda.max_memory_allocated``
   of one step of the plan's `models.llama_3d` on the card, the truth
   this module approximates; run for a pick, never inside the search.

Accounting (fp32-master training, the O2 recipe: fused Adam on fp32
masters, bf16 compute):

- weights: 4 B/param of the device's shard (layer products /tp,
  experts /ep, the stack /pp; norms and router replicated over tp;
  emb/head /tp);
- grads: 4 B/param, the same shards;
- optimizer: 8 B/param (two Adam moments), divided by dp when the
  layout's ``zero`` flag shards the update;
- activations: the remat pipeline keeps (a) the microbatch boundary
  stack, M x (S/(cp*tp)) x mb x E in fp32 through the backward, and (b)
  one layer's recompute working set at the gathered sequence width
  (S/cp) in bf16;
- data: the (M, S/cp, mb) int32 token and label shards.

The capability row's ``hbm_reserve_bytes`` is subtracted from its
``hbm_bytes``: on an H100 the bytes the CUDA context and the kernel
library hold (measured, `measure_hbm_reserve`).
"""

from __future__ import annotations

from typing import Optional

from apex1_tpu_torch.planner.layouts import Layout, ModelShape


def budget_bytes(generation: Optional[str] = None) -> int:
    """Usable device memory for planning at a capability row."""
    from apex1_tpu_torch.core.capability import get_capability

    cap = get_capability(generation)
    return cap.hbm_bytes - cap.hbm_reserve_bytes


def param_counts(shape: ModelShape) -> dict:
    """Global parameter counts by sharding class."""
    E, F = shape.hidden_size, shape.ffn_size
    HD = shape.num_heads * shape.head_dim
    KD = shape.num_kv_heads * shape.head_dim
    attn = E * HD * 2 + E * KD * 2          # wq + wo, wk + wv
    if shape.moe:
        dense_mlp = 0
        router = E * shape.num_experts
        experts = shape.num_experts * 2 * E * F   # w_moe1 + w_moe2
    else:
        dense_mlp = 3 * E * F               # gate, up, down
        router = 0
        experts = 0
    norms = 2 * E
    shared = 2 * shape.vocab_size * E + E   # emb, head, final_norm
    return dict(
        layer_tp_sharded=attn + dense_mlp,  # col/row shards over tp
        layer_replicated=norms + router,    # tp-replicated
        layer_ep_sharded=experts,           # expert stacks over ep
        shared_tp_sharded=2 * shape.vocab_size * E,
        shared_replicated=E,
        total=(shape.num_layers
               * (attn + dense_mlp + norms + router + experts)
               + shared))


def params_per_device(shape: ModelShape, layout: Layout) -> float:
    c = param_counts(shape)
    per_layer = (c["layer_tp_sharded"] / layout.tp
                 + c["layer_replicated"]
                 + c["layer_ep_sharded"] / layout.ep)
    return (shape.num_layers / layout.pp * per_layer
            + c["shared_tp_sharded"] / layout.tp
            + c["shared_replicated"])


def hbm_breakdown(shape: ModelShape, layout: Layout,
                  generation: Optional[str] = None) -> dict:
    """Per-device memory bytes by component, and the budget verdict."""
    p_dev = params_per_device(shape, layout)
    weights = 4.0 * p_dev
    grads = 4.0 * p_dev
    opt = 8.0 * p_dev / (layout.dp if layout.zero else 1)

    S_sp = shape.seq_len // (layout.cp * layout.tp)   # SP-region rows
    S_cp = shape.seq_len // layout.cp                 # gathered rows
    mb = layout.microbatch_size
    M = layout.num_microbatches
    E, F = shape.hidden_size, shape.ffn_size
    F_eff = F * (shape.moe_top_k if shape.moe else 1)
    Hl = max(1, shape.num_heads // layout.tp)
    # boundary stack (fp32 through the backward) + one layer's recompute
    # working set at the gathered width: residual in/out + qkv/attn io +
    # mlp hidden
    acts = (M * S_sp * mb * E * 4.0
            + S_cp * mb * (4 * E + 2 * F_eff
                           + 4 * Hl * shape.head_dim) * 2.0)
    data = 2.0 * M * S_cp * mb * 4.0                  # tokens + labels
    total = weights + grads + opt + acts + data
    budget = budget_bytes(generation)
    return dict(weights=weights, grads=grads, opt=opt, acts=acts,
                data=data, total=total, budget=float(budget),
                fits=total <= budget)


def fit_check(shape: ModelShape, layout: Layout,
              generation: Optional[str] = None) -> Optional[str]:
    """None when the layout fits the per-device budget; otherwise the
    rejection message WITH the sizing stated."""
    from apex1_tpu_torch.core.capability import default_generation

    b = hbm_breakdown(shape, layout, generation)
    if b["fits"]:
        return None
    gib = 2.0 ** 30
    return (f"hbm-fit: needs {b['total'] / gib:.2f} GiB/chip > "
            f"{b['budget'] / gib:.2f} GiB usable "
            f"({generation or default_generation()}) — weights "
            f"{b['weights'] / gib:.2f} + grads {b['grads'] / gib:.2f} "
            f"+ opt {b['opt'] / gib:.2f} + acts {b['acts'] / gib:.2f} "
            f"+ data {b['data'] / gib:.2f} GiB at layout "
            f"{layout.mesh_str()}")


def measure_hbm_reserve(device=None) -> dict:
    """The memory a card holds back before any tensor: loads the CUDA
    context and the kernel library (`ops._build.library`), then reads
    ``torch.cuda.mem_get_info``. ``reserve`` is the row's ``hbm_bytes``
    less what PyTorch's allocator could still get (free plus what it
    caches). Needs a card."""
    import torch

    from apex1_tpu_torch.core.capability import get_capability
    from apex1_tpu_torch.ops import _build

    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        raise ValueError(f"measure_hbm_reserve reads a card, got {dev}")
    torch.zeros(1, device=dev)
    _build.library()
    torch.cuda.synchronize(dev)
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev)
    cap = get_capability()
    return dict(total=int(total), free=int(free), cached=int(cached),
                reserve=int(cap.hbm_bytes - (free + cached)),
                row=cap.generation, row_reserve=cap.hbm_reserve_bytes)


def step_memory_analysis(cfg, mesh=None, *, device=None,
                         seed: int = 0) -> dict:
    """The truth the analytic model approximates: the peak
    ``torch.cuda.max_memory_allocated`` over one train step of
    `models.llama_3d` at ``cfg`` (`make_train_step` from
    `init_params(cfg, seed)`, a batch of zeros), with the train state's
    own bytes beside it, on ``mesh`` or `parallel_state`'s (a process
    group must exist). Eager PyTorch has no compile-only memory
    analysis, so this stands where the JAX package's
    ``aot_memory_analysis`` lowers and compiles the step: it runs one.
    Needs a card."""
    import torch

    from apex1_tpu_torch.core.pytree import tree_flatten_with_path
    from apex1_tpu_torch.models import llama_3d as L3
    from apex1_tpu_torch.ops._common import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"step_memory_analysis reads a card, got {dev}")
    step, state, _ = L3.make_train_step(cfg, mesh, device=dev, seed=seed)
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_flatten_with_path(state)
                      if isinstance(t, torch.Tensor))
    m = cfg.model
    data = torch.zeros((cfg.num_microbatches, m.max_seq_len,
                        cfg.microbatch_size * cfg.dp * cfg.ep),
                       dtype=torch.int64, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state, loss = step(state, data, data)
    torch.cuda.synchronize(dev)
    return dict(peak_bytes=int(torch.cuda.max_memory_allocated(dev)),
                state_bytes=int(state_bytes), loss=float(loss))

