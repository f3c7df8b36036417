"""The layout cost engine (the port of ``apex1_tpu/planner/cost.py``):
analytic step pricing, corrected by banked measurements of the same
card.

Prices one (ModelShape, Layout) pair in milliseconds an optimizer step:

- compute and memory terms ride `perf_model.roofline` at the
  capability row's peaks (the tensor cores' dense bf16 rate, HBM);
- attention flops come from `perf_model.flash_flops_bytes` (the port's
  two-pass backward, 7 products), the LM-head cross-entropy from
  `perf_model.linear_xent_flops`;
- link terms come from `perf_model.sp_boundary_comms` (the
  sequence-parallel boundary at the layout's own shard shape, exposed
  by its ``sp_mode``) and `perf_model.ring_attention_comms` (the cp
  ring), plus the gradient all-reduce over the data replicas
  (`perf_model.allreduce_bytes`), all at the row's per-peer link rate;
- the pipeline bubble multiplies the step by (M + pp - 1) / M;
- CALIBRATION: the analytic time is multiplied by the banked slowdown
  of the SAME generation (`obs.calibrate.table_for`): the shape's own
  step factor, else the geometric mean of the banked step factors
  (``fleet-geomean``), else 1.0 labelled ``uncalibrated``. A table
  fitted for another chip is refused and the price labelled
  ``uncalibrated (table is for <chip>)``. cpu-proxy factors are never
  applied.

The default generation is the detected card (h100 with no card).
"""

from __future__ import annotations

import math
from typing import Optional

from apex1_tpu_torch.core.capability import (default_generation,
                                             get_capability)
from apex1_tpu_torch.perf_model import (allreduce_bytes, flash_flops_bytes,
                                        linear_xent_flops,
                                        ring_attention_comms, roofline,
                                        sp_boundary_comms)
from apex1_tpu_torch.planner import memory
from apex1_tpu_torch.planner.layouts import Layout, ModelShape

DTYPE_BYTES = 2   # bf16 compute


def step_flops(shape: ModelShape) -> dict:
    """Global forward and backward flops an optimizer step, by
    component: dense products 2*M*N*K forward, x3 with the backward (dX,
    dW); flash attention its own x4.5; the fused LM-head cross-entropy
    6*T*E*V."""
    E, F, V = shape.hidden_size, shape.ffn_size, shape.vocab_size
    HD = shape.num_heads * shape.head_dim
    KD = shape.num_kv_heads * shape.head_dim
    T = shape.tokens_per_step
    qkvo = 2.0 * T * (E * HD + 2 * E * KD + HD * E)
    if shape.moe:
        mlp = (2.0 * T * E * shape.num_experts          # router
               + shape.moe_top_k * 4.0 * T * E * F)     # w1 + w2
    else:
        mlp = 6.0 * T * E * F                           # gate, up, down
    linear = shape.num_layers * (qkvo + mlp) * 3.0      # fwd+bwd
    attn_f, _ = flash_flops_bytes(shape.global_batch, shape.num_heads,
                                  shape.num_kv_heads, shape.seq_len,
                                  shape.head_dim, causal=True,
                                  grad=True)
    attn = shape.num_layers * attn_f
    ce = float(linear_xent_flops(T, E, V))
    return dict(linear=linear, attn=attn, ce=ce,
                total=linear + attn + ce)


def _sp_exposed_bytes(shape: ModelShape, layout: Layout,
                      generation: str) -> float:
    """A device's exposed link bytes from the sequence-parallel
    boundaries of ONE step: a layer's 2 all-gathers and 2
    reduce-scatters forward, the mirrored duals backward, each priced
    at the layout's shard shape and exposed by its sp_mode."""
    if layout.tp < 2:
        return 0.0
    rows = (shape.seq_len // layout.cp) * layout.microbatch_size
    E, F = shape.hidden_size, shape.ffn_size
    HD = shape.num_heads * shape.head_dim
    KD = shape.num_kv_heads * shape.head_dim
    key = f"exposed_{layout.sp_mode}"
    boundaries = (
        # (local K of the chunk product, out width, acc bytes, hop
        # width): an all-gather hops the bf16 INPUT activation (width
        # E), a reduce-scatter the fp32 partial result (hop_width None)
        (E, (HD + 2 * KD) // layout.tp, DTYPE_BYTES, E),   # qkv AG
        (HD // layout.tp, E, 4, None),                      # wo RS
        (E, 2 * F // layout.tp, DTYPE_BYTES, E),           # gate+up AG
        (F // layout.tp, E, 4, None),                       # down RS
    )
    per_layer = 0.0
    for local_k, out_w, acc, hop_w in boundaries:
        m = sp_boundary_comms(generation, layout.tp, rows=rows,
                              local_k=max(1, local_k),
                              out_width=max(1, out_w), acc_bytes=acc,
                              hop_width=hop_w)
        if m is None:
            return 0.0
        per_layer += m[key]
    layers_dev = shape.num_layers / layout.pp
    # the backward mirrors every boundary through the dual collective
    return per_layer * 2.0 * layers_dev * layout.num_microbatches


def _cp_exposed_bytes(shape: ModelShape, layout: Layout,
                      generation: str) -> float:
    """A device's exposed link bytes from the ring-attention cp axis
    (the double-buffered schedule: only the per-hop residual the attend
    cannot cover)."""
    if layout.cp < 2:
        return 0.0
    m = ring_attention_comms(
        generation, layout.cp, B=layout.microbatch_size,
        Hq=max(1, shape.num_heads // layout.tp),
        Hkv=max(1, shape.num_kv_heads // layout.tp),
        S=shape.seq_len, D=shape.head_dim)
    if m is None:
        return 0.0
    per_layer = m["exp_f_overlap"] + m["exp_b_overlap"]
    return (per_layer * (shape.num_layers / layout.pp)
            * layout.num_microbatches)


def _dp_exposed_bytes(shape: ModelShape, layout: Layout) -> float:
    """Gradient-sync bytes a device: fp32 grads ring-all-reduced over
    the data replicas (dp x ep x cp); the ZeRO split moves the same."""
    replicas = layout.dp * layout.ep * layout.cp
    grad_bytes = 4.0 * memory.params_per_device(shape, layout)
    return allreduce_bytes(grad_bytes, replicas)


def _pp_exposed_bytes(shape: ModelShape, layout: Layout) -> float:
    """Pipeline boundary p2p: one SP-sharded boundary activation a
    microbatch a stage boundary, forward and backward."""
    if layout.pp < 2:
        return 0.0
    act = (shape.seq_len // (layout.cp * layout.tp)
           * layout.microbatch_size * shape.hidden_size * DTYPE_BYTES)
    return (2.0 * layout.num_microbatches * act
            * (layout.pp - 1) / layout.pp)


def _hbm_bytes_per_device(shape: ModelShape, layout: Layout) -> float:
    """First-order memory traffic a device a step: the stage weights
    re-streamed a microbatch (forward + 2x backward), the optimizer's
    fp32 read-modify-write, and the residual stream's activations."""
    p_dev = memory.params_per_device(shape, layout)
    weight_stream = (p_dev * DTYPE_BYTES * 3.0
                     * layout.num_microbatches)
    opt_rw = 28.0 * p_dev   # m/v/master read+write + grad read
    tok_dev = (shape.tokens_per_step
               / (layout.dp * layout.ep * layout.cp))
    act_stream = (tok_dev * shape.hidden_size * DTYPE_BYTES
                  * (shape.num_layers / layout.pp) * 12.0 / layout.tp)
    return weight_stream + opt_rw + act_stream


def calibration_factor(shape: ModelShape,
                       results_dir: Optional[str] = None,
                       generation: Optional[str] = None) -> dict:
    """The banked slowdown to apply to this shape's analytic price at
    ``generation``: the shape's own step factor (``step:<shape.name>``),
    else the geometric mean of every banked step factor, else 1.0. The
    source string rides into the plan. A table fitted for another chip
    is refused."""
    from apex1_tpu_torch.obs.calibrate import table_for

    gen = generation or default_generation()
    doc, refused = table_for(gen, results_dir)
    if doc is None:
        return dict(slowdown=1.0, source=(
            f"uncalibrated ({refused})" if refused
            else "uncalibrated (no banked calibration.json)"))
    f = doc.get("factors", {}).get(f"step:{shape.name}")
    if isinstance(f, dict) and isinstance(f.get("slowdown"),
                                          (int, float)) \
            and f["slowdown"] > 0:
        return dict(slowdown=float(f["slowdown"]),
                    source=f"step:{shape.name} (n={f.get('n')}, "
                           f"banked calibration.json)")
    steps = [v["slowdown"] for k, v in
             sorted(doc.get("factors", {}).items())
             if k.startswith("step:") and isinstance(v, dict)
             and isinstance(v.get("slowdown"), (int, float))
             and v["slowdown"] > 0]
    if steps:
        geo = math.exp(sum(math.log(s) for s in steps) / len(steps))
        return dict(slowdown=geo,
                    source=f"fleet-geomean over {len(steps)} banked "
                           f"{get_capability(gen).platform} step factors")
    return dict(slowdown=1.0, source=(
        f"uncalibrated (no {get_capability(gen).platform} step factors banked)"))


def _sp_kernel_factor(layout: Layout,
                      results_dir: Optional[str] = None,
                      generation: Optional[str] = None) -> dict:
    """The banked kernel slowdown of the SP-boundary schedule the layout
    selected: only the fused schedule runs a kernel of its own
    (``fused_collective_matmul``, the port's ``csrc/chunk_matmul.cu``),
    the others are collectives and products the step factor covers."""
    from apex1_tpu_torch.obs.calibrate import kernel_slowdown

    gen = generation or default_generation()
    f = (kernel_slowdown("fused_collective_matmul", results_dir, gen)
         if (layout.tp > 1 and layout.sp_mode == "fused") else None)
    if isinstance(f, dict) and isinstance(f.get("slowdown"),
                                          (int, float)):
        return dict(slowdown=float(f["slowdown"]),
                    source=f"kernel:fused_collective_matmul (banked "
                           f"{get_capability(gen).platform} A/B)")
    return dict(slowdown=1.0, source=f"analytic (no {get_capability(gen).platform} "
                "kernel factor banked for the SP boundary)")


def price_layout(shape: ModelShape, layout: Layout, *,
                 generation: Optional[str] = None,
                 results_dir: Optional[str] = None,
                 use_calibration: bool = True,
                 calibration: Optional[dict] = None,
                 sp_kernel: Optional[dict] = None) -> dict:
    """Milliseconds an optimizer step for one layout, with the full
    breakdown and the calibration's provenance. Deterministic: the same
    inputs (and the same banked table) give identical floats.

    ``calibration`` / ``sp_kernel``: precomputed factor docs
    (`calibration_factor` / `_sp_kernel_factor`), constant across one
    search, so `search.search_layouts` reads the table once."""
    gen = generation or default_generation()
    cap = get_capability(gen)
    fl = step_flops(shape)
    shard = layout.dp * layout.ep * layout.cp * layout.tp
    # a device's compute: an equal stage slice of the layer stack, plus
    # the LM-head cross-entropy on the LAST stage (the critical one)
    flops_dev = ((fl["linear"] + fl["attn"]) / (shard * layout.pp)
                 + fl["ce"] / shard)
    bytes_dev = _hbm_bytes_per_device(shape, layout)
    sp = _sp_exposed_bytes(shape, layout, gen)
    cp = _cp_exposed_bytes(shape, layout, gen)
    dp = _dp_exposed_bytes(shape, layout)
    pp = _pp_exposed_bytes(shape, layout)
    kf = (sp_kernel if sp_kernel is not None
          else _sp_kernel_factor(layout, results_dir, gen))
    exposed = sp * kf["slowdown"] + cp + dp + pp
    t, bound, mfu = roofline(flops_dev, bytes_dev, cap,
                             exposed_bytes=exposed)
    bubble = ((layout.num_microbatches + layout.pp - 1)
              / layout.num_microbatches)
    step_ms = t * bubble * 1e3
    cal = (dict(slowdown=1.0, source="calibration disabled")
           if not use_calibration
           else calibration if calibration is not None
           else calibration_factor(shape, results_dir, gen))
    calibrated_ms = step_ms * cal["slowdown"]
    tok_rate = (shape.tokens_per_step / (calibrated_ms * 1e-3)
                / layout.n_devices) if calibrated_ms > 0 else 0.0
    return dict(
        step_ms=step_ms, calibrated_step_ms=calibrated_ms,
        tokens_per_sec_per_chip=tok_rate,
        bound=bound, mfu=mfu, bubble_factor=bubble,
        flops_per_device=flops_dev, hbm_bytes_per_device=bytes_dev,
        # the plan schema's key (``apex1-plan-v1``, shared with the JAX
        # planner): link bytes not hidden behind compute
        ici_exposed_bytes=dict(sp_boundary=sp, cp_ring=cp,
                               dp_gradsync=dp, pp_p2p=pp),
        calibration=cal, sp_kernel=kf, generation=gen)
