"""Plan emission: the winner as an EXECUTABLE spec (the port of
``apex1_tpu/planner/emit.py``).

A plan is a plain JSON document (schema ``apex1-plan-v1``, the JAX
planner's: a plan either package wrote drives the other) carrying what a
consumer needs to run the chosen layout:

- ``mesh``: the five axis degrees for `core.mesh.make_mesh`;
- ``partition_rules``: regex -> spec rules over ``/``-joined parameter
  paths (``chunk/wq``), consumed through `parallel.specs.specs_from_rules`
  and pinned by test to reproduce `models.llama_3d.chunk_param_specs` /
  ``shared_param_specs`` leaf for leaf;
- ``schedule``: microbatch count and size, chunks, scan or 1f1b;
- ``kernel_flags``: the SP-boundary schedule (``overlap`` / ``fused``);
- ``zero``: whether (and over which axis) the optimizer state shards;
- ``predicted`` / ``memory`` / ``search``: the pricing evidence.

DETERMINISM: `plan_json` is byte-identical for identical plans (sorted
keys, indent 1, no timestamps), and identical to the JAX package's for
equal plans.

A spec entry serialises as ``None`` -> null, an axis name -> string, a
multi-axis dimension -> list of strings.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from apex1_tpu_torch.planner.layouts import Layout, ModelShape
# the schema, the layout-identity keys and `plan_spec` live with the
# checkpoint reshard, which reads them without the planner
from apex1_tpu_torch.resilience.reshard import (PLAN_SCHEMA,  # noqa: F401
                                                PLAN_SPEC_KEYS, plan_spec)


# -- partition rules ---------------------------------------------------------

def spec_to_json(entries):
    return [list(e) if isinstance(e, (tuple, list)) else e
            for e in entries]


def spec_from_json(entries):
    from apex1_tpu_torch.parallel.specs import P

    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def partition_rules(moe: bool) -> list:
    """Regex -> spec-json rules for the llama_3d stacked parameter tree
    (paths ``chunk/<leaf>`` / ``shared/<leaf>``), first match wins:
    col-parallel stacks shard their last dimension over tp,
    row-parallel their second-to-last, expert stacks over ep, norms and
    router replicated beyond the pp stage axis, embedding/head rows over
    tp. The stacked chunk leaves carry the (chunk, pp, layer) prefix,
    hence the leading (None, pp, None)."""
    rules = [
        [r"chunk/(attn_norm|mlp_norm)$", [None, "pp", None, None]],
    ]
    if moe:
        rules += [
            [r"chunk/wg$", [None, "pp", None, None, None]],
            [r"chunk/(w_moe1|w_moe2)$",
             [None, "pp", None, "ep", None, None]],
        ]
    rules += [
        [r"chunk/(wq|wk|wv|w_gate|w_up)$",
         [None, "pp", None, None, "tp"]],
        [r"chunk/(wo|w_down)$", [None, "pp", None, "tp", None]],
        [r"shared/(emb|head)$", ["tp", None]],
        [r"shared/final_norm$", []],
    ]
    return rules


def rules_to_specs(rules):
    """``((regex, PartitionSpec), ...)`` ready for
    `parallel.specs.specs_from_rules`."""
    return tuple((pat, spec_from_json(spec)) for pat, spec in rules)


def plan_param_specs(plan: dict, params: dict) -> dict:
    """The spec of each parameter, from the PLAN's rules, in the shape
    of ``params``: a nested tree (``{"chunk": {"wq": ...}, "shared":
    {...}}``, `models.llama_3d.gather_state`'s) gives a nested dict, a
    flat one (``{"chunk.wq": ...}``, the port's names) a flat one. The
    rules match the ``/``-joined path either way (``chunk/wq``), so a
    plan the JAX package wrote drives the port unchanged."""
    from apex1_tpu_torch.parallel.specs import specs_from_rules

    rules = rules_to_specs(plan["partition_rules"]["rules"])
    default = spec_from_json(plan["partition_rules"]["default"])

    def spec(path: str):
        return specs_from_rules({path: None}, rules, default=default)[path]

    def walk(tree: dict, prefix: str) -> dict:
        return {name: walk(v, f"{prefix}{name}/") if isinstance(v, dict)
                else spec(f"{prefix}{name}".replace(".", "/"))
                for name, v in tree.items()}

    return walk(params, "")


# -- plan document -----------------------------------------------------------

def build_plan(shape: ModelShape, layout: Layout, price: dict,
               mem: dict, *, generation: str, search: dict,
               provenance: Optional[dict] = None) -> dict:
    gib = 2.0 ** 30
    return {
        "schema": PLAN_SCHEMA,
        "generation": generation,
        "n_devices": layout.n_devices,
        "model": dataclasses.asdict(shape),
        "mesh": {"dp": layout.dp, "pp": layout.pp, "cp": layout.cp,
                 "ep": layout.ep, "tp": layout.tp},
        "schedule": {"kind": layout.schedule,
                     "num_microbatches": layout.num_microbatches,
                     "microbatch_size": layout.microbatch_size,
                     "num_chunks": layout.num_chunks},
        "kernel_flags": {"sp_boundary": layout.sp_mode},
        "zero": {"enabled": layout.zero, "axis": "dp",
                 "consumer": "parallel.distributed_optimizer."
                             "shard_opt_state_specs"},
        "partition_rules": {"rules": partition_rules(shape.moe),
                            "default": []},
        "predicted": price,
        "memory": {k: round(v / gib, 4) if k != "fits" else v
                   for k, v in mem.items()},
        "search": search,
        "provenance": provenance or {},
    }


def plan_json(plan: dict) -> str:
    """THE serialisation: sorted keys, indent 1, trailing newline."""
    return json.dumps(plan, indent=1, sort_keys=True) + "\n"


def save_plan(plan: dict, path: str) -> str:
    from apex1_tpu_torch.resilience.manifest import atomic_write_text

    atomic_write_text(path, plan_json(plan))
    return path


def load_plan(path: str) -> dict:
    """Parse and schema-check a banked plan. Raises ValueError (never a
    raw traceback from a foreign file) on anything but a v1 plan."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(f"plan file unreadable: {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise ValueError(f"plan file is not JSON: {path}: {e}") from e
    if not isinstance(doc, dict) or doc.get("schema") != PLAN_SCHEMA:
        raise ValueError(
            f"not an {PLAN_SCHEMA} plan: {path} "
            f"(schema={doc.get('schema') if isinstance(doc, dict) else None!r})")
    return doc


#: the ModelShape dims a replayed plan must agree on before its schedule
#: and rules may drive a model (global_batch excluded: the plan's
#: schedule is the batch authority on replay)
PLAN_MODEL_KEYS = ("num_layers", "hidden_size", "ffn_size", "seq_len",
                   "vocab_size", "num_heads", "num_kv_heads",
                   "num_experts", "moe_top_k")


def check_plan_model(plan: dict, shape: ModelShape) -> list:
    """Mismatches between a plan's banked model dims and the model a
    consumer is about to drive with it (empty = safe to consume)."""
    pm = plan.get("model", {})
    return [f"{k}: plan={pm.get(k)} model={getattr(shape, k)}"
            for k in PLAN_MODEL_KEYS
            if pm.get(k) != getattr(shape, k)]


def model_shape_from_plan(plan: dict) -> ModelShape:
    """The banked model dims as a `ModelShape`: what `search.make_plan`
    needs to re-plan the SAME model for another device count."""
    pm = dict(plan["model"])
    fields = {f.name for f in dataclasses.fields(ModelShape)}
    unknown = set(pm) - fields
    if unknown or not set(pm) >= {"name", "num_layers"}:
        raise ValueError(
            f"plan model dims do not round-trip into ModelShape "
            f"(unknown keys {sorted(unknown)})")
    return ModelShape(**pm)


def layout_from_plan(plan: dict) -> Layout:
    m, s = plan["mesh"], plan["schedule"]
    return Layout(dp=m["dp"], pp=m["pp"], cp=m["cp"], ep=m["ep"],
                  tp=m["tp"],
                  num_microbatches=s["num_microbatches"],
                  microbatch_size=s["microbatch_size"],
                  num_chunks=s["num_chunks"], schedule=s["kind"],
                  zero=plan["zero"]["enabled"],
                  sp_mode=plan["kernel_flags"]["sp_boundary"])


def llama3d_config_from_plan(plan: dict, model_cfg,
                             learning_rate: float = 1e-4,
                             ignore_zero: bool = False):
    """The plan as a runnable `models.llama_3d.Llama3DConfig`.
    ``model_cfg`` is the `LlamaConfig` the plan's ModelShape came from
    (the plan carries dims, not the precision policy).

    A ``zero``-enabled plan is REFUSED by default: its memory verdict
    divided the optimizer state by dp, and Llama3DConfig runs the
    unsharded optimizer. Pass ``ignore_zero=True`` only when the
    unsharded optimizer fits. ``kernel_flags.sp_boundary`` is advisory
    here: llama_3d's stage runs its default mappings."""
    from apex1_tpu_torch.models.llama_3d import Llama3DConfig

    if plan.get("zero", {}).get("enabled") and not ignore_zero:
        raise ValueError(
            "plan has zero (ZeRO-1 optimizer sharding) enabled — its "
            "HBM fit assumed opt-state/dp, which Llama3DConfig does "
            "not implement; re-plan with allow_zero=False, or pass "
            "ignore_zero=True if the unsharded optimizer provably "
            "fits (consumer: parallel.distributed_optimizer)")
    lay = layout_from_plan(plan)
    moe = bool(plan["model"].get("num_experts", 0))
    return Llama3DConfig(
        model=model_cfg, dp=lay.dp, pp=lay.pp, tp=lay.tp, cp=lay.cp,
        ep=lay.ep, moe=moe, num_chunks=lay.num_chunks,
        num_microbatches=lay.num_microbatches,
        microbatch_size=lay.microbatch_size,
        learning_rate=learning_rate, schedule=lay.schedule)
