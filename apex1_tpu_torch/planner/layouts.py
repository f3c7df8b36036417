"""Layout search space: model shapes, parallel layouts, legality rules
(the port of ``apex1_tpu/planner/layouts.py``, which imports only the
standard library; this copy is the port's own).

The first questions a parallel configuration must answer are discrete:
does dp x pp x cp x ep x tp cover the devices, do the TP shards divide
the heads and the vocab, do the pipeline stages balance, does the
microbatch schedule feed the pipeline. `models.llama_3d.Llama3DConfig`
raises them one at a time at construction; here they are a predicate
over data (:func:`check_layout` returns the violated rules by name), so
the enumerator, an example's argument check and the tests consult one
source. The rule names (``device-product``, ``axis-positive``,
``sp-mode``, ``tp-heads``, ``tp-vocab``, ``sp-seq``, ``pp-stages``,
``pp-layers``, ``pp-microbatches``, ``dp-batch``, ``ep-moe``,
``ep-experts``, ``zero-dp``) are the model stack's rules and the JAX
package's, rule for rule.

The five mesh axes mirror ``core.mesh.MESH_AXES`` (dp, pp, cp, ep, tp;
fsdp is the ``zero`` flag: optimizer-state sharding over the dp axis,
``parallel.distributed_optimizer.shard_opt_state_specs``). ``sp_mode``
names which schedule runs each sequence-parallel boundary product.
Pricing, memory, search and emission are the sibling modules ``cost``,
``memory``, ``search`` and ``emit``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

SP_MODES = ("serial", "overlap", "fused")


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The planner's view of a transformer training job: every number
    the legality rules (and the JAX package's cost and memory models)
    need, and nothing that requires importing a model class."""

    name: str                  # the model's name (a plan's key)
    num_layers: int
    hidden_size: int
    ffn_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    seq_len: int
    global_batch: int          # sequences per optimizer step (global)
    num_experts: int = 0       # 0 = dense FFN everywhere
    moe_top_k: int = 2

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @property
    def tokens_per_step(self) -> int:
        return self.global_batch * self.seq_len

    @classmethod
    def from_llama(cls, cfg, *, global_batch: int,
                   name: str = "llama") -> "ModelShape":
        """Duck-typed bridge from a `models.llama.LlamaConfig`-shaped
        object (reads attributes only: no model import)."""
        experts = (int(cfg.num_experts)
                   if getattr(cfg, "moe_every", 0) else 0)
        return cls(name=name, num_layers=cfg.num_layers,
                   hidden_size=cfg.hidden_size, ffn_size=cfg.ffn_size,
                   num_heads=cfg.num_heads,
                   num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.hidden_size // cfg.num_heads,
                   vocab_size=cfg.vocab_size, seq_len=cfg.max_seq_len,
                   global_batch=global_batch, num_experts=experts,
                   moe_top_k=getattr(cfg, "moe_top_k", 2))


#: The bench shapes the JAX package's planner prices, the same dims:
#: GPT-2 124M at B 16 x 1024, the 16-layer 0.8B Llama at 16k tokens
#: (`bench.py`'s ``llama_longctx``) and Llama-3-8B at global batch 8.
BANKED_SHAPES = {
    "gpt2": ModelShape(
        name="gpt2", num_layers=12, hidden_size=768, ffn_size=3072,
        num_heads=12, num_kv_heads=12, head_dim=64, vocab_size=50432,
        seq_len=1024, global_batch=16),
    "llama_longctx": ModelShape(
        name="llama_longctx", num_layers=16, hidden_size=2048,
        ffn_size=5632, num_heads=32, num_kv_heads=4, head_dim=64,
        vocab_size=32000, seq_len=16384, global_batch=1),
    "llama8b": ModelShape(
        name="llama8b", num_layers=32, hidden_size=4096,
        ffn_size=14336, num_heads=32, num_kv_heads=8, head_dim=128,
        vocab_size=128256, seq_len=8192, global_batch=8),
}


@dataclasses.dataclass(frozen=True)
class Layout:
    """One point of the search space: the five mesh degrees + the
    schedule/kernel knobs the cost model prices."""

    dp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    tp: int = 1
    num_microbatches: int = 1
    microbatch_size: int = 1
    zero: bool = False         # ZeRO-1: opt state sharded over dp
    sp_mode: str = "overlap"   # SP-boundary schedule (SP_MODES)
    num_chunks: int = 1
    schedule: str = "scan"

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.cp * self.ep * self.tp

    def sort_key(self):
        """Deterministic total order — the tie-break rule for equal
        prices, so the same inputs always produce the same plan."""
        return (self.tp, self.pp, self.cp, self.ep, self.dp,
                self.num_microbatches, self.zero,
                SP_MODES.index(self.sp_mode))

    def mesh_str(self) -> str:
        parts = [f"dp={self.dp}", f"pp={self.pp}", f"cp={self.cp}",
                 f"ep={self.ep}", f"tp={self.tp}"]
        knobs = [f"M={self.num_microbatches}"]
        if self.zero:
            knobs.append("zero")
        if self.tp > 1:
            knobs.append(f"sp={self.sp_mode}")
        return " ".join(parts) + " (" + " ".join(knobs) + ")"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken legality rule — ``rule`` is the stable machine name
    the tests and the examples' error messages key on."""

    rule: str
    message: str

    def __str__(self):
        return f"{self.rule}: {self.message}"


def check_layout(shape: ModelShape, layout: Layout,
                 n_devices: Optional[int] = None) -> list[Violation]:
    """Every legality rule the repo's 3D stack enforces (or assumes),
    evaluated together. Empty list = legal. The rule names are part of
    the contract (tests pin them; examples print them)."""
    v: list[Violation] = []
    add = v.append
    lay = layout

    if n_devices is not None and lay.n_devices != n_devices:
        add(Violation(
            "device-product",
            f"dp*pp*cp*ep*tp = {lay.n_devices} != {n_devices} devices"))
    for axis in ("dp", "pp", "cp", "ep", "tp"):
        if getattr(lay, axis) < 1:
            add(Violation("axis-positive",
                          f"{axis}={getattr(lay, axis)} must be >= 1"))
    if any(getattr(lay, a) < 1 for a in ("dp", "pp", "cp", "ep",
                                         "tp")):
        # every divisibility rule below would divide by the zero
        # axis — the axis-positive violations ARE the verdict; return
        # them instead of a ZeroDivisionError traceback
        return v
    if lay.sp_mode not in SP_MODES:
        add(Violation("sp-mode",
                      f"sp_mode={lay.sp_mode!r} not in {SP_MODES}"))
    if shape.num_heads % lay.tp or shape.num_kv_heads % lay.tp:
        add(Violation(
            "tp-heads",
            f"tp={lay.tp} must divide num_heads={shape.num_heads} and "
            f"num_kv_heads={shape.num_kv_heads} (TP shards attention "
            f"heads; models.llama_3d head-divisibility rule)"))
    if shape.vocab_size % lay.tp:
        add(Violation(
            "tp-vocab",
            f"tp={lay.tp} must divide vocab_size={shape.vocab_size} "
            f"(vocab-parallel embedding + fused LM-head CE shard the "
            f"vocab over tp)"))
    if shape.seq_len % (lay.tp * lay.cp):
        add(Violation(
            "sp-seq",
            f"tp*cp = {lay.tp * lay.cp} must divide "
            f"seq_len={shape.seq_len} (Megatron-SP + ring-attention "
            f"sequence shards)"))
    if lay.pp > shape.num_layers:
        add(Violation(
            "pp-stages",
            f"pp={lay.pp} exceeds num_layers={shape.num_layers} — a "
            f"stage would hold zero layers"))
    elif shape.num_layers % (lay.pp * lay.num_chunks):
        add(Violation(
            "pp-layers",
            f"pp*num_chunks = {lay.pp * lay.num_chunks} must divide "
            f"num_layers={shape.num_layers} (equal pipeline stage "
            f"balance)"))
    # M < pp is a bubble-efficiency disaster but RUNS (the scan
    # schedule accepts it — verified against Llama3DConfig), so it is
    # NOT a legality violation here; enumerate_layouts prunes it as
    # dominated instead. What Llama3DConfig actually refuses is the
    # interleaved schedule's microbatch constraints — mirror those:
    if lay.num_chunks > 1:
        if lay.num_microbatches < lay.pp:
            add(Violation(
                "pp-microbatches",
                f"interleaved pipeline (num_chunks="
                f"{lay.num_chunks}) needs num_microbatches >= pp, "
                f"got {lay.num_microbatches} < {lay.pp}"))
        if lay.schedule == "1f1b":
            if lay.num_microbatches % lay.pp:
                add(Violation(
                    "pp-microbatches",
                    f"interleaved 1F1B requires num_microbatches % "
                    f"pp == 0, got {lay.num_microbatches} % "
                    f"{lay.pp}"))
            if lay.pp < 2:
                add(Violation(
                    "pp-microbatches",
                    "interleaved 1F1B needs pipeline size >= 2"))
    data_replicas = lay.dp * lay.ep
    if shape.global_batch % data_replicas:
        add(Violation(
            "dp-batch",
            f"dp*ep = {data_replicas} must divide "
            f"global_batch={shape.global_batch} sequences"))
    elif (lay.num_microbatches * lay.microbatch_size * data_replicas
          != shape.global_batch):
        add(Violation(
            "dp-batch",
            f"num_microbatches*microbatch_size*dp*ep = "
            f"{lay.num_microbatches * lay.microbatch_size}"
            f"*{data_replicas} != global_batch={shape.global_batch}"))
    if lay.ep > 1 and not shape.moe:
        add(Violation(
            "ep-moe", f"ep={lay.ep} > 1 requires an MoE model "
            f"(num_experts=0 here)"))
    if shape.moe and shape.num_experts % lay.ep:
        add(Violation(
            "ep-experts",
            f"ep={lay.ep} must divide num_experts={shape.num_experts}"))
    if lay.zero and lay.dp < 2:
        add(Violation(
            "zero-dp",
            f"zero (ZeRO-1 optimizer sharding) needs dp >= 2, got "
            f"dp={lay.dp}"))
    return v


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_layouts(shape: ModelShape, n_devices: int, *,
                      allow_cp: bool = True,
                      allow_ep: Optional[bool] = None,
                      allow_zero: bool = True,
                      require_zero: Optional[bool] = None,
                      sp_modes: Sequence[str] = ("overlap", "fused"),
                      microbatch_size: int = 1
                      ) -> Iterator[Layout]:
    """Every LEGAL layout for ``shape`` on ``n_devices`` chips, in a
    deterministic order (sorted degree tuples — same inputs, same
    sequence; the plan-determinism test rides on this).

    ``num_microbatches`` is derived, not searched: with
    ``microbatch_size`` fixed, M = global_batch / (dp * ep) is the only
    value that covers the global batch — the schedule dimension the
    planner DOES search is the (dp x pp) trade this forces (more dp =
    fewer microbatches = worse pipeline fill).

    The knob dimensions are pruned where they are degenerate: ``zero``
    only when dp >= 2, ``sp_mode`` beyond the first only when tp >= 2
    (no SP boundary exists at tp=1) — otherwise the same physical
    config would be enumerated (and priced) twice.

    ``require_zero`` (None = don't care) filters to layouts whose
    ``zero`` flag MATCHES — the elastic-resume constraint: a
    checkpoint's optimizer-state tree structure is fixed, so a re-plan
    for a changed fleet must keep the ZeRO setting, not merely be
    allowed to (`resilience.elastic_resume` passes the source plan's
    setting here).
    """
    if allow_ep is None:
        allow_ep = shape.moe
    for tp in _divisors(n_devices):
        for pp in _divisors(n_devices // tp):
            rest2 = n_devices // (tp * pp)
            for cp in (_divisors(rest2) if allow_cp else (1,)):
                if rest2 % cp:
                    continue
                rest3 = rest2 // cp
                for ep in (_divisors(rest3) if allow_ep else (1,)):
                    if rest3 % ep:
                        continue
                    dp = rest3 // ep
                    mbs = shape.global_batch // (dp * ep) \
                        if shape.global_batch % (dp * ep) == 0 else 0
                    if mbs < 1 or mbs % microbatch_size:
                        continue
                    M = mbs // microbatch_size
                    if M < pp:
                        # runnable but dominated (bubble factor
                        # (M+pp-1)/M >= 2): pruned from the SEARCH,
                        # not outlawed by check_layout — hand flags
                        # may still pick it
                        continue
                    zeros = (False, True) if (allow_zero and dp >= 2) \
                        else (False,)
                    if require_zero is not None:
                        zeros = tuple(z for z in zeros
                                      if z == require_zero)
                        if not zeros:
                            continue
                    modes = tuple(sp_modes) if tp >= 2 \
                        else tuple(sp_modes[:1])
                    for zero in zeros:
                        for mode in modes:
                            lay = Layout(
                                dp=dp, pp=pp, cp=cp, ep=ep, tp=tp,
                                num_microbatches=M,
                                microbatch_size=microbatch_size,
                                zero=zero, sp_mode=mode)
                            if not check_layout(shape, lay, n_devices):
                                yield lay
