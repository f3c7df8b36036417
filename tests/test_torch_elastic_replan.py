"""The port's elastic re-plan onto another device count, on the CPU.

One run of `resilience.elastic.drill` (shared by the tests below): the
drill's tiny `models.llama_3d` (4 layers, hidden 64, GQA 4/2, vocab 128,
S 32, global batch 8) at O0 trains under `planner.make_plan`'s layout
for 4 gloo ranks and dies after a seed-keyed number of committed
checkpoints; 2 fresh gloo ranks resume it through `elastic_resume`
(re-planned by the planner, resharded, manifest-verified) beside a
control. Held here:

- both plans equal the JAX package's ``make_plan`` for the same shape
  and counts, priced at the same h100 row (injected into the JAX
  package's table in this test only) without a calibration table;
- the reshard report: every chunk leaf of params and both moments
  restacked, conserved;
- the resumed losses equal the control's bit for bit;
- step 1's loss within 1e-5 of the JAX package's flat Llama on the same
  weights and batch (the pattern of tests/test_torch_elastic.py);
- the spine events are the JAX drill's five, the re-plan's generation
  named with where it came from.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from apex1_tpu import planner as jplanner
from apex1_tpu.core import capability as jax_cap
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.llama import Llama as JaxLlama
from apex1_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex1_tpu.ops import softmax_cross_entropy_loss
from apex1_tpu.planner import memory as jax_memory
from apex1_tpu_torch.core import capability as cap
from apex1_tpu_torch.interop import flax_from_named
from apex1_tpu_torch.models import llama_3d as L3
from apex1_tpu_torch.obs import calibrate
from apex1_tpu_torch.resilience import elastic

SEED = 20260804
#: the names the JAX drill requires of the spine
#: (apex1_tpu/resilience/elastic.py's phase 4)
JAX_EVENTS = ("elastic.detect", "elastic.replan", "elastic.reshard",
              "elastic.verify", "elastic.resume")


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    return elastic.drill(4, 2, seed=SEED, level="O0",
                         work_dir=str(tmp_path_factory.mktemp("drill")),
                         verbose=False)


def _jax_plan(monkeypatch, n):
    """The JAX package's ``make_plan`` of the drill's shape on ``n``
    devices at the port's h100 row."""
    row = cap.get_capability("h100")
    monkeypatch.setitem(jax_cap._TABLE, "h100", jax_cap.TpuCapability(
        "h100", (128, 128), 2 * row.smem_block_bytes, row.hbm_bytes,
        row.hbm_gbps, row.bf16_tflops, 1, 1, True, False,
        2 * row.link_gbps))
    monkeypatch.setattr(jax_memory, "HBM_RESERVE_BYTES",
                        row.hbm_reserve_bytes)
    shape, *_ = elastic._drill_fixture(SEED, "O0")
    return jplanner.make_plan(
        jplanner.ModelShape(**dataclasses.asdict(shape)), n,
        generation="h100", results_dir=calibrate.default_results_dir(),
        allow_zero=False, require_zero=False)


def _as_jax(plan: dict) -> dict:
    """The port's plan in the JAX planner's words: the binding side's
    name and the platform the kernel factor was looked up for."""
    pr = dict(plan["predicted"])
    pr["bound"] = {"tensor": "MXU", "HBM": "HBM", "link": "ICI"}[pr["bound"]]
    pr["sp_kernel"] = dict(pr["sp_kernel"], source=pr["sp_kernel"][
        "source"].replace("no gpu kernel", "no tpu kernel"))
    return dict(plan, predicted=pr)


def test_both_plans_are_the_jax_planners(drill, monkeypatch):
    assert (drill["n_from"], drill["n_to"]) == (4, 2)
    for plan, n in ((drill["plan_from"], 4), (drill["plan_to"], 2)):
        assert plan["generation"] == "h100"
        assert _as_jax(plan) == _jax_plan(monkeypatch, n)
    assert drill["old_mesh"] == "dp1 pp4 cp1 ep1 tp1 /4"
    assert drill["new_mesh"] == "dp1 pp2 cp1 ep1 tp1 /2"


def test_reshard_restacks_every_chunk_leaf(drill):
    _shape, cfg_of, _t, _b = elastic._drill_fixture(SEED, "O0")
    n_chunk = len(L3._layer_leaf_shapes(cfg_of(drill["plan_to"])))
    # params, exp_avg and exp_avg_sq: the chunk stack (1, 4, 1) -> (1, 2, 2)
    assert drill["n_restacked"] == 3 * n_chunk
    assert drill["n_leaves"] == 3 * (n_chunk + 3) + 2   # + shared, steps
    assert drill["conserved"] is True


def test_resumed_losses_equal_the_control(drill):
    assert drill["losses"] == drill["losses_control"]
    assert len(drill["losses"]) == 6 - drill["kill_step"] > 0
    assert np.isfinite(drill["losses"]).all()


def test_step_one_loss_is_the_jax_flat_llamas(drill):
    """Phase 1's first loss (4 ranks, pp 4) against the JAX package's flat
    Llama at O0 on `init_params(cfg, 0)`'s weights and batch 0."""
    _shape, cfg_of, _t, batch_at = elastic._drill_fixture(SEED, "O0")
    cfg = cfg_of(drill["plan_from"])
    chunk, shared = L3.init_params(cfg, 0, "cpu")
    L = cfg.model.num_layers
    named = {f"layer{i}.{k}": v.reshape((L,) + tuple(v.shape[3:]))[i]
             for k, v in chunk.items() for i in range(L)}
    named.update(tok_embeddings=shared["emb"], output=shared["head"],
                 norm=shared["final_norm"])
    flat = flax_from_named(named)
    m = cfg.model
    model = JaxLlama(JaxLlamaConfig.tiny(
        num_layers=L, max_seq_len=m.max_seq_len, vocab_size=m.vocab_size,
        num_heads=m.num_heads, num_kv_heads=m.num_kv_heads,
        hidden_size=m.hidden_size, ffn_size=m.ffn_size,
        policy=jax_get_policy("O0")))
    tok, lbl = (x.numpy() for x in batch_at(0, cfg, "cpu"))
    want = float(jnp.mean(jnp.stack([softmax_cross_entropy_loss(
        model.apply({"params": flat}, jnp.asarray(t.T)).astype(jnp.float32),
        jnp.asarray(y.T)) for t, y in zip(tok, lbl)])))
    np.testing.assert_allclose(drill["losses_from"][0], want, rtol=1e-5)


def test_spine_events_are_the_jax_drills(drill):
    assert elastic.EPISODE_EVENTS == JAX_EVENTS
    assert drill["events"] == sorted(JAX_EVENTS)
    ev = drill["replan_event"]
    assert (ev["generation"], ev["generation_source"]) == \
        ("h100", "the checkpoint's plan")
    assert ev["new_spec"]["n_devices"] == 2 and \
        ev["old_spec"]["n_devices"] == 4


def test_replan_generation_of_a_jax_written_plan():
    gen, why = elastic._replan_generation({"generation": "v5e"}, None)
    assert gen == "h100" and "'v5e'" in why and "detected card" in why
    assert elastic._replan_generation({"generation": "h100"}, None) == \
        ("h100", "the checkpoint's plan")
    assert elastic._replan_generation({"generation": "v5e"}, "h100") == \
        ("h100", "stated by the caller")


def test_drill_refuses_a_multi_rank_leg_on_the_card():
    with pytest.raises(ValueError, match="gloo ranks of the CPU"):
        elastic.drill(4, 2, device="cuda")
