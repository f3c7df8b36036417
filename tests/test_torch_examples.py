"""The port's examples against the JAX package, on the CPU at tiny
sizes: `examples.gpt2_amp` (``--tiny``, O0, 5 steps through
`TokenDataset` and `PrefetchLoader`) against JAX's ``Amp`` step on the
same batches from the same weights (`models.gpt2.init_params`, the JAX
package's flax layout); its SIGTERM drill (exit 75, then ``--resume
auto`` giving the uninterrupted run's losses bit for bit) with the
spine file it banks; `examples.imagenet_amp` (``--tiny``, O0, 3 steps)
against JAX's ``shard_map`` step on one CPU device from JAX's weights
(`interop.resnet_params_from_jax`). The data-parallel runs over ranks
are in test_torch_examples_ranks.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import apex1_tpu.runtime as jrt
from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.gpt2 import GPT2 as JaxGPT2
from apex1_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from apex1_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from apex1_tpu.models.resnet import ResNet as JaxResNet
from apex1_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops import softmax_cross_entropy_loss as jax_xent
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu.optim.fused_sgd import fused_sgd as jax_fused_sgd
from apex1_tpu_torch import ResNetConfig, get_policy
from apex1_tpu_torch.examples import gpt2_amp, imagenet_amp
from apex1_tpu_torch.interop import flax_from_named, resnet_params_from_jax
from apex1_tpu_torch.models.gpt2 import GPT2Config, init_params
from apex1_tpu_torch.obs import read_events
from apex1_tpu_torch.runtime import write_token_file

B, S = 2, 32


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gpt2") / "tokens.bin")
    write_token_file(path, np.random.default_rng(3).integers(
        0, 256, 4096).astype(np.uint16))
    return path


def _gpt2_argv(tokens, *extra):
    return ["--tiny", "--device", "cpu", "--opt-level", "O0", "--batch",
            str(B), "--seq", str(S), "--data", tokens, *extra]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_gpt2_amp_matches_jax_amp_on_the_same_batches(tokens):
    got = gpt2_amp.main(_gpt2_argv(tokens, "--steps", "5"))
    params = init_params(GPT2Config.tiny(), 0)
    model = JaxGPT2(JaxGPT2Config.tiny(policy=jax_get_policy("O0")))
    amp = JaxAmp(jax_fused_adam(3e-4, weight_decay=0.01), opt_level="O0",
                 max_grad_norm=1.0)
    state = amp.init(params)
    step = jax.jit(amp.make_train_step(jax_gpt2_loss_fn(model)))
    want = []
    with jrt.TokenDataset(tokens, seq_len=S, batch_size=B) as ds, \
            jax_common.force_impl("xla"):
        for i in range(5):
            state, m = step(state, jnp.asarray(ds.batch_at(i)))
            want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    port = _leaves(flax_from_named({k: v.detach().numpy() for k, v in
                                    got["state"].params.items()}))
    ref = _leaves(state.params)
    assert port.keys() == ref.keys()
    # atol 1e-4: the key bias's gradient is zero up to rounding (softmax
    # is shift-invariant), and Adam turns rounding noise into steps of
    # up to the learning rate, 3e-4
    for k, w in ref.items():
        np.testing.assert_allclose(port[k], w, rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    assert len(got["step_ms"]) == 5


def test_gpt2_amp_sigterm_drill_resumes_bit_for_bit(tokens, tmp_path,
                                                    monkeypatch):
    argv = _gpt2_argv(tokens, "--steps", "6")
    full = gpt2_amp.main(argv)
    drill = argv + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                    "6", "--obs-dir", str(tmp_path / "obs")]
    monkeypatch.setenv("APEX1_CHAOS_SIGTERM_STEP", "3")
    with pytest.raises(SystemExit) as exit_:
        gpt2_amp.main(drill)
    assert exit_.value.code == 75
    monkeypatch.delenv("APEX1_CHAOS_SIGTERM_STEP")
    resumed = gpt2_amp.main(drill)
    assert resumed["losses"] == full["losses"][3:]
    assert "APEX1_OBS_DIR" not in os.environ
    runs = [read_events(str(tmp_path / "obs" / f))
            for f in sorted(os.listdir(tmp_path / "obs"))]
    names = [[(r["kind"], r.get("name")) for r in run] for run in runs]
    assert all(n[0] == ("run", None) for n in names)
    events = [r for run in runs for r in run[1:]]
    saves = [r for r in events if r["name"] == "checkpoint.save"]
    assert [(r["data_step"], r["sync"]) for r in saves] == [(3, True),
                                                          (6, False)]
    assert [r["data_step"] for r in events
            if r["name"] == "checkpoint.restore"] == [3]
    assert [r["step"] for r in events if r["name"] == "metrics"] == [0, 5]


def test_imagenet_amp_matches_jax_on_one_device():
    hw, steps, batch = 32, 3, 4
    jmodel = JaxResNet(JaxResNetConfig.tiny(bn_axis_name="dp",
                                            policy=jax_get_policy("O0")))
    variables = jax.jit(jmodel.init)(jax.random.key(0),
                                     jnp.zeros((2, hw, hw, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    model = resnet_params_from_jax(
        params, stats, ResNetConfig.tiny(policy=get_policy("O0")), "cpu")
    got = imagenet_amp.main(["--tiny", "--device", "cpu", "--opt-level",
                             "O0", "--steps", str(steps), "--batch",
                             str(batch), "--image", str(hw)], model=model)

    def loss_fn(p, b, bn):
        logits, mutated = jmodel.apply({"params": p, "batch_stats": bn},
                                       b["images"], mutable=["batch_stats"])
        loss = jnp.mean(jax_xent(logits, b["labels"], smoothing=0.1))
        return loss, mutated["batch_stats"]

    amp = JaxAmp(jax_fused_sgd(0.1, momentum=0.9), opt_level="O0",
                 grad_psum_axes=("dp",))
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    step = jax.jit(jax.shard_map(
        amp.make_train_step(loss_fn, has_aux=True), mesh=mesh,
        in_specs=(P(), {"images": P("dp"), "labels": P("dp")}, P()),
        out_specs=(P(), P()), check_vma=False))
    state, bn, want = amp.init(params), stats, []
    for b in imagenet_amp.synthetic_loader(batch, hw, steps, 10,
                                           np.random.default_rng(0)):
        b = {"images": jrt.normalize_images(b["images"], imagenet_amp.MEAN,
                                            imagenet_amp.STD),
             "labels": b["labels"].astype(np.int32)}
        with jax_common.force_impl("xla"):
            state, m = step(state, b, bn)
        bn = m.pop("aux")
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    port = _leaves(flax_from_named({k: v.detach().numpy() for k, v in
                                    got["state"][0].params.items()}))
    for k, w in _leaves(state.params).items():
        np.testing.assert_allclose(port[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert isinstance(got["batch"][0], torch.Tensor)
