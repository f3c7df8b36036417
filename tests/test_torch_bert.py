"""The BERT slice as a whole: the port against the JAX package on the
CPU.

A tiny BERT pretraining model (vocab 256, 2 layers, 4 heads of 16,
ffn 128) from the JAX package's params (`interop.bert_params_from_jax`),
on a batch with token types, a padding ``attention_mask`` and MLM labels
of -1 outside a 15 % draw:

- O0: the loss and every grad leaf of ``bert_pretrain_loss_fn`` within
  1e-5 of JAX's, with ``fuse_head`` True and False, with and without
  dropout 0.1, JAX through its XLA composites and its Pallas kernels in
  interpret mode. JAX's per-layer dropout seeds (``seed_from_key`` of
  its ``dropout`` rng, one a layer) are recorded by wrapping the
  function with ``monkeypatch`` and handed to the port as its
  (num_layers,) ``dropout_rng``;
- O2 with dropout: a 3-step loss, grad norm and param trajectory within
  2e-2 of JAX's; O2_fp16 with an overflow forced at step 2 skipped like
  JAX's;
- `FusedScaleMaskSoftmax` (padding and causal) against JAX's class;
- the params cross between the packages; the int base seed rule; the
  entry points default to CUDA; `param_specs` gives the tensor-parallel
  spec of each parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex1_tpu.models.bert as jax_bert
from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models.bert import BertConfig as JaxBertConfig
from apex1_tpu.models.bert import BertPretrain as JaxBertPretrain
from apex1_tpu.models.bert import bert_pretrain_loss_fn as jax_loss_fn
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.ops.softmax import FusedScaleMaskSoftmax as JaxFSMS
from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
from apex1_tpu_torch import (Amp, BertConfig, BertPretrain,
                             bert_params_from_jax, bert_pretrain_loss_fn,
                             fused_adam, get_policy)
from apex1_tpu_torch.interop import bert_params_to_numpy, flax_from_named
from apex1_tpu_torch.models.bert import Bert, param_specs
from apex1_tpu_torch.ops import KERNEL_WRAPPERS, NEG_INF
from apex1_tpu_torch.ops.softmax import FusedScaleMaskSoftmax
from apex1_tpu_torch.ops.stochastic import fold_seed, layer_seeds

B, S = 2, 32
P = 0.1


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _jcfg(level="O0", dropout=0.0):
    return JaxBertConfig.tiny(policy=jax_get_policy(level), dropout=dropout)


def _tcfg(level="O0", dropout=0.0):
    return BertConfig.tiny(policy=get_policy(level), dropout=dropout)


@pytest.fixture(scope="module")
def tiny():
    cfg = _jcfg()
    rng = np.random.default_rng(40)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S - 7:] = 0
    batch = {
        "tokens": tokens,
        "token_types": (np.arange(S)[None] >= S // 2).repeat(B, 0).astype(
            np.int32),
        "attention_mask": mask,
        "mlm_labels": np.where(rng.random((B, S)) < 0.15,
                               rng.integers(0, cfg.vocab_size, (B, S)),
                               -1).astype(np.int32),
        "nsp_labels": rng.integers(0, 2, (B,)).astype(np.int32)}
    jparams = jax.jit(JaxBertPretrain(cfg).init)(
        jax.random.key(5), jnp.asarray(tokens))["params"]
    return dict(batch=batch, jparams=jparams, np_params=_np_tree(jparams))


#: the JAX dropout key of every dropout test here
KEY = 9


@pytest.fixture(scope="module")
def seeds(tiny):
    """JAX's per-layer dropout seeds for ``key(KEY)``: one forward with
    ``seed_from_key`` wrapped so each value is recorded."""
    seen = []
    orig = jax_bert.seed_from_key

    def recording(key):
        s = orig(key)
        seen.append(int(s))
        return s

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bert, "seed_from_key", recording)
        jax_loss_fn(JaxBertPretrain(_jcfg(dropout=P)))(
            tiny["jparams"], _jax_batch(tiny, jax.random.key(KEY)))
    assert len(seen) == _jcfg().num_layers
    return seen


def _jax_batch(tiny, dropout_key=None):
    batch = {k: jnp.asarray(v) for k, v in tiny["batch"].items()}
    if dropout_key is not None:
        batch["dropout_rng"] = dropout_key
    return batch


def _port_batch(tiny, seeds=None):
    batch = {k: torch.from_numpy(v) for k, v in tiny["batch"].items()}
    if seeds is not None:
        batch["dropout_rng"] = torch.tensor(seeds, dtype=torch.int32)
    return batch


def _port_model(tiny, level="O0", dropout=0.0):
    return bert_params_from_jax(tiny["np_params"], _tcfg(level, dropout),
                                "cpu")


@pytest.mark.parametrize("dropout", [False, True], ids=["det", "dropout"])
@pytest.mark.parametrize("fuse_head", [True, False], ids=["fused", "logits"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_o0_loss_and_every_grad_leaf_match_jax(tiny, seeds, impl, fuse_head,
                                                dropout):
    key = jax.random.key(KEY) if dropout else None
    seeds = seeds if dropout else None
    p = P if dropout else 0.0
    with jax_common.force_impl(impl):
        wl, wg = jax.jit(jax.value_and_grad(jax_loss_fn(
            JaxBertPretrain(_jcfg(dropout=p)), fuse_head=fuse_head)))(
                tiny["jparams"], _jax_batch(tiny, key))
    model = _port_model(tiny, dropout=p)
    params = dict(model.named_parameters())
    loss = bert_pretrain_loss_fn(model, fuse_head=fuse_head)(
        params, _port_batch(tiny, seeds))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    got = _leaves(flax_from_named(dict(zip(params, grads))))
    want = _leaves(_np_tree(wg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def test_dropout_changes_the_loss_and_base_seeds_fold_per_layer(tiny):
    model = _port_model(tiny, dropout=P)
    params = dict(model.named_parameters())
    fn = bert_pretrain_loss_fn(model)
    det = fn(params, _port_batch(tiny)).item()
    a = fn(params, dict(_port_batch(tiny), dropout_rng=7)).item()
    b = fn(params, _port_batch(tiny, [fold_seed(7, i) for i in range(2)]))
    c = fn(params, dict(_port_batch(tiny), dropout_rng=8)).item()
    assert a == b.item() and a != det and a != c
    assert layer_seeds(torch.tensor(7), 2) == layer_seeds(7, 2)
    with pytest.raises(ValueError, match="3 seeds for 2 layers"):
        layer_seeds([1, 2, 3], 2)
    # cfg.dropout == 0 ignores the seeds, as the reference ignores its key
    plain = _port_model(tiny)
    pp = dict(plain.named_parameters())
    assert bert_pretrain_loss_fn(plain)(
        pp, dict(_port_batch(tiny), dropout_rng=7)).item() == det


def _jax_run(tiny, level, steps, key, overflow_at=None):
    base = jax_loss_fn(JaxBertPretrain(_jcfg(level, P)))
    amp = JaxAmp(jax_fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(tiny["jparams"])
    step = jax.jit(amp.make_train_step(lambda p, f, b: base(p, b) * f))
    out = []
    for i in range(steps):
        f = jnp.float32(jnp.inf if i == overflow_at else 1.0)
        state, m = step(state, f, _jax_batch(tiny, key))
        out.append((_np_tree(state), _np_tree(m)))
    return out


def _port_run(tiny, level, steps, seeds, overflow_at=None):
    model = _port_model(tiny, level, P)
    base = bert_pretrain_loss_fn(model)
    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(lambda p, f, b: base(p, b) * f)
    out = []
    for i in range(steps):
        f = torch.tensor(float("inf") if i == overflow_at else 1.0)
        state, m = step(state, f, _port_batch(tiny, seeds))
        out.append((state, {k: v.numpy() for k, v in m.items()}))
    return out


def test_o2_three_step_dropout_trajectory_matches_jax(tiny, seeds):
    want = _jax_run(tiny, "O2", 3, jax.random.key(KEY))
    got = _port_run(tiny, "O2", 3, seeds)
    for (js, jm), (ts, tm) in zip(want, got):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=2e-2)
        got_l = _leaves(flax_from_named(ts.params))
        want_l = _leaves(js.params)
        dist = np.sqrt(sum(np.sum((got_l[k] - w) ** 2)
                           for k, w in want_l.items()))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want_l.values()))
        assert dist <= 2e-2 * norm, dist / norm
    assert got[-1][1]["loss"] < got[0][1]["loss"]


def test_o2_fp16_forced_overflow_skips_like_jax(tiny, seeds):
    want = _jax_run(tiny, "O2_fp16", 3, jax.random.key(KEY), overflow_at=1)
    got = _port_run(tiny, "O2_fp16", 3, seeds, overflow_at=1)
    for (_, jm), (_, tm) in zip(want, got):
        for k in ("skipped_steps", "loss_scale", "grads_finite"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    # step 2 is skipped (on top of any overflow while the scale
    # calibrates down from 2^16) and leaves the params bit for bit
    p1, p2 = got[0][0].params, got[1][0].params
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert got[1][1]["skipped_steps"] == got[0][1]["skipped_steps"] + 1


def test_params_round_trip(tiny):
    back = _leaves(bert_params_to_numpy(_port_model(tiny)))
    want = _leaves(tiny["np_params"])
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w)
    enc = bert_params_from_jax(tiny["np_params"]["bert"], _tcfg(), "cpu")
    assert isinstance(enc, Bert)
    seq, pooled = enc(torch.from_numpy(tiny["batch"]["tokens"]))
    assert seq.shape == (B, S, 64) and pooled.shape == (B, 64)


@pytest.mark.parametrize("kind", ["padding", "causal"])
def test_fused_scale_mask_softmax_matches_jax(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    mask = np.where(rng.random((2, 1, 1, 16)) < 0.3, NEG_INF,
                    0.0).astype(np.float32)
    jm = None if kind == "causal" else jnp.asarray(mask)
    tm = None if kind == "causal" else torch.from_numpy(mask)
    for impl in ("xla", "pallas"):
        with jax_common.force_impl(impl):
            want = np.asarray(JaxFSMS(kind, scale=0.5)(jnp.asarray(x), jm))
        got = FusedScaleMaskSoftmax(kind, scale=0.5)(torch.from_numpy(x),
                                                     tm)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    class Kind:
        name = kind

    fs = FusedScaleMaskSoftmax(Kind())
    assert fs.attn_mask_type == kind and fs.scale == 1.0
    # the fused path launches its kernel only for CUDA tensors
    assert not fs.is_kernel_available(torch.from_numpy(x))
    assert not FusedScaleMaskSoftmax(kind, scaled_masked_softmax_fusion=False
                                     ).is_kernel_available()


def test_cpu_runs_plain_versions_and_entry_points_default_to_cuda(tiny):
    before = {n: f.launches for n, f in KERNEL_WRAPPERS.items()}
    model = _port_model(tiny, dropout=P)
    params = dict(model.named_parameters())
    loss = bert_pretrain_loss_fn(model)(params,
                                        dict(_port_batch(tiny), dropout_rng=1))
    loss.backward()
    assert {n: f.launches for n, f in KERNEL_WRAPPERS.items()} == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BertPretrain(_tcfg())
    specs = param_specs(params)
    assert specs["bert.word_embeddings"] == ("tp", None)
    assert specs["bert.layer0.qkv.weight"] == ("tp", None)
    assert specs["bert.layer0.attn_out.weight"] == (None, "tp")
    assert specs["mlm_bias"] == ("tp",) and specs["nsp.weight"] == ()
