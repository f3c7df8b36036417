"""Public modules run on the card unless the caller names another
device: `SyncBatchNorm`, `FusedLayerNorm`, `FusedRMSNorm`,
`DynamicLossScaler`, `LossScaler`, the tensor-parallel layer modules
`ColumnParallelLinear`, `RowParallelLinear` and `VocabParallelEmbedding`
and `SpatialBottleneck`, built without ``device=``, put
their tensors on CUDA, or raise a RuntimeError naming CUDA where there
is none (the form of ``test_torch_moe.py::test_moe_mlp_defaults_to_
cuda``); with ``device="cpu"`` they stay on the CPU.
`convert_syncbn_model` keeps each batch norm's own device: a CPU model
stays on the CPU, also where a batch norm holds no tensor at all. The
serving tier likewise: the dense `KVPool` (through the decoder's
``make_cache``), the dense `Engine` and the engines a `ServingFrontend`'s
replicas build (without CUDA the build raises naming it, the replica
dies and its request is evicted at failover). The resilience layer too:
`sentinel_init` and a template-free `restore_checkpoint` put their
tensors on the card when no device is named (the restore checked with
CUDA stubbed in: each leaf is moved to a CUDA device). The runtime's
`PrefetchLoader` puts its batches on the card unless told otherwise;
with CUDA stubbed in, each array is pinned and copied without blocking
on the loader's side stream, the consumer's stream waits on the event
recorded after the copies, and each yielded tensor is marked used on
the consumer's stream.
"""

import pytest
import torch

from apex1_tpu_torch.fp16_utils import DynamicLossScaler, LossScaler
from apex1_tpu_torch.models.resnet import ResNetConfig, SpatialBottleneck
from apex1_tpu_torch.ops.layer_norm import FusedLayerNorm, FusedRMSNorm
from apex1_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model
from apex1_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    st = obj.state
    return [st.scale, st.growth_count, st.overflow_count,
            st.hysteresis_left]


MAKERS = {
    "SyncBatchNorm": lambda **kw: SyncBatchNorm(8, **kw),
    "SyncBatchNorm_no_affine": lambda **kw: SyncBatchNorm(8, affine=False,
                                                          **kw),
    "FusedLayerNorm": lambda **kw: FusedLayerNorm((4, 8), **kw),
    "FusedLayerNorm_no_affine": lambda **kw: FusedLayerNorm(
        8, elementwise_affine=False, **kw),
    "FusedRMSNorm": lambda **kw: FusedRMSNorm(8, **kw),
    "DynamicLossScaler": lambda **kw: DynamicLossScaler(**kw),
    "LossScaler": lambda **kw: LossScaler(128.0, **kw),
    "ColumnParallelLinear": lambda **kw: ColumnParallelLinear(4, 8, **kw),
    "RowParallelLinear": lambda **kw: RowParallelLinear(8, 4, **kw),
    "VocabParallelEmbedding": lambda **kw: VocabParallelEmbedding(10, 4,
                                                                  **kw),
    "SpatialBottleneck": lambda **kw: SpatialBottleneck(
        ResNetConfig.tiny(), 4, **kw),
}


@pytest.mark.parametrize("name", list(MAKERS))
def test_defaults_to_cuda(name):
    make = MAKERS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    else:
        assert {t.device.type for t in _tensors(make())} == {"cuda"}
    assert {t.device.type for t in _tensors(make(device="cpu"))} == {"cpu"}


@pytest.mark.parametrize("affine,track", [(True, True), (False, True),
                                          (False, False)])
def test_convert_syncbn_model_keeps_a_cpu_model_on_the_cpu(affine, track):
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 1),
        torch.nn.BatchNorm2d(4, affine=affine, track_running_stats=track))
    conv = convert_syncbn_model(net, axis_name=None)
    assert isinstance(conv[1], SyncBatchNorm)
    assert {t.device.type for t in _tensors(conv)} == {"cpu"}
    x = torch.randn(2, 3, 5, 5)
    assert conv(x).device.type == "cpu"
    bare = torch.nn.BatchNorm1d(4, affine=False, track_running_stats=False)
    assert not list(bare.parameters()) and not list(bare.buffers())
    assert {t.device.type for t in _tensors(
        convert_syncbn_model(bare, axis_name=None))} == {"cpu"}


# ---- the serving tier: the dense pool, its engine, the frontend ---------


def _toy_engine(**kw):
    from apex1_tpu_torch.serving import Engine, EngineConfig
    from apex1_tpu_torch.testing.chaos import toy_decoder
    apply_fn, make_cache = toy_decoder(device=kw.get("device"))
    return Engine(apply_fn, make_cache,
                  EngineConfig(max_slots=2, max_len=16, prefill_chunk=4,
                               paged=False, vocab_size=61), **kw)


def _pool_leaves(eng):
    return [t for e in eng.kv.cache.values() for t in e.values()]


@pytest.mark.parametrize("make", ["KVPool", "Engine"])
def test_dense_pool_and_engine_default_to_cuda(make):
    from apex1_tpu_torch.serving import KVPool
    from apex1_tpu_torch.testing.chaos import toy_decoder

    def build(**kw):
        if make == "KVPool":
            return KVPool(toy_decoder(**kw)[1], max_slots=2, max_len=8)
        return _toy_engine(**kw)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    else:
        obj = build()
        pool = obj if make == "KVPool" else obj.kv
        assert {t.device.type for e in pool.cache.values()
                for t in e.values()} == {"cuda"}
    obj = build(device="cpu")
    pool = obj if make == "KVPool" else obj.kv
    assert {t.device.type for e in pool.cache.values()
            for t in e.values()} == {"cpu"}
    if make == "Engine":
        assert obj._d_idxs.device.type == "cpu"


@pytest.mark.parametrize("device", [None, "cpu"])
def test_frontend_replicas_build_their_engines_on_the_named_device(device):
    from apex1_tpu_torch.serving import (FrontendConfig, ReplicaConfig,
                                         ServingFrontend)
    front = ServingFrontend(lambda: _toy_engine(device=device),
                            FrontendConfig(n_replicas=1, hedge_after_s=None,
                                           replica=ReplicaConfig(
                                               max_restarts=0)))
    rid = front.submit([1, 2, 3], max_new_tokens=3)
    front.pump(2)
    rep = front.replicas[0]
    if device is None and not torch.cuda.is_available():
        # the build raised naming CUDA: the replica died, no restart
        # budget, the request is evicted at failover
        assert rep.state == "failed"
        assert "CUDA" in repr(front.metrics.transitions[0]["error"])
        assert front.poll(rid).status == "evicted"
        return
    front.run_until_drained(timeout_s=30.0)
    assert front.poll(rid).status == "done"
    want = "cpu" if device == "cpu" else "cuda"
    assert {t.device.type for t in _pool_leaves(rep.engine)} == {want}


def test_sentinel_init_defaults_to_cuda():
    from apex1_tpu_torch.resilience import sentinel_init
    s = sentinel_init("cpu")
    assert {s.steps_seen.device.type, s.last_loss.device.type} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sentinel_init()
    else:
        assert sentinel_init().steps_seen.device.type == "cuda"


def test_template_free_restore_defaults_to_cuda(tmp_path, monkeypatch):
    from apex1_tpu_torch.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
    state = {"w": torch.ones(3), "n": {"s": torch.tensor(1)},
             "h": torch.zeros(2, dtype=torch.bfloat16)}
    save_checkpoint(tmp_path / "ck", state)
    got = restore_checkpoint(tmp_path / "ck", device="cpu")
    assert {got["w"].device.type, got["n"]["s"].device.type,
            got["h"].device.type} == {"cpu"}
    if torch.cuda.is_available():
        got = restore_checkpoint(tmp_path / "ck")
        assert got["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_checkpoint(tmp_path / "ck")
    moved = []

    def to(self, *args, **kw):
        moved.append(torch.device(args[0] if args else kw["device"]).type)
        return self

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.Tensor, "to", to)
    restore_checkpoint(tmp_path / "ck")
    assert moved == ["cuda"] * 3


def test_prefetch_loader_defaults_to_cuda_side_stream_copies(monkeypatch):
    import contextlib

    import numpy as np

    from apex1_tpu_torch.runtime import PrefetchLoader
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PrefetchLoader(iter([]))
    calls, active = [], []

    class Stream:
        def __init__(self, device=None):
            self.device = device

        def wait_event(self, ev):
            calls.append(("wait", self, ev))

    class Event:
        def record(self, stream):
            calls.append(("record", stream, self))

    @contextlib.contextmanager
    def on(stream):
        active.append(stream)
        yield
        active.pop()

    def to(self, device, non_blocking=False):
        calls.append(("to", str(device), non_blocking, active[-1]))
        return self

    consumer = Stream("consumer")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: consumer)
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self: (calls.append(("pin",)), self)[1])
    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: calls.append(("record_stream", s)))
    loader = PrefetchLoader(iter([{"x": np.ones(3), "y": np.zeros(2),
                                   "n": 5}]))
    assert loader.device.type == "cuda"
    (batch,) = list(loader)
    assert batch["n"] == 5 and isinstance(batch["x"], torch.Tensor)
    side = calls[2][3]
    assert isinstance(side, Stream) and side is not consumer
    ev = calls[5][2]
    assert calls == [("set_device", "cuda:0"),
                     ("pin",), ("to", "cuda:0", True, side),
                     ("pin",), ("to", "cuda:0", True, side),
                     ("record", side, ev), ("wait", consumer, ev),
                     ("record_stream", consumer),
                     ("record_stream", consumer)]


def test_obs_smoke_and_the_sweep_default_to_cuda(capsys, tmp_path,
                                                 monkeypatch):
    """``python -m apex1_tpu_torch.obs --smoke`` traces its step on the
    card unless ``--device cpu`` (without one its trace stage fails
    naming CUDA); the tuning sweep times on the card unless ``--device
    cpu`` (without one it exits 1 naming the missing device)."""
    from apex1_tpu_torch import tuning
    from apex1_tpu_torch.obs import __main__ as obs_main
    from apex1_tpu_torch.tuning import sweep
    monkeypatch.setenv("APEX1_TUNING_DIR", str(tmp_path))
    if not torch.cuda.is_available():
        assert obs_main.main(["--smoke"]) == 1
        assert "FAIL stage trace" in capsys.readouterr().out
        assert sweep.main(["--kernel", "lora_epilogue"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert obs_main.main(["--smoke", "--device", "cpu"]) == 0
    assert "host-proxy" in capsys.readouterr().out
    assert sweep.main(["--kernel", "lora_epilogue", "--device", "cpu",
                       "--iters", "1"]) == 0
    tuning.clear_cache()
