"""The port's `resilience` (retry, manifest, checkpointer, sentinel,
preemption) and `testing.chaos`'s training faults against the JAX
package, on the CPU; the counterpart of each class of
tests/test_resilience.py.

- retry: `backoff_delays` equal to JAX's for several seeds and jitters;
  `retry_call` makes the same attempts and sleeps (a recording sleep)
  as JAX's over the same `Flaky` failures, deadline and exhaustion;
- manifest: `tree_entries` of the port's tensors equals JAX's of the
  same arrays (list for list); the JAX package's `read_manifest`,
  `verify_files` and chaos damage accept a step directory the port
  wrote, and the port's one JAX wrote; every corruption class a typed
  `IntegrityError`;
- the checkpointer: async save and restore with meta, the snapshot
  surviving an in-place update of the live tensors, the ring GC with a
  milestone, the scan past a truncated and a bit-flipped checkpoint,
  the fingerprint refusal, a stale ``latest``, the third save blocking,
  ``plan=`` (the JAX planner's plan as JSON) banked in every save and
  refused on a layout change, an uncommitted save invisible;
- chaos: each package's `truncate_checkpoint` and `bitflip_checkpoint`
  on two copies of one directory leave identical bytes;
  `poison_at_steps` hits exact steps;
- the sentinel: the loop of JAX's chaos smoke (NaN at steps 3 and 4,
  save every step, poll, roll back) in both packages: health flags,
  counters, poll actions, the rollback's step and the kept params within
  1e-6; the banked records; the abort; the ``gnorm_threshold`` flag;
  `refold_key` and `refold_seed` bit for bit against JAX's; the guarded
  step dispatches no ``aten._local_scalar_dense`` (no host sync);
- preemption (tests/test_resilience.py:478-545), the double-signal
  cases in a subprocess.
"""

import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex1_tpu.amp import Amp as JaxAmp
from apex1_tpu.optim.fused_sgd import fused_sgd as jax_fused_sgd
from apex1_tpu.resilience import checkpointer as jax_ckptr
from apex1_tpu.resilience import manifest as jax_manifest
from apex1_tpu.resilience import retry as jax_retry
from apex1_tpu.resilience import sentinel as jax_sentinel
from apex1_tpu.testing import chaos as jax_chaos
from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.checkpoint import CheckpointError, save_checkpoint
from apex1_tpu_torch.optim import fused_sgd
from apex1_tpu_torch.resilience import (DivergenceError, EXIT_RESUMABLE,
                                        IntegrityError, LayoutMismatch,
                                        PreemptionHandler,
                                        ResilientCheckpointer, Sentinel,
                                        TransientError, backoff_delays,
                                        find_restorable, guard_train_step,
                                        read_manifest, read_plan,
                                        refold_key, refold_seed,
                                        retry_call, sentinel_init,
                                        verify_files, verify_tree,
                                        write_manifest)
from apex1_tpu_torch.resilience import manifest
from apex1_tpu_torch.testing import chaos


def _amp_setup(poisonable=False):
    amp = Amp(fused_sgd(0.1), opt_level="O0")
    state = amp.init({"w": torch.arange(1.0, 9.0),
                      "b": torch.zeros(4)})
    if poisonable:
        def loss_fn(p, x, step):
            loss = torch.sum(torch.square(p["w"])) * x + torch.sum(p["b"])
            return chaos.poison_at_steps(loss, step, (3, 4))
    else:
        def loss_fn(p, x):
            return torch.sum(torch.square(p["w"])) * x + torch.sum(p["b"])
    return amp, state, loss_fn


ONE = torch.tensor(1.0)


# ---------------------------------------------------------------------------
# retry / backoff


class TestRetry:
    @pytest.mark.parametrize("kw", [
        dict(seed=7, base_s=0.01, cap_s=0.1), dict(seed=3, cap_s=10.0),
        dict(jitter=0.0, cap_s=10.0), dict(seed=123, jitter=1.0,
                                           factor=3.0)])
    def test_delays_equal_jax(self, kw):
        assert list(backoff_delays(8, **kw)) == \
            list(jax_retry.backoff_delays(8, **kw))

    def test_delay_errors(self):
        with pytest.raises(ValueError, match="retries"):
            list(backoff_delays(-1))
        with pytest.raises(ValueError, match="jitter"):
            list(backoff_delays(2, jitter=2.0))

    @pytest.mark.parametrize("fails,kw", [
        (3, dict(retries=5, base_s=0.5, seed=4)),
        (10, dict(retries=2, base_s=0.1)),
        (10, dict(retries=50, base_s=10.0, jitter=0.0, deadline_s=0.05))])
    def test_retry_call_equals_jax_sleeps_included(self, fails, kw):
        runs = {}
        for name, mod, flaky_cls in (("port", None, chaos.Flaky),
                                     ("jax", jax_retry, jax_chaos.Flaky)):
            call = retry_call if mod is None else mod.retry_call
            exc = TransientError if mod is None else mod.TransientError
            flaky = flaky_cls(lambda: "ok", fails=fails)
            slept, seen = [], []
            try:
                out = call(flaky, sleep=slept.append,
                           on_retry=lambda n, e: seen.append(n), **kw)
            except exc:
                out = "raised"
            runs[name] = (out, flaky.attempts, flaky.failures, slept, seen)
        assert runs["port"] == runs["jax"]

    def test_non_retryable_propagates_immediately(self):
        def boom():
            raise ValueError("not transient")

        with pytest.raises(ValueError):
            retry_call(boom, retries=5, base_s=0.0)

    def test_one_home_for_the_policy(self):
        """`runtime` and the serving engine use the resilience module's
        policy and hash, not copies."""
        from apex1_tpu_torch import runtime
        from apex1_tpu_torch.resilience import retry
        from apex1_tpu_torch.serving import engine
        assert runtime.backoff_delays is retry.backoff_delays
        assert engine._mix32 is retry._mix32
        assert [retry._mix32(x) for x in (0, 1, 2 ** 40, 12345)] == \
            [jax_retry._mix32(x) for x in (0, 1, 2 ** 40, 12345)]


# ---------------------------------------------------------------------------
# manifest


def _tree():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(4, 4)).astype(np.float32),
            "n": np.int32(3), "h": rng.normal(size=(5,)).astype(np.float16)}


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


class TestManifest:
    def _write(self, tmp_path, tree=None):
        tree = tree if tree is not None else _port(_tree())
        d = tmp_path / "ck"
        save_checkpoint(d / "state", tree)
        write_manifest(d, step=7, state=tree, fingerprint=0xABC,
                       meta={"data_step": 9})
        return d, tree

    def test_tree_entries_equal_jax(self):
        assert manifest.tree_entries(_port(_tree())) == \
            jax_manifest.tree_entries({k: jnp.asarray(v)
                                       for k, v in _tree().items()})

    def test_round_trip_and_verify(self, tmp_path):
        d, tree = self._write(tmp_path)
        m = read_manifest(d)
        assert (m.step, m.fingerprint, m.meta["data_step"]) == (7, "0xabc",
                                                                9)
        verify_files(d)
        verify_tree(d, tree, m)

    def test_jax_reads_and_verifies_the_port_dir(self, tmp_path):
        d, tree = self._write(tmp_path)
        jm = jax_manifest.verify_files(d)
        assert jm.tree == read_manifest(d).tree
        jax_manifest.verify_tree(d, {k: v.numpy() for k, v in tree.items()})

    def test_port_reads_and_verifies_a_jax_dir(self, tmp_path):
        jtree = {k: jnp.asarray(v) for k, v in _tree().items()}
        with jax_ckptr.ResilientCheckpointer(tmp_path / "j") as ck:
            path = ck.save_sync(4, jtree, meta={"data_step": 5})
        m = verify_files(path)
        assert (m.step, m.meta["data_step"]) == (4, 5)
        verify_tree(path, _port(_tree()), m)
        assert os.path.basename(find_restorable(tmp_path / "j")) == \
            "step_00000004"

    def test_truncation_detected(self, tmp_path):
        d, _ = self._write(tmp_path)
        chaos.truncate_checkpoint(d)
        with pytest.raises(IntegrityError, match="truncated|missing"):
            verify_files(d)

    def test_bitflip_detected(self, tmp_path):
        d, _ = self._write(tmp_path)
        chaos.bitflip_checkpoint(d)
        with pytest.raises(IntegrityError, match="digest mismatch"):
            verify_files(d)

    def test_missing_manifest_is_uncommitted(self, tmp_path):
        d, _ = self._write(tmp_path)
        os.unlink(d / "manifest.json")
        with pytest.raises(IntegrityError, match="manifest missing"):
            verify_files(d)

    def test_wrong_restore_is_typed(self, tmp_path):
        d, tree = self._write(tmp_path)
        wrong = dict(tree, w=tree["w"].clone())
        wrong["w"][0, 0] = 99.0
        with pytest.raises(IntegrityError, match="sha256 mismatch"):
            verify_tree(d, wrong)
        with pytest.raises(IntegrityError, match="structure mismatch"):
            verify_tree(d, {"w": tree["w"]})


# ---------------------------------------------------------------------------
# chaos damage: both packages, one directory, the same bytes


def _all_bytes(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for n in files:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


class TestChaos:
    @pytest.mark.parametrize("kind,seed", [("truncate", 0),
                                           ("truncate", 7),
                                           ("bitflip", 0), ("bitflip", 5)])
    def test_damage_equals_jax(self, tmp_path, kind, seed):
        tree = {"w": torch.arange(256.0), "v": torch.arange(256.0) * 2,
                "n": torch.tensor(1)}
        with ResilientCheckpointer(tmp_path / "ck") as ck:
            src = ck.save_sync(1, tree)
        a, b = tmp_path / "a", tmp_path / "b"
        shutil.copytree(src, a)
        shutil.copytree(src, b)
        port = {"truncate": chaos.truncate_checkpoint,
                "bitflip": chaos.bitflip_checkpoint}[kind]
        jx = {"truncate": jax_chaos.truncate_checkpoint,
              "bitflip": jax_chaos.bitflip_checkpoint}[kind]
        pa, pb = port(a, seed=seed), jx(b, seed=seed)
        assert os.path.relpath(pa, a) == os.path.relpath(pb, b)
        assert _all_bytes(a) == _all_bytes(b)
        assert _all_bytes(a) != _all_bytes(src)

    def test_poison_hits_exact_steps(self):
        x = torch.ones(4)
        assert chaos.poison_at_steps(x, torch.tensor(3), ()) is x
        for s, bad in ((2, True), (3, False)):
            out = chaos.poison_at_steps(x, torch.tensor(s), (2,))
            assert bool(torch.isnan(out).all()) == bad
        inf = chaos.poison_at_steps(x, 2, (2,), poison=float("inf"))
        assert bool(torch.isinf(inf).all())
        tree = chaos.poison_tree_at_steps(
            {"g": x, "i": torch.ones(2, dtype=torch.int32)},
            torch.tensor(1), (1,))
        assert bool(torch.isnan(tree["g"]).all())
        assert tree["i"].dtype == torch.int32

    def test_pick_is_deterministic(self, tmp_path):
        tree = {"w": torch.arange(256.0)}
        d = tmp_path / "ck"
        save_checkpoint(d / "state", tree)
        write_manifest(d, step=1, state=tree)
        a = chaos._pick_payload_file(str(d), seed=5)
        assert a == chaos._pick_payload_file(str(d), seed=5) == \
            jax_chaos._pick_payload_file(str(d), seed=5)
        assert chaos.bitflip_checkpoint(d, seed=5) == a

    def test_flaky_and_sigterm_self(self):
        f = chaos.Flaky(lambda x: x + 1, fails=1)
        with pytest.raises(TransientError):
            f(1)
        assert f(1) == 2 and (f.attempts, f.failures) == (2, 1)
        assert chaos.sigterm_self_at(3, None) is False
        assert chaos.sigterm_self_at(3, 4) is False


# ---------------------------------------------------------------------------
# resilient checkpointer


class TestResilientCheckpointer:
    def test_async_save_restore_and_meta(self, tmp_path):
        amp, state, loss_fn = _amp_setup()
        step = amp.make_train_step(loss_fn)
        with ResilientCheckpointer(tmp_path / "ck", keep=2) as ck:
            for i in range(3):
                state, _ = step(state, ONE)
                ck.save(int(state.step), state, meta={"data_step": i + 1})
            ck.wait()
            restored, man = ck.restore(template=state)
            assert [t["step"] for t in ck.timings] == [1, 2, 3]
        assert man.step == 3 and man.meta["data_step"] == 3
        for k in state.params:
            assert torch.equal(restored.params[k], state.params[k])
        assert torch.equal(restored.step, state.step)

    def test_snapshot_survives_in_place_update(self, tmp_path):
        """The snapshot is a copy: the caller may update the live
        tensors in place while the save is still writing."""
        import threading
        amp, state, loss_fn = _amp_setup()
        state, _ = amp.make_train_step(loss_fn)(state, ONE)
        want = state.params["w"].clone()
        gate = threading.Event()
        with ResilientCheckpointer(tmp_path / "ck") as ck:
            orig = ck._write_one
            ck._write_one = lambda *a: (gate.wait(30), orig(*a))[1]
            ck.save(1, state)
            state.params["w"].add_(100.0)
            gate.set()
            ck.wait()
            restored, _ = ck.restore(template=state)
        assert torch.equal(restored.params["w"], want)

    def test_packed_snapshot_round_trips_every_dtype(self, tmp_path):
        """The snapshot packs each device's tensors into one buffer at
        16-byte offsets; odd sizes, 0-d, empty and strided leaves of
        every width come back bit for bit, async and sync."""
        g = torch.Generator().manual_seed(0)
        tree = {"f32": torch.randn(3, generator=g),
                "bf16": torch.randn(5, generator=g).bfloat16(),
                "f16": torch.randn(2, 3, generator=g).half(),
                "mask": torch.randn(7, generator=g) > 0,
                "i8": torch.tensor(-3, dtype=torch.int8),
                "t": torch.arange(12, dtype=torch.int64).reshape(3, 4).T,
                "empty": torch.zeros(0, 4),
                "n": 5, "arr": np.arange(3, dtype=np.int32)}
        want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in tree.items()}
        with ResilientCheckpointer(tmp_path / "ck", keep=4) as ck:
            ck.save(1, tree)
            ck.save_sync(2, tree)
            for step in (1, 2):
                got, man = ck.restore(
                    template=want,
                    path=str(tmp_path / "ck" / f"step_0000000{step}"))
                assert man.step == step
                for k, v in want.items():
                    if isinstance(v, torch.Tensor):
                        assert got[k].dtype == v.dtype
                        assert torch.equal(got[k], v), k
                    else:
                        np.testing.assert_array_equal(got[k], v)
        assert manifest.tree_entries(got) == manifest.tree_entries(want)

    def test_async_save_writes_on_a_capped_pool(self, tmp_path):
        """An async save hashes and writes on at most ``ASYNC_THREADS``
        threads; a sync save (the caller waits) on the host's pool."""
        import threading
        import time as _t
        ids = set()

        def who(_x):
            ids.add(threading.get_ident())
            _t.sleep(0.002)

        with manifest.parallel_cap(2):
            manifest.parallel_map(who, range(64))
        assert len(ids) <= 2
        seen = []
        ck = ResilientCheckpointer(tmp_path / "ck")
        orig = ck._write_one

        def spy(*a):
            seen.append(getattr(manifest._pool, "cap", None))
            return orig(*a)

        ck._write_one = spy
        ck.save(1, {"w": torch.ones(4)})
        ck.wait()
        ck.save_sync(2, {"w": torch.ones(4)})
        ck.close()
        assert seen == [ResilientCheckpointer.ASYNC_THREADS, None]

    def test_ring_gc_keeps_last_k_and_milestones(self, tmp_path):
        tree = {"w": torch.ones(4)}
        with ResilientCheckpointer(tmp_path / "ck", keep=2) as ck:
            ck.save_sync(1, tree, milestone=True)
            for s in (2, 3, 4, 5):
                ck.save_sync(s, tree)
        kept = sorted(p for p in os.listdir(tmp_path / "ck")
                      if p.startswith("step_"))
        assert kept == ["step_00000001", "step_00000004", "step_00000005"]

    def test_scan_past_truncated_and_bitflipped(self, tmp_path):
        tree = {"w": torch.arange(64.0)}
        with ResilientCheckpointer(tmp_path / "ck", keep=5) as ck:
            for s in (1, 2, 3):
                ck.save_sync(s, dict(tree, step=torch.tensor(s)))
            d = str(tmp_path / "ck")
            chaos.truncate_checkpoint(os.path.join(d, "step_00000003"))
            chaos.bitflip_checkpoint(os.path.join(d, "step_00000002"))
            best = find_restorable(d)
            assert os.path.basename(best) == "step_00000001"
            assert os.path.basename(jax_ckptr.find_restorable(d)) == \
                "step_00000001"
            restored, man = ck.restore(
                template=dict(tree, step=torch.tensor(0)))
            for s in (2, 3):
                with pytest.raises(IntegrityError):
                    ck.restore(template=dict(tree, step=torch.tensor(0)),
                               path=os.path.join(d, f"step_0000000{s}"))
        assert man.step == 1 and int(restored["step"]) == 1

    def test_leaf_files_digested_once_and_checked_on_restore(self,
                                                             tmp_path):
        """A leaf file's manifest digest is its leaf digest (no second
        pass at save); a restore holds each leaf's recorded digest
        against its verified file, so a manifest whose leaf entry
        disagrees with the payload is refused without hashing the
        restored leaves."""
        from apex1_tpu_torch.checkpoint import read_index
        from apex1_tpu_torch.resilience.manifest import atomic_write_json
        tree = {"w": torch.arange(64.0), "b": torch.ones(3, 2,
                                                       dtype=torch.bfloat16)}
        with ResilientCheckpointer(tmp_path / "ck") as ck:
            path = ck.save_sync(1, tree)
            m = verify_files(path)
            files = {e["path"]: e["sha256"] for e in m.files}
            for e in read_index(os.path.join(path, "state")):
                leaf = [t for t in m.tree if t["path"] == e["path"]][0]
                assert files[f"state/{e['file']}"] == leaf["sha256"]
            doc = json.load(open(os.path.join(path, "manifest.json")))
            doc["tree"][0]["sha256"] = "0" * 64
            atomic_write_json(os.path.join(path, "manifest.json"), doc)
            verify_files(path)          # the files themselves are intact
            with pytest.raises(IntegrityError, match="sha256 mismatch"):
                ck.restore(template=tree)
            doc["tree"] = doc["tree"][1:]
            atomic_write_json(os.path.join(path, "manifest.json"), doc)
            with pytest.raises(IntegrityError, match="structure mismatch"):
                ck.restore(template=tree)

    def test_no_valid_checkpoint_is_typed(self, tmp_path):
        with ResilientCheckpointer(tmp_path / "ck") as ck:
            with pytest.raises(CheckpointError, match="no valid"):
                ck.restore(template={"w": torch.ones(4)})

    def test_fingerprint_refuses_changed_program(self, tmp_path):
        tree = {"w": torch.ones(4)}
        with ResilientCheckpointer(tmp_path / "ck",
                                   fingerprint=0x1111) as ck:
            ck.save_sync(1, tree)
        with ResilientCheckpointer(tmp_path / "ck",
                                   fingerprint=0x2222) as ck2:
            with pytest.raises(CheckpointError,
                               match="fingerprint mismatch"):
                ck2.restore(template=tree)
            restored, _ = ck2.restore(template=tree,
                                      allow_fingerprint_mismatch=True)
        assert torch.equal(restored["w"], torch.ones(4))

    def test_stale_latest_pointer_does_not_hide_newer_valid(self,
                                                            tmp_path):
        tree = {"w": torch.ones(4)}
        d = tmp_path / "ck"
        with ResilientCheckpointer(d, keep=3) as ck:
            ck.save_sync(1, tree)
            ck.save_sync(2, tree)
            with open(d / "latest", "w") as f:
                f.write("step_00000001\n")
            assert os.path.basename(find_restorable(d)) == "step_00000002"

    def test_snapshot_bound_third_save_blocks(self, tmp_path):
        import threading
        import time as _t

        gate = threading.Event()
        ck = ResilientCheckpointer(tmp_path / "ck")
        orig = ck._write_one
        ck._write_one = lambda *a: (gate.wait(30), orig(*a))[1]
        tree = {"w": torch.ones(4)}
        snaps = []
        orig_snap = ck._snapshot
        ck._snapshot = lambda s: snaps.append(1) or orig_snap(s)
        ck.save(1, tree)
        ck.save(2, tree)
        t = threading.Thread(target=lambda: ck.save(3, tree))
        t.start()
        _t.sleep(0.3)
        assert len(snaps) == 2 and t.is_alive()
        gate.set()
        t.join(timeout=30)
        ck.close()
        assert len(snaps) == 3
        assert os.path.basename(ck.latest_valid()) == "step_00000003"

    def test_plan_banked_in_every_save_meta(self, tmp_path):
        from apex1_tpu import planner
        shape = planner.ModelShape(
            name="bank", num_layers=2, hidden_size=32, ffn_size=64,
            num_heads=4, num_kv_heads=2, head_dim=8, vocab_size=64,
            seq_len=16, global_batch=4)
        plan = json.loads(json.dumps(planner.plan_for_layout(
            shape, planner.Layout(dp=2, num_microbatches=2))))
        other = json.loads(json.dumps(planner.plan_for_layout(
            shape, planner.Layout(dp=1, num_microbatches=4))))
        tree = {"w": torch.ones(4)}
        with ResilientCheckpointer(tmp_path / "ck", plan=plan) as ck:
            ck.save_sync(1, tree, meta={"data_step": 1})
            ck.save_sync(2, tree)
            for s in (1, 2):
                assert read_plan(os.path.join(
                    str(tmp_path / "ck"), f"step_0000000{s}")) == plan
            restored, man = ck.restore(template=tree)
            assert man.meta["plan"]["mesh"] == plan["mesh"]
        with ResilientCheckpointer(tmp_path / "ck", plan=other) as ck:
            with pytest.raises(LayoutMismatch, match="elastic_resume"):
                ck.restore(template=tree)
        with pytest.raises(ValueError, match="apex1-plan-v1"):
            ResilientCheckpointer(tmp_path / "ck2",
                                  plan={"schema": "nope"})

    def test_uncommitted_save_is_invisible(self, tmp_path):
        tree = {"w": torch.ones(4)}
        d = tmp_path / "ck"
        with ResilientCheckpointer(d, keep=2) as ck:
            ck.save_sync(1, tree)
            os.makedirs(d / "step_00000002")
            assert os.path.basename(find_restorable(d)) == "step_00000001"
            restored, man = ck.restore(template=tree)
        assert man.step == 1

    def test_background_failure_surfaces(self, tmp_path):
        with ResilientCheckpointer(tmp_path / "ck") as ck:
            ck.save(1, {"w": object()})
            with pytest.raises(CheckpointError, match="background save"):
                ck.wait()


# ---------------------------------------------------------------------------
# sentinel


def _jax_loop(tmp_path):
    """JAX's chaos-smoke loop: NaN at steps 3 and 4, a save every step,
    a poll, a rollback."""
    amp = JaxAmp(tx=jax_fused_sgd(0.1), opt_level="O0")
    state = amp.init({"w": jnp.arange(1.0, 9.0, dtype=jnp.float32),
                      "b": jnp.zeros((4,), jnp.float32)})

    def loss_fn(p, x, step):
        loss = jnp.sum(jnp.square(p["w"])) * x + jnp.sum(p["b"])
        return jax_chaos.poison_at_steps(loss, step, (3, 4))

    ck = jax_ckptr.ResilientCheckpointer(tmp_path / "j", keep=4)
    sent = jax_sentinel.Sentinel(ck, check_every=1, rollback_after=2)
    guarded = jax.jit(sent.guard(amp.make_train_step(loss_fn)))
    carry = (state, jax_sentinel.sentinel_init())
    rows, rolled = [], None
    for i in range(6):
        carry, m = guarded(carry, jnp.float32(1.0), carry[0].step)
        ck.save_sync(int(carry[0].step), carry[0],
                     meta={"data_step": i + 1})
        s = carry[1]
        action = sent.poll(s)
        rows.append((bool(m["sentinel_healthy"]), int(s.steps_seen),
                     int(s.consecutive_bad), int(s.total_bad),
                     int(s.last_bad_step), action))
        if action == "rollback":
            good, man, s0 = sent.rollback(template=carry[0])
            rolled = (man.step, man.meta["data_step"],
                      {k: np.asarray(v) for k, v in good.params.items()},
                      int(s0.consecutive_bad))
            break
    ck.close()
    return rows, rolled, [r["action"] for r in sent.records]


def _port_loop(tmp_path):
    amp, state, loss_fn = _amp_setup(poisonable=True)
    ck = ResilientCheckpointer(tmp_path / "p", keep=4)
    sent = Sentinel(ck, check_every=1, rollback_after=2)
    guarded = sent.guard(amp.make_train_step(loss_fn))
    carry = (state, sentinel_init("cpu"))
    rows, rolled = [], None
    for i in range(6):
        carry, m = guarded(carry, ONE, carry[0].step)
        ck.save_sync(int(carry[0].step), carry[0],
                     meta={"data_step": i + 1})
        s = carry[1]
        action = sent.poll(s)
        rows.append((bool(m["sentinel_healthy"]), int(s.steps_seen),
                     int(s.consecutive_bad), int(s.total_bad),
                     int(s.last_bad_step), action))
        if action == "rollback":
            good, man, s0 = sent.rollback(template=carry[0])
            rolled = (man.step, man.meta["data_step"],
                      {k: v.numpy() for k, v in good.params.items()},
                      int(s0.consecutive_bad))
            break
    ck.close()
    return rows, rolled, [r["action"] for r in sent.records]


def _sentinel_keep_case(case: str):
    """Two clean steps, then one step only the sentinel marks bad, in
    both packages under ``Amp(fused_adam, O0, dynamic loss scale)``.
    The bare step changes the params, the Adam moments and the loss
    scale's state; the guarded step keeps every one of them at the
    previous step's, bit for bit, and within 1e-6 of JAX's kept state."""
    from apex1_tpu.optim.fused_adam import fused_adam as jax_fused_adam
    from apex1_tpu_torch.core.pytree import (keystr,
                                             tree_flatten_with_path)
    from apex1_tpu_torch.optim import fused_adam
    bad_x = 1e8 if case == "gnorm" else 1.0
    thresh = 1e3 if case == "gnorm" else None
    w0 = np.arange(1.0, 9.0, dtype=np.float32) / 8

    def loss_of(sq, where, full, p, x, step):
        loss = sq(p["w"]) * x
        if case == "nan_loss":
            loss = where(step == 2, full(loss, float("nan")), loss)
        return loss

    amp = Amp(fused_adam(0.1), opt_level="O0", loss_scale="dynamic")
    inner = amp.make_train_step(lambda p, x, step: loss_of(
        lambda w: torch.sum(torch.square(w)), torch.where,
        torch.full_like, p, x, step))
    guarded = guard_train_step(inner, gnorm_threshold=thresh)
    carry = (amp.init({"w": torch.from_numpy(w0.copy())}),
             sentinel_init("cpu"))
    jamp = JaxAmp(tx=jax_fused_adam(0.1), opt_level="O0",
                  loss_scale="dynamic")
    jinner = jamp.make_train_step(lambda p, x, step: loss_of(
        lambda w: jnp.sum(jnp.square(w)), jnp.where, jnp.full_like,
        p, x, step))
    jguarded = jax.jit(jax_sentinel.guard_train_step(
        jinner, gnorm_threshold=thresh))
    jcarry = (jamp.init({"w": jnp.asarray(w0)}),
              jax_sentinel.sentinel_init())
    for x in (1.0, 1.0, bad_x):
        prev, jprev = carry[0], jcarry[0]
        carry, m = guarded(carry, torch.tensor(x), carry[0].step)
        jcarry, jm = jguarded(jcarry, jnp.float32(x), jcarry[0].step)
        assert bool(m["sentinel_healthy"]) == bool(jm["sentinel_healthy"])
    assert not bool(m["sentinel_healthy"])
    if case == "nan_loss":
        assert bool(m["grads_finite"])
    bare, _ = inner(prev, torch.tensor(bad_x), prev.step)
    kept = carry[0]
    assert int(kept.step) == 3
    for field in ("params", "opt_state", "loss_scale"):
        was = tree_flatten_with_path(getattr(prev, field))
        now = tree_flatten_with_path(getattr(kept, field))
        moved = tree_flatten_with_path(getattr(bare, field))
        assert [keystr(p) for p, _ in now] == [keystr(p) for p, _ in was]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(was, now))
        assert not all(torch.equal(a, b)
                       for (_, a), (_, b) in zip(was, moved)), field
        jnow = jax.tree_util.tree_leaves(getattr(jcarry[0], field))
        assert len(jnow) == len(now)
        for (_, a), b in zip(now, jnow):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)


class TestSentinel:
    def _guarded(self, sent=None):
        amp, state, loss_fn = _amp_setup(poisonable=True)
        inner = amp.make_train_step(loss_fn)
        guard = (sent.guard(inner) if sent is not None
                 else guard_train_step(inner))
        return state, guard

    def test_smoke_loop_equals_jax(self, tmp_path):
        rows, rolled, actions = _port_loop(tmp_path)
        jrows, jrolled, jactions = _jax_loop(tmp_path)
        assert rows == jrows
        assert actions == jactions == ["skip", "rollback"]
        assert rolled[0] == jrolled[0] and rolled[1] == jrolled[1]
        assert rolled[3] == jrolled[3] == 0
        for k, v in jrolled[2].items():
            np.testing.assert_allclose(rolled[2][k], v, rtol=1e-6,
                                       atol=1e-6)

    def test_guarded_step_has_no_host_sync(self):
        """No ``aten._local_scalar_dense`` (``.item()``, ``bool(t)``,
        ``int(t)``) is dispatched by the guarded step: the flag and the
        counters stay tensors."""
        from torch.utils._python_dispatch import TorchDispatchMode
        state, guard = self._guarded()
        seen = []

        class Rec(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, a=(), kw=None):
                seen.append(str(func))
                return func(*a, **(kw or {}))

        carry = (state, sentinel_init("cpu"))
        for _ in range(4):      # clean steps and a poisoned one
            with Rec():
                carry, _m = guard(carry, ONE, carry[0].step)
        assert seen and not [f for f in seen
                             if "_local_scalar_dense" in f]

    def test_poisoned_step_skipped_params_kept(self):
        state, guarded = self._guarded()
        carry = (state, sentinel_init("cpu"))
        for _ in range(3):
            carry, m = guarded(carry, ONE, carry[0].step)
            assert bool(m["sentinel_healthy"])
        good = carry[0].params["w"].clone()
        carry, m = guarded(carry, ONE, carry[0].step)
        assert not bool(m["sentinel_healthy"])
        assert torch.equal(carry[0].params["w"], good)
        assert int(carry[0].step) == 4
        s = carry[1]
        assert (int(s.consecutive_bad), int(s.total_bad),
                int(s.last_bad_step)) == (1, 1, 3)

    def test_escalation_banks_records(self, tmp_path):
        ck = ResilientCheckpointer(tmp_path / "ck")
        sent = Sentinel(ck, check_every=1, rollback_after=2,
                        abort_after=4)
        state, guarded = self._guarded(sent)
        carry = (state, sentinel_init("cpu"))
        for _ in range(3):
            carry, _m = guarded(carry, ONE, carry[0].step)
            assert sent.poll(carry[1]) is None
        ck.save_sync(int(carry[0].step), carry[0], meta={"data_step": 3})
        good = carry[0].params["w"].clone()
        carry, _m = guarded(carry, ONE, carry[0].step)
        assert sent.poll(carry[1]) == "skip"
        carry, _m = guarded(carry, ONE, carry[0].step)
        assert sent.poll(carry[1]) == "rollback"
        restored, man, s0 = sent.rollback(template=carry[0])
        assert torch.equal(restored.params["w"], good)
        assert man.meta["data_step"] == 3 and int(s0.consecutive_bad) == 0
        banked = sorted(os.listdir(tmp_path / "ck" / "diagnostics"))
        assert len(banked) == 2 and banked[-1].endswith("rollback.json")
        rec = json.load(open(tmp_path / "ck" / "diagnostics" / banked[-1]))
        assert rec["consecutive_bad"] == 2 and rec["action"] == "rollback"
        ck.close()

    def test_abort_raises_divergence_error(self, tmp_path):
        sent = Sentinel(None, check_every=1, rollback_after=1,
                        abort_after=2, diagnostics_dir=str(tmp_path))
        state, guarded = self._guarded(sent)
        carry = (state, sentinel_init("cpu"))
        for _ in range(3):
            carry, _m = guarded(carry, ONE, carry[0].step)
        with pytest.raises(DivergenceError) as ei:
            for _ in range(2):
                carry, _m = guarded(carry, ONE, carry[0].step)
                sent.poll(carry[1])
        assert ei.value.record["action"] == "abort"
        assert any(n.endswith("abort.json") for n in os.listdir(tmp_path))

    def test_gnorm_threshold_flags_finite_divergence(self):
        amp, state, _ = _amp_setup()
        inner = amp.make_train_step(
            lambda p, x: torch.sum(torch.square(p["w"])) * x)
        guarded = guard_train_step(inner, gnorm_threshold=1e3)
        carry = (state, sentinel_init("cpu"))
        carry, m = guarded(carry, torch.tensor(1e8))
        assert not bool(m["sentinel_healthy"])
        assert int(carry[1].consecutive_bad) == 1
        # the gradient is finite, so the Amp step applies it; the keep
        # is the sentinel's alone
        _sentinel_keep_case("gnorm")

    def test_nan_loss_with_finite_grads_keeps_state(self):
        """A NaN loss whose gradients are finite (a `poison_at_steps`
        select passes zeros back) passes the Amp skip; Adam's moments
        would still move the params and the dynamic scale would grow its
        count. The sentinel keeps all of it, as JAX's does."""
        _sentinel_keep_case("nan_loss")

    def test_sentinel_state_keys_and_checkpoint(self, tmp_path):
        from apex1_tpu_torch.core.pytree import (keystr,
                                                 tree_flatten_with_path)
        s = sentinel_init("cpu")
        assert [keystr(p) for p, _ in tree_flatten_with_path(s)] == \
            [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(
                 jax_sentinel.sentinel_init())[0]]
        assert manifest.tree_entries(s) == jax_manifest.tree_entries(
            jax_sentinel.sentinel_init())

    @pytest.mark.parametrize("attempt", [1, 2, 7])
    def test_refolds_equal_jax(self, attempt):
        from apex1_tpu_torch.core.random import prng_key
        got = refold_key(prng_key(0), attempt)
        want = jax_sentinel.refold_key(jax.random.key(0), attempt)
        assert list(got) == [int(v) for v in jax.random.key_data(want)]
        assert refold_seed(7, attempt) == \
            jax_sentinel.refold_seed(7, attempt)
        assert refold_key(prng_key(0), 1) != refold_key(prng_key(0), 2)


# ---------------------------------------------------------------------------
# preemption


class TestPreemption:
    def test_sigterm_sets_flag_and_uninstall_restores(self):
        old = signal.getsignal(signal.SIGTERM)
        with PreemptionHandler(signals=(signal.SIGTERM,)) as pre:
            assert not pre.triggered
            os.kill(os.getpid(), signal.SIGTERM)
            assert pre.triggered and pre.signum == signal.SIGTERM
            assert not pre.deadline_exceeded()
        assert signal.getsignal(signal.SIGTERM) is old

    def test_exit_resumable_code(self, capsys):
        pre = PreemptionHandler()
        with pytest.raises(SystemExit) as ei:
            pre.exit_resumable("test")
        assert ei.value.code == EXIT_RESUMABLE == 75
        assert "resumable" in capsys.readouterr().out

    def _double_signal_child(self, first, second):
        """A subprocess loading the port's module by file path (stdlib
        only): the handler installed, two signals while the drain (a
        sleep) is in flight."""
        import subprocess
        import sys
        import textwrap

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "apex1_tpu_torch", "resilience", "preemption.py")
        code = textwrap.dedent(f"""
            import importlib.util, os, signal, sys, time
            spec = importlib.util.spec_from_file_location(
                "preemption", {path!r})
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            h = mod.PreemptionHandler().install()
            os.kill(os.getpid(), signal.{first})
            assert h.triggered
            os.kill(os.getpid(), signal.{second})
            time.sleep(5)
            sys.exit(3)
        """)
        return subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=60)

    @pytest.mark.parametrize("first,second", [("SIGTERM", "SIGTERM"),
                                              ("SIGINT", "SIGTERM")])
    def test_second_signal_mid_drain_exits_75(self, first, second):
        r = self._double_signal_child(first, second)
        assert r.returncode == EXIT_RESUMABLE == 75, \
            (r.returncode, r.stderr)
        assert "immediate resumable exit" in r.stderr


# ---------------------------------------------------------------------------
# the public surface


def test_public_surface_matches_jax():
    import importlib
    import apex1_tpu.resilience as jres
    import apex1_tpu.testing.chaos as jchaos
    import apex1_tpu_torch.resilience as pres
    assert set(pres.__all__) == set(jres.__all__)
    assert all(hasattr(pres, n) for n in jres.__all__)
    assert set(chaos.__all__) == set(jchaos.__all__)
    surface = {
        "checkpoint": ["save_checkpoint", "restore_checkpoint",
                       "CheckpointManager", "CheckpointError",
                       "to_global", "to_host_local"],
        "resilience.reshard": ["LayoutMismatch", "reshard_state",
                               "reshard_checkpoint", "read_plan",
                               "plan_meta", "mesh_str"],
        "resilience.elastic": ["ElasticDecision", "elastic_resume",
                               "drill"],
        "utils.debug": ["program_fingerprint",
                        "assert_same_program_across_processes",
                        "assert_donation_safe", "enable_deterministic"],
        "models.llama_3d": ["gather_state", "local_state"]}
    for mod, names in surface.items():
        m = importlib.import_module(f"apex1_tpu_torch.{mod}")
        assert all(hasattr(m, n) for n in names), mod


def test_the_slice_imports_no_jax():
    import subprocess
    import sys
    code = ("import sys; import apex1_tpu_torch.resilience, "
            "apex1_tpu_torch.checkpoint, apex1_tpu_torch.utils.debug, "
            "apex1_tpu_torch.testing.chaos, apex1_tpu_torch.runtime, "
            "apex1_tpu_torch.serving.engine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'apex1_tpu', 'orbax', 'ml_dtypes')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
