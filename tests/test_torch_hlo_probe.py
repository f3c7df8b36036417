"""The port's overlap probe (`apex1_tpu_torch.testing.hlo_probe`)
against the JAX package's, on the CPU.

The verdicts are the JAX package's: its `check_collective_overlap`
passes the overlapped ring (forward, and forward + backward) and fails
`ring_attention_serial` on its 8-device CPU mesh (optimized HLO at cp =
4: at cp = 2 XLA unrolls the ring's one-step loop and the JAX probe
finds no loop body to read);
the port's probe, reading the ``torch.profiler`` traces of the same
rings on two gloo ranks (`parallel.launch`, rank bodies in
tests/torch_dist_ranks.py), gives the same verdict on each rank, in
dependence mode. `halo.exchange_overlap` passes, the plain
`halo_exchange` has no compute to probe. `count_collectives` equals
`mappings.COLLECTIVES` over the same traced step for every kind. Async
mode (the card's NCCL kernels) is held on hand-built device events: an
NCCL kernel bracketing a compute kernel on another stream passes, the
same kernels one after the other fail; its run on NCCL ranks waits for
two cards.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.parallel.ring_attention import ring_attention as jax_ring
from apex1_tpu.parallel.ring_attention import \
    ring_attention_serial as jax_serial
from apex1_tpu.testing import hlo_probe as jhp
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.testing import hlo_probe as hp

import torch_dist_ranks

N, JAX_CP = 2, 4


def _jax_verdicts(devices):
    mesh = make_mesh(cp=JAX_CP, dp=1, devices=devices[:JAX_CP])
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 2, 64 * JAX_CP, 16)),
                           jnp.float32) for _ in range(3))
    spec = P(None, None, "cp", None)

    def smap(fn):
        return jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                             out_specs=spec)

    ring = smap(lambda q, k, v: jax_ring(q, k, v, "cp", causal=True))
    serial = smap(lambda q, k, v: jax_serial(q, k, v, "cp", causal=True))

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v) ** 2)

    return {"fwd": jhp.check_collective_overlap(
                jhp.optimized_hlo(ring, q, k, v)),
            "bwd": jhp.check_collective_overlap(jhp.optimized_hlo(
                jax.grad(loss, argnums=(0, 1, 2)), q, k, v)),
            "serial": jhp.check_collective_overlap(
                jhp.optimized_hlo(serial, q, k, v))}


@pytest.fixture(scope="module")
def runs(devices):
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.hlo_probe_cases, N, N,
                         backend="gloo")
        jax_out = _jax_verdicts(devices)
        return jax_out, port.result(timeout=600)


@pytest.mark.parametrize("which", ["fwd", "bwd", "serial"])
def test_ring_verdicts_equal_jax(runs, which):
    jax_out, ranks = runs
    want = jax_out[which]
    assert want.mode == "dependence" and want.bodies
    for res in ranks:
        rep = hp.check_collective_overlap(res[which]["events"])
        assert rep.mode == "dependence" and rep.bodies
        assert rep.ok == want.ok, rep.detail
        assert len(rep.bodies) == (2 if which == "bwd" else 1)
        if want.ok:
            hp.assert_collective_overlap(res[which]["events"],
                                         expect_mode="dependence")
        else:
            with pytest.raises(AssertionError, match="FAILED"):
                hp.assert_collective_overlap(res[which]["events"])


def test_halo_exchange_overlap_passes(runs):
    for res in runs[1]:
        rep = hp.assert_collective_overlap(res["halo"]["events"])
        assert [b.body for b in rep.bodies] == ["halo"]
        plain = hp.check_collective_overlap(res["halo_plain"]["events"])
        assert not plain.ok and not plain.bodies


@pytest.mark.parametrize("kind", ["all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all",
                                  "send_recv", "broadcast"])
def test_count_collectives_equals_the_counter(runs, kind):
    for res in runs[1]:
        for step in ("counts", "halo"):
            got = hp.count_collectives(res[step]["events"], (kind,))
            assert got == res[step]["counts"][kind], (step, kind)
        ring = res["bwd"]
        if kind == "send_recv":
            assert hp.count_collectives(ring["events"], (kind,)) == \
                ring["send_recv"] > 0


def _k(name, ts, dur, stream):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream}


@pytest.mark.parametrize("overlapped", [True, False])
def test_async_mode_on_hand_built_device_events(overlapped):
    comm = "ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)"
    attend = "void flash_fwd_wg_kernel<__nv_bfloat16, 64, false, true>(F)"
    if overlapped:   # the hop's kernel on its own stream spans the attend
        ev = [_k(comm, 0, 100, 20), _k(attend, 10, 60, 7)]
    else:            # the attend waits for the transfer to land
        ev = [_k(comm, 0, 40, 20), _k(attend, 45, 60, 7)]
    ev.append(_k(attend, 200, 30, 7))
    rep = hp.check_collective_overlap(ev)
    assert rep.mode == "async" and rep.ok == overlapped
    assert rep.bodies[0].n_permutes == 1 and rep.bodies[0].n_compute == 2
    if overlapped:
        hp.assert_collective_overlap(ev, expect_mode="async")
    with pytest.raises(AssertionError, match="expected 'dependence'"):
        hp.assert_collective_overlap(ev, expect_mode="dependence")


def test_same_stream_is_not_overlap():
    ev = [_k("ncclKernel_AllReduce_RING", 0, 100, 7),
          _k("void glu_wg_kernel<__half, 0, 64>(GluArgs)", 10, 20, 7)]
    assert not hp.check_collective_overlap(ev).ok


def test_nothing_to_probe_fails():
    rep = hp.check_collective_overlap([])
    assert not rep.ok and not rep.bodies and "nothing to probe" in rep.detail
