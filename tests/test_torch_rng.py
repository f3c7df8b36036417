"""The port's RNG keys, tracker and ``broadcast_data`` against the JAX
package's, on the CPU.

- `core.random`: `prng_key`, `fold_in`, `split`, `domain_key` for each
  named domain and a crc32 one, `model_parallel_key` at tp ranks 0-3
  and `RNGKeychain.key(name, step)`: the key data bit for bit equal to
  ``jax.random.key_data`` of JAX's keys;
- `RNGStatesTracker`: ``add`` (a duplicate raises RuntimeError),
  ``fork`` outside a tp group (the key as it is, as JAX's outside
  ``shard_map``), ``reset``, ``get_states``/``set_states`` and
  `model_parallel_seed`, the keys bit for bit JAX's tracker's;
- two gloo ranks (`apex1_tpu_torch.parallel.launch`, body in
  tests/torch_dist_ranks.py) at tp = 2: each rank's ``fork`` and
  `model_parallel_key` equal JAX's under ``shard_map`` on device r (a
  fork folds the tp index into any domain, as JAX's); `broadcast_data`
  with other
  data on rank 1 gives rank 0's values everywhere (cast first with a
  ``datatype``), one broadcast a tensor, as JAX's masked sum does.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex1_tpu.core import random as jrandom
from apex1_tpu.core.mesh import make_mesh
from apex1_tpu.transformer.tensor_parallel import data as jdata
from apex1_tpu.transformer.tensor_parallel import random as jtracker
from apex1_tpu_torch.core import random as trandom
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.transformer.tensor_parallel import random as ttracker

import torch_dist_ranks

N = 2
SEEDS = (0, 42, 1234, 2 ** 31 - 1, -5)
DOMAINS = ("default", "model-parallel-rng", "data-parallel-rng", "dropout",
           "attention")


def _kd(key) -> tuple:
    """JAX key data as a pair of ints."""
    a = np.asarray(jax.random.key_data(key) if jnp.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key)
    return tuple(int(v) for v in a.astype(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bitwise(seed):
    jkey = jax.random.PRNGKey(seed)
    key = trandom.prng_key(seed)
    assert key == _kd(jkey)
    assert trandom.fold_in(key, 7) == _kd(jax.random.fold_in(jkey, 7))
    assert trandom.split(key, 3) == [_kd(k) for k in
                                     jax.random.split(jkey, 3)]
    for d in DOMAINS:
        assert trandom.domain_key(key, d) == _kd(jrandom.domain_key(jkey, d))
    for name in ("dropout", "data-parallel-rng"):
        for step in (0, 1, 5, 2 ** 32 - 1):
            assert (trandom.RNGKeychain(seed).key(name, step)
                    == _kd(jrandom.RNGKeychain(seed).key(name, step)))


def test_model_parallel_key_at_each_tp_rank():
    key = jax.random.PRNGKey(99)
    mesh = make_mesh(tp=4, devices=jax.devices()[:4])
    want = jax.jit(jax.shard_map(
        lambda _: jrandom.model_parallel_key(key)[None],
        mesh=mesh, in_specs=P("tp"), out_specs=P("tp")))(jnp.zeros(4))
    for r in range(4):
        assert trandom.model_parallel_key(_kd(key), r) == _kd(want[r])


def test_tracker_outside_a_group():
    jt, tt = jtracker.RNGStatesTracker(), ttracker.RNGStatesTracker()
    for t in (jt, tt):
        t.add("dropout", 5)
    with pytest.raises(RuntimeError, match="already present"):
        tt.add("dropout", 6)
    assert tt.fork("dropout") == _kd(jt.fork("dropout"))
    assert tt.fork("dropout") == trandom.prng_key(5)
    saved = tt.get_states()
    tt.reset()
    assert tt.get_states() == {}
    with pytest.raises(KeyError):
        tt.fork("dropout")
    tt.set_states(saved)
    assert tt.fork("dropout", tp_axis=None) == trandom.prng_key(5)
    jtracker.model_parallel_seed(77)
    ttracker.model_parallel_seed(77)
    jstates = jtracker.get_rng_tracker().get_states()
    tstates = ttracker.get_rng_tracker().get_states()
    assert set(tstates) == set(jstates) == {"default", "model-parallel-rng"}
    for k, v in jstates.items():
        assert tstates[k] == _kd(v)
    assert tstates["model-parallel-rng"] == trandom.prng_key(77 + 2718)


def _inputs() -> dict:
    rng = np.random.default_rng(51)
    return {"seed": np.int64(31), "key": np.asarray(
        jax.random.PRNGKey(8)).astype(np.int64),
        "a": rng.standard_normal((N, 3, 4)).astype(np.float32),
        "b": rng.integers(0, 100, (N, 5)).astype(np.int64)}


def _jax_ranks(inputs) -> dict:
    mesh = make_mesh(tp=N, devices=jax.devices()[:N])
    jtracker.model_parallel_seed(int(inputs["seed"]))
    tr = jtracker.get_rng_tracker()
    key = jnp.asarray(inputs["key"].astype(np.uint32))

    def body(a, b):
        got = jdata.broadcast_data(["a", "b"], {"a": a[0], "b": b[0]})
        got_f = jdata.broadcast_data(["a"], {"a": a[0]}, jnp.float32)
        out = dict(fork_mp=tr.fork(), fork_default=tr.fork("default"),
                   mp_key=jrandom.model_parallel_key(key), a=got["a"],
                   b=got["b"], a_f=got_f["a"])
        return jax.tree_util.tree_map(lambda t: t[None], out)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("tp"), P("tp")),
                               out_specs=P("tp"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(
        jnp.asarray(inputs["a"]), jnp.asarray(inputs["b"].astype(np.int32))))


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.rng_cases, N, inputs, N,
                         backend="gloo")
        want = _jax_ranks(inputs)
        return dict(port=port.result(), want=want, inputs=inputs)


def test_tracker_forks_per_tp_rank(world):
    want = world["want"]
    for r, got in enumerate(world["port"]):
        assert tuple(got["fork_mp"]) == _kd(want["fork_mp"][r])
        assert tuple(got["fork_default"]) == _kd(want["fork_default"][r])
        assert tuple(got["mp_key"]) == _kd(want["mp_key"][r])
        # tp_axis=None: the domain key itself, the same on every rank
        assert tuple(got["fork_untied"]) == trandom.prng_key(
            int(world["inputs"]["seed"]) + 2718)
    ports = world["port"]
    assert ports[0]["fork_mp"] != ports[1]["fork_mp"]


def test_broadcast_data_takes_rank_0(world):
    inputs, want = world["inputs"], world["want"]
    for r, got in enumerate(world["port"]):
        np.testing.assert_array_equal(got["a"], inputs["a"][0])
        np.testing.assert_array_equal(got["b"], inputs["b"][0])
        np.testing.assert_array_equal(got["a"], want["a"][r])
        np.testing.assert_array_equal(got["b"], want["b"][r])
        assert got["a_f64"].dtype == np.float64
        np.testing.assert_array_equal(got["a_f64"], want["a_f"][r])
        assert got["counts"] == 3
