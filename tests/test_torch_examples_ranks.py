"""The port's data-parallel examples over two gloo ranks, launched
through `parallel.multiproc`'s command line (``main(["--nproc", "2",
script, ...])``, each rank joining through `init_from_env`): rank 0's
final params within 1e-5 of one process on the whole batch, for
`examples.imagenet_amp` (SyncBN statistics and averaged gradients) and
`examples.distributed_data_parallel`."""

import os

import numpy as np
import pytest

from apex1_tpu_torch.examples import distributed_data_parallel, imagenet_amp
from apex1_tpu_torch.parallel import multiproc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "apex1_tpu_torch", "examples")


@pytest.fixture
def child_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _two_ranks(script, out, *args):
    code = multiproc.main(["--nproc", "2", os.path.join(EXAMPLES, script),
                           "--device", "cpu", "--out", str(out), *args])
    assert code == 0
    return np.load(out)


def test_imagenet_amp_two_ranks_equal_one_on_the_whole_batch(tmp_path,
                                                             child_env):
    args = ["--tiny", "--opt-level", "O0", "--steps", "3", "--image", "32"]
    got = _two_ranks("imagenet_amp.py", tmp_path / "w2.npz", *args,
                     "--batch", "2")
    one = imagenet_amp.main(args + ["--device", "cpu", "--batch", "4"])
    params = one["state"][0].params
    assert sorted(got.files) == sorted(params)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_distributed_data_parallel_two_ranks_equal_one(tmp_path, child_env):
    got = _two_ranks("distributed_data_parallel.py", tmp_path / "w2.npz")
    one = distributed_data_parallel.main(["--device", "cpu"])
    np.testing.assert_allclose(got["w"], one["params"]["w"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert one["losses"][-1] < one["losses"][0]


def test_launcher_reports_the_first_failure(tmp_path, child_env,
                                            monkeypatch):
    monkeypatch.setattr(multiproc, "FAILURE_GRACE_S", 0.5)
    bad = tmp_path / "bad.py"
    bad.write_text("import os, sys, time\n"
                   "if os.environ['RANK'] == '1':\n    sys.exit(3)\n"
                   "time.sleep(60)\n")
    assert multiproc.launch_script(str(bad), num_processes=2) == 3
    ok = tmp_path / "ok.py"
    ok.write_text("import os\nassert os.environ['WORLD_SIZE'] == '2'\n"
                  "assert os.environ['LOCAL_RANK'] == os.environ['RANK']\n"
                  "assert int(os.environ['MASTER_PORT']) > 0\n")
    assert multiproc.main(["--nproc", "2", str(ok)]) == 0
    assert multiproc.main([]) == 2
