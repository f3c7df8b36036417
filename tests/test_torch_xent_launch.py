"""What the cross-entropy wrappers hand the kernels, checked on the CPU.

The wrappers pass the logits in place (a ``logits[:, :-1]`` slice keeps
its pointer and strides: no copy) with the arguments in the order and
number of the C entry points, whose parameter lists are read back from
``csrc/xentropy.cu``. Which columns of a row take 16-byte vectors the
kernels decide per row from the row's own address; the main path's
slice is shown here to start every row on 16 bytes, and the unpadded
width to leave rows off them (the kernels' scalar head)."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops import xentropy as xe
from apex1_tpu_torch.ops._common import DTYPE_CODES

CU = (Path(__file__).resolve().parent.parent / "apex1_tpu_torch" / "csrc"
      / "xentropy.cu").read_text()

_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("entry", ["apex1_xent_fwd", "apex1_xent_bwd"])
def test_entry_point_arity_matches_signature(entry):
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                       CU).group(1)
    assert len(params.split(",")) == len(_build.SIGNATURES[entry])


@pytest.mark.parametrize("dtype", _DTYPES)
def test_gpt2_slice_rows_start_on_16_bytes(dtype):
    """The training step's logits[:, :-1] of (16, 1024, 50304): both
    strides are whole 16-byte vectors, so every row of an aligned
    tensor takes the vector path from its first column; the unpadded
    width 50257 leaves rows off 16 bytes."""
    es = torch.empty((), dtype=dtype).element_size()
    x3 = xe._as3d(torch.empty((16, 1024, 50304), dtype=dtype,
                              device="meta")[:, :-1])
    assert x3.shape == (16, 1023, 50304)
    assert x3.stride(0) * es % 16 == 0 and x3.stride(1) * es % 16 == 0
    odd = xe._as3d(torch.empty((16, 1024, 50257), dtype=dtype,
                               device="meta")[:, :-1])
    assert odd.stride(1) * es % 16 != 0


def _record_launches(monkeypatch):
    """Route the wrappers to a recorder of their C arguments, as if the
    CPU tensors were on the card."""
    calls = []
    monkeypatch.setattr(xe, "use_kernel", lambda x: True)
    monkeypatch.setattr(xe, "check_cuda", lambda *a: None)
    monkeypatch.setattr(xe._build, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("width", [300, 4099])
def test_wrappers_pass_the_slice_in_place(monkeypatch, width, dtype):
    calls = _record_launches(monkeypatch)
    full = torch.zeros(2, 6, width, dtype=dtype)
    x = full[:, :-1]
    labels = torch.zeros(10, dtype=torch.int64)
    loss, lse = xe.xent_fwd(x, labels, 0.1, 3, width - 2)
    dx = xe.xent_bwd(x, labels, lse, torch.ones(10), 0.1, 3, width - 2)
    assert loss.shape == lse.shape == (10,) and dx.shape == (10, width)
    assert [name for name, _ in calls] == ["apex1_xent_fwd",
                                           "apex1_xent_bwd"]
    for (name, args), first in zip(calls, (4, 5)):
        assert len(args) == len(_build.SIGNATURES[name])
        # the logits' own pointer: the slice is not copied
        assert args[0] == full.data_ptr()
        # rows, t_len, s_a, s_t, width, K
        assert args[first:first + 6] == (10, 5, 6 * width, width, width,
                                         width - 2)
        assert args[-2] == DTYPE_CODES[dtype]
