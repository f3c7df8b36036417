"""Build and load the port's CUDA kernels.

The sources in ``apex1_tpu_torch/csrc/*.cu`` have a plain C interface
(no PyTorch headers), so ``nvcc`` compiles each in seconds. At first
use every source is compiled to an object file by its own ``nvcc``,
all started together, and the objects are linked into one shared
library under ``apex1_tpu_torch/build/`` (git-ignored), named by a
hash of the sources and flags so an edited source is rebuilt. The
library is loaded with ctypes; each wrapper passes raw pointers from
``tensor.data_ptr()`` and the current stream, and checks the returned
``cudaGetLastError()`` code.

Nothing here runs at import time: the CPU tests import every module
of the package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

#: sm_90a: Hopper with its architecture-specific instructions. No
#: --use_fast_math: the sampler's gumbel noise must use precise logf so
#: it equals torch.log on the card bit for bit.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry points and their argument types (pointers and the stream
#: as c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "apex1_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                             _P],
    "apex1_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P],
    "apex1_softmax_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _L, _L, _L,
                          _L, _I, _P],
    "apex1_softmax_bwd": [_P, _P, _P, _L, _I, _F, _I, _P],
    "apex1_xent_fwd": [_P, _P, _P, _P, _I, _I, _L, _L, _I, _I, _F, _F, _I,
                       _I, _I, _P],
    "apex1_xent_bwd": [_P, _P, _P, _P, _P, _I, _I, _L, _L, _I, _I, _F, _F,
                       _I, _I, _I, _P],
    "apex1_paged_attend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _I, _I, _P],
    "apex1_fused_sample": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
}

_LOCK = threading.Lock()
_STATE: dict = {"lib": None, "log": ""}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit (set CUDA_HOME)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build() -> Path:
    """Compile every source (one ``nvcc`` each, in parallel) and link
    the shared library; returns its path. A finished library with the
    same digest is reused."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / f"libapex1_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    cc = nvcc()
    objs, procs = [], []
    for src in sources():
        obj = BUILD / f"{src.stem}_{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, _run([cc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                                 str(src), "-o", str(obj)])))
    log = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        (BUILD / "build.log").write_text("\n".join(log))
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD / f"{lib.name}.{os.getpid()}.tmp"
    link = _run([cc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                 *map(str, objs)])
    out, _ = link.communicate()
    log.append(f"== link\n{out}")
    (BUILD / "build.log").write_text("\n".join(log))
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + out)
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    _STATE["log"] = "\n".join(log)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _STATE["lib"] is None:
        with _LOCK:
            if _STATE["lib"] is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _STATE["lib"] = lib
    return _STATE["lib"]


def build_log() -> str:
    """nvcc's output (with ptxas's register and spill report) from a
    build in this process; empty when the library was already built."""
    return _STATE["log"]


def launch(name: str, *args) -> None:
    """Call one C entry point and raise on a refused launch."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
