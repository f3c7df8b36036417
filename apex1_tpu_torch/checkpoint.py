"""Checkpoint and resume (the port of ``apex1_tpu/checkpoint.py``;
reference ``amp.state_dict()``, ``DistributedFusedAdam.state_dict()``).

One checkpoint holds the whole train state: an `AmpState` carries the
params, the optimizer state, the loss-scale state and the step, the
tuple the reference's README saves by hand.

The payload is the port's own (the card has no orbax, so neither
package reads the other's payload; the manifest of
`resilience.manifest` is the shared contract):

- ``index.json``: a format tag and, for each leaf in key-path order
  (`core.pytree.keystr`), its path, numpy dtype name, shape and file;
- ``leaves/<i>.bin``: the leaf's C-contiguous little-endian bytes, one
  raw file a leaf. No pickle.

Atomicity as in the JAX package: the payload lands in
``<path>.tmp-<pid>``, each file and the directory are fsynced, and the
directory is renamed to ``path``; an existing ``path`` is moved aside
first, so a kill at any point leaves the old or the new checkpoint,
never a half one.

Distributed state follows Apex's own ``DistributedFusedAdam
.state_dict``: a tree holding DTensors (`core.mesh.place`,
`to_global`) is saved by a collective call on every rank (each leaf
gathered with ``full_tensor()``, rank 0 writes and commits, every rank
waits for its verdict); a restore with ``mesh`` and ``spec_tree``
places each leaf by its spec (`core.mesh.place`), so a checkpoint
written on one layout restores onto another.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from apex1_tpu_torch.core.pytree import (is_key_data, keystr,
                                         tree_flatten_with_path,
                                         tree_map_with_path)

# suffix marker for in-progress saves: a killed save leaves only
# `<path>.tmp-<pid>`, never a half-written `<path>` that looks restorable
_TMP_MARK = ".tmp-"
_FORMAT = "apex1-torch-ckpt-v1"
_INDEX = "index.json"
_LEAVES = "leaves"


class CheckpointError(RuntimeError):
    """Typed checkpoint failure naming the path and the reason: a
    missing directory, a partial save, a short or corrupt leaf file and
    a structure, shape or dtype that differs from the template all
    surface through this one type."""

    def __init__(self, path: str | os.PathLike, reason: str):
        self.path = os.fspath(path)
        self.reason = reason
        super().__init__(f"checkpoint {self.path}: {reason}")


def _is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and hasattr(x, "full_tensor")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_payload(tmp: str, leaves: list) -> None:
    """``leaves``: [(path string, array, dtype name)] (host arrays)."""
    from apex1_tpu_torch.resilience.manifest import (atomic_write_json,
                                                     parallel_map)
    os.makedirs(os.path.join(tmp, _LEAVES))

    def write(i):
        a = leaves[i][1]
        with open(os.path.join(tmp, _LEAVES, f"{i}.bin"), "wb") as f:
            f.write(memoryview(np.ascontiguousarray(a).reshape(-1)
                               .view(np.uint8)))
            f.flush()
            os.fsync(f.fileno())

    parallel_map(write, range(len(leaves)))
    index = [{"path": p, "dtype": name, "shape": list(a.shape),
              "file": f"{_LEAVES}/{i}.bin"}
             for i, (p, a, name) in enumerate(leaves)]
    _fsync_dir(os.path.join(tmp, _LEAVES))
    atomic_write_json(os.path.join(tmp, _INDEX),
                      {"format": _FORMAT, "leaves": index})
    _fsync_dir(tmp)


def commit_dir(tmp: str, path: str) -> None:
    """Rename ``tmp`` to ``path``; an existing ``path`` is moved aside
    first, never deleted before the rename."""
    old = None
    try:
        if os.path.exists(path):
            old = f"{path}.old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(tmp, path)
        _fsync_dir(os.path.dirname(path))
    except BaseException:
        if old is not None and not os.path.exists(path):
            os.rename(old, path)        # put the old checkpoint back
            old = None
        raise
    finally:
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)


def save_checkpoint(path: str | os.PathLike, state: Any, *,
                    force: bool = True) -> None:
    """Write ``state`` (a tree of tensors, arrays, scalars and keys, e.g.
    an `AmpState`) to ``path``, atomically (module docstring). A tree
    with DTensor leaves is a collective call on every rank."""
    import torch.distributed as dist
    from apex1_tpu_torch.resilience.manifest import host_leaves
    path = os.fspath(os.path.abspath(path))
    collective = (dist.is_available() and dist.is_initialized()
                  and any(_is_dtensor(x)
                          for _, x in tree_flatten_with_path(state)))
    writer = not collective or dist.get_rank() == 0
    err = None
    if writer and os.path.exists(path) and not force:
        err = "exists and force=False"
    leaves = None
    try:
        if writer and err is None:
            leaves = host_leaves(state)
        elif collective:
            # join each leaf's gather in the writer's order; only the
            # writer keeps a host copy
            for _, x in tree_flatten_with_path(state):
                if _is_dtensor(x):
                    x.full_tensor()
    except Exception as e:
        err = f"save failed: {e!r}"
    if writer and err is None:
        tmp = f"{path}{_TMP_MARK}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _write_payload(tmp, leaves)
            commit_dir(tmp, path)
        except Exception as e:
            shutil.rmtree(tmp, ignore_errors=True)
            err = f"save failed: {e!r}"
    if collective:
        verdict = [err]
        dist.broadcast_object_list(verdict, src=0)
        err = verdict[0]
    if err is not None:
        raise CheckpointError(path, err)


def read_index(path: str) -> list:
    """The payload's leaf entries: ``[{path, dtype, shape, file}]`` in
    key-path order."""
    try:
        with open(os.path.join(path, _INDEX)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(path, f"restore failed: index unreadable "
                              f"({e})") from e
    if doc.get("format") != _FORMAT:
        raise CheckpointError(path, f"restore failed: unknown payload "
                              f"format {doc.get('format')!r}")
    return doc["leaves"]


def _load_leaf(path: str, entry: dict) -> np.ndarray:
    """A leaf file's bytes as a numpy array of the entry's shape (a
    name numpy lacks as its integer view)."""
    from apex1_tpu_torch.resilience.manifest import host_dtype
    np_dt = host_dtype(entry["dtype"])
    shape = tuple(entry["shape"])
    n = int(np.prod(shape, dtype=np.int64))
    full = os.path.join(path, entry["file"])
    try:
        size = os.path.getsize(full)
        if size != n * np_dt.itemsize:
            raise CheckpointError(
                path, f"restore failed: leaf {entry['path']}: {size} "
                f"bytes, expected {n * np_dt.itemsize} (truncated?)")
        return np.fromfile(full, dtype=np_dt, count=n).reshape(shape)
    except OSError as e:
        raise CheckpointError(path, f"restore failed: leaf "
                              f"{entry['path']}: {e}") from e


def _host_like(template, a: np.ndarray, name: str):
    """A loaded leaf in the template leaf's type, on the host: a CPU
    tensor, a key tuple, a Python scalar or a numpy array of its dtype."""
    from apex1_tpu_torch.resilience.manifest import to_tensor
    if template is None or isinstance(template, torch.Tensor):
        return to_tensor(a, name)
    if is_key_data(template):
        return tuple(int(v) for v in a.reshape(-1))
    if isinstance(template, (bool, int, float)):
        return type(template)(a.item())
    return a.view(np.asarray(template).dtype)


def _device_of(template, device):
    """Where a restored tensor goes: the template tensor's device (a
    meta tensor's, or no template's: ``device``)."""
    if template is None or template.is_meta:
        return device
    return (template.to_local().device if _is_dtensor(template)
            else template.device)


def _template_meta(leaf) -> tuple:
    """(shape, dtype name) a template leaf asks for."""
    from apex1_tpu_torch.resilience.manifest import dtype_name, host_array
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), dtype_name(leaf.dtype)
    a, name = host_array(leaf)
    return tuple(a.shape), name


def _nested(entries: dict):
    """Template-free: nested dicts keyed by the path's keys (list and
    tuple indices as strings), as orbax restores without a target."""
    import re
    out: dict = {}
    token = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(-?\d+)\]|\.(\w+)")
    for p, v in entries.items():
        keys = [m.group(1) if m.group(1) is not None else
                m.group(2) if m.group(2) is not None else m.group(3)
                for m in token.finditer(p)]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys:
            node[keys[-1]] = v
        else:
            return v
    return out


def restore_checkpoint(path: str | os.PathLike, template: Any = None, *,
                       mesh=None, spec_tree: Any = None, device=None
                       ) -> Any:
    """Restore a checkpoint.

    ``template``: a tree matching the saved structure (its tensors may
    be meta tensors: `models.llama_3d.abstract_state`); the result has
    the template's containers and leaf types, each tensor on the
    template leaf's device. Without a template the result is nested
    dicts of tensors on ``device`` (CUDA unless named). With ``mesh``
    and ``spec_tree`` (a tree of `parallel.specs.PartitionSpec` shaped
    like the state) every tensor is placed by its spec
    (`core.mesh.place`): resume on another layout than the save.

    Leaf files are read side by side (`resilience.manifest.parallel_map`).
    Raises `CheckpointError` on a missing path, an unfinished ``.tmp-``
    save, a short or corrupt leaf file, and a structure, shape or dtype
    that differs from the template.
    """
    from apex1_tpu_torch.ops._common import resolve_device
    path = os.fspath(os.path.abspath(path))
    if not os.path.exists(path):
        raise CheckpointError(path, "missing (no such directory)")
    if _TMP_MARK in os.path.basename(path):
        raise CheckpointError(
            path, "partial write (unfinished save temp dir)")
    index = {e["path"]: e for e in read_index(path)}
    if template is None:
        flat = [(p, None) for p in index]
    else:
        flat = [(keystr(p), x) for p, x in tree_flatten_with_path(template)]
        want = {p for p, _ in flat}
        if want != set(index):
            raise CheckpointError(
                path, "restore failed: structure mismatch: missing "
                f"{sorted(want - set(index))[:4]}, unexpected "
                f"{sorted(set(index) - want)[:4]}")
        for p, x in flat:
            e = index[p]
            shape, name = _template_meta(x)
            if shape != tuple(e["shape"]) or name != e["dtype"]:
                raise CheckpointError(
                    path, f"restore failed: leaf {p} is "
                    f"{e['dtype']}{list(e['shape'])} on disk, the "
                    f"template asks {name}{list(shape)}")
    from apex1_tpu_torch.resilience.manifest import parallel_map
    arrays = parallel_map(lambda px: _load_leaf(path, index[px[0]]), flat)
    host = {p: _host_like(x, a, index[p]["dtype"])
            for (p, x), a in zip(flat, arrays)}
    del arrays
    if any(x is None or (isinstance(x, torch.Tensor) and x.is_meta)
           for _, x in flat):
        device = resolve_device(device)
    moved = {p: (host[p].to(_device_of(x, device))
                 if isinstance(host[p], torch.Tensor) else host[p])
             for p, x in flat}
    del host
    state = (_nested(moved) if template is None else tree_map_with_path(
        lambda p, x: moved[keystr(p)], template))
    if mesh is None:
        return state
    return _placed(state, mesh, spec_tree)


def _is_spec(x) -> bool:
    from apex1_tpu_torch.parallel.specs import PartitionSpec
    return isinstance(x, PartitionSpec)


def _placed(state, mesh, spec_tree):
    """Each tensor of ``state`` placed on ``mesh`` by its spec in
    ``spec_tree`` (replicated where None)."""
    from apex1_tpu_torch.core.mesh import place
    from apex1_tpu_torch.parallel.specs import PartitionSpec
    if spec_tree is None:
        spec_tree = tree_map_with_path(lambda p, x: PartitionSpec(), state)
    specs = {keystr(p): s for p, s in
             tree_flatten_with_path(spec_tree, is_leaf=_is_spec)}
    tensors = {keystr(p): x for p, x in tree_flatten_with_path(state)
               if isinstance(x, torch.Tensor)}
    placed = place(tensors, {k: specs[k] for k in tensors}, mesh)
    return tree_map_with_path(
        lambda p, x: placed.get(keystr(p), x), state)


def to_global(tree, mesh, spec_tree: Any = None):
    """Rank-local pieces as global DTensors on ``mesh``: each tensor
    leaf is this rank's block of the global tensor split by its spec in
    ``spec_tree`` (replicated by default), ``DTensor.from_local`` over
    the mesh axes `core.mesh.place` spans. Such a tree saves as its
    global tensors (`save_checkpoint`): a `DistributedAdamState`'s
    ``…_shard`` slices become the one padded flat buffer."""
    from torch.distributed.tensor import DTensor
    from apex1_tpu_torch.core.mesh import placements, spanned_mesh
    from apex1_tpu_torch.parallel.specs import PartitionSpec
    if spec_tree is None:
        spec_tree = tree_map_with_path(lambda p, x: PartitionSpec(), tree)
    specs = {keystr(p): s for p, s in
             tree_flatten_with_path(spec_tree, is_leaf=_is_spec)}
    dm, axes = spanned_mesh(mesh, specs.values())

    def leaf(p, x):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(
            x, dm, placements(specs[keystr(p)], x.ndim, axes),
            run_check=False)

    return tree_map_with_path(leaf, tree)


def to_host_local(tree, mesh=None, spec_tree: Any = None):
    """`to_global`'s inverse: each DTensor leaf as this rank's block
    (``to_local()``); other leaves as they are."""
    return tree_map_with_path(
        lambda p, x: x.to_local() if _is_dtensor(x) else x, tree)


class CheckpointManager:
    """Step-numbered checkpoints ``<directory>/<step>`` with orbax's
    rotation: a save at a step that ``save_interval_steps`` does not
    divide is skipped unless ``force``; after each save only the newest
    ``max_to_keep`` remain. ``save(step, state)`` / ``latest()`` /
    ``restore(template)``; saves are synchronous, so
    ``wait_until_finished`` returns at once."""

    def __init__(self, directory: str | os.PathLike, *,
                 max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = os.fspath(os.path.abspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        if step in self.all_steps():
            raise CheckpointError(os.path.join(self.directory, str(step)),
                                  "step already saved")
        save_checkpoint(os.path.join(self.directory, str(step)), state)
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)
        return True

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None,
                mesh=None, spec_tree: Any = None, device=None) -> Any:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        return restore_checkpoint(os.path.join(self.directory, str(step)),
                                  template, mesh=mesh, spec_tree=spec_tree,
                                  device=device)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing to release."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
