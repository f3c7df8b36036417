"""Rank bodies for the port's distributed CPU tests.

`apex1_tpu_torch.parallel.launch` runs each function here in spawned
ranks of a gloo process group. A spawned rank imports this module, so
it imports torch, numpy and the port, never JAX: the ranks stay light.
Each body takes the global numpy inputs, with a leading axis of one
entry per rank where the ranks' inputs differ, runs every case of its
test file on this rank's entries and returns numpy arrays; the test
files hold the results against the JAX package's ``shard_map`` on its
8-device CPU mesh, where device r holds rank r's entries.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _setup(**degrees):
    """One thread (the ranks share the box's cores) and the mesh."""
    from apex1_tpu_torch.transformer import parallel_state
    torch.set_num_threads(1)
    parallel_state.destroy_model_parallel()
    return parallel_state.initialize_model_parallel(**degrees)


def _mine(inputs: dict, rank: int) -> dict:
    """This rank's tensors: entry ``rank`` of each stacked input."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank]))
            for k, v in inputs.items()}


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().copy()
    return x


def _vjp(fn, primals: list, ct: torch.Tensor):
    """``(fn(*primals), grads of <fn(*primals), ct> per primal)``."""
    xs = [p.clone().requires_grad_() for p in primals]
    y = fn(*xs)
    grads = torch.autograd.grad(y, xs, ct, allow_unused=True)
    return [y.detach()] + [None if g is None else g for g in grads]


def _raises(fn, *exc) -> str:
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


# ---- tests/test_torch_tensor_parallel.py --------------------------------


def tp_regions(i: dict, group) -> dict:
    """The seven region functions and the decomposed collective matmuls,
    forward and vjp."""
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    out = {}
    for name, fn, x in (
            ("copy", tp.copy_to_tensor_model_parallel_region, "x_rep"),
            ("reduce", tp.reduce_from_tensor_model_parallel_region, "x"),
            ("scatter", tp.scatter_to_tensor_model_parallel_region,
             "x_wide"),
            ("gather", tp.gather_from_tensor_model_parallel_region, "x"),
            ("sp_scatter", tp.scatter_to_sequence_parallel_region,
             "x_seq_rep"),
            ("sp_gather", tp.gather_from_sequence_parallel_region, "x"),
            ("sp_gather_split",
             lambda x, g: tp.gather_from_sequence_parallel_region(
                 x, g, 0, False), "x"),
            ("sp_rs", tp.reduce_scatter_to_sequence_parallel_region,
             "x_seq")):
        y, dx = _vjp(lambda a: fn(a, group), [i[x]], i[f"ct_{name}"])
        out[name] = [y, dx]
    out["agm"] = _vjp(lambda x, w: tp.all_gather_matmul(x, w, group, 0),
                      [i["x"], i["w_col"]], i["ct_agm"])
    out["mrs"] = _vjp(lambda x, w: tp.matmul_reduce_scatter(x, w, group, 0),
                      [i["x_seq"], i["w_row"]], i["ct_mrs"])
    out["mrs3"] = _vjp(
        lambda x, w: tp.matmul_reduce_scatter(x, w, group, 0),
        [i["x_seq3"], i["w_row"]], i["ct_mrs3"])
    return out


def tp_layers(i: dict, group) -> dict:
    """The functional layers, forward and vjp (x, kernel, bias)."""
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    out = {}
    col = tp.column_parallel_linear
    row = tp.row_parallel_linear
    out["col"] = _vjp(lambda x, w, b: col(x, w, b, gather_output=True,
                                          group=group),
                      [i["x_rep"], i["w_col"], i["b_col"]], i["ct_col"])
    for kind, kw in (("", {}), ("_overlap", {"overlap": True}),
                     ("_fused", {"fused": True})):
        out["col_sp" + kind] = _vjp(
            lambda x, w: col(x, w, sequence_parallel_enabled=True,
                             group=group, **kw),
            [i["x"], i["w_col"]], i["ct_agm"])
        out["row_sp" + kind] = _vjp(
            lambda x, w: row(x, w, sequence_parallel_enabled=True,
                             group=group, **kw),
            [i["x_seq"], i["w_row"]], i["ct_mrs"])
    out["row"] = _vjp(lambda x, w, b: row(x, w, b, group=group),
                      [i["x"], i["w_row"], i["b_row"]], i["ct_row"])
    out["row_scatter"] = _vjp(
        lambda x, w: row(x, w, input_is_parallel=False, group=group),
        [i["x_wide"], i["w_row"]], i["ct_row"])
    table = i["table"].clone().requires_grad_()
    y = tp.vocab_parallel_embedding(i["tokens"], table, group=group)
    (dt,) = torch.autograd.grad(y, [table], i["ct_emb"])
    out["embedding"] = [y.detach(), dt]
    out["errors"] = [_raises(lambda: col(i["x"], i["w_col"], overlap=True,
                                         fused=True, group=group),
                             ValueError)]
    return out


def tp_cross_entropy(i: dict, group) -> dict:
    """The vocab-parallel cross-entropies: loss and grads, and the
    linear one's all-reduce counts, fused against decomposed."""
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    out = {}
    for ls in (0.0, 0.1):
        out[f"vpce_{ls}"] = _vjp(
            lambda lg: tp.vocab_parallel_cross_entropy(lg, i["labels_s"],
                                                       ls, group),
            [i["logits"]], i["ct_s"])
    for name, x, kw in (
            ("plain", "xh", {}),
            ("smooth_pad", "xh", dict(label_smoothing=0.1, padding_idx=0)),
            ("classes", "xh", dict(num_classes=i["num_classes"].item())),
            ("sp_input", "xh_seq", dict(sequence_parallel_input=True))):
        for fused in (False, True):
            xs = i[x].clone().requires_grad_()
            w = i["wv"].clone().requires_grad_()
            mappings.reset_collectives()
            loss = tp.vocab_parallel_linear_cross_entropy(
                xs, w, i["labels_t"], group=group, fused=fused, **kw)
            fwd = mappings.collective_counts()
            dx, dw = torch.autograd.grad(loss, [xs, w], i["ct_t"])
            bwd = mappings.collective_counts()
            key = f"lce_{name}_{'fused' if fused else 'dec'}"
            out[key] = [loss.detach(), dx, dw]
            out[key + "_counts"] = [fwd, bwd]
    return out


def tp_cases(inputs: dict, n: int) -> dict:
    """Every case of tests/test_torch_tensor_parallel.py on this rank."""
    from apex1_tpu_torch.core.mesh import MESH_AXES
    from apex1_tpu_torch.transformer import parallel_state as ps
    mesh = _setup(tensor_model_parallel_size=n)
    rank = dist.get_rank()
    i = _mine(inputs, rank)
    group = ps.get_tensor_model_parallel_group()
    out = {}
    out.update(tp_regions(i, group))
    out.update(tp_layers(i, group))
    out.update(tp_cross_entropy(i, group))
    out["state"] = dict(
        coords=[mesh.index(ax) for ax in MESH_AXES],
        sizes=[ps.get_tensor_model_parallel_world_size(),
               ps.get_data_parallel_world_size(),
               ps.get_context_parallel_world_size(), ps.get_world_size()],
        ranks=[ps.get_tensor_model_parallel_rank(),
               ps.get_data_parallel_rank()],
        tp_ranks=mesh.ranks("tp"),
        errors=[_raises(lambda: ps.initialize_model_parallel(n),
                        RuntimeError),
                _raises(lambda: _remesh(pp=n), NotImplementedError),
                _raises(lambda: _remesh(ep=n), NotImplementedError)])
    ps.destroy_model_parallel()
    return _np(out)


def _remesh(**degrees):
    from apex1_tpu_torch.core.mesh import make_mesh
    return make_mesh(dp=-1, **degrees)


# ---- tests/test_torch_fused_collective.py -------------------------------


def fc_cases(inputs: dict, n: int) -> dict:
    """The fused SP matmuls against the decomposed rings (forward and
    vjp), the serialized gather, the rdma ring, the all-gather flash
    attention against ring attention, and the packed vocab merge."""
    from apex1_tpu_torch.ops import fused_collective as fc
    from apex1_tpu_torch.parallel.ring_attention import ring_attention
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    from apex1_tpu_torch.transformer import parallel_state as ps
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    _setup(tensor_model_parallel_size=n)
    rank = dist.get_rank()
    i = _mine(inputs, rank)
    g = ps.get_tensor_model_parallel_group()
    out = {}
    for name, fn, x, w, ct in (
            ("fmrs", fc.fused_matmul_reduce_scatter, "x_seq", "w_row",
             "ct_mrs"),
            ("mrs", tp.matmul_reduce_scatter, "x_seq", "w_row", "ct_mrs"),
            ("fmrs3", fc.fused_matmul_reduce_scatter, "x_seq3", "w_row",
             "ct_mrs3"),
            ("mrs3", tp.matmul_reduce_scatter, "x_seq3", "w_row", "ct_mrs3"),
            ("fagm", fc.fused_all_gather_matmul, "x", "w_col", "ct_agm"),
            ("agm", tp.all_gather_matmul, "x", "w_col", "ct_agm")):
        out[name] = _vjp(lambda a, b: fn(a, b, g, 0), [i[x], i[w]], i[ct])
    out["fagm_serial"] = [fc.fused_all_gather_matmul_serial(i["x"],
                                                            i["w_col"], g)]
    mappings.reset_collectives()
    out["rdma"] = [fc.matmul_reduce_scatter_rdma(i["x_seq"], i["w_row"], g)]
    out["rdma_hops"] = mappings.collective_counts()["send_recv"]
    # a ring of one: every rank makes every one-rank group, keeps its own
    singles = [dist.new_group([r]) for r in range(n)]
    out["rdma_errors"] = [
        _raises(lambda: fc.matmul_reduce_scatter_rdma(
            i["x_seq"], i["w_row"], singles[rank]), ValueError),
        _raises(lambda: fc.matmul_reduce_scatter_rdma(
            i["x_seq3"], i["w_row"], g), ValueError),
        _raises(lambda: fc.matmul_reduce_scatter_rdma(
            i["x_seq"][:-1], i["w_row"], g), ValueError)]
    for name, kw in (("causal", dict(causal=True)), ("full", {}),
                     ("gqa", dict(causal=True, gqa=True)),
                     ("segments", dict(segments=True))):
        kv = ("k_gqa", "v_gqa") if kw.pop("gqa", False) else ("k", "v")
        if kw.pop("segments", False):
            kw["segment_ids"] = i["segs"]
        for key, fn in (("agf", fc.all_gather_flash_attention),
                        ("ring", ring_attention)):
            out[f"{key}_{name}"] = _vjp(
                lambda q, k, v: fn(q, k, v, g, **kw),
                [i["q"], i[kv[0]], i[kv[1]]], i["do"])
    mappings.reset_collectives()
    out["vp_merge"] = list(fc.fused_vocab_parallel_merge(i["stats"], g))
    out["vp_merge_counts"] = mappings.collective_counts()
    ps.destroy_model_parallel()
    return _np(out)


# ---- tests/test_torch_ring_attention.py ---------------------------------


def ring_cases(inputs: dict, n: int, cases: dict) -> dict:
    """`ring_attention` (and the serialized ring) forward and vjp over
    the context-parallel group, for each case's keyword arguments."""
    from apex1_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_serial)
    from apex1_tpu_torch.transformer import parallel_state as ps
    _setup(context_parallel_size=n)
    i = _mine(inputs, dist.get_rank())
    g = ps.get_context_parallel_group()
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        dt = getattr(torch, kw.pop("dtype", "float32"))
        kv = ("k_gqa", "v_gqa") if kw.pop("gqa", False) else ("k", "v")
        if kw.pop("segments", False):
            kw["segment_ids"] = i["segs"]
        prim = [i["q"].to(dt), i[kv[0]].to(dt), i[kv[1]].to(dt)]
        for key, fn in (("ring", ring_attention),
                        ("serial", ring_attention_serial)):
            got = _vjp(lambda q, k, v: fn(q, k, v, g, **kw), prim,
                       i["do"].to(dt))
            out[f"{key}_{name}"] = [t.float() for t in got]
    ps.destroy_model_parallel()
    return _np(out)


# ---- tests/test_torch_ddp.py --------------------------------------------


def ddp_cases(inputs: dict, gpt2: dict, steps: int) -> dict:
    """On a dp 2 x tp 2 mesh: the mesh coordinates, `allreduce_grads`
    with a predivide factor, `broadcast_params`, DDP's value_and_grad,
    and ``steps`` O2 steps of a tiny GPT-2 through
    ``Amp(grad_psum_axes=("dp",))`` on this rank's dp share of the
    batch."""
    from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                                 gpt2_loss_fn, gpt2_params_from_jax)
    from apex1_tpu_torch.core.mesh import MESH_AXES
    from apex1_tpu_torch.parallel import (DistributedDataParallel,
                                          allreduce_grads, broadcast_params)
    from apex1_tpu_torch.transformer import parallel_state as ps
    mesh = _setup(tensor_model_parallel_size=2)
    rank = dist.get_rank()
    i = _mine(inputs, rank)
    out = {"coords": [mesh.index(ax) for ax in MESH_AXES]}
    grads = {"a": i["ga"], "b": i["gb"], "step": i["step"]}
    out["allreduce"] = allreduce_grads(grads, groups=("dp",),
                                       gradient_predivide_factor=2.0)
    out["broadcast"] = broadcast_params({"a": i["ga"]})

    def loss_fn(p, x, y):
        return ((x @ p["w"] - y) ** 2).mean()

    ddp = DistributedDataParallel(loss_fn, gradient_predivide_factor=2.0)
    loss, g = ddp.value_and_grad()({"w": i["w"]}, i["xb"], i["yb"])
    out["ddp"] = [loss, g["w"]]

    cfg = GPT2Config.tiny(policy=get_policy("O2"), **gpt2["kw"])
    model = gpt2_params_from_jax(gpt2["params"], cfg, "cpu")
    base = gpt2_loss_fn(model, fuse_head=False)
    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level="O2",
              grad_psum_axes=("dp",))
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(base)
    dp = mesh.index("dp")
    tokens = torch.from_numpy(gpt2["tokens"]).chunk(2)[dp].contiguous()
    rows = []
    for _ in range(steps):
        state, m = step(state, tokens)
        rows.append({k: v for k, v in m.items()})
    out["amp"] = dict(metrics=rows, params=state.params)
    ps.destroy_model_parallel()
    return _np(out)


def broken(n: int):
    """Rank 1 raises; the others wait on it in a collective."""
    torch.set_num_threads(1)
    if dist.get_rank() == 1:
        raise ValueError("rank 1 is broken")
    dist.all_reduce(torch.ones(1))
    return dist.get_rank()


# ---- tests/test_torch_sync_batchnorm.py -----------------------------------


def sync_bn_cases(inputs: dict, group_sizes: list) -> dict:
    """On a dp-only mesh: a channel-last `SyncBatchNorm` synced over
    "dp" with each of ``group_sizes`` (None: the whole group), training
    mode on this rank's x; per case y, the grads of <y, ct> for x,
    scale and bias, and the new running statistics; then the module's
    own forward, which writes them into its buffers."""
    from apex1_tpu_torch.parallel import SyncBatchNorm
    from apex1_tpu_torch.transformer import parallel_state as ps
    _setup()
    i = _mine(inputs, dist.get_rank())
    out = {}
    for gs in group_sizes:
        bn = SyncBatchNorm(i["x"].shape[-1], axis_name="dp", group_size=gs,
                           device="cpu")
        with torch.no_grad():
            for k in ("scale", "bias", "mean", "var"):
                getattr(bn, k).copy_(torch.from_numpy(inputs[k]))
        x = i["x"].clone().requires_grad_()
        y, stats = bn.stats_forward(x)
        grads = torch.autograd.grad((y * i["ct"]).sum(),
                                    [x, bn.scale, bn.bias])
        bn(i["x"])
        out[str(gs)] = dict(y=y, dx=grads[0], dscale=grads[1],
                            dbias=grads[2], mean=stats["mean"],
                            var=stats["var"],
                            buffers=[bn.mean.clone(), bn.var.clone()])
    ps.destroy_model_parallel()
    return _np(out)
