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
                        RuntimeError)],
        fsdp=_remesh(fsdp=n))
    ps.destroy_model_parallel()
    return _np(out)


def _remesh(**degrees) -> dict:
    """A second mesh of these degrees: its shape, this rank's
    coordinates and the ranks of its data-parallel (dp x fsdp) group."""
    from apex1_tpu_torch.core.mesh import (MESH_AXES, data_parallel_size,
                                           make_mesh)
    mesh = make_mesh(dp=-1, **degrees)
    return dict(shape=[mesh.size(ax) for ax in MESH_AXES],
                coords=[mesh.index(ax) for ax in MESH_AXES],
                data_ranks=dist.get_process_group_ranks(mesh.data_group),
                data_size=data_parallel_size(mesh))


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


# ---- tests/test_torch_pipeline.py ---------------------------------------


def _stage(p, x):
    """One pipeline chunk: linear + tanh (tests/test_pipeline.py's)."""
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_aux(p, x):
    y = _stage(p, x)
    return y, 0.01 * (y * y).sum()


def _mse(outs, targets):
    return ((outs - targets) ** 2).mean()


def _ring_stage(group):
    """A stage with a ring inside (ring attention over ``group``)."""
    from apex1_tpu_torch.parallel.ring_attention import ring_attention

    def stage(p, x):
        a = ring_attention(x[None, None], x[None, None], x[None, None],
                           group)[0, 0]
        return _stage(p, a)

    return stage


def pipeline_cases(inputs: dict, n: int, grid: list) -> dict:
    """Every case of tests/test_torch_pipeline.py on this rank of a pp = n
    mesh: the scan schedule's forward and grads (both conventions, remat,
    a padded boundary, the aux channel) for each (V, M) of ``grid``, the
    1F1B schedule (plain, with loss params and aux, interleaved), the
    tied embedding, the p2p shifts, the parallel state and the errors."""
    from apex1_tpu_torch.transformer import parallel_state as ps
    from apex1_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p)
    from apex1_tpu_torch.transformer.pipeline_parallel import schedules as S
    _setup(pipeline_model_parallel_size=n)
    s = dist.get_rank()
    i = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inputs.items()}
    out = {}

    def local(V):
        return {"w": i[f"w{V}"][:, s].clone(), "b": i[f"b{V}"][:, s].clone()}

    for V, M in grid:
        key = f"V{V}_M{M}"
        mbs, tg = i[f"mbs{M}"], i[f"tg{M}"]
        fwd = (S.forward_backward_pipelining_with_interleaving if V > 1
               else S.forward_backward_pipelining_without_interleaving)
        kw = {"num_chunks": V} if V > 1 else {}
        loss, g = fwd(_stage, _mse, None, local(V), mbs, tg, **kw)
        outs = S.pipeline_apply(_stage, local(V), mbs, num_chunks=V)
        # the partial convention: per-rank partial loss, grads inside
        p = {k: v.requires_grad_() for k, v in local(V).items()}
        part = S.pipeline_apply(_stage, p, mbs, num_chunks=V,
                                broadcast_outputs=False)
        lp = float(s == n - 1) * _mse(part, tg)
        gp = torch.autograd.grad(lp, [p["w"], p["b"]])
        p = {k: v.requires_grad_() for k, v in local(V).items()}
        lr = _mse(S.pipeline_apply(_stage, p, mbs, num_chunks=V,
                                   remat_stage=True), tg)
        gr = torch.autograd.grad(lr, [p["w"], p["b"]])
        out[key] = dict(loss=loss, w=g["w"], b=g["b"], outs=outs,
                        part=part.detach(), part_w=gp[0], part_b=gp[1],
                        remat_w=gr[0], remat_b=gr[1])
    # a padded boundary and the aux channel (V 2, M 4)
    bounded = S.pipeline_apply(_stage, local(2), i["mbs_narrow"],
                               num_chunks=2, boundary_shape=(2, 16),
                               boundary_dtype=torch.float32)
    p = {k: v.requires_grad_() for k, v in local(2).items()}
    y, aux = S.pipeline_apply(_stage_aux, p, i["mbs4"], num_chunks=2,
                              with_aux=True, broadcast_outputs=False)
    ga = torch.autograd.grad(_mse(y, i["tg4"]) + aux, [p["w"], p["b"]])
    out["boundary"] = bounded
    out["aux"] = dict(y=y.detach(), aux=aux.detach(), w=ga[0], b=ga[1])

    # 1F1B: plain V 1; loss params + aux at V 1 and V 2; V 2 plain with
    # skip_idle False
    lpar = {"u": i["u"]}

    def loss_plain(y, m):
        return _mse(y, i["tg4"][m])

    def loss_lp(lp_, y, m):
        return _mse(y * lp_["u"], i["tg4"][m])

    for name, V, kw in (
            ("plain", 1, dict(loss_mb=loss_plain)),
            ("lp_aux", 1, dict(loss_mb=loss_lp, loss_params=lpar,
                               with_aux=True, aux_cotangent=0.5)),
            ("v2_lp_aux", 2, dict(loss_mb=loss_lp, loss_params=lpar,
                                  with_aux=True, aux_cotangent=0.5)),
            ("v2_noskip", 2, dict(loss_mb=loss_plain, skip_idle=False))):
        stage = _stage_aux if kw.get("with_aux") else _stage
        sp = local(V) if V > 1 else {k: v[0] for k, v in local(1).items()}
        got = S.one_f_one_b(stage, sp, i["mbs4"], kw.pop("loss_mb"),
                            num_chunks=V, **kw)
        out[f"1f1b_{name}"] = list(got)

    # the tied embedding, both conventions
    def embed(tied, tok):
        return tied["emb"][tok.long()]

    def head(tied, outs):
        logits = torch.einsum("mbd,vd->mbv", outs, tied["emb"])
        return -torch.log_softmax(logits.float(), -1)[..., 0].mean(1)

    for conv, bcast in (("outer", True), ("inside", False)):
        p = {k: v.requires_grad_() for k, v in local(1).items()}
        tied = {"emb": i["emb"].clone().requires_grad_()}
        z = S.pipeline_tied_apply(_stage, p, embed, head, tied, i["tok"],
                                  broadcast_outputs=bcast)
        loss = z.mean()
        gw, gb, ge = torch.autograd.grad(loss, [p["w"], p["b"],
                                                tied["emb"]])
        ge = S.allreduce_embedding_grads({"emb": ge})["emb"]
        if not bcast:
            loss = _psum_pp(loss.detach())     # the partials' sum
        out[f"tied_{conv}"] = dict(loss=loss.detach(), w=gw, b=gb, emb=ge)

    # the p2p shifts and their transposes
    for name, fn in (("fwd", p2p.send_forward_recv_forward),
                     ("bwd", p2p.send_backward_recv_backward)):
        out[f"p2p_{name}"] = _vjp(lambda x: fn(x), [i["x"][s]], i["ct"][s])
    out["p2p_chained"] = p2p.recv_forward(p2p.send_forward(i["x"][s]))

    # the parallel state, with and without a virtual pipeline
    st = dict(sizes=[ps.get_pipeline_model_parallel_world_size(),
                     ps.get_pipeline_model_parallel_rank()],
              embed=ps.is_rank_in_embedding_group(),
              func=S.get_forward_backward_func().__name__)
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(1, n, virtual_pipeline_model_parallel_size=2)
    flags = []
    for v in (0, 1):
        ps.set_virtual_pipeline_model_parallel_rank(v)
        flags.append([ps.is_pipeline_first_stage(),
                      ps.is_pipeline_last_stage(),
                      ps.is_pipeline_first_stage(ignore_virtual=True),
                      ps.is_pipeline_last_stage(ignore_virtual=True)])
    st.update(virtual=[ps.get_virtual_pipeline_model_parallel_world_size(),
                       ps.get_virtual_pipeline_model_parallel_rank()],
              flags=flags, vfunc=S.get_forward_backward_func().__name__)
    out["state"] = st

    # the errors
    cp = ps.get_context_parallel_group()          # one rank
    ring = _ring_stage(cp)
    sp1 = {k: v[0] for k, v in local(1).items()}
    errs = {
        "v2_few_mb": _raises(lambda: S.pipeline_apply(
            _stage, local(2), i["mbs4"][:n - 1], num_chunks=2), ValueError),
        "boundary": _raises(lambda: S.pipeline_apply(
            _stage, local(1), i["mbs4"], boundary_shape=(2, 8)),
            ValueError),
        "1f1b_mod": _raises(lambda: S.one_f_one_b(
            _stage, local(2), i["mbs8"][:n + 1], loss_plain,
            num_chunks=2), ValueError),
        "1f1b_aux": _raises(lambda: S.one_f_one_b(
            _stage_aux, sp1, i["mbs4"], loss_plain, with_aux=True),
            ValueError),
        "skip_ring": _raises(lambda: S.pipeline_apply(
            ring, local(1), i["mbs4"]), ValueError),
        "skip_idle_ring": _raises(lambda: S.one_f_one_b(
            ring, sp1, i["mbs4"], loss_plain), ValueError),
        "no_skip_ring": _raises(lambda: S.pipeline_apply(
            ring, local(1), i["mbs4"], skip_bubbles=False), ValueError)}
    ps.destroy_model_parallel()
    errs["virtual_pp1"] = _raises(lambda: ps.initialize_model_parallel(
        1, 1, virtual_pipeline_model_parallel_size=2), ValueError)
    ps.destroy_model_parallel()
    out["errors"] = errs
    return _np(out)


def _psum_pp(x):
    from apex1_tpu_torch.transformer import parallel_state as ps
    from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp
    return mp.all_reduce(x, ps.get_pipeline_model_parallel_group())


# ---- tests/test_torch_moe.py ----------------------------------------------


def moe_cases(inputs: dict, n: int, cfg_kw: dict) -> dict:
    """`moe_shard_map_apply` on an ep = n mesh (this rank's tokens and
    experts), with and without ``stats_axes``, forward and vjp; the
    `param_specs` slice of the stacked experts."""
    from apex1_tpu_torch.core.mesh import make_mesh
    from apex1_tpu_torch.transformer import moe
    torch.set_num_threads(1)
    mesh = make_mesh(dp=1, ep=n)
    from apex1_tpu_torch.transformer import parallel_state as ps
    ps.destroy_model_parallel()
    ps.set_mesh(mesh)
    r = dist.get_rank()
    i = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inputs.items()}
    cfg = moe.MoEConfig(**cfg_kw)
    full = {"router": i["wg"], "w1": i["w1"], "w2": i["w2"]}
    mine = moe.shard_params(full, moe.param_specs(full), mesh)
    out = {"shard": mine}
    for name, kw in (("plain", {}), ("stats", dict(stats_axes=("ep",)))):
        x = i["x"][r].clone().requires_grad_()
        prm = [t.clone().requires_grad_() for t in
               (mine["router"], mine["w1"], mine["w2"])]
        y, aux = moe.moe_shard_map_apply(x, *prm, cfg, axis_name="ep",
                                         **kw)
        grads = torch.autograd.grad([y, aux], [x] + prm,
                                    [i["ct"][r], torch.tensor(1.0)])
        out[name] = [y.detach(), aux.detach()] + list(grads)
    return _np(out)


# ---- tests/test_torch_llama_cp.py ------------------------------------------


def llama_cp_cases(inputs: dict, n: int, cfg_kw: dict) -> dict:
    """A tiny Llama with ``seq_shard_axis="cp"`` on a cp = n mesh, ring
    and Ulysses: this rank's logits and the grads of the sum of its
    next-token CE over its shard; `ulysses_attention` forward and vjp
    (GQA, and GQA with fewer KV heads than ranks) and its errors."""
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.interop import llama_params_from_jax
    from apex1_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex1_tpu_torch.parallel.ulysses import ulysses_attention
    from apex1_tpu_torch.transformer import parallel_state as ps
    _setup(context_parallel_size=n)
    r = dist.get_rank()
    g = ps.get_context_parallel_group()
    out = {}
    tok = torch.from_numpy(inputs["tokens"][r])
    lbl = torch.from_numpy(inputs["labels"][r])
    for impl in ("ring", "ulysses"):
        cfg = LlamaConfig.tiny(policy=get_policy("O0"), cp_impl=impl,
                               **cfg_kw)
        from apex1_tpu_torch.models.llama import Llama
        model = llama_params_from_jax(inputs["params"], cfg, "cpu")
        cp_model = Llama(cfg, seq_shard_axis="cp", device="cpu")
        cp_model.load_state_dict(model.state_dict())
        params = {k: v.detach().requires_grad_()
                  for k, v in cp_model.named_parameters()}
        logits = torch.func.functional_call(cp_model, params, (tok,))
        loss = softmax_cross_entropy_loss(logits.float(), lbl).sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        out[impl] = dict(logits=logits.detach(),
                         grads=dict(zip(params, grads)))
    i = {k: torch.from_numpy(np.ascontiguousarray(inputs[k][r]))
         for k in ("q", "k", "v", "k1", "v1", "do")}
    for name, (kk, vv) in (("gqa", ("k", "v")), ("gqa_rep", ("k1", "v1"))):
        out[f"ulysses_{name}"] = _vjp(
            lambda q, k, v: ulysses_attention(q, k, v, g, causal=True),
            [i["q"], i[kk], i[vv]], i["do"])
    out["errors"] = [
        _raises(lambda: ulysses_attention(i["q"][:, :3], i["k"][:, :1],
                                          i["v"][:, :1], g), ValueError),
        _raises(lambda: ulysses_attention(i["q"], i["k"], i["v"], g,
                                          fallback="tree"), ValueError)]
    out["fallback"] = ulysses_attention(i["q"][:, :3], i["k1"], i["v1"], g,
                                        causal=True, fallback="ring")
    ps.destroy_model_parallel()
    return _np(out)


# ---- tests/test_torch_llama_3d.py ------------------------------------------


def llama_3d_cases(inputs: dict, layouts: dict, model_kw: dict) -> dict:
    """For each layout of ``layouts`` (Llama3DConfig keywords, ``moe``
    among them), on its own mesh: this rank's coordinates, the global
    loss and this rank's combined grads of one forward and backward
    (`llama_3d.loss_and_grads`) from the flat model's params
    ``inputs["flat"][moe]``; with ``steps`` also that many train steps
    (`make_train_step`) from ``inputs["start"]``, the losses and the
    final params; with ``overflow`` an fp16 step whose loss is forced to
    inf."""
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.core.mesh import MESH_AXES, make_mesh
    from apex1_tpu_torch.interop import llama3d_state_from_jax
    from apex1_tpu_torch.models import llama_3d as L3
    torch.set_num_threads(1)
    out = {}
    for name, lay in layouts.items():
        lay = dict(lay)
        moe = lay.pop("moe", False)
        steps = lay.pop("steps", 0)
        level = lay.pop("level", "O0")
        mk = dict(model_kw[moe])
        m = LlamaConfig.tiny(policy=get_policy(level), **mk)
        cfg = L3.Llama3DConfig(model=m, moe=moe, **lay)
        mesh = make_mesh(dp=cfg.dp, pp=cfg.pp, cp=cfg.cp, ep=cfg.ep,
                         tp=cfg.tp)
        tok = torch.from_numpy(inputs["tokens"][moe])
        lbl = torch.from_numpy(inputs["labels"][moe])
        res = dict(coords=[mesh.index(a) for a in MESH_AXES],
                   sizes=[mesh.size(a) for a in MESH_AXES])
        if not steps:
            named = {k: torch.from_numpy(v.copy())
                     for k, v in inputs["flat"][moe].items()}
            params = L3.shard_params(*L3.from_llama_params(named, cfg), cfg,
                                     mesh)
            loss, grads = L3.loss_and_grads(cfg, params, tok, lbl,
                                            mesh=mesh)
            res.update(loss=loss, grads=grads)
        else:
            step, _ = L3.build_step(cfg, mesh)
            state = llama3d_state_from_jax(inputs["start"], cfg, mesh,
                                           device="cpu")
            losses = []
            for _ in range(steps):
                state, loss = step(state, tok, lbl)
                losses.append(loss)
            res.update(losses=losses, params=state["params"],
                       step=state["step"])
        out[name] = res
    st, data = L3.abstract_state(cfg, mesh)
    out["abstract"] = dict(
        meta=all(v.is_meta for v in st["params"].values()),
        shapes={k: list(v.shape) for k, v in st["params"].items()},
        data=list(data.shape))
    return _np(out)


def llama_3d_overflow(inputs: dict, lay: dict, model_kw: dict) -> dict:
    """Two O2_fp16 steps of `llama_3d.build_step`; before the second the
    embedding master is multiplied by 1e8, so its fp16 copy overflows
    and every gradient is non-finite: the params and both Adam moments
    after that step against those before it, and the scale state."""
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.core.mesh import make_mesh
    from apex1_tpu_torch.interop import llama3d_state_from_jax
    from apex1_tpu_torch.models import llama_3d as L3
    torch.set_num_threads(1)
    m = LlamaConfig.tiny(policy=get_policy("O2_fp16"), **model_kw)
    cfg = L3.Llama3DConfig(model=m, **lay)
    mesh = make_mesh(dp=cfg.dp, pp=cfg.pp, cp=cfg.cp, ep=cfg.ep, tp=cfg.tp)
    step, _ = L3.build_step(cfg, mesh)
    state = llama3d_state_from_jax(inputs["start"], cfg, mesh, device="cpu")
    tok = torch.from_numpy(inputs["tokens"][False])
    lbl = torch.from_numpy(inputs["labels"][False])
    state, l1 = step(state, tok, lbl)
    params = dict(state["params"])
    params["shared.emb"] = params["shared.emb"] * 1e8
    before = dict(state, params=params)
    after, l2 = step(before, tok, lbl)
    same = {k: all(torch.equal(a[n], b[n]) for n in params)
            for k, a, b in (("params", after["params"], before["params"]),
                            ("exp_avg", after["opt"].exp_avg,
                             before["opt"].exp_avg),
                            ("exp_avg_sq", after["opt"].exp_avg_sq,
                             before["opt"].exp_avg_sq))}
    return _np(dict(
        losses=[l1, l2], same=same,
        step=[int(before["opt"].step), int(after["opt"].step)],
        scale=[float(before["scale"].scale), float(after["scale"].scale)],
        overflow=[int(before["scale"].overflow_count),
                  int(after["scale"].overflow_count)]))


# ---- tests/test_torch_rng.py --------------------------------------------


def rng_cases(inputs: dict, n: int) -> dict:
    """The tracker's forks inside a tp group of ``n`` ranks,
    `model_parallel_key` at this rank, and `broadcast_data` of rank
    0's tensors (each rank holds its own) with and without a dtype."""
    from apex1_tpu_torch.core.random import model_parallel_key
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    _setup(tensor_model_parallel_size=n)
    rank = dist.get_rank()
    tp.model_parallel_seed(int(inputs["seed"]))
    tracker = tp.get_rng_tracker()
    out = dict(fork_mp=tracker.fork(), fork_default=tracker.fork("default"),
               fork_untied=tracker.fork(tp_axis=None),
               mp_key=model_parallel_key(tuple(int(k) for k in
                                               inputs["key"])))
    mine = _mine({k: inputs[k] for k in ("a", "b")}, rank)
    mappings.reset_collectives()
    got = tp.broadcast_data(["a", "b"], mine)
    got_f = tp.broadcast_data(["a"], mine, torch.float64)
    out.update(a=got["a"], b=got["b"], a_f64=got_f["a"],
               counts=mappings.collective_counts()["broadcast"])
    return _np(out)


# ---- tests/test_torch_distributed_optimizer.py --------------------------


def _flat_moments(state, names_shapes, group):
    """The ranks' moment slices gathered, cut to the flat length and
    unflattened in the params' order."""
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    out = {}
    for f in ("exp_avg_shard", "exp_avg_sq_shard"):
        flat = mappings.all_gather(getattr(state, f), group, 0)
        off, leaves = 0, {}
        for k, shape in names_shapes:
            size = int(np.prod(shape))
            leaves[k] = flat[off:off + size].reshape(shape)
            off += size
        out[f] = leaves
    return out


def zero_cases(inputs: dict, n: int) -> dict:
    """`distributed_fused_adam` (3 steps, weight decay) and
    `distributed_fused_lamb` (2 steps: weight decay; ``use_nvlamb``
    without it) at fsdp = ``n``, every rank with the same grads; the
    collectives of a step; and the placed training of
    `fsdp_param_specs` / `shard_opt_state_specs` (3 Adam steps with the
    params gathered in the loss)."""
    from apex1_tpu_torch.core.mesh import gather, place
    from apex1_tpu_torch.optim import fused_adam
    from apex1_tpu_torch.parallel import distributed_optimizer as do
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    mesh = _setup(fsdp_size=n)
    group = mesh.group("fsdp")
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inputs.items()}
    out = {}
    params = {"w": t["w"], "b": t["b"]}
    opt = do.distributed_fused_adam(1e-2, weight_decay=0.01)
    state = opt.init(params)
    counts = []
    for i in range(3):
        mappings.reset_collectives()
        params, state = opt.step({"w": t["gw"][i], "b": t["gb"][i]}, state,
                                 params)
        counts.append(mappings.collective_counts())
    out["adam"] = dict(params=params, counts=counts,
                       moments=_flat_moments(state, [("w", t["w"].shape),
                                                     ("b", t["b"].shape)],
                                             group))
    for name, kw in (("lamb_wd", dict(weight_decay=0.01)),
                     ("lamb_nv", dict(weight_decay=0.0, use_nvlamb=True)),
                     ("lamb_plain", dict(weight_decay=0.0))):
        lp = {"w": t["lw"], "b": t["lb"]}
        lg = {"w": t["lgw"], "b": t["lgb"]}
        lamb = do.distributed_fused_lamb(1e-2, axis_name="fsdp", **kw)
        st = lamb.init(lp)
        mappings.reset_collectives()
        lp, st = lamb.step(lg, st, lp)
        c = mappings.collective_counts()
        lp, st = lamb.step(lg, st, lp)
        out[name] = dict(params=lp, counts=c)
    out["placed"] = _placed_training(t, mesh, fused_adam, do, place, gather)
    out["mesh"] = _mesh_helpers(t, mesh, n)
    out["amp"] = _amp_over_data_axes(t, n)
    return _np(out)


def _amp_over_data_axes(t, n: int) -> dict:
    """2 O0 steps of ``Amp(fused_adam(1e-2), grad_psum_axes=("dp",
    "fsdp"))``, each rank on its rows of the batch."""
    from apex1_tpu_torch.amp import Amp
    from apex1_tpu_torch.optim import fused_adam
    rank = dist.get_rank()
    x, y = t["x"].chunk(n)[rank], t["y"].chunk(n)[rank]
    amp = Amp(fused_adam(1e-2), opt_level="O0",
              grad_psum_axes=("dp", "fsdp"))
    step = amp.make_train_step(
        lambda p, x, y: ((torch.tanh(x @ p["w"]) - y) ** 2).mean())
    state = amp.init({"w": t["aw"]})
    losses = []
    for _ in range(2):
        state, m = step(state, x, y)
        losses.append(m["loss"])
    return dict(params=state.params, losses=losses)


def _mesh_helpers(t, mesh, n: int) -> dict:
    """`shard_batch` and `replicate` on the fsdp mesh, `MeshResource`,
    the size helpers, `local_mesh`, and `make_hybrid_mesh` with two
    slices of tp = n / 2."""
    from apex1_tpu_torch.core import mesh as cm
    hybrid = cm.make_hybrid_mesh(cm.MeshConfig(tp=n // 2), dcn_dp=2)
    return dict(
        batch=cm.shard_batch(mesh, {"x": t["x"]})["x"].to_local(),
        rep=cm.replicate(mesh, {"y": t["y"]})["y"].to_local(),
        spec=list(cm.MeshResource().spec("batch", None, "heads")),
        sizes=[cm.axis_size(mesh, ax) for ax in cm.MESH_AXES],
        data_size=cm.data_parallel_size(mesh),
        local=[cm.local_mesh(fsdp=n).size(ax) for ax in cm.MESH_AXES],
        hybrid_shape=[hybrid.size(ax) for ax in cm.MESH_AXES],
        hybrid_coords=[hybrid.index(ax) for ax in cm.MESH_AXES])


def _placed_training(t, mesh, fused_adam, do, place, gather):
    tx = fused_adam(1e-2)
    params = {"w1": t["w1"], "w2": t["w2"]}
    x, y = t["x"], t["y"]

    def loss_fn(p):
        p = gather(p)
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    pspecs = do.fsdp_param_specs(params, min_size=64)
    sspecs = do.shard_opt_state_specs(tx.init(params), axis="fsdp",
                                      param_specs=pspecs)
    p = {k: v.requires_grad_() for k, v in
         place(params, pspecs, mesh).items()}
    st0 = tx.init(params)
    st = type(st0)(step=st0.step,
                   exp_avg=place(st0.exp_avg, sspecs.exp_avg, mesh),
                   exp_avg_sq=place(st0.exp_avg_sq, sspecs.exp_avg_sq, mesh))
    for _ in range(3):
        g = dict(zip(p, torch.autograd.grad(loss_fn(p), list(p.values()))))
        up, st = tx.update(g, st, {k: v.detach() for k, v in p.items()})
        p = {k: (v.detach() + up[k]).requires_grad_() for k, v in p.items()}
    placements = {k: [(type(pl).__name__, getattr(pl, "dim", None))
                      for pl in v.placements] for k, v in p.items()}
    local = {k: v.to_local().detach() for k, v in p.items()}
    with torch.no_grad():
        loss = loss_fn(p)
    return dict(params={k: v.detach() for k, v in gather(p).items()},
                loss=loss, local=local, placements=placements,
                pspecs={k: list(v) for k, v in pspecs.items()},
                sspecs={k: list(v) for k, v in sspecs.exp_avg.items()})


# ---- tests/test_torch_halo.py -------------------------------------------


def halo_cases(inputs: dict, n: int) -> dict:
    """`halo_exchange` (halo 1 and 2, dims 1 and 2, periodic or not)
    with the gradient of <out, ct>; `exchange_overlap` (halo 2 and 0);
    `spatial_conv2d` on H and W; `SpatialBottleneck` at train and eval
    (output, the grads of x and of every param, new statistics); the
    halo-larger-than-shard error. ``inputs`` hold the global tensors;
    each rank takes its block of the split axis."""
    from apex1_tpu_torch.models.resnet import ResNetConfig, SpatialBottleneck
    from apex1_tpu_torch.parallel import halo
    _setup(context_parallel_size=n)
    rank = dist.get_rank()

    def block(a, dim):
        return torch.from_numpy(np.ascontiguousarray(a)).chunk(
            n, dim)[rank].contiguous()

    out = {}
    for dim in (1, 2):
        x = block(inputs["x"], dim)
        for h in (1, 2):
            for periodic in (False, True):
                xs = x.clone().requires_grad_()
                y = halo.halo_exchange(xs, "cp", halo=h, dim=dim,
                                       periodic=periodic)
                ct = torch.from_numpy(np.ascontiguousarray(
                    inputs[f"ct{dim}{h}"][rank]))
                (g,) = torch.autograd.grad((y * ct).sum(), [xs])
                out[f"ex_{dim}_{h}_{periodic}"] = [y.detach(), g]
        ext, inner = halo.exchange_overlap(x, lambda v: torch.tanh(v) * 2.0,
                                           "cp", halo=2, dim=dim)
        out[f"ov_{dim}"] = [ext, inner,
                            halo.halo_exchange(x, "cp", halo=2, dim=dim)]
        out[f"ov0_{dim}"] = list(halo.exchange_overlap(
            x, lambda v: v + 1.0, "cp", halo=0, dim=dim))
        w = torch.from_numpy(inputs["conv_w"])
        out[f"conv_{dim}"] = halo.spatial_conv2d(x, w, "cp", dim=dim)
    out["too_big"] = _raises(lambda: halo.halo_exchange(
        block(inputs["x"], 1), "cp", halo=inputs["x"].shape[1] // n + 1,
        dim=1), ValueError)
    blk = SpatialBottleneck(ResNetConfig.tiny(), 4, "cp", device="cpu")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in inputs.items() if k.startswith("bb.")}
    blk.load_state_dict({k[3:]: v for k, v in sd.items()})
    xb = block(inputs["xb"], 1)
    ctb = block(inputs["ctb"], 1)
    for train in (True, False):
        xs = xb.clone().requires_grad_()
        stats = {}
        y = blk(xs.permute(0, 3, 1, 2), train=train, stats=stats,
                prefix="b").permute(0, 2, 3, 1)
        names, params = zip(*blk.named_parameters())
        grads = torch.autograd.grad((y * ctb).sum(), [xs, *params])
        out[f"bottleneck_{train}"] = dict(
            y=y.detach(), dx=grads[0], grads=dict(zip(names, grads[1:])),
            stats={k: v.detach() for k, v in stats.items()})
    return _np(out)


# ---- tests/test_torch_param_specs.py ------------------------------------


def _model_of(kind: str, np_params: dict, kw: dict):
    from apex1_tpu_torch import interop
    from apex1_tpu_torch.models import bert, gpt2, llama, t5
    mk = {"gpt2": (gpt2.GPT2Config, interop.gpt2_params_from_jax),
          "llama": (llama.LlamaConfig, interop.llama_params_from_jax),
          "bert": (bert.BertConfig, interop.bert_params_from_jax),
          "t5": (t5.T5Config, interop.t5_params_from_jax)}[kind]
    from apex1_tpu_torch import get_policy
    return mk[1](np_params, mk[0].tiny(policy=get_policy("O0"), **kw), "cpu")


def _loss_of(kind: str, model, fuse_head: bool):
    from apex1_tpu_torch.models import bert, gpt2, llama, t5
    return {"gpt2": lambda: gpt2.gpt2_loss_fn(model, fuse_head=fuse_head),
            "llama": lambda: llama.llama_loss_fn(model, fuse_head=fuse_head),
            "bert": lambda: bert.bert_pretrain_loss_fn(model,
                                                       fuse_head=fuse_head),
            "t5": lambda: t5.t5_loss_fn(model, fuse_head=fuse_head)}[kind]()


def spec_cases(inputs: dict, n: int) -> dict:
    """Each tiny model's loss and every grad with its parameters placed
    by its `param_specs` at tp = ``n`` (either head), the DTensor
    propagation running the plain path; the column -> gelu -> row MLP
    and the vocab-parallel embedding (out-of-shard tokens) placed by
    their ``partition_specs()``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from apex1_tpu_torch.core.mesh import gather, place
    from apex1_tpu_torch.models import bert, gpt2, llama, t5
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    mesh = _setup(tensor_model_parallel_size=n)
    specs_of = {"gpt2": gpt2.param_specs, "llama": llama.param_specs,
                "bert": bert.param_specs, "t5": t5.param_specs}
    out = {}
    for kind, case in inputs["models"].items():
        model = _model_of(kind, case["params"], case["kw"])
        params = {k: v.detach() for k, v in model.named_parameters()}
        batch = [({k: torch.from_numpy(v) for k, v in b.items()}
                  if isinstance(b, dict) else torch.from_numpy(b))
                 for b in case["batch"]]
        for fuse in (True, False):
            placed = {k: v.requires_grad_() for k, v in place(
                params, specs_of[kind](params), mesh).items()}
            with implicit_replication():
                loss = _loss_of(kind, model, fuse)(placed, *batch)
                grads = torch.autograd.grad(loss, list(placed.values()))
            full = gather(dict(zip(placed, grads)))
            loss = loss.full_tensor() if hasattr(loss, "full_tensor") \
                else loss
            out[f"{kind}_{fuse}"] = dict(loss=loss.detach(), grads=full)
    m = inputs["mlp"]
    col = tp.ColumnParallelLinear(16, 64, device="cpu")
    row = tp.RowParallelLinear(64, 16, device="cpu")
    with torch.no_grad():
        for mod, name in ((col, "fc1"), (row, "fc2")):
            mod.kernel.copy_(torch.from_numpy(m[f"{name}_kernel"]))
            mod.bias.copy_(torch.from_numpy(m[f"{name}_bias"]))
    for mod in (col, row):
        for k, v in place(dict(mod.named_parameters()),
                          mod.partition_specs(), mesh).items():
            setattr(mod, k, torch.nn.Parameter(v))
    x = torch.from_numpy(m["x"])
    with implicit_replication():
        y = row(torch.nn.functional.gelu(col(x), approximate="tanh"))
    out["mlp"] = dict(y=y.full_tensor(),
                      local=col.kernel.to_local().detach(),
                      specs=[list(col.partition_specs()["kernel"]),
                             list(row.partition_specs()["kernel"])])
    emb = tp.VocabParallelEmbedding(10, 4, device="cpu")
    with torch.no_grad():
        emb.embedding.copy_(torch.from_numpy(inputs["table"]))
    table = place({"embedding": emb.embedding.detach()},
                  emb.partition_specs(), mesh)["embedding"]
    emb.embedding = torch.nn.Parameter(table)
    tokens = torch.from_numpy(inputs["tokens"])
    with implicit_replication():
        ye = emb(tokens)
        (ge,) = torch.autograd.grad(
            (ye * torch.from_numpy(inputs["ct_emb"])).sum(), [emb.embedding])
    out["emb"] = dict(y=ye.full_tensor(), grad=ge.full_tensor(),
                      local=table.to_local())
    from apex1_tpu_torch.ops import _common, xentropy
    labels = torch.zeros(10, dtype=torch.int32)
    out["refused"] = [
        _raises(lambda: _common.check_cuda("layer_norm_fwd", table),
                TypeError),
        _raises(lambda: xentropy._check(table[None], labels, "xent_fwd"),
                TypeError)]
    return _np(out)


# ---- tests/test_torch_checkpoint.py ---------------------------------------


def _zero_specs():
    """The spec tree of a {"params", "opt": DistributedAdamState} state:
    params replicated, the moment slices split over fsdp."""
    from apex1_tpu_torch.parallel.distributed_optimizer import (
        DistributedAdamState)
    from apex1_tpu_torch.parallel.specs import PartitionSpec as P
    return lambda params: {
        "params": {k: P() for k in params},
        "opt": DistributedAdamState(step=P(), exp_avg_shard=P("fsdp"),
                                    exp_avg_sq_shard=P("fsdp"))}


def checkpoint_cases(inputs: dict, path: str) -> dict:
    """At fsdp = 2: (1) the unsharded checkpoint ``path/full`` restored
    onto the mesh with ``{"w": P("fsdp", None), "step": P()}``, against
    `place` of the same full state (this rank's blocks and placements);
    (2) `distributed_fused_adam` on ``inputs``' params, 2 steps, its
    state made global by `to_global` and saved by `save_checkpoint`
    (a collective call) to ``path/zero``: this rank's moment slices."""
    import os
    from apex1_tpu_torch.checkpoint import (restore_checkpoint,
                                            save_checkpoint, to_global,
                                            to_host_local)
    from apex1_tpu_torch.core.mesh import place
    from apex1_tpu_torch.parallel import distributed_optimizer as do
    from apex1_tpu_torch.parallel.specs import PartitionSpec as P
    mesh = _setup(fsdp_size=2)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    full = {"w": t["full_w"], "step": t["full_step"]}
    specs = {"w": P("fsdp", None), "step": P()}
    got = restore_checkpoint(os.path.join(path, "full"), template=full,
                             mesh=mesh, spec_tree=specs)
    want = place(full, specs, mesh)
    out = {"mesh": dict(
        local=got["w"].to_local(), want_local=want["w"].to_local(),
        same_placements=all(got[k].placements == want[k].placements
                            for k in full),
        host_local=to_host_local(got)["w"])}
    params = {"w": t["w"], "b": t["b"]}
    opt = do.distributed_fused_adam(1e-2, axis_name="fsdp")
    state = opt.init(params)
    for i in range(2):
        params, state = opt.step({"w": t["gw"][i], "b": t["gb"][i]}, state,
                                 params)
    tree = to_global({"params": params, "opt": state}, mesh,
                     _zero_specs()(params))
    save_checkpoint(os.path.join(path, "zero"), tree)
    out["zero"] = dict(exp_avg=state.exp_avg_shard,
                       exp_avg_sq=state.exp_avg_sq_shard,
                       params=params,
                       global_len=tree["opt"].exp_avg_shard.shape[0])
    # the sentinel's flag agreed over the fsdp group (JAX's pmin): rank
    # 1's loss is NaN, so both ranks see an unhealthy step
    from apex1_tpu_torch.resilience import health_flag
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    loss = torch.tensor(float("nan") if dist.get_rank() == 1 else 1.0)
    mappings.reset_collectives()
    out["flag"] = dict(
        local=bool(health_flag({"loss": loss})),
        agreed=bool(health_flag({"loss": loss}, axis_names=("fsdp",))),
        all_reduces=mappings.collective_counts()["all_reduce"])
    return _np(out)


# ---- tests/test_torch_elastic.py ------------------------------------------


def zero_reshard_save(inputs: dict, path: str, plan: dict) -> dict:
    """At fsdp = 4: `distributed_fused_adam` 2 steps, the state made
    global (`to_global`, every rank) and committed by rank 0 through
    ``ResilientCheckpointer(plan=plan)`` at ``path``; then a third step
    on the same ranks (the continuation the resharded resume must
    meet)."""
    from apex1_tpu_torch.checkpoint import to_global
    from apex1_tpu_torch.core.pytree import tree_map_with_path
    from apex1_tpu_torch.parallel import distributed_optimizer as do
    from apex1_tpu_torch.resilience import ResilientCheckpointer
    mesh = _setup(fsdp_size=4)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inputs.items()}
    params = {"w": t["w"], "b": t["b"]}
    opt = do.distributed_fused_adam(1e-2, axis_name="fsdp")
    state = opt.init(params)
    for i in range(2):
        params, state = opt.step({"w": t["gw"][i], "b": t["gb"][i]}, state,
                                 params)
    tree = to_global({"params": params, "opt": state}, mesh,
                     _zero_specs()(params))
    full = tree_map_with_path(
        lambda p, x: x.full_tensor() if hasattr(x, "full_tensor") else x,
        tree)
    if dist.get_rank() == 0:
        with ResilientCheckpointer(path, plan=plan) as ck:
            ck.save_sync(2, full, meta={"data_step": 2})
    dist.barrier()
    params, state = opt.step({"w": t["gw"][2], "b": t["gb"][2]}, state,
                             params)
    return _np(dict(params=params))


def zero_reshard_resume(inputs: dict, path: str, plan: dict) -> dict:
    """At fsdp = 2: the resharded checkpoint ``path`` verified, restored
    onto the mesh by spec (`restore_checkpoint(mesh=, spec_tree=)`),
    back to this rank's slices (`to_host_local`), and the third step."""
    import os
    from apex1_tpu_torch.checkpoint import restore_checkpoint, to_host_local
    from apex1_tpu_torch.parallel import distributed_optimizer as do
    from apex1_tpu_torch.resilience import read_plan, verify_files
    mesh = _setup(fsdp_size=2)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inputs.items()}
    man = verify_files(path)
    params = {"w": t["w"], "b": t["b"]}
    n = do.shard_padded_len(do.flat_param_len(params), 2)
    template = {"params": params, "opt": do.DistributedAdamState(
        step=torch.zeros((), dtype=torch.int32),
        exp_avg_shard=torch.zeros(n), exp_avg_sq_shard=torch.zeros(n))}
    placed = restore_checkpoint(os.path.join(path, "state"), template,
                                mesh=mesh,
                                spec_tree=_zero_specs()(params))
    local = to_host_local(placed)
    opt = do.distributed_fused_adam(1e-2, axis_name="fsdp")
    params, state = opt.step({"w": t["gw"][2], "b": t["gb"][2]},
                             local["opt"], local["params"])
    return _np(dict(params=params, step=int(state.step),
                    data_step=man.meta["data_step"],
                    plan_dp=read_plan(path)["mesh"]["dp"],
                    shard_len=int(local["opt"].exp_avg_shard.shape[0])))


def llama_3d_resume(inputs: dict, path: str, lay_a: dict, lay_b: dict,
                    model_kw: dict, plans: dict) -> dict:
    """At world 4: `llama_3d` on layout ``lay_a`` from the JAX package's
    global params ``inputs["start_a"]``, one step; the global state
    (`gather_state`) committed by rank 0 with ``plans["a"]``; a second
    step on ``lay_a`` (the continuation). Rank 0 reshards the checkpoint
    onto ``plans["b"]``; every rank restores it (verified against its
    manifest) into ``lay_b``'s state (`local_state`) and takes the
    second step there."""
    import os
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.core.mesh import make_mesh
    from apex1_tpu_torch.interop import llama3d_state_from_jax
    from apex1_tpu_torch.models import llama_3d as L3
    from apex1_tpu_torch.resilience import (ResilientCheckpointer,
                                            reshard_checkpoint)
    torch.set_num_threads(1)
    m = LlamaConfig.tiny(policy=get_policy("O0"), **model_kw)
    tok = torch.from_numpy(inputs["tokens"])
    lbl = torch.from_numpy(inputs["labels"])
    cfg_a = L3.Llama3DConfig(model=m, **lay_a)
    mesh_a = make_mesh(dp=cfg_a.dp, pp=cfg_a.pp, tp=cfg_a.tp)
    step_a, _ = L3.build_step(cfg_a, mesh_a)
    state = llama3d_state_from_jax(inputs["start_a"], cfg_a, mesh_a,
                                   device="cpu")
    state, loss1 = step_a(state, tok, lbl)
    g = L3.gather_state(cfg_a, state, mesh_a)
    src = os.path.join(path, "a", "step_00000001")
    if dist.get_rank() == 0:
        with ResilientCheckpointer(os.path.join(path, "a"),
                                   plan=plans["a"]) as ck:
            ck.save_sync(1, g, meta={"data_step": 1})
    dist.barrier()
    _, loss_cont = step_a(state, tok, lbl)

    cfg_b = L3.Llama3DConfig(model=m, **lay_b)
    mesh_b = make_mesh(dp=cfg_b.dp, pp=cfg_b.pp, tp=cfg_b.tp)
    out_dir = os.path.join(path, "b", "step_00000001")
    report = None
    if dist.get_rank() == 0:
        _, _, report = reshard_checkpoint(src, g, plans["b"], out_dir)
    dist.barrier()
    fresh = L3.state_template(cfg_b, L3.shard_params(
        *L3.init_params(cfg_b, device="cpu"), cfg_b, mesh_b))
    template = L3.gather_state(cfg_b, fresh, mesh_b)
    with ResilientCheckpointer(os.path.join(path, "b"),
                               plan=plans["b"]) as ck:
        g_b, man = ck.restore(template, path=out_dir)
    step_b, _ = L3.build_step(cfg_b, mesh_b)
    state_b = L3.local_state(cfg_b, g_b, mesh_b)
    state_b, loss_res = step_b(state_b, tok, lbl)
    # the gathered state of layout b re-sliced for layout a's stack is
    # layout a's (reshape_chunks' contract), so local_state round-trips
    back = L3.gather_state(cfg_b, L3.local_state(cfg_b, g_b, mesh_b),
                           mesh_b)
    same_back = all(torch.equal(back["params"]["chunk"][k],
                                g_b["params"]["chunk"][k])
                    for k in g_b["params"]["chunk"])
    return _np(dict(loss1=loss1, loss_cont=loss_cont, loss_res=loss_res,
                    step=int(state_b["step"]), data_step=man.meta[
                        "data_step"], report=report, same_back=same_back,
                    global_shapes={k: list(v.shape) for k, v in
                                   g["params"]["chunk"].items()}))


# ---- tests/test_torch_debug.py --------------------------------------------


def debug_cases(inputs: dict) -> dict:
    """`assert_same_program_across_processes` at world 2: the same
    program on every rank (the fingerprint), then rank 1 running another
    shape (the assertion's message)."""
    from apex1_tpu_torch.utils.debug import (
        assert_same_program_across_processes)
    x = torch.from_numpy(inputs["x"])
    w = torch.from_numpy(inputs["w"])

    def f(x, w):
        return torch.tanh(x @ w).sum()

    fp = assert_same_program_across_processes(f, x, w)
    mine = x if dist.get_rank() == 0 else x[:-1]
    err = _raises(lambda: assert_same_program_across_processes(f, mine, w),
                  AssertionError)
    return dict(fp=fp, err=err)


# ---- tests/test_torch_examples_parallel.py ----------------------------------


def examples_cases(inputs: dict, n: int) -> dict:
    """The examples at world ``n``, each through its ``main``:
    `gpt2_pp_tied` at pp ``n`` (each rank's losses, stage and final
    params), then `llama_distributed` at O0 with tp 2 and fsdp ``n`` /
    2 from the JAX package's params (the losses and the full final
    params)."""
    from apex1_tpu_torch import LlamaConfig, get_policy
    from apex1_tpu_torch.examples import gpt2_pp_tied, llama_distributed
    from apex1_tpu_torch.interop import llama_params_from_jax
    from apex1_tpu_torch.transformer import parallel_state
    torch.set_num_threads(1)
    parallel_state.destroy_model_parallel()
    steps = str(inputs["steps"])
    pp = gpt2_pp_tied.main(["--pp", str(n), "--device", "cpu", "--steps",
                            steps])
    model = llama_params_from_jax(
        inputs["llama"], LlamaConfig.tiny(policy=get_policy("O0"),
                                          max_seq_len=inputs["seq"]), "cpu")
    ld = llama_distributed.main(
        ["--device", "cpu", "--opt-level", "O0", "--tp", "2", "--fsdp",
         str(n // 2), "--steps", steps, "--seq", str(inputs["seq"])],
        model=model)
    return _np(dict(pp=dict(losses=pp["losses"], stage=pp["stage"],
                            params=pp["params"]),
                    ld=dict(losses=ld["losses"], params=ld["params"])))


# ---- tests/test_torch_hlo_probe.py --------------------------------------


def hlo_probe_cases(n: int) -> dict:
    """The overlap probe's traces on this rank: `hlo_probe.ring_case` for
    the overlapped ring forward, forward + backward and the serialized
    ring; `halo.exchange_overlap` and its plain `halo_exchange` under
    the profiler; and one traced step of every collective kind of
    `mappings.COLLECTIVES`, with the counter's values."""
    import tempfile

    from apex1_tpu_torch.parallel import halo
    from apex1_tpu_torch.testing import hlo_probe
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    from apex1_tpu_torch.utils.observability import trace
    _setup(context_parallel_size=n)
    out = {w: hlo_probe.ring_case(w) for w in ("fwd", "bwd", "serial")}
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(1, 8, 4, 3)

    def traced(fn):
        mappings.reset_collectives()
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as prof:
                fn()
            events = [e for e in hlo_probe.trace_events(prof.trace_path)
                      if e.get("ph") == "X"
                      and (e["name"].startswith("overlap.")
                           or e["name"].startswith("c10d::"))]
        return {"events": events, "counts": dict(mappings.COLLECTIVES)}

    out["halo"] = traced(lambda: halo.exchange_overlap(
        x, torch.tanh, "cp", halo=1, dim=1))
    out["halo_plain"] = traced(lambda: halo.halo_exchange(
        x, "cp", halo=1, dim=1))
    g = dist.group.WORLD

    def step():
        for _ in range(3):
            mappings.all_reduce(x, g)
        mappings.all_gather(x, g, 1)
        mappings.all_gather(x, g, 2)
        mappings.reduce_scatter(x, g, 1)
        mappings.all_to_all(x, g, 1, 2)
    out["counts"] = traced(step)
    return out
