"""Pipeline-parallel schedules (the port of
``apex1_tpu/transformer/pipeline_parallel/schedules.py``; reference
``apex/transformer/pipeline_parallel/schedules/*``:
``fwd_bwd_no_pipelining``, ``forward_backward_pipelining_without_
interleaving`` (1F1B) and ``..._with_interleaving`` (virtual pipeline),
chosen by ``get_forward_backward_func()``).

The JAX schedule is one ``lax.scan`` over ticks, because XLA needs one
program. Here it is Apex's own form: a host loop over the same ticks,
in which each stage runs the microbatch its tick gives it and trades
boundary tensors with its neighbours through `p2p_communication`'s ring
shift (``dist.batch_isend_irecv``; the identity at one stage). The tick
arithmetic, and so the order in which microbatches enter each chunk and
the order in which their gradients add up, is JAX's:

- V = 1: microbatch m is on stage s at tick t = m + s; M + P − 1 ticks.
- V > 1 (interleaved: chunk c = v·P + s lives on stage s): microbatch m
  enters chunk v at tick t = v·M + m + s; stage P − 1's output rides the
  ring to stage 0, which holds it in a FIFO until chunk v + 1 takes it
  (needs M ≥ P); V·M + P − 1 ticks.

`pipeline_apply` is one autograd function: its forward runs every tick,
keeping each valid tick's stage graph (or, with ``remat_stage``, only
its input: `checkpoint_with_policy`), and its backward runs the ticks in
reverse, each stage's ``torch.autograd.grad`` fed by the cotangent its
next stage sends back: the transpose JAX takes of the scan. `one_f_one_b`
is the true 1F1B: warm-up forwards, then one forward and one backward a
tick, then cool-down, in JAX's clocking, each backward a
``torch.autograd.grad`` of the stored stage output against the received
gradient, so at most O(V·P) microbatches' activations are alive.

Bubble ticks do no stage work. The JAX package refuses a stage that
holds a ``ppermute`` (ring attention, a halo exchange) while its bubble
ticks are skipped (``skip_bubbles`` / ``skip_idle``), because XLA pairs
a permute across the whole mesh and a skipped tick breaks the pairing;
it finds one by inspecting the stage's jaxpr. Here a stage is Python
with nothing to inspect, and a ring pairs within its own group, whose
members all sit on one stage and skip the same ticks, so the skip is
safe. The rule is kept as a contract, so the port accepts and refuses
the same calls with the same message: the schedule counts the ring
steps (`mappings.PERMUTES`) its stage work makes and raises at the end
of the schedule, on every rank alike, if a skipping schedule saw one.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from apex1_tpu_torch.core.mesh import AXIS_PP
from apex1_tpu_torch.transformer import parallel_state
from apex1_tpu_torch.transformer.parallel_state import (group_size_rank,
                                                        resolve_group)
from apex1_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    ring_shift)
from apex1_tpu_torch.transformer.tensor_parallel import mappings as mp


def _skip_error(caller: str, flag_name: str) -> ValueError:
    return ValueError(
        f"{caller}: stage_fn contains lax.ppermute (ring attention / "
        f"halo exchange), which is NOT safe under {flag_name}=True — "
        f"skipped ticks desynchronize ppermute's mesh-wide rendezvous "
        f"pairing and corrupt results silently. Pass {flag_name}="
        f"False for ppermute-bearing stages (bubble ticks then run on "
        f"zeros and mask — wall-time equivalent, the skip only saves "
        f"FLOPs/power).")


class _RingWatch:
    """Counts the ring steps made inside ``with watch:`` blocks."""

    def __init__(self):
        self.seen = 0

    def __enter__(self):
        self._start = mp.PERMUTES["count"]

    def __exit__(self, *exc):
        self.seen += mp.PERMUTES["count"] - self._start


def _detached(leaves, grad=None):
    """Fresh leaves: each requiring grad as ``grad`` says (None: as the
    tensor does; True: every floating tensor)."""
    return [x.detach().requires_grad_(
        x.requires_grad if grad is None else x.is_floating_point())
        for x in leaves]


def _f32(g):
    """At least fp32 (a float64 gradient stays float64)."""
    return g if g.dtype == torch.float64 else g.float()


def _add(acc, i, g):
    if g is not None:
        acc[i] = _f32(g) if acc[i] is None else acc[i] + _f32(g)


class _BroadcastLast(torch.autograd.Function):
    """Forward: the last stage's tensor on every stage (a sum all-reduce
    of the masked tensor). Backward: the cotangent kept on the last
    stage only, so a loss that every stage computes from the broadcast
    value back-propagates once (the JAX package's outside-grad
    convention)."""

    @staticmethod
    def forward(ctx, x, group, is_last):
        ctx.is_last = is_last
        out = x * float(is_last)
        if group is not None:
            out = mp.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * float(ctx.is_last), None, None


class _Pipeline(torch.autograd.Function):
    """The scan schedule: forward over the ticks, backward over them in
    reverse. ``plan`` carries the stage function and the layout."""

    @staticmethod
    def forward(ctx, plan, mbs, *leaves):
        P, s, M, V = plan.P, plan.s, mbs.shape[0], plan.V
        T = V * M + P - 1
        # one detached leaf per (chunk, parameter): a tick's grads land on
        # its own chunk only
        chunk_leaves = [[x[v].detach().requires_grad_(x.requires_grad)
                         for x in leaves] for v in range(V)]
        chunks = [tree_unflatten(cl, plan.spec) for cl in chunk_leaves]
        zeros_x = torch.zeros(mbs.shape[1:], dtype=mbs.dtype,
                              device=mbs.device)
        outs = torch.zeros_like(mbs)
        aux_sum = torch.zeros((), dtype=torch.float32, device=mbs.device)
        fifo, records = {}, {}
        x_recv = zeros_x
        watch = _RingWatch()
        for t in range(T):
            # stage-0 FIFO: the chunk output that arrived this tick (sent
            # by stage P-1 at tick t-1), held for the next chunk
            if V > 1 and s == 0 and t >= P:
                fifo[(t - P) % M] = (x_recv, t - 1)
            u = t - s
            y_send = zeros_x
            if 0 <= u < V * M:
                v, m = u // M, u % M
                if s == 0 and v == 0:
                    x, src = mbs[m], ("mb", m)
                elif s == 0:
                    x, tt = fifo[m]
                    src = ("recv", tt)
                else:
                    x, src = x_recv, ("recv", t - 1)
                x_in = x.detach().requires_grad_()
                with torch.enable_grad(), watch:
                    out = plan.stage(chunks[v], x_in)
                y, aux = out if plan.with_aux else (out, None)
                records[t] = (x_in, y, aux, src, v, m)
                if aux is not None:
                    aux_sum = aux_sum + aux.detach().float()
                if s == P - 1 and v == V - 1:
                    outs[m] = y.detach()
                y_send = y.detach()
            x_recv = ring_shift(y_send, plan.group, 1)
        ctx.plan = plan
        ctx.state = (records, chunk_leaves, leaves, mbs.shape, T, watch)
        plan.watch = watch
        return outs, aux_sum

    @staticmethod
    def backward(ctx, douts, daux):
        plan = ctx.plan
        records, chunk_leaves, leaves, mb_shape, T, watch = ctx.state
        P, s, V = plan.P, plan.s, plan.V
        dtype, dev = douts.dtype, douts.device
        zeros_x = torch.zeros(mb_shape[1:], dtype=dtype, device=dev)
        dmb = torch.zeros(mb_shape, dtype=dtype, device=dev)
        dchunk = [[None] * len(leaves) for _ in range(V)]
        d_recv = {}
        for t in reversed(range(T)):
            # the transpose of tick t's shift: the cotangent of what was
            # received goes back, that of what was sent comes in
            dy = ring_shift(d_recv.pop(t, zeros_x), plan.group, -1)
            if t not in records:
                continue
            x_in, y, aux, src, v, m = records.pop(t)
            if s == P - 1 and v == V - 1:
                dy = dy + douts[m]
            outputs, cts = [y], [dy.to(y.dtype)]
            if aux is not None and aux.requires_grad:
                outputs.append(aux)
                cts.append(daux.to(aux.dtype).reshape(aux.shape))
            need = [x_in] + [x for x in chunk_leaves[v] if x.requires_grad]
            with watch:
                grads = torch.autograd.grad(outputs, need, cts,
                                            allow_unused=True)
            dx = grads[0]
            it = iter(grads[1:])
            for i, x in enumerate(chunk_leaves[v]):
                if x.requires_grad:
                    _add(dchunk[v], i, next(it))
            if dx is not None:
                if src[0] == "mb":
                    dmb[src[1]] += dx.to(dtype)
                else:
                    d_recv[src[1]] = d_recv.get(src[1], zeros_x) + dx.to(
                        dtype)
        dleaves = []
        for i, x in enumerate(leaves):
            if not x.requires_grad:
                dleaves.append(None)
                continue
            per = [dchunk[v][i] if dchunk[v][i] is not None
                   else torch.zeros(x.shape[1:], dtype=torch.float32,
                                    device=x.device) for v in range(V)]
            dleaves.append(torch.stack(per).to(x.dtype))
        return (None, dmb, *dleaves)


def pipeline_apply(stage_fn: Callable, chunk_params, microbatches, *,
                   num_chunks: int = 1, axis_name=AXIS_PP,
                   broadcast_outputs: bool = True, remat_stage: bool = False,
                   scan_unroll=1, skip_bubbles: bool = True,
                   with_aux: bool = False, boundary_shape=None,
                   boundary_dtype=None):
    """The pipelined forward over the pp group (``axis_name``: a mesh
    axis name of `parallel_state`'s mesh, or a ``ProcessGroup``);
    differentiable.

    - ``stage_fn(params_chunk, x) -> y`` (or ``(y, aux)`` with
      ``with_aux``, aux a scalar side loss): one chunk's forward, the
      boundary shape and dtype in and out.
    - ``chunk_params``: a tree (dict) of this stage's chunk parameters,
      every leaf with the leading chunk axis V (``(1, ...)`` for V = 1).
    - ``microbatches`` (M, ...): the inputs, the same on every stage
      (stage 0 consumes them).

    ``broadcast_outputs=True``: the last chunk's (M, ...) outputs on
    every stage; their backward keeps the cotangent of the last stage
    only, so a loss every stage computes from them is differentiated
    once. False: the PARTIAL outputs, real on the last stage and zeros
    elsewhere (the convention for a per-rank partial loss; combine
    pp-replicated grads with `allreduce_embedding_grads`). With
    ``with_aux`` the return is ``(outputs, aux_sum)``, aux summed over
    this stage's valid ticks (a per-rank partial over pp).

    ``remat_stage`` recomputes each stage in the backward
    (`checkpoint_with_policy`, ``nothing_saveable``). ``boundary_shape``
    / ``boundary_dtype`` pad the microbatches into a larger boundary
    buffer (JAX's pad-to-max for stages of variable extent); outputs
    come back in it. ``skip_bubbles``: see the module docstring (the
    port always skips bubble work; a stage with a ring raises under
    True, as in the JAX package). ``scan_unroll`` is accepted and has no
    meaning here."""
    del scan_unroll
    group = resolve_group(axis_name)
    P, s = group_size_rank(group)
    M = microbatches.shape[0]
    V = num_chunks
    if V > 1 and M < P:
        raise ValueError(
            f"interleaved pipeline requires num_microbatches ({M}) >= "
            f"pipeline size ({P})")
    x_shape = tuple(boundary_shape or microbatches.shape[1:])
    dtype = boundary_dtype or microbatches.dtype
    if len(x_shape) != microbatches.dim() - 1 or any(
            b < m for b, m in zip(x_shape, microbatches.shape[1:])):
        raise ValueError(
            f"boundary_shape {x_shape} must have the microbatch rank and "
            f"cover the microbatch shape {tuple(microbatches.shape[1:])}")
    mbs = microbatches.to(dtype)
    if x_shape != tuple(microbatches.shape[1:]):
        pads = []
        for b, m in reversed(list(zip(x_shape, microbatches.shape[1:]))):
            pads += [0, b - m]
        mbs = torch.nn.functional.pad(mbs, pads)
    if remat_stage:
        from apex1_tpu_torch.transformer.tensor_parallel.random import (
            checkpoint_with_policy)
        stage_fn = checkpoint_with_policy(stage_fn, "nothing_saveable")
    leaves, spec = tree_flatten(chunk_params)
    plan = SimpleNamespace(stage=stage_fn, spec=spec, group=group, P=P, s=s,
                           V=V, with_aux=with_aux)
    outs, aux_sum = _Pipeline.apply(plan, mbs, *leaves)
    if skip_bubbles and plan.watch.seen:
        raise _skip_error("pipeline_apply", "skip_bubbles")
    if broadcast_outputs:
        outs = _BroadcastLast.apply(outs, group, s == P - 1)
    return (outs, aux_sum) if with_aux else outs


# ---------------------------------------------------------------------------
# tied-embedding pipeline (embedding group)
# ---------------------------------------------------------------------------

def pipeline_tied_apply(stage_fn: Callable, chunk_params, embed_fn: Callable,
                        head_fn: Callable, tied_params, tokens_mb, *,
                        num_chunks: int = 1, axis_name=AXIS_PP,
                        broadcast_outputs: bool = True, **pipeline_kwargs):
    """A pipeline with a TIED input embedding and LM head (the
    reference's embedding group: a copy on the first and on the last
    stage). ``embed_fn(tied_params, tokens) -> (..., D)`` feeds the
    pipeline (its gradient reaches stage 0's copy only) and
    ``head_fn(tied_params, outs) -> z`` runs on the last chunk's
    outputs, masked to the last stage (its gradient reaches the last
    stage's copy only). The tied grads are per-stage partials: sum them
    with `allreduce_embedding_grads`, the reference's embedding-group
    all-reduce. ``broadcast_outputs=True``: ``z`` on every stage (a loss
    computed from it on every stage back-propagates once); False: the
    per-stage partial, zeros off the last stage."""
    group = resolve_group(axis_name)
    P, s = group_size_rank(group)
    h_mb = torch.stack([embed_fn(tied_params, t) for t in tokens_mb])
    outs = pipeline_apply(stage_fn, chunk_params, h_mb,
                          num_chunks=num_chunks, axis_name=group,
                          broadcast_outputs=False, **pipeline_kwargs)
    z = head_fn(tied_params, outs)
    last = float(s == P - 1)
    z = tree_map(lambda a: a * last, z)
    if not broadcast_outputs:
        return z
    return tree_map(lambda a: _BroadcastLast.apply(a, group, s == P - 1), z)


def allreduce_embedding_grads(tied_grads, axis_name=AXIS_PP):
    """The reference's embedding-grad all-reduce over the embedding group
    after the pipeline step: the sum over the pp group of each leaf (the
    first stage's input-embedding part and the last stage's head part;
    middle stages add zeros)."""
    group = resolve_group(axis_name)
    if group_size_rank(group)[0] == 1:
        return tied_grads
    return tree_map(lambda g: mp.all_reduce(g, group), tied_grads)


# ---------------------------------------------------------------------------
# true 1F1B
# ---------------------------------------------------------------------------

def one_f_one_b(stage_fn: Callable, stage_params, microbatches,
                loss_mb: Callable, *, axis_name=AXIS_PP, num_chunks: int = 1,
                skip_idle: bool = True, scan_unroll=1, loss_params=None,
                with_aux: bool = False, aux_cotangent=None):
    """TRUE 1F1B (reference ``forward_backward_pipelining_without_
    interleaving``; with ``num_chunks`` V > 1 ``..._with_interleaving``):
    each stage interleaves one microbatch's backward between forwards,
    so at most O(V·P) microbatches' activations are alive, whatever M.

    The clocking is JAX's. V = 1, tick t of T = 2(M + P − 1): stage s
    runs the forward of microbatch m at t = 2m + s and its backward at
    t = 2m + 2P − 1 − s. V > 1 (Megatron's interleaved order, groups of
    P microbatches cycle through all V chunks; needs M % P == 0 and
    P ≥ 2): with m = g·P + r, the forward of (g, v, r) at
    t = 2(g·V·P + v·P + r) + s and its backward at
    t = D + 2(g·V·P + (V − 1 − v)·P + r) + 2P − 1 − s, D = 2(V − 1)P;
    chunk hand-offs recirculate through stage 0's activation FIFO and
    the last stage's gradient FIFO. Each tick ends with one forward
    shift (activations) and one backward shift (gradients).

    - ``stage_fn(stage_params, x) -> y`` (or ``(y, aux)`` with
      ``with_aux``): one chunk; with V > 1 ``stage_params`` leaves carry
      the leading (V, ...) chunk axis and the grads keep it.
    - ``loss_mb(y, m) -> scalar`` (``loss_mb(loss_params, y, m)`` with
      ``loss_params``): microbatch m's loss on the last stage after its
      last chunk's forward; its gradient seeds that microbatch's
      backward. The objective is the SUM over microbatches.
    - ``aux_cotangent`` (required with ``with_aux``): the cotangent each
      backward seeds the stage's aux with.

    Returns ``(loss_sum, grads, dmicrobatches[, dloss_params][,
    aux_sum])``, per-rank partials as in JAX: ``loss_sum`` real on the
    last stage, ``grads`` (fp32, shaped as ``stage_params``) this
    stage's, ``dmicrobatches`` (M, ...) fp32 real on stage 0,
    ``dloss_params`` fp32 real on the last stage, ``aux_sum`` the sum of
    this stage's aux values."""
    del scan_unroll
    group = resolve_group(axis_name)
    P, s = group_size_rank(group)
    M = microbatches.shape[0]
    V = num_chunks
    if V > 1:
        if M % P:
            raise ValueError(
                f"interleaved 1F1B requires num_microbatches ({M}) % "
                f"pipeline size ({P}) == 0 (the reference's "
                f"microbatches %% pp assertion)")
        if P < 2:
            raise ValueError("interleaved 1F1B needs pipeline size >= 2")
    D_ = (V - 1) * 2 * P
    VP = V * P
    T = D_ + 2 * V * M + 2 * P - 2
    dtype, dev = microbatches.dtype, microbatches.device
    zeros_x = torch.zeros(microbatches.shape[1:], dtype=dtype, device=dev)
    is_last = s == P - 1
    if with_aux and aux_cotangent is None:
        raise ValueError(
            "with_aux=True requires aux_cotangent — a zero default would "
            "silently drop the aux objective from every gradient")
    leaves, spec = tree_flatten(stage_params)
    if V == 1:
        chunk_leaves = [_detached(leaves, True)]
    else:
        chunk_leaves = [_detached([x[v] for x in leaves], True)
                        for v in range(V)]
    chunks = [tree_unflatten(cl, spec) for cl in chunk_leaves]
    lp_leaves, lp_spec = tree_flatten(
        {} if loss_params is None else loss_params)
    lp_d = _detached(lp_leaves, True)
    lp_tree = tree_unflatten(lp_d, lp_spec)
    gacc = [[None] * len(leaves) for _ in range(V)]
    lpacc = [None] * len(lp_leaves)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    dmb = torch.zeros(microbatches.shape, dtype=torch.float32, device=dev)
    watch = _RingWatch()

    def decomp(uu):
        """uu = g·V·P + v·P + r -> (g, v, r, m)."""
        g, rem = divmod(uu, VP)
        v, r = divmod(rem, P)
        return g, v, r, g * P + r

    def on_tick(w):
        return w >= 0 and w % 2 == 0 and w // 2 < V * M

    fwd_fifo, dy_fifo, dy_seed, ring = {}, {}, {}, {}
    x_recv = dy_recv = zeros_x
    for t in range(T):
        if V > 1:
            # stage 0 keeps chunk v's output of (g, r) for chunk v + 1;
            # the last stage keeps the cotangent of chunk v's input for
            # chunk v - 1's backward
            w1 = t - P
            if s == 0 and on_tick(w1):
                g1, v1, r1, _ = decomp(w1 // 2)
                if v1 <= V - 2:
                    fwd_fifo[(g1, v1 + 1, r1)] = x_recv
            w2 = t - D_ - 2 * P
            if is_last and on_tick(w2):
                g2, vv2, r2, _ = decomp(w2 // 2)
                if vv2 <= V - 2:
                    dy_fifo[(g2, V - 2 - vv2, r2)] = dy_recv

        # ---- forward subtick: fwd(g, v, r) at t = 2(g·VP+v·P+r)+s ----
        y_send = zeros_x
        if on_tick(t - s):
            g_f, v_f, r_f, m_f = decomp((t - s) // 2)
            if s == 0:
                x = (microbatches[m_f] if v_f == 0
                     else fwd_fifo.pop((g_f, v_f, r_f)))
            else:
                x = x_recv
            x_in = x.detach().requires_grad_()
            with torch.enable_grad(), watch:
                out = stage_fn(chunks[v_f], x_in)
            y, aux = out if with_aux else (out, None)
            if aux is not None:
                aux_sum = aux_sum + aux.detach().float()
            if is_last and v_f == V - 1:
                y_d = y.detach().requires_grad_()
                with torch.enable_grad(), watch:
                    lm = (loss_mb(y_d, m_f) if loss_params is None
                          else loss_mb(lp_tree, y_d, m_f)).float()
                    need = [y_d] + [x for x in lp_d if x.requires_grad]
                    grads = torch.autograd.grad(lm, need, allow_unused=True)
                dy_seed[(g_f, r_f)] = (torch.zeros_like(y_d)
                                       if grads[0] is None
                                       else grads[0].to(dtype))
                it = iter(grads[1:])
                for i, x in enumerate(lp_d):
                    if x.requires_grad:
                        _add(lpacc, i, next(it))
                loss_sum = loss_sum + lm.detach()
            ring[(g_f, v_f, r_f)] = (x_in, y, aux)
            y_send = y.detach()

        # ---- backward subtick: bwd(g, v, r) at
        #      t = D + 2(g·VP + (V−1−v)·P + r) + 2P−1−s ----
        dx_send = zeros_x
        w = t - D_ - (2 * P - 1 - s)
        if on_tick(w):
            g_b, vv_b, r_b, m_b = decomp(w // 2)
            v_b = V - 1 - vv_b
            if not is_last:
                seed = dy_recv
            elif v_b == V - 1:
                seed = dy_seed.pop((g_b, r_b))
            else:
                seed = dy_fifo.pop((g_b, v_b, r_b))
            x_in, y, aux = ring.pop((g_b, v_b, r_b))
            outputs, cts = [y], [seed.to(y.dtype)]
            if aux is not None and aux.requires_grad:
                outputs.append(aux)
                cts.append(torch.as_tensor(aux_cotangent, dtype=aux.dtype,
                                           device=dev).reshape(aux.shape))
            need = [x_in] + [x for x in chunk_leaves[v_b] if x.requires_grad]
            with watch:
                grads = torch.autograd.grad(outputs, need, cts,
                                            allow_unused=True)
            it = iter(grads[1:])
            for i, x in enumerate(chunk_leaves[v_b]):
                if x.requires_grad:
                    _add(gacc[v_b], i, next(it))
            dx = zeros_x if grads[0] is None else grads[0].to(dtype)
            if s == 0 and v_b == 0:
                dmb[m_b] = dx.float()
            dx_send = dx
        x_recv = ring_shift(y_send, group, 1)
        dy_recv = ring_shift(dx_send, group, -1)
    if skip_idle and watch.seen:
        raise _skip_error("one_f_one_b", "skip_idle")

    def stacked(i, x):
        per = [gacc[v][i] if gacc[v][i] is not None
               else torch.zeros(chunk_leaves[v][i].shape,
                                dtype=torch.float32, device=x.device)
               for v in range(V)]
        return per[0] if V == 1 else torch.stack(per)

    grads = tree_unflatten([stacked(i, x) for i, x in enumerate(leaves)],
                           spec)
    out = (loss_sum, grads, dmb)
    if loss_params is not None:
        dlp = [a if a is not None else torch.zeros(
            x.shape, dtype=torch.float32, device=x.device)
            for a, x in zip(lpacc, lp_leaves)]
        out = out + (tree_unflatten(dlp, lp_spec),)
    if with_aux:
        out = out + (aux_sum,)
    return out


def forward_backward_no_pipelining(loss_fn: Callable, params, microbatches):
    """``fwd_bwd_no_pipelining``: the microbatches in order, one gradient
    accumulation (the grad sync happens once, after). ``loss_fn(params,
    microbatch) -> scalar``; ``microbatches`` a tensor or a tree of
    tensors with the leading M. Returns (mean_loss, fp32 grads)."""
    leaves, spec = tree_flatten(params)
    mb_leaves, mb_spec = tree_flatten(microbatches)
    M = mb_leaves[0].shape[0]
    acc = [None] * len(leaves)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=mb_leaves[0].device)
    for m in range(M):
        p = _detached(leaves, True)
        mb = tree_unflatten([x[m] for x in mb_leaves], mb_spec)
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(p, spec), mb)
            need = [x for x in p if x.requires_grad]
            grads = iter(torch.autograd.grad(loss, need, allow_unused=True))
        for i, x in enumerate(p):
            if x.requires_grad:
                _add(acc, i, next(grads))
        loss_sum = loss_sum + loss.detach().float()
    scale = 1.0 / M
    grads = [(torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              if a is None else a) * scale for a, x in zip(acc, leaves)]
    return loss_sum * scale, tree_unflatten(grads, spec)


# ---------------------------------------------------------------------------
# the whole forward and backward through the pipeline
# ---------------------------------------------------------------------------

def pipelined_loss_fn(stage_fn: Callable, loss_fn: Callable, mesh=None, *,
                      num_chunks: int = 1, axis_name: str = AXIS_PP,
                      **pipeline_kwargs):
    """``f(chunk_params, microbatches, targets) -> loss``: the pipeline
    over ``mesh``'s ``axis_name`` group (`parallel_state`'s mesh when
    None), then ``loss_fn(outputs, targets) -> scalar`` on every stage
    from the broadcast outputs. Where the JAX package takes the global
    (V, P, ...) stack and shards it, this rank passes its own stage's
    column, leaves (V, ...). Differentiate ``f`` (autograd) for the
    whole forward and backward; the loss back-propagates once. Extra
    keyword arguments (``skip_bubbles``, ``remat_stage``,
    ``boundary_shape``, ...) go to `pipeline_apply`."""
    group = (resolve_group(axis_name) if mesh is None
             else mesh.group(axis_name))

    def f(chunk_params, microbatches, targets):
        outs = pipeline_apply(stage_fn, chunk_params, microbatches,
                              num_chunks=num_chunks, axis_name=group,
                              **pipeline_kwargs)
        return loss_fn(outs, targets)

    return f


def _value_and_grad(f, chunk_params, microbatches, targets):
    leaves, spec = tree_flatten(chunk_params)
    p = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = f(tree_unflatten(p, spec), microbatches, targets)
        grads = torch.autograd.grad(loss, p)
    return loss.detach(), tree_unflatten(list(grads), spec)


def forward_backward_pipelining_without_interleaving(
        stage_fn, loss_fn, mesh, chunk_params, microbatches, targets, **kw):
    """The V = 1 schedule. Returns (loss, this stage's grads)."""
    f = pipelined_loss_fn(stage_fn, loss_fn, mesh, num_chunks=1, **kw)
    return _value_and_grad(f, chunk_params, microbatches, targets)


def forward_backward_pipelining_with_interleaving(
        stage_fn, loss_fn, mesh, chunk_params, microbatches, targets,
        num_chunks: int = 2, **kw):
    """The interleaved (virtual pipeline) schedule, V = ``num_chunks``."""
    f = pipelined_loss_fn(stage_fn, loss_fn, mesh, num_chunks=num_chunks,
                          **kw)
    return _value_and_grad(f, chunk_params, microbatches, targets)


def get_forward_backward_func():
    """``schedules/__init__.py :: get_forward_backward_func``: chosen by
    the installed parallel state."""
    if (parallel_state.model_parallel_is_initialized()
            and parallel_state.get_pipeline_model_parallel_world_size() > 1):
        if parallel_state.get_virtual_pipeline_model_parallel_world_size():
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
