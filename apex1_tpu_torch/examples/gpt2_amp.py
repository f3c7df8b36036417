"""GPT-2 mixed-precision training (the port of ``examples/gpt2_amp.py``;
reference ``examples/imagenet/main_amp.py``'s amp half on GPT-2 124M):
opt-level presets, dynamic loss scaling with skip-on-overflow, fused
Adam. Data comes from a memory-mapped `TokenDataset` (step-indexed, so
resumable) behind a `PrefetchLoader` (the next batch staged in pinned
memory and copied on a side stream while the current step runs).
Without ``--data`` a synthetic token file is written once.

``python -m apex1_tpu_torch.examples.gpt2_amp [--opt-level O1|O1_fp16|O2]
[--tiny] [--data tokens.bin] [--device cpu] [--prefetch N]``

``--prefetch 0`` copies each batch to the device inline instead (the
loop the prefetcher is measured against). Every step ends in a
synchronize, so a step's wall is the time from the previous step's end
to its own, data included.

With ``--ckpt-dir`` the loop runs under the resilient runtime
(`apex1_tpu_torch.resilience`): async integrity-checked checkpoints
every ``--ckpt-every`` steps and at the last, ``--resume auto``
continuing exactly from the newest valid checkpoint (the data position
is just the step), the divergence sentinel (skip, rollback, abort) and
a SIGTERM/SIGINT hook that saves a last checkpoint and exits with
`EXIT_RESUMABLE` (75). ``APEX1_CHAOS_SIGTERM_STEP=<n>`` sends that
SIGTERM to this process after step n (the kill-and-resume drill).

``--obs-dir <dir>`` (or ``APEX1_OBS_DIR``) banks the run through the
telemetry spine (`apex1_tpu_torch.obs`): every `MetricsLogger` line,
sentinel diagnostic and checkpoint save or restore lands in one
run-scoped JSONL file.

`main` returns the run's record: the loss of every step, the step walls
(ms), the final state and the step function.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import StepRecord
from apex1_tpu_torch.interop import gpt2_params_from_jax
from apex1_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss_fn, init_params
from apex1_tpu_torch.obs import spine
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import fused_adam
from apex1_tpu_torch.runtime import (PrefetchLoader, TokenDataset,
                                     write_token_file)
from apex1_tpu_torch.utils.observability import MetricsLogger


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--opt-level", default="O1")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--data", default=None,
                    help="flat uint16 token file (default: synthetic)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches prefetched ahead; 0 copies each batch "
                    "to the device inline")
    ap.add_argument("--ckpt-dir", default=None,
                    help="enable the resilient runtime: async "
                    "checkpoints + sentinel + preemption hook")
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--resume", default="auto", choices=("auto", "never"),
                    help="auto: continue from the newest VALID "
                    "checkpoint under --ckpt-dir")
    ap.add_argument("--obs-dir", default=None,
                    help="bank run telemetry as JSONL through "
                    "apex1_tpu_torch.obs (as APEX1_OBS_DIR does)")
    return ap.parse_args(argv)


def build(args):
    """``(cfg, model, amp, state)``: GPT-2 124M (or ``--tiny``) at the
    opt level, weights from `init_params` at seed 0, under
    ``Amp(fused_adam(3e-4, weight_decay=0.01), max_grad_norm=1.0)``."""
    policy = get_policy(args.opt_level)
    cfg = (GPT2Config.tiny(policy=policy) if args.tiny
           else GPT2Config(policy=policy))
    model = gpt2_params_from_jax(init_params(cfg, 0), cfg, args.device)
    amp = Amp(fused_adam(3e-4, weight_decay=0.01),
              opt_level=args.opt_level, max_grad_norm=1.0)
    return cfg, model, amp, amp.init(dict(model.named_parameters()))


def synthetic_data(cfg: GPT2Config, batch: int, seq: int) -> str:
    """A uint16 token file of ``max(batch * seq * 8, 2^18)`` tokens from
    ``np.random.default_rng(0)`` under the temporary directory, written
    once (through a rename: an interrupted write never leaves a
    truncated file at the name)."""
    n_tok = max(batch * seq * 8, 1 << 18)
    path = os.path.join(
        tempfile.gettempdir(),
        f"gpt2_amp_synth_{cfg.vocab_size}_{n_tok}_{os.getuid()}.bin")
    if not os.path.exists(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        write_token_file(tmp, np.random.default_rng(0).integers(
            0, cfg.vocab_size, n_tok).astype(np.uint16))
        os.replace(tmp, path)
    return path


def batches(ds: TokenDataset, start: int, args, device):
    """The step-indexed batches from ``start`` on the device: through a
    `PrefetchLoader`, or copied inline with ``--prefetch 0``."""
    if args.prefetch:
        return iter(PrefetchLoader(ds.iter_from(start),
                                   prefetch=args.prefetch, device=device))
    return (torch.from_numpy(b).to(device) for b in ds.iter_from(start))


def main(argv=None) -> dict:
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    prev_obs = os.environ.get("APEX1_OBS_DIR")
    if args.obs_dir:
        # the spine's default run reads this at its first emit, so every
        # MetricsLogger line of the loop lands in it
        os.environ["APEX1_OBS_DIR"] = args.obs_dir
    try:
        return _run(args)
    finally:
        if args.obs_dir:
            if prev_obs is None:
                os.environ.pop("APEX1_OBS_DIR", None)
            else:
                os.environ["APEX1_OBS_DIR"] = prev_obs
            spine.default_run()   # re-keyed: closes this run's file


def _run(args) -> dict:
    cfg, model, amp, state = build(args)
    if args.seq > cfg.max_seq_len:   # --tiny keeps the default --seq
        args.seq = cfg.max_seq_len
    step = amp.make_train_step(gpt2_loss_fn(model))
    data_path = args.data or synthetic_data(cfg, args.batch, args.seq)
    logger = MetricsLogger()
    rec = StepRecord(args.device)
    t0 = time.time()
    if args.ckpt_dir:
        state = _resilient_loop(args, amp, model, state, data_path, logger,
                                rec)
    else:
        with TokenDataset(data_path, seq_len=args.seq,
                          batch_size=args.batch) as ds:
            it = batches(ds, 0, args, args.device)
            try:
                for i, batch in zip(range(args.steps), it):
                    state, metrics = step(state, batch)
                    rec(metrics)
                    if i % 5 == 0 or i == args.steps - 1:
                        logger.log(i, metrics,
                                   tokens=args.batch * args.seq)
            finally:
                # stop the prefetch worker BEFORE the mmap goes away
                it.close()
    print(f"done in {time.time() - t0:.1f}s; final loss-scale "
          f"{float(state.loss_scale.scale)}, "
          f"skipped {int(state.loss_scale.overflow_count)} steps")
    return {**rec.result(), "state": state, "step": step, "cfg": cfg,
            "tokens_per_step": args.batch * args.seq}


def _resilient_loop(args, amp, model, state, data_path, logger, rec):
    """The --ckpt-dir path: the same train step under the resilient
    runtime. `TokenDataset.batch_at(step)` is a pure function of the
    step, so the data position in the checkpoint's meta is one int and
    resume and rollback are exact."""
    from apex1_tpu_torch.resilience import (PreemptionHandler,
                                            ResilientCheckpointer, Sentinel,
                                            sentinel_init)
    from apex1_tpu_torch.testing.chaos import sigterm_self_at
    from apex1_tpu_torch.utils.debug import program_fingerprint

    dev = args.device
    sample = torch.zeros((args.batch, args.seq), dtype=torch.int32,
                         device=dev)
    plain_step = amp.make_train_step(gpt2_loss_fn(model))
    sent = Sentinel(None, check_every=max(1, args.ckpt_every),
                    rollback_after=2)
    guarded = sent.guard(plain_step)
    fp = program_fingerprint(guarded, (state, sentinel_init(dev)), sample)
    ck = ResilientCheckpointer(args.ckpt_dir, keep=3, fingerprint=fp)
    sent.checkpointer = ck
    chaos_at = os.environ.get("APEX1_CHAOS_SIGTERM_STEP")
    chaos_at = int(chaos_at) if chaos_at else None

    def save(i, carry, sync=False, **meta):
        (ck.save_sync if sync else ck.save)(
            int(carry[0].step), carry[0], meta={"data_step": i, **meta})
        spine.emit("event", "checkpoint.save", step=int(carry[0].step),
                   data_step=i, sync=sync, **meta)

    start = 0
    carry = (state, sentinel_init(dev))
    if args.resume == "auto" and ck.latest_valid() is not None:
        restored, man = ck.restore(carry[0])
        start = int(man.meta.get("data_step", man.step))
        carry = (restored, sentinel_init(dev))
        spine.emit("event", "checkpoint.restore", step=int(man.step),
                   data_step=start)
        print(f"resumed from {man.step} (data step {start})", flush=True)

    with TokenDataset(data_path, seq_len=args.seq,
                      batch_size=args.batch) as ds, \
            PreemptionHandler() as pre, ck:
        i = start
        while i < args.steps:
            step_idx = i
            batch = torch.from_numpy(ds.batch_at(i)).to(dev)
            carry, metrics = guarded(carry, batch)
            rec(metrics)
            i += 1
            action = sent.poll(carry[1])
            if action == "rollback":
                restored, man, s0 = sent.rollback(template=carry[0])
                i = int(man.meta.get("data_step", man.step))
                carry = (restored, s0)
                # the loss is deterministic, so the retry replays the
                # same trajectory: a transient fault does not recur, a
                # logical NaN does and the ladder escalates to abort
                print(f"sentinel rollback to data step {i}", flush=True)
                continue
            if i % args.ckpt_every == 0 or i == args.steps:
                save(i, carry)
            if step_idx % 5 == 0 or step_idx == args.steps - 1:
                logger.log(step_idx, metrics,
                           tokens=args.batch * args.seq)
            sigterm_self_at(i, chaos_at)
            if pre.triggered:
                ck.wait()   # let the in-flight async save commit first
                save(i, carry, sync=True, preempted=True)
                pre.exit_resumable(f"preempted at data step {i}")
        ck.wait()
    return carry[0]


if __name__ == "__main__":
    main()
