"""T5 seq2seq training, then generation (the port of
``examples/t5_seq2seq.py``): amp and fused Adam on a synthetic sorting
task (the decoder must emit the encoder's tokens in ascending order:
position-free, so it suits T5's relative-position attention), then
KV-cached greedy generation (`models.generate.t5_generate`) of a
held-out batch, scored as the share of tokens in their sorted place.
Duplicates are the hard part of the task.

- amp O2 + fused Adam -> ``Amp(fused_adam(1e-3, weight_decay=0.01))``
- the loss            -> ``t5_loss_fn(model, label_pad_id=0)`` (the
                         fused LM head; the relative-position bias
                         through flash attention's bias operand)
- generation          -> ``t5_generate(model, src, max_new_tokens=seq,
                         dec_start_id=1)``

``python -m apex1_tpu_torch.examples.t5_seq2seq [--opt-level O2]
[--steps 1500] [--device cpu]``. The weights come from
``init_weights(seed 0)`` (the tests pass the JAX package's); the
batches from ``np.random.default_rng(0)``: the init batch, one a step,
then the held-out eight. `main` returns each step's loss, the step
walls, the sort accuracy, the generated tokens and the final state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.examples._common import StepRecord
from apex1_tpu_torch.models.generate import t5_generate
from apex1_tpu_torch.models.t5 import T5, T5Config, init_weights, t5_loss_fn
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import fused_adam


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def make_batch(rng, batch, seq, vocab, pad_id=0, bos_id=1):
    """The sort task as numpy: the encoder sees [2, vocab) tokens; the
    decoder target is the ascending sort wrapped as [BOS, sorted...,
    PAD]."""
    src = rng.integers(2, vocab, (batch, seq))
    dec = np.concatenate(
        [np.full((batch, 1), bos_id), np.sort(src, axis=1),
         np.full((batch, 1), pad_id)], axis=1)
    return src, dec


def config(opt_level: str) -> T5Config:
    return T5Config.tiny(vocab_size=32, d_model=128, num_heads=4,
                         head_dim=32, d_ff=256, num_encoder_layers=2,
                         num_decoder_layers=2, policy=get_policy(opt_level))


def main(argv=None, *, model: T5 = None) -> dict:
    """``model``: a T5 at `config`'s widths to train in place of the one
    drawn from seed 0."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config(args.opt_level)
    rng = np.random.default_rng(0)
    make_batch(rng, args.batch, args.seq, cfg.vocab_size)   # the init's
    if model is None:
        model = init_weights(T5(cfg, device=dev), seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"T5 tiny: {n_params / 1e6:.2f}M params, opt {args.opt_level}")

    amp = Amp(fused_adam(1e-3, weight_decay=0.01), opt_level=args.opt_level)
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(t5_loss_fn(model, label_pad_id=0))

    def tensors(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    rec = StepRecord(dev)
    t0 = time.time()
    for i in range(args.steps):
        src, dec = make_batch(rng, args.batch, args.seq, cfg.vocab_size)
        state, metrics = step(state, *tensors(src, dec))
        rec(metrics)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {metrics['loss'].item():.4f}  "
                  f"scale {metrics['loss_scale'].item():.0f}")
    train_s = time.time() - t0
    print(f"trained {args.steps} steps in {train_s:.1f}s")

    # greedy generation: the decoder should sort a held-out batch
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(state.params[k])
    src, _ = make_batch(rng, 8, args.seq, cfg.vocab_size)
    (src_t,) = tensors(src)
    t1 = time.time()
    got = t5_generate(model, src_t, max_new_tokens=args.seq,
                      dec_start_id=1).cpu().numpy()
    gen_s = time.time() - t1
    acc = float((got == np.sort(src, axis=1)).mean())
    print(f"greedy decode sort accuracy: {acc:.1%}")
    for i in range(2):
        print(f"  src {src[i].tolist()}")
        print(f"  out {got[i].tolist()}")
    return {**rec.result(), "accuracy": acc, "tokens": got, "src": src,
            "state": state, "train_s": train_s, "generate_s": gen_s,
            "loss_scale": float(state.loss_scale.scale)}


if __name__ == "__main__":
    main()
