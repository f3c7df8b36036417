"""RNN-Transducer speech training (the port of
``examples/rnnt_speech.py``; reference ``apex/contrib/transducer``): an
LSTM audio encoder and an LSTM prediction network (`rnn.LSTM`, the
hoisted input projection), the broadcast-add transducer joint with ReLU
(`contrib.transducer.transducer_joint`), a vocabulary head and the
RNN-T loss (`contrib.transducer.transducer_loss`), trained with amp and
fused Adam (lr 2e-3) on a synthetic phoneme task: each label held for a
few noisy audio frames, which the transducer must recover as the label
sequence. Greedy RNN-T decoding (advance t on blank, u on an emission)
on four held-out utterances checks the learned alignment.

``python -m apex1_tpu_torch.examples.rnnt_speech [--steps 800]
[--opt-level O2] [--device cpu]``. The weights come from
`init_weights` (seed 0; the tests pass the JAX package's through
`interop.rnnt_params_from_jax`); the projection and the batches from
``np.random.default_rng(0)`` in the JAX script's order. `main` returns
each step's loss, the step walls, the hypotheses, the exact-sequence
count and the final state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn as nn

from apex1_tpu_torch.amp import Amp
from apex1_tpu_torch.contrib.transducer import (transducer_joint,
                                                transducer_loss)
from apex1_tpu_torch.examples._common import StepRecord
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import fused_adam
from apex1_tpu_torch.rnn import LSTM

BLANK = 0


class RNNT(nn.Module):
    """The minimal transducer: encoder and predictor LSTMs, the joint,
    a vocabulary head. Parameters (fp32, the flax module's names):
    ``encoder.*``, ``embed`` (vocab, hidden), ``predictor.*``, ``head``
    (hidden, vocab); zero or LSTM-initialized until `init_weights` or
    `interop.rnnt_params_from_jax` fills them."""

    def __init__(self, vocab: int, feat: int, hidden: int = 64,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab, self.feat, self.hidden = vocab, feat, hidden
        self.encoder = LSTM(feat, hidden, device=dev)
        self.embed = nn.Parameter(torch.zeros(vocab, hidden, device=dev))
        self.predictor = LSTM(hidden, hidden, device=dev)
        self.head = nn.Parameter(torch.zeros(hidden, vocab, device=dev))

    def forward(self, audio, dec_in):
        """audio (B, T, feat); dec_in (B, U) label ids with a leading
        BLANK (the prediction network's <s>). Returns the (B, T, U,
        vocab) joint logits in audio's dtype."""
        dtype = audio.dtype
        enc, _ = self.encoder(audio.transpose(0, 1))
        pred, _ = self.predictor(
            self.embed[dec_in.long()].to(dtype).transpose(0, 1))
        h = transducer_joint(enc.transpose(0, 1), pred.transpose(0, 1),
                             relu=True)
        return h @ self.head.to(h.dtype)


@torch.no_grad()
def init_weights(model: RNNT, seed: int) -> RNNT:
    """Random weights at the flax module's scales, drawn on the model's
    device from ``torch.Generator(device).manual_seed(seed)``: the LSTM
    kernels normal(fan_in ** -0.5), their biases zero, the embedding
    and head normal(0.02). (The JAX package's draws differ: load its
    params with `interop.rnnt_params_from_jax` to compare the two.)"""
    gen = torch.Generator(device=model.head.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("_b"):
            p.zero_()
        elif name.endswith("_w"):
            p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model


def make_batch(rng, batch, U_lab, frames_per, vocab, feat, proj):
    """Each utterance: ``U_lab`` labels from [1, vocab), each held for
    ``frames_per`` audio frames; audio = one-hot @ ``proj`` + noise. As
    numpy: (audio (B, T, feat) float32, labels (B, U_lab), dec_in (B,
    U_lab + 1) with the leading BLANK)."""
    labels = rng.integers(1, vocab, (batch, U_lab))
    frames = np.repeat(labels, frames_per, axis=1)           # (B, T)
    onehot = np.eye(vocab)[frames]                           # (B, T, V)
    audio = onehot @ proj + rng.normal(0, 0.1, (batch, U_lab * frames_per,
                                                feat))
    dec_in = np.concatenate([np.zeros((batch, 1), np.int64), labels], 1)
    return audio.astype(np.float32), labels, dec_in


@torch.no_grad()
def greedy_decode(model: RNNT, audio: torch.Tensor, max_symbols: int = 8):
    """Standard RNN-T greedy: at each t emit while the argmax is not
    blank (at most ``max_symbols``), else advance t; the host loop of
    the JAX script (one whole forward an emission decision). Returns a
    list of label lists."""
    B, T, _ = audio.shape
    hyps = []
    for b in range(B):
        y = [BLANK]
        for t in range(T):
            for _ in range(max_symbols):
                logits = model(audio[b:b + 1],
                               torch.tensor([y], device=audio.device))
                k = int(torch.argmax(logits[0, t, len(y) - 1]))
                if k == BLANK:
                    break
                y.append(k)
        hyps.append(y[1:])
    return hyps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--labels", type=int, default=5)
    ap.add_argument("--frames-per", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=8)
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def main(argv=None, *, model: RNNT = None) -> dict:
    """``model``: an `RNNT` (vocab, feat of the flags) to train in place
    of the one from `init_weights` (seed 0)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    proj = rng.normal(0, 1.0, (args.vocab, args.feat))

    def batch_of(n):
        return make_batch(rng, n, args.labels, args.frames_per,
                          args.vocab, args.feat, proj)

    batch_of(args.batch)                        # the init's batch
    if model is None:
        model = init_weights(RNNT(args.vocab, args.feat, device=dev), 0)
    n = sum(p.numel() for p in model.parameters())
    print(f"RNN-T: {n / 1e3:.0f}k params, opt {args.opt_level}")

    T = args.labels * args.frames_per
    f_len = torch.full((args.batch,), T, dtype=torch.int32, device=dev)
    y_len = torch.full((args.batch,), args.labels, dtype=torch.int32,
                       device=dev)

    def loss_fn(params, audio, labels, dec_in):
        logits = torch.func.functional_call(model, params, (audio, dec_in))
        return transducer_loss(logits, labels, f_len, y_len,
                               blank_idx=BLANK)

    amp = Amp(fused_adam(2e-3), opt_level=args.opt_level)
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(loss_fn)
    rec = StepRecord(dev)
    t0 = time.time()
    for i in range(args.steps):
        batch = [torch.from_numpy(a).to(dev) for a in batch_of(args.batch)]
        state, m = step(state, *batch)
        rec(m)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  nll {m['loss'].item():.4f}")
    train_s = time.time() - t0
    print(f"trained {args.steps} steps in {train_s:.1f}s")

    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(state.params[k])
    audio, labels, _ = batch_of(4)
    # an untrained model emits junk at up to max_symbols a frame, so
    # short smoke runs cap the emission budget hard
    t1 = time.time()
    hyps = greedy_decode(model, torch.from_numpy(audio).to(dev),
                         max_symbols=8 if args.steps >= 100 else 2)
    decode_s = time.time() - t1
    want = [r.tolist() for r in labels]
    exact = sum(h == w for h, w in zip(hyps, want))
    print(f"greedy exact-sequence match: {exact}/4")
    for h, w in zip(hyps[:2], want[:2]):
        print(f"  ref {w}\n  hyp {h}")
    return {**rec.result(), "hyps": hyps, "labels": want, "exact": exact,
            "state": state, "train_s": train_s, "decode_s": decode_s}


if __name__ == "__main__":
    main()
