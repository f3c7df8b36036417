"""Llama serving walkthrough (the port of ``examples/serving_llama.py``):
on one model, the whole decode stack of `models.generate`:

1. greedy KV-cached generation (`generate`);
2. ragged batching: mixed-length prompts served together through
   ``prompt_lens`` (left-aligned once; each row decodes as if alone);
3. beam search with the GNMT length penalty (`beam_search`, K 4, lp
   1.0);
4. int8 weight-only decode (`models.quant_decode.llama_quant_decoder`:
   the same loop over per-out-channel int8 weights, the int8 GEMM
   kernel);
5. speculative decoding (`speculative_generate`): a quarter-depth draft
   proposes K = 4 tokens, the target verifies a chunk a forward; the
   verify rounds a row are printed;
6. prefix caching: a shared system prompt prefilled once, two user
   turns continued off it (``cache_start``), each against the flat
   prompt.

The model is the 1B Llama of the JAX script (16 layers, hidden 2048,
32 / 4 heads, ffn 5632, vocab 32000, O2) on a CUDA device, and
``LlamaConfig.tiny`` (O2, 128 positions) with ``--tiny`` or on the CPU,
its weights from ``init_weights`` (seed 0, the draft seed 7; the tests
pass the JAX package's). Speculative greedy must give greedy's tokens:
equal at fp32 (O0), and at O2 apart first only at a near-tie
(`models.near_tie`: the verify chunk and the one-token step round
differently in bf16), else the script raises. The ragged rows are held
against each row generated alone by the same rule, and returned.

``python -m apex1_tpu_torch.examples.serving_llama [--tiny] [--batch 2]
[--prompt-len 8] [--new 16] [--beams 4] [--device cpu]``. `main`
returns each section's tokens (the beam scores, the verify rounds, the
agreements), each section's wall (s, ending in a synchronize) and the
near-tie verdicts.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from apex1_tpu_torch.core.policy import get_policy
from apex1_tpu_torch.models import near_tie
from apex1_tpu_torch.models.generate import (beam_search, generate,
                                             llama_decoder,
                                             speculative_generate)
from apex1_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
from apex1_tpu_torch.models.quant_decode import llama_quant_decoder
from apex1_tpu_torch.ops._common import resolve_device

#: the JAX script's accelerator config
LLAMA_1B = dict(vocab_size=32000, max_seq_len=2048, num_layers=16,
                num_heads=32, num_kv_heads=4, hidden_size=2048,
                ffn_size=5632)
DRAFT_K = 4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--beams", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def main(argv=None, *, model: Llama = None, draft: Llama = None) -> dict:
    """``model`` and ``draft``: the target and the speculative draft in
    place of the ones drawn from seeds 0 and 7."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if model is None:
        cfg = (LlamaConfig.tiny(policy=get_policy("O2"), max_seq_len=128)
               if args.tiny or dev.type != "cuda" else
               LlamaConfig(**LLAMA_1B, policy=get_policy("O2")))
        model = init_weights(Llama(cfg, device=dev), seed=0)
    cfg = model.cfg
    if draft is None:
        draft = init_weights(Llama(dataclasses.replace(
            cfg, num_layers=max(1, cfg.num_layers // 4)), device=dev), seed=7)
    exact = cfg.policy.compute_dtype == torch.float32
    B, S0, N, V = args.batch, args.prompt_len, args.new, cfg.vocab_size
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, V, (B, S0))).to(dev)
    apply_fn, make_cache = llama_decoder(model)
    walls, out = {}, {}

    def timed(tag, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls[tag] = time.perf_counter() - t0
        print(f"  {tag:34s} {walls[tag]:7.3f}s")
        return res

    print(f"== serving {B}x{S0}+{N} on {dev} ({cfg.num_layers} layers, "
          f"hidden {cfg.hidden_size}) ==")
    rec = []
    toks = timed("greedy generate", lambda: generate(
        near_tie.recorder(apply_fn, rec), prompt, max_new_tokens=N,
        cache=make_cache(B, S0 + N), vocab_size=V))
    out["greedy"] = toks.cpu().numpy()
    print(f"    row0: {out['greedy'][0][:10]}...")

    # ragged: the same rows at their true (mixed) lengths in one batch,
    # each row but the first held against itself decoded alone
    lens = [S0] + [max(1, S0 // 2)] * (B - 1)
    rec_r = []
    ragged = timed("ragged generate (mixed lens)", lambda: generate(
        near_tie.recorder(apply_fn, rec_r), prompt, max_new_tokens=N,
        cache=make_cache(B, S0 + N), vocab_size=V,
        prompt_lens=torch.tensor(lens, device=dev)))
    out["ragged"] = ragged.cpu().numpy()
    alone, rec_a = [], []
    for r in range(1, B):
        rec_a.append([])
        alone.append(generate(
            near_tie.recorder(apply_fn, rec_a[-1]), prompt[r:r + 1, :lens[r]],
            max_new_tokens=N, cache=make_cache(1, lens[r] + N),
            vocab_size=V).cpu().numpy()[0])
    out["alone"] = np.stack(alone) if alone else np.zeros((0, N), np.int64)
    ragged_verdict = near_tie.judge(
        out["ragged"][1:], out["alone"],
        lambda r, t: rec_r[t][r + 1:r + 2] if t < len(rec_r) else None,
        lambda r, t: rec_a[r][t] if t < len(rec_a[r]) else None, V)
    print(f"    lens {lens} -> row1: {out['ragged'][min(1, B - 1)][:10]}...;"
          f" rows against alone: first flips {ragged_verdict['flips']}")

    beams, scores = timed(f"beam search K={args.beams}, lp=1.0",
                          lambda: beam_search(
        apply_fn, prompt, max_new_tokens=N,
        cache=make_cache(B * args.beams, S0 + N), num_beams=args.beams,
        length_penalty=1.0, vocab_size=V))
    out["beams"], out["scores"] = beams.cpu().numpy(), scores.cpu().numpy()
    print(f"    best scores: {out['scores'].round(3)}")

    apply_q, make_cache_q, _ = llama_quant_decoder(model)
    toks_q = timed("int8 weight-only generate", lambda: generate(
        apply_q, prompt, max_new_tokens=N, cache=make_cache_q(B, S0 + N),
        vocab_size=V))
    out["int8"] = toks_q.cpu().numpy()
    out["int8_agreement"] = float((out["int8"] == out["greedy"]).mean())
    print(f"    token agreement with the model's own dtype: "
          f"{out['int8_agreement']:.2f}")

    # speculative: a shallow draft of the same family; greedy's tokens,
    # fewer target forwards where the draft agrees
    d_fn, make_cache_d = llama_decoder(draft)
    S = S0 + N + DRAFT_K + 1
    verify = []
    toks_s, rounds = timed("speculative (K=4, shallow draft)",
                           lambda: speculative_generate(
        near_tie.recorder(apply_fn, verify, chunks=True), d_fn, prompt,
        max_new_tokens=N, target_cache=make_cache(B, S),
        draft_cache=make_cache_d(B, S), num_draft=DRAFT_K, vocab_size=V))
    out["speculative"] = toks_s.cpu().numpy()
    out["rounds"] = rounds.cpu().numpy()
    spec_verdict = near_tie.judge(
        out["speculative"], out["greedy"],
        near_tie.verify_logits(verify, S0, DRAFT_K),
        near_tie.step_logits(rec), V)
    print(f"    verify rounds/row {out['rounds'].tolist()} vs {N - 1} greedy "
          f"target forwards; first flips against greedy "
          f"{spec_verdict['flips']}")
    if exact and spec_verdict["flips"]:
        raise AssertionError("speculative output must be token-identical "
                             "to greedy at fp32")
    if spec_verdict["bad"]:
        raise AssertionError(f"speculative output differs from greedy off "
                             f"a near-tie: {spec_verdict['bad']}")

    # prefix caching: prefill the "system prompt" once, continue turns
    Ls = max(2, S0 // 2)
    _, cache_pre = apply_fn(prompt, make_cache(B, S0 + Ls + N), 0)
    out["prefix"], out["prefix_agreement"] = [], []
    for turn in range(2):
        user = torch.from_numpy(np.random.default_rng(100 + turn).integers(
            1, V, (B, Ls))).to(dev)
        cont = timed(f"prefix-cached turn {turn}", lambda: generate(
            apply_fn, user, max_new_tokens=N, cache=cache_pre,
            cache_start=S0, vocab_size=V)).cpu().numpy()
        flat = generate(apply_fn, torch.cat([prompt, user], 1),
                        max_new_tokens=N, cache=make_cache(B, S0 + Ls + N),
                        vocab_size=V).cpu().numpy()
        out["prefix"].append(cont)
        out["prefix_agreement"].append(float((cont == flat).mean()))
    print(f"    2 turns off one cached prefix; token agreement vs flat "
          f"{[round(a, 2) for a in out['prefix_agreement']]}")
    print("serving walkthrough done")
    return {**out, "walls": walls, "ragged_verdict": ragged_verdict,
            "speculative_verdict": spec_verdict, "cfg": cfg,
            "greedy_tokens_per_s": B * N / walls["greedy generate"]}


if __name__ == "__main__":
    main()
