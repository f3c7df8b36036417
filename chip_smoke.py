#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`apex1_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile [NAME ...]
                                     # build, then profile decode steps
                                     # and training steps (GPT-2: flash
                                     # off, flash on, flash and fused
                                     # head; llama_block: fused_mlp off
                                     # and on; bert; bert_large; t5;
                                     # resnet) and
                                     # the decode slice's token steps
                                     # (decode-int8, serve-lora), or
                                     # only the NAMEs given (keys of the
                                     # profile: llama_block, bert, ...)
    python3 chip_smoke.py --compare TREE [PART ...]
                                     # build, then time the flash
                                     # kernels, the chunk product, the
                                     # linear-xent forward and backward,
                                     # int8_mm, glu_fwd, the norm
                                     # forward, the softmax forward, the
                                     # norm backward, flash dbias,
                                     # paged attention, the sampler, the
                                     # LoRA delta and the cross-entropy
                                     # forward and backward against
                                     # those of TREE (a checkout of another
                                     # commit) in turns on the same
                                     # inputs, or only the PARTs given
                                     # (flash, chunk, lxent, int8, glu,
                                     # norm, softmax, normbwd, dbias,
                                     # paged, sample, lora, xent)
    python3 chip_smoke.py --only [generate-t5] [contrib] [serve-dense]
                         [serve-fleet] [disagg] [speculative]
                         [train-resume] [train-sentinel] [train-fsdp]
                         [train-zero] [train-bert-lamb]
                         [spatial-bottleneck] [llama-3d-resume]
                         [examples] [examples-parallel]
                         [examples-encdec] [serve-example] [planner]
                         [elastic-drill] [tune] [obs]
                                     # build, then run only those
                                     # phases (all of them by default;
                                     # train-fsdp, train-zero,
                                     # train-bert-lamb,
                                     # spatial-bottleneck,
                                     # llama-3d-resume and
                                     # examples-parallel each in a
                                     # one-rank NCCL group); no kernels
                                     # line
    python3 chip_smoke.py --save-inflight
                                     # build, then time GPT-2 124M's
                                     # training steps with an async
                                     # checkpoint save in flight, for
                                     # several variants of the save's
                                     # worker, and profile one
    python3 chip_smoke.py --gate-sweep [kernels] [plain]
                                     # build, then train bert_large at
                                     # O2 for GATE_STEPS steps at each
                                     # seed of GATE_SEEDS on each path
                                     # (both by default) and print the
                                     # loss-fell gate's smallest safe
                                     # step count N

Phases, each printed on its own line; a failure in any exits non-zero:

1. build — compile the port's CUDA kernels from ``apex1_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the build seconds.
2. kernels — hold each kernel against its plain PyTorch version on the
   card at the shapes its main path gives it (serving's and the
   training step's), with the stated tolerance; print errors, kernel /
   plain / library-yardstick times and the bound. The norm backward
   runs at GPT-2's, the Llama step's, T5's, BERT-base's and BERT-large's
   rows and at H 8192 (LN and RMS), and it and the softmax forward must
   give the same bits twice. The flash kernels
   (forward, dq, dk/dv) run at GPT-2's training shape and at GQA,
   packed-segment, odd, offset, lse-cotangent, fp16 and f32 cases;
   dq and dk/dv must give the same bits twice. The linear-xent kernels
   (forward in its three modes, dx, dW) run at the GPT-2 head's shape
   (16368 x 768 against 50304 x 768, 50257 classes) in bf16 and fp16,
   a small f32 case, smoothing 0.1 with a padding_idx, a col_offset
   shard with labels outside it, and the DPO path's ragged last vocab
   chunk (1152 rows); the forward (bf16/fp16: one wgmma product with
   the statistics in its epilogue, then a fold), dx and dW (bf16/fp16:
   three wgmma products a vocab chunk) must give the same bits twice,
   dx and dW equal to ``lxent_grads``'s (one G a chunk for both), and
   the packed statistics (mode 2) equal the four (mode 1) bit for bit.
   The half-precision backward cases also print how far two plain
   versions that differ only in the logits' summation precision lie
   apart. The
   Llama slice's shapes: the RMS norm forward and backward at (8192,
   4096); flash at GQA 32/8, head_dim 128, S = 4096, causal and packed;
   paged attention at 32/8 heads, head_dim 128 (decode steps, chunks of
   64 and the engine's own prefill chunk of 16, each also for the same
   bits twice); the linear-xent kernels
   at the Llama head (8190 x 4096 against 32000 x 4096) in bf16 and
   fp16, a smoothed shard and a ragged f32 case (fp32's wide path, H >
   768), dx and dW also together (one G a vocab chunk for both) with
   the same bits;
   RoPE (kernel 12) at q (2, 4096, 32, 128) forward and backward, k,
   per-row tables, interleaved, fp16, f32, head_dim 256 and a decode
   step, equal bits required; the fused SwiGLU (kernel 13) at (8192,
   4096) x (4096, 14336) bf16, fp16, GeGLU, a serving chunk, f32 and a
   ragged case. The BERT slice's: the bias-dropout-add kernels (rows 14
   and 15) at BERT-base's, BERT-large's and GPT-2's residual epilogues
   and f32/fp16 cases with a bias, h = 1000 (scalar loads), ragged rows
   and an fp32 residual, y and dx equal to the plain version bit for
   bit, dbias at f32 tolerance with the same bits twice, and a mask
   witness (x = 1, residual 0: y's zero pattern is the mask, equal to
   the plain version's, keep rate within 3 sigma of 1 - p); flash with
   dropout 0.1 at BERT's shape (8 x 12 heads x 512, D 64, non-causal,
   padding segments; beside p = 0), GPT-2 causal, GQA 12/4 and offsets,
   with a witness (v the identity: out's zero pattern is the mask); the
   library call for flash is also timed at the Llama shape (GQA through
   ``enable_gqa``) and at BERT's (the padding as a boolean mask, with
   its own dropout); the fused MLM heads (H + 1 = 769 and 1025 on the
   plain-load branch, and zero-padded to 776 and 1032 as the models run
   them; labels -1 outside the masked tokens) and the NSP cross-entropy
   (K = 2); the ResNet head, (64, 1000) fp32 logits, K = 1000 unpadded
   (the JAX package pads it to 1024 lanes), with the same bits twice. The
   T5 slice's: flash with an additive bias at T5's shape (8 x 16 heads
   x 512, D 64, bf16; the (1, 16, 512, 512) fp32 relative-position
   bias), non-causal as in the encoder and causal as in the decoder,
   with padding segments and with dropout 0.1; a (B, 1, Sq, Sk)
   key-padding mask of -10000 and NEG_INF; a (B, Hq) bias with GQA and
   ragged shapes in fp16 and a shared (1, 1) bias in f32 with offsets;
   each also checks kernel 6 (dbias, fp32, at f32 tolerance, the same
   bits on a second launch); the library's SDPA with the bias as a
   float ``attn_mask`` is timed beside it, its backward also with the
   mask taking a gradient (dbias's yardstick). The sampler (kernel 22)
   at a GPT-2 decode step (8 rows of 50304), the engine's prefill row
   and `serve-lora`'s verify step (40 rows of 32000), greedy and at T
   0.7: the ids exactly, the same ids twice, the vocab splits launched,
   ``torch.argmax`` timed beside it at T 0. The decode slice's: the
   int8 matmul (kernel 20) at the decode model's projections for 8
   decode rows and 1024 prefill rows, the head and a ragged case, at the
   fp32 rounding bound with the same bits twice (cuBLAS in bf16 over a
   dequantized copy timed beside it); the LoRA delta (kernel 23) at 8
   decode rows, 8 x 5 verify rows and a prefill row (rank 16, vocab
   32000, three adapters and an adapterless row) and a ragged f32 case:
   the fp32 rounding bound, page-0 rows exactly 0.0, the same bits twice
   and every row equal to itself computed alone. The multi-GPU slice's:
   the chunk product of the fused collective matmuls (kernels 24-25, and
   27's product with its fp32 accumulator) at the SP boundary MLP's
   world-1 products (8192 x 2048 @ 2048 x 8192 and 8192 x 8192 @ 8192 x
   2048, bf16), a tp = 8 rank's chunks, an (S, mb, hid) operand, ragged,
   fp16 and f32 shapes: the fp32 rounding bound, the same bits twice,
   ``acc + kernel`` equal to the accumulator mode bit for bit (``torch.mm``
   in the operand type timed beside it); the flash forward's merge
   epilogue (kernel 26) at a cp = 8 rank's steps of `llama_longctx`
   (1 x 32/4 heads x 2048 of 64, off and on the diagonal, segments),
   the world-1 step (16384) and a ragged f32 case, with a carried (out,
   lse): the flash rounding bound, the same bits twice, the port's
   two-step form (flash_fwd, then the merge in PyTorch) timed beside it.
   The T5 generation and contrib slice's: flash at one query row
   against T5's 512 keys with key padding (a decode step's
   cross-attention, 8 x 16 heads), the RMS norm at a decode step's 8 x
   1024 rows, the norm at OpenFold's 32768 x 256 and 65536 x 128 rows,
   the softmax at OpenFold's (128, 8, 256, 256) scores with the folded
   pair-bias mask, and the cross-entropy on the bf16 GPT-2 head (every
   column a class, smoothing 0.1, padding_idx 0). Rows 18-19 also run
   that head in fp16 and the fp32 GPT-2 slice at the unpadded width
   50257 (rows off 16 bytes), and every cross-entropy case must give
   the same bits twice (`XENT_CASES`).
3. engine — serve GPT-2 124M at full width (12 layers, hidden 768,
   vocab 50257 padded to 50304) at policy O2, weights made from a seed,
   through the paged continuous-batching engine: 16 requests (prompts
   of 32-512 tokens, four sharing a prefix) over 8 slots, 64 new tokens
   each at temperature 0.7. Every request must end done with 64 tokens,
   and every serving kernel's launch count must equal the count the
   engine's forwards imply (the training kernels 0).
4. parity — the same workload at O0 (fp32), depth 2, once through the
   kernels and once through the plain versions on the card: the token
   streams must be identical.
5. train — GPT-2 124M at full width (``use_flash=False``: materialized
   scores through the fused causal softmax; ``fuse_head=False``: fp32
   logits through the fused cross-entropy) trained at B=16 x S=1024
   under ``Amp(fused_adam(1e-4, weight_decay=0.01))``, 6 steps at O2
   and 3 at O2_fp16 (dynamic loss scale from 2^16). Every loss must be
   finite, the O2 loss must fall from step 1 to step 6, and every step
   must launch LayerNorm fwd and bwd 25 times, softmax fwd and bwd 12,
   cross-entropy fwd and bwd once.
6. train-flash — the same with ``use_flash=True`` (causal flash
   attention): every step must launch LayerNorm fwd and bwd 25 times,
   flash fwd, dq and dk/dv 12, cross-entropy fwd and bwd once, softmax
   never.
7. train-packed — the flash model at O2 for 3 steps on 16 rows packed
   by ``pack_documents`` (documents of 64-2048 tokens, positions
   restarting per chunk): finite losses, the same launches.
   train-fused-head and train-fused-packed — the flash model with
   ``fuse_head=True`` (the JAX default: the head product fused into
   the cross-entropy, no logits), 6 steps at O2 and 6 at O2_fp16, and
   3 O2 steps on the packed batch: every step must launch LayerNorm fwd
   and bwd 25 times, flash 12/12/12, the linear-xent forward, dx and dW
   once, the materialized cross-entropy and softmax never; its step
   wall, tokens/s and peak memory are printed next to the
   ``fuse_head=False`` flash step's.
8. train-parity — depth 2, full width, 3 steps through the kernels and
   through the plain versions, for ``use_flash=False``, ``True`` and
   ``True`` with ``fuse_head=True`` (the materialized-head flash path
   on a dense and a packed batch, the fused head on the dense one): O0
   losses within 1e-5 relative and grad norms within 1e-4; O2_fp16
   with the loss multiplied by inf at step 2 on both sides (at the step
   after the first finite one, where the dynamic scale first overflows
   by itself while it calibrates down from 2^16): that step skipped,
   the params it leaves equal to the step before's bit for bit, the
   scale halved, skipped_steps up by one, the next step finite (GPT-2
   and Llama: steps 1-3 finite, skipped, finite; skipped_steps 1). The
   step-1 O0 loss of the fused head
   must equal the materialized head's on the same weights within 1e-5.
9. dpo — GPT-2 124M at O2 through ``Amp(fused_adam(DPO_LR))`` with
   ``chunked_dpo_loss`` over 8 chosen and 8 rejected rows of 1024
   tokens: the reference logps (``chunked_logprob`` under no_grad
   through the initial compute-dtype params) make step 1's margin 0,
   so its loss must be ln 2 within 1e-4, and every later loss must lie
   in (0, ln 2) (each step prints its loss and β·margin); 3 steps, each
   launching the linear-xent forward, dx and dW 7 times (vocab chunks)
   per sequence batch.
10. generate — GPT-2 124M at O2 through ``generate`` on a dense cache of
   1024 slots: 8 ragged prompts of 32-512 tokens (``prompt_lens``),
   64 new tokens, greedy and at temperature 0.7 from ``key(0)``; the
   flash prefill must launch flash fwd 12 times a call.
11. generate-parity — the same at O0, depth 2, through the kernels and
   the plain versions: equal token streams, or a first differing token
   whose top-2 score gap is below 1e-4 relative (a near-tie).
12. train-llama — the JAX bench's ``llama_block`` (Llama-3 8B widths:
   hidden 4096, ffn 14336, 32 query and 8 KV heads of 128, rope base
   500000; 3 layers, vocab 32000; weights drawn on the card from a
   seed) with remat (``nothing_saveable``) and the fused head, trained
   at B=2 x S=4096 under ``Amp(fused_adam(1e-4, weight_decay=0.01))``:
   6 O2 and 3 O2_fp16 steps, 3 O2 steps with ``fused_mlp=True``, and 3
   O2 steps on a packed batch (per-document positions). Losses finite,
   the O2 loss falling over 6 steps, and every step launching exactly
   `llama_launches` (remat's recompute counted: RMS norm fwd 13 and bwd
   7, rope 18, flash 6/3/3, the linear-xent 1/1/1, glu 6 or 0, the
   materialized cross-entropy and softmax never).
13. train-llama-parity — depth 2, full width, B=2 x S=1024, lr 1e-5,
   kernels against plain versions as in train-parity, for (fused_mlp,
   fuse_head) = (False, True), (True, True), (False, False); the fused
   head's step-1 O0 loss equals the materialized head's within 1e-5.
14. serve-llama — the 3-layer model at O2 with ``fused_mlp=True``
   through the paged engine (the engine phase's workload at vocab
   32000): all 16 requests done with 64 tokens inside the vocabulary,
   exact launches of the RMS norm, rope, paged attention, glu and
   sampling kernels; one greedy ``generate`` through ``llama_decoder``
   (8 ragged prompts, 32 new tokens; flash fwd launched once a layer
   in the prefill); serve-llama-parity: the engine at O0, depth 2,
   kernels against plain versions, identical token streams.
15. train-bert — the JAX bench's BERT pretraining configurations
   (``bench.py:220-258``) at full width and depth under
   ``Amp(fused_adam(1e-4, weight_decay=0.01))`` at O2 with the fused
   MLM head, on the bench's batch (``np.random.default_rng(0)`` tokens,
   MLM labels -1 outside a 15 % draw, NSP labels): ``bert_dropout``
   (BERT-base, 8 x 512, dropout 0.1 from an int base seed), ``bert``,
   ``bert_large`` (24 layers, 1024 wide, 4 x 512) and ``bert_dropout``
   on a padded batch (``attention_mask``), 6 steps each, 8 for
   ``bert_large`` (the first Adam steps at lr 1e-4 can raise the loss
   before it falls; ``--gate-sweep`` finds 8 the smallest count from
   which bert_large's gate holds at eight seeds on both paths). Each
   prints tokens/s beside the bench's A100 proxy, device ms a step (3
   more steps under torch.profiler) and peak memory; losses finite, the
   loss falling, and every step launching exactly `bert_launches` (LN
   fwd and bwd 2L + 2, flash L/L/L, linear-xent 1/1/1, xent 1/1 for
   NSP, bias-dropout-add 2L/2L with dropout, softmax never).
   train-bert-parity — BERT-base width, depth 2, 8 x 512, dropout 0.1,
   kernels against plain versions as in train-parity (lr 1e-5), with
   the fused and the materialized MLM head, whose step-1 O0 losses
   agree within 1e-5.
16. train-gpt2-dropout — GPT-2 124M, flash, fused head, dropout 0.1,
   B=16 x S=1024, 3 O2 steps: LN 25/25, flash 12/12/12, bias-dropout-
   add 24/24, linear-xent 1/1/1 a step.
17. train-t5 — the JAX bench's ``t5`` (``bench.py:372-400``: T5-large
   widths, d_model 1024, 16 heads of 64, d_ff 4096, vocab 32128, 32
   buckets; 12 encoder and 12 decoder layers, remat; weights drawn on
   the card from a seed) with the fused tied head under
   ``Amp(fused_adam(1e-4, weight_decay=0.01))`` at O2 on the bench's
   batch (8 x 512 encoder and decoder tokens of
   ``np.random.default_rng(0)``), 6 steps: finite losses and every step
   launching exactly `t5_launches` (RMS norm fwd 122 and bwd 62, flash
   72/36/36 with remat's recompute, dbias 24: the 12 + 12
   self-attentions, linear-xent 1/1/1); tokens/s = 8 x 1024 over the
   step wall beside the bench's A100 proxy 48,000, device ms a step and
   the busy share (3 profiled steps), the largest kernels, peak memory.
18. train-t5-parity — T5-large width, 2 + 2 layers, the bench's batch,
   lr 1e-5, kernels against plain versions as in train-parity, with the
   fused and the materialized head (step-1 O0 losses within 1e-5), and
   the two relative-position tables' O0 gradient norms within 1e-4
   (their difference printed beside the cells' sums of absolute terms,
   which cancel: each row of a layer's dbias sums to 0).
19. mha — ``SelfMultiheadAttn(1024, 16, dropout=0.1,
   include_norm_add=True)`` (fairseq transformer-big's width) and
   ``EncdecMultiheadAttn`` at the same width, S = 512, B = 8, bf16,
   with an additive key-padding mask, forward and backward against the
   plain versions; launches LN 1/1, flash 1/1/1, dbias 0, bias-dropout-
   add 1/1 each.
20. train-llama-longctx — the bench's ``llama_longctx`` (hidden 2048,
   GQA 32/4 of 64, ffn 5632, 16 layers, vocab 32000, remat, fused head)
   at B=1 x S=16384, 3 O2 steps: finite losses, exact launches,
   tokens/s beside the A100 proxy 11,100, peak memory.
21. decode — the bench's ``decode`` (that model without remat) through
   ``generate`` with ``llama_decoder``: 8 prompts of 128 tokens, 128 new
   tokens greedy; tokens/s beside the A100 proxy 6,100, peak memory, 16
   flash prefill launches a call.
22. decode-int8 — the bench's ``decode_int8`` (`bench.py:403-463`,
   ``quant=True``): decode's model and workload through
   ``llama_quant_decoder`` (every projection and the head int8 with
   per-channel scales) and ``generate``; tokens/s beside the A100 proxy
   12,200, peak memory, the int8 weight bytes; every forward launches
   int8_mm 7 times a layer and once for the head, each call's prefill
   flash 16 times.
23. serve-lora — decode's model (16 layers, O2) through the paged
   engine with ``lora_rank=16``: three tenants registered (A and B drawn
   on the card), the engine phase's 16 requests sent to tenants 0, 1, 2
   and none in turn; lora_delta launched once a decode step and prefill
   chunk; every tenant's stream differs from the same request on a
   ``lora_rank=0`` engine, every adapterless one equals it, and three
   requests re-run alone give their streams bit for bit; then the same
   load with ``num_draft=4`` (speculative verify: accept rate, tokens/s).
24. decode-int8-parity — depth 2, weights exactly representable in
   int8 and bf16 (q · 2^-9): the int8 decode equals the bf16
   ``llama_decoder`` stream, and its kernels equal its plain versions
   on the card, or differ first at a near-tie (top-2 gap < 1e-4).
25. serve-lora-parity — depth 2, O0: the LoRA engine's kernels against
   its plain versions on the card, ``num_draft=2`` against 0 with and
   without LoRA: equal streams, or a first difference at a near-tie of
   the reference's sampling scores.
26. train-resnet — the JAX bench's ``resnet`` (``bench.py:261-300``):
   ResNet-50 (stages 3/4/6/3, width 64, 1000 classes; weights drawn on
   the card from a seed) on 64 images of 224 x 224 x 3 and their labels
   (``np.random.default_rng(1234)``) under ``Amp(fused_sgd(0.1,
   momentum=0.9, weight_decay=1e-4))`` at O2 with ``has_aux=True``,
   the running statistics carried from step to step as the aux, 6
   steps: finite losses, exactly one cross-entropy forward and backward
   launch a step and nothing else (the convolutions are cuDNN's, the
   batch norm plain PyTorch, as the JAX package leaves both to XLA);
   images/s from the median wall of steps 2-6 beside the bench's A100
   proxy 2,900, device ms a step and the busy share over 3 profiled
   steps with the largest kernels, and peak memory.
27. train-gpt2-fp16 — the bench's ``gpt2_fp16`` (``bench.py:188-216``):
   GPT-2 124M at B=16 x S=1024 under O1_fp16 (fp16 compute, fp32
   fragile ops, a dynamic loss scale from 2^16) with the default
   ``use_flash=True`` and ``fuse_head=True``, fused Adam, 10 steps:
   the losses from the first finite step on finite, fewer than half the
   steps skipped, exact launches (LN 25/25, flash 12/12/12,
   linear-xent 1/1/1); tokens/s, skipped steps and the loss scale; then
   one step with the loss multiplied by inf, which must be skipped,
   leave the params and both Adam moments bit for bit and halve the
   scale.
28. resnet-parity — a reduced ResNet (stages 1/1/1/1, width 64, 64
   images of 64 x 64) at O0, 2 steps through the kernels and through
   the plain versions on the card: the loss within 1e-5 relative, the
   grad norm within 1e-4 and the running statistics within 1e-5 of
   their tensors' largest values (cuDNN's backward may not repeat its
   bits, so only the cross-entropy kernel is held to the same bits
   twice, in the kernels phase).
29. the multi-GPU slice, on a one-rank NCCL process group (a file
   rendezvous, `apex1_tpu_torch.parallel.init_distributed`): tp-sp —
   the SP boundary MLP (x (8192, 2048) bf16, ffn 8192;
   `tools/bench_fused_comm.py`'s A/B shapes) through
   ``column_parallel_linear`` and ``row_parallel_linear`` with
   sequence parallelism, monolithic, ``overlap=True``, ``fused=True``
   and the serialized gather: host walls, the fused step's 4
   chunk_matmul launches, every form's collectives, and each fused op
   against its decomposed form (output and dx within the fp32 rounding
   bound, dW bit for bit); cp — causal attention at `llama_longctx`'s
   shape (1 x 32/4 x 16384 x 64) through ``ring_attention`` and
   ``all_gather_flash_attention``, forward and backward: walls, exact
   launches (the merge flash once a forward), the two forms within
   flash's bf16 tolerance; vp-ce — ``vocab_parallel_linear_cross_
   entropy`` at `llama_longctx`'s head (16384 x 2048 against 32000),
   fused against decomposed bit for bit, 2 against 4 forward
   all-reduces; ddp — GPT-2 124M (flash, fused head) at O2, 3 steps
   with ``Amp(grad_psum_axes=("dp",))`` against the same steps without,
   losses and params bit for bit; rdma — ``matmul_reduce_scatter_rdma``
   raises its ring-size error at world 1.
30. train-llama-3d — in the same one-rank group, the bench's
   ``llama_3d`` (``bench.py:466-547``) at its one-card layout (dp = pp
   = cp = ep = tp = 1, the scan schedule, 4 microbatches of 1 x 2048,
   ``num_chunks`` 1): `models.llama_3d` at the llama_longctx widths
   (hidden 2048, GQA 32/4 of 64, ffn 5632), 8 layers, remat, O2, fused
   Adam at lr 1e-4, weights and tokens from seed 1234 (labels the
   tokens rolled by one), 6 steps: finite losses, exact launches a step
   (`llama_3d_launches`: RMS norm 129/65, rope 192, flash 64/32/32,
   the vocab-parallel head's shard_stats, dx and dW once), tokens/s
   beside the bench's A100 proxy 11,100, device ms a step and busy
   share over 3 profiled steps, peak memory.
31. train-llama-3d-1f1b — the same model, params and batch on
   ``schedule="1f1b"``: step 1's loss and grad norm against the scan's
   (1e-2 and 2e-2 relative), 3 steps with exact launches (the head
   once a microbatch), wall and peak memory beside the scan's.
32. llama-3d-parity — depth 2, O0 fp32: kernels against plain (loss
   1e-5, the grad norm and every leaf's 1e-4 relative); the llama_3d
   step against the flat `models.llama.Llama` on the same params;
   ``num_chunks=2`` against 1; ``moe=True`` (8 experts, top-2) kernels
   against plain with every router call's dispatch equal bit for bit;
   O2_fp16 with a forced overflow (the embedding master times 1e8):
   skipped, params and both Adam moments bit for bit, the scale halved.
33. generate-t5 — the bench's ``t5`` (12 + 12 layers at T5-large
   widths, O2, weights from the seed) through ``t5_generate`` for the
   bench's 8 x 512 encoder tokens (rows 0-1 key-padded over their last
   100 positions), 32 new tokens: greedy (after a warm-up call), 4
   beams at length penalty 0.6, and sampling at T 0.7, top-k 50 twice
   from one key; each call launching exactly the RMS norm 25 + 32 x 37
   and flash 12 + 32 x 12 times (the decoder's self-attention is the
   ``cache_attend`` composite, its cross-attention flash at one query
   row). Greedy against the plain versions and the port's uncached
   decoder loop: equal, or apart first where the reference's top-2 gap
   is below the two runs' logit difference there, itself at most twice
   the O2 path's own rounding (its plain first-step logits against the
   O0 plain path's); the same model at O0 through the kernels and the
   plain versions (a flip only at a gap below 1e-4); ``beam_search`` at
   1 beam equal to greedy; the two sampled streams equal. Prints
   tokens/s and the wall of each call, the encode's wall, and the device
   ms of a decoder step (a profiled call less a profiled encode).
34. contrib — OpenFold's ``attention_core`` at AlphaFold2's MSA row
   attention with pair bias ((1, 128, 8, 256, 32) bf16, the folded
   (1, 128, 1, 1, 256) + (1, 1, 8, 256, 256) mask; forward and
   backward), its ``layer_norm`` at c_m 256 and c_z 128, and
   ``SoftmaxCrossEntropyLoss.apply`` at the bf16 GPT-2 head (smoothing
   0.1, padding_idx 0, half_to_float), each through the kernels against
   the plain versions with exact launches; then every kernel-free
   module (focal loss, group norm, index_mul_2d, the transducer, ASP,
   the RNNs, weight norm, the fused dense modules) once on the card
   against the same call on the CPU.
35. serve-dense — the engine phase's GPT-2 124M (O2, 12 layers, seed
   1234) and 16 requests through ``EngineConfig(paged=False)``, the
   dense pool (each row at its own device index, the ``cache_attend``
   composite, ``fused_sample``): its streams against the paged
   engine's, recorded again as the reference, a flip only where the
   reference's top-2 score gap is below twice the two runs' logit
   difference there (over T), itself at most 2^-6 of the top logit;
   exact launches (the norm 25 and the sampler once a forward, paged
   attention never); prefix hits counted; ``prefix_cache=False`` gives
   the same streams.
36. serve-fleet — ``ServingFrontend`` over 2 ``ReplicaSupervisor`` objects,
   each an engine (paged, 256 positions) of that GPT-2, pump mode, 32
   requests (prompts of 16-200 tokens, 32 new, guaranteed and
   sheddable): one cancelled mid-stream, one whose deadline passes
   mid-stream (the engines' clock moved past it), one hedged, one
   infeasible deadline rejected at the door, replica 0 killed at its
   step 10 and restarted; then the plain requests with
   ``max_restarts=0`` (failover) and in threaded mode. Every completed
   stream equals an undisturbed single engine's bit for bit; statuses
   and reasons as set; free pages back; one kernel-library load; exact
   launches in the pump runs. Prints tokens/s, TTFT p50, restarts,
   hedges and the mode transitions.
37. disagg — ``DisaggFrontend`` with a prefill and a decode engine
   (paged) of that GPT-2, the engine phase's 16 requests: 16
   digest-verified handoffs, streams against the colocated engine's
   (the near-tie rule of 35), exact launches; a ``HandoffCorruption``
   and a ``HandoffWindowKill`` typed, re-routed, no stream lost.
38. speculative — ``speculative_generate`` with the bench's ``decode``
   model (16 layers, O2) as the target and its ``llama_quant_decoder``
   int8 copy as the draft, 8 x 128 prompt tokens, 128 new, 4 drafts a
   round: greedy against greedy ``generate`` (a flip only where the
   target's top-2 gap is below the verify/step logit difference there,
   itself at most twice the largest the two paths show where the
   streams agree), exact launches (RMS norm, RoPE, flash at both
   prefills, int8_mm each draft forward); at T 0.7 tokens in the
   vocabulary, two calls the same bits. Prints target forwards per
   row, the accept rate, tokens/s beside plain ``generate``.
39. train-resume — the ddp phase's trainer (GPT-2 124M, flash, fused
   head, O2): run A 4 steps; run B step 1, an async
   ``ResilientCheckpointer.save``, step 2 with it in flight, a SIGTERM
   to itself inside a ``PreemptionHandler``: ``save_sync`` and the
   resumable exit (code 75, caught); run C from another seed restores
   step 2 and takes steps 3-4: losses, final params and launches equal
   A's bit for bit. Then the newest checkpoint bit-flipped and the next
   truncated: ``find_restorable`` falls back to the oldest, restoring a
   damaged one raises ``IntegrityError``. Prints the bytes, the save's
   host copy, write and digest seconds, the restore's, and step 2's wall
   with the save in flight beside run A's.
40. train-sentinel — the same trainer under ``Sentinel.guard``, NaN
   losses with finite gradients at steps 3 and 4
   (``chaos.poison_at_steps`` added to the loss): step 3 skipped by the
   sentinel alone (params, moments and loss-scale state kept bit for
   bit where the bare step moves them; the counters), ``poll`` says rollback after
   step 4, the rollback restores step 2 with a banked record; two steps
   on ``refold_seed`` batches equal a control restored from the same
   checkpoint. The guarded step makes no more synchronizing calls than
   the bare one (``set_sync_debug_mode("warn")``, both printed).
41. llama-3d-resume — the bench's llama_3d at its one-card layout:
   step 1, ``gather_state`` saved with its plan; two plain step-2s
   agree bit for bit, and so does the restore's step 2; the checkpoint
   resharded onto ``num_chunks=2`` and restored there: the step-2 loss
   within 2e-5 relative. Prints the walls and bytes.
42. examples — the host runtime and the port's examples, each
   example's ``main(argv)`` called in-process. The runtime: the native
   library must have built; ``TokenDataset.batch_at`` native against
   NumPy bit for bit across an epoch boundary; ``normalize_images``
   native against NumPy within 1e-6; 50 ``PrefetchLoader`` batches
   (``prefetch=2``) equal to ``torch.from_numpy(b).cuda()`` (made
   before the loop) bit for bit, compared as soon as each is yielded
   (the ``wait_event`` witness) and again after the consumer's stream
   sleeps, the batch freed and a kernel writing a fresh tensor there
   (the pinned buffer and ``record_stream`` witness); host timings of ``batch_at`` (16 x
   1025 tokens), ``normalize_images`` (64 x 224 x 224 x 3) and
   ``flatten`` (GB/s), native and NumPy. ``gpt2_amp``: GPT-2 124M, O2,
   16 x 1024, 12 steps through the prefetcher, then the same loop
   copying inline: finite losses, launches exactly 12 times
   ``train_launches``'s flash and fused-head step, median step wall and
   tokens/s of each, ``flops_per_step`` (the plain path on meta
   tensors, without the backward's recomputation) within 5 % of the
   model count 6 x weights + 12 x L x S x H a token. Its resilient loop: SIGTERM at
   step 6 (``APEX1_CHAOS_SIGTERM_STEP``) exits 75, ``--resume auto``
   takes steps 6-11 with the uninterrupted run's losses bit for bit;
   the ``--obs-dir`` spine holds the run header, the metrics lines and
   the checkpoint events. ``imagenet_amp``: ResNet-50, O2, 64 x 224^2,
   12 steps: finite losses, the cross-entropy forward and backward once
   a step, images/s with and without the prefetcher, the busy share of
   3 profiled steps. ``distributed_data_parallel``: 10 steps in a
   one-rank NCCL group.
43. examples-parallel — in a one-rank NCCL group: ``llama_distributed``
   (10 O2 steps, params placed by their TP specs), ``gpt2_pp_tied`` at
   GPT-2 124M widths (12 layers, hidden 768, vocab 50304, 4
   microbatches of 2 x 1024, fp32, 20 steps: step wall, tokens/s, peak
   memory), ``llama_3d`` on its one-card layout (scan with 2 chunks,
   1F1B), its SIGTERM drill resumed bit for bit, ``--tp 3`` exiting 2
   naming tp-heads; every run's launches exact.
44. examples-encdec — ``t5_seq2seq`` (1500 steps), ``rnnt_speech`` (800)
   and ``dcgan_amp`` (20) at the JAX scripts' defaults, O2: the sort
   accuracy at least half the JAX script's CPU run's (0.625), the RNN-T
   exact decodes at most one under its 4 of 4, finite losses, both
   DCGAN loss scales printed, launches exact.
45. serve-example — ``serving_llama`` at its 1B config (B 2, prompt 8,
   16 new, 4 beams): each section's wall, greedy tokens/s, the ragged
   rows against each row alone and speculative against greedy by the
   near-tie rule (``models.near_tie``), the int8 and prefix
   agreements, launches exact.
46. the ``kernels`` JSON line (each kernel's launches over the main
   paths: the engine, the train phases, dpo, generate, train-llama,
   serve-llama and its generate, the BERT phases, train-gpt2-dropout,
   train-t5, mha, train-llama-longctx, decode, decode-int8,
   serve-lora, train-resnet, train-gpt2-fp16, tp-sp, cp, vp-ce, ddp,
   train-llama-3d, train-llama-3d-1f1b, generate-t5's kernel calls,
   contrib's kernel cases, serve-dense, serve-fleet, disagg,
   speculative, train-resume's run A, llama-3d-resume's two resumed
   steps, the examples' gpt2_amp and imagenet_amp runs through the
   prefetcher and the three phases above), the card's name and power
   limit, and the last line
   ``{"ok": true, "device": {...}}``.

Kernel times are device times of CUDA-graph replays (no host launch
overhead), or between CUDA events for kernels of a millisecond or more;
step and request times are host wall times ending in a synchronize.
It imports nothing of JAX. Without a CUDA device, or run from a
directory that holds no ``apex1_tpu_torch``, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense rates):
#: the port's h100 capability row (`apex1_tpu_torch/core/capability.py`),
#: read where the package sits beside this script (main refuses to run
#: where it does not)
if os.path.isdir(os.path.join(HERE, "apex1_tpu_torch")):
    sys.path.insert(0, HERE)
    from apex1_tpu_torch.core.capability import get_capability as _row
    HBM_BYTES_PER_S = _row("h100").hbm_gbps * 1e9          # HBM3
    F32_OPS_PER_S = _row("h100").fp32_tflops * 1e12        # CUDA cores
    BF16_OPS_PER_S = _row("h100").bf16_tflops * 1e12       # tensor cores
SEED = 1234
#: GPT-2 124M training shapes: B x S tokens, hidden, heads, vocab and
#: padded vocab
TB, TS, TH, THEADS, TV, TV_PAD = 16, 1024, 768, 12, 50257, 50304
#: the Llama slice: the JAX bench's ``llama_block`` (Llama-3 8B widths,
#: 3 layers, the bench's vocab 32000) at B x S tokens: hidden, ffn,
#: query and KV heads, head_dim, vocab, layers
LB, LS = 2, 4096
LH, LFFN, LHEADS, LKV, LD, LV, LLAYERS = 4096, 14336, 32, 8, 128, 32000, 3
#: the T5 slice: the JAX bench's ``t5`` (T5-large widths, 12 encoder and
#: 12 decoder layers) at B x (S_enc + S_dec) tokens: batch, sequence,
#: d_model, heads, head_dim, d_ff, vocab, layers a stack
T5B, T5S = 8, 512
T5E, T5HEADS, T5D, T5FF, T5V, T5LAYERS = 1024, 16, 64, 4096, 32128, 12
#: the contrib phase's OpenFold shapes (AlphaFold2's Evoformer MSA row
#: attention with pair bias at a crop of 256 residues): clusters, crop,
#: heads, head_dim, the MSA and pair channels
OF_N, OF_S, OF_H, OF_D, OF_CM, OF_CZ = 128, 256, 8, 32, 256, 128


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unknown (nvidia-smi failed)"


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times; the median replay over
    ``iters``."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del g
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """The least time for the work: bytes over the memory rate or
    operations over ``ops_per_s`` (the peak for their operand type),
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: (rtol, atol) per output dtype: element i passes when
#: |got - want| <= rtol * |want_i| + atol * rms(want). rtol 2^-7 is one
#: bf16 ulp; rms(want) is the output's typical magnitude, so atol reads
#: as a share of a typical value, not of the largest one.
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 3e-2),
        "float16": (2.0 ** -10, 1e-2)}


#: unit roundoff of the half operand types (half an ulp, relative), and
#: half their smallest subnormal step (the absolute rounding error
#: where a value lies below the normal range: fp16 below 6.1e-5)
UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
ETA = {"bfloat16": 2.0 ** -134, "float16": 2.0 ** -25}


def rounding_errs(got, want, absprod, u: float, sides: int, eta=0.0,
                  abs_sum=0.0):
    """The error bound of a sum of products whose operands are rounded
    to the operand type: the flash forward rounds its probabilities P
    (kernel only: ``sides`` 1), the linear-xent backward its G (kernel
    and plain version, each from its own fp32 logits: ``sides`` 2).
    Rounding moves each term by at most u of its size, so the outputs
    before their own rounding lie within ``sides``·u·Σ|a||b| of each
    other, where ``absprod`` is that sum of absolute products (the plain
    function on |operands|); the two roundings of the output add at
    most 2u·|want|, the normalization one u·|want| more, fp32 sums in
    another order 1e-5·Σ|a||b|. A rounded operand below the normal
    range is off by up to ``eta`` absolute, not u relative: that adds
    ``sides``·eta·Σ|b| (``abs_sum``, the other operand's absolute sum)
    and 3·eta for the output. Returns (max |got - want|, the worst
    element's error over that bound): within it when the second is at
    most 1. A flat rtol/atol rule cannot hold here: where terms cancel,
    |want| is far below Σ|a||b| (an early causal row's few large
    values; a vocab row's target term against the rest)."""
    got, want, absprod = got.double(), want.double(), absprod.double()
    diff = (got - want).abs()
    allow = (u * (sides * absprod + 3 * want.abs()) + 1e-5 * absprod
             + eta * (sides * abs_sum + 3) + 1e-30)
    return diff.max().item(), (diff / allow).max().item()


def max_errs(got, want, rtol: float, atol: float, eta: float = 0.0):
    """(max |got - want|, the worst element's error over its allowance
    rtol·|want| + atol·rms(want) + ``eta``): within tolerance when the
    second is at most 1."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    allow = rtol * want.abs() + atol * want.pow(2).mean().sqrt() + eta
    return diff.max().item(), (diff / allow).max().item()


def max_errs_all(pairs, tol, eta: float = 0.0):
    """`max_errs` over several (got, want) outputs: the largest of each."""
    errs = [max_errs(g, w, *tol, eta) for g, w in pairs]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def event_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn`` between two CUDA events around
    ``iters`` calls, after two warm-up calls: for kernels of a
    millisecond or more, whose launches the host keeps ahead of."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---- phase 2: kernels against their plain versions ----------------------


#: the norm forward's checks: (rows, H, dtype, half γ/β, RMS). Serving
#: (fp32 γ/β) at decode and prefill rows; training's B*S rows with half
#: γ/β, the amp compute params; the Llama step's RMS rows (B*S x 4096,
#: fp32 γ); a T5 decode step's RMS rows (8 x 1024); OpenFold's layer
#: norms (fp32 γ/β) over its MSA (128 x 256 rows of c_m 256) and pair
#: (256 x 256 rows of c_z 128) activations
NORM_CASES = [(8, TH, "float32", False, False),
              (8, TH, "bfloat16", False, False),
              (16 * 64, TH, "float32", False, False),
              (16 * 64, TH, "bfloat16", False, False),
              (TB * TS, TH, "bfloat16", True, False),
              (TB * TS, TH, "float16", True, False),
              (LB * LS, LH, "bfloat16", False, True),
              # generate-t5: a decode step's rows (RMS, fp32 γ)
              (T5B, T5E, "bfloat16", False, True),
              # contrib: OpenFold's MSA rows (c_m) and pair rows (c_z)
              (OF_N * OF_S, OF_CM, "bfloat16", False, False),
              (OF_S * OF_S, OF_CZ, "bfloat16", False, False)]


def norm_inputs(torch, gen, rows, H, dt, half_g):
    """x, γ, β of a `NORM_CASES` case on the card (γ/β in x's dtype with
    ``half_g``, else fp32)."""
    x = (torch.randn(rows, H, generator=gen) * 2 + 0.5).cuda().to(dt)
    g = (1 + 0.1 * torch.randn(H, generator=gen)).cuda()
    b = (0.1 * torch.randn(H, generator=gen)).cuda()
    if half_g:
        g, b = g.to(dt), b.to(dt)
    return x, g, b


def check_layer_norm(torch, ops, gen):
    from apex1_tpu_torch.ops.layer_norm import layer_norm, rms_norm
    F = torch.nn.functional
    results = []
    for rows, H, dts, half_g, rms in NORM_CASES:
        dt = getattr(torch, dts)
        x, g, b = norm_inputs(torch, gen, rows, H, dt, half_g)
        gl, bl = g.to(dt), b.to(dt)
        if rms:
            def run():
                return rms_norm(x, g, eps=1e-5)

            def lib_call():
                return F.rms_norm(x, (H,), gl, 1e-5)
        else:
            def run():
                return layer_norm(x, g, b)

            def lib_call():
                return F.layer_norm(x, (H,), gl, bl, 1e-5)
        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS[str(dt)[6:]]
        abs_e, worst = max_errs(got, want, *tol)
        ms = graph_ms(run)
        with ops.force_impl("torch"):
            plain = graph_ms(run)
        lib = graph_ms(lib_call)
        eb = x.element_size()
        n_par = 1 if rms else 2
        bnd, by = bound_ms(2 * rows * H * eb + n_par * H * g.element_size()
                           + 2 * rows * 4, 8 * rows * H)
        results.append(dict(case=f"rows={rows} H={H} {str(dt)[6:]}"
                            + (" half γ/β" if half_g else "")
                            + (" RMS, fp32 γ" if rms else ""),
                            abs=abs_e, worst=worst, tol=tol, ms=ms,
                            plain_ms=plain, library_ms=lib,
                            bound_ms=bnd, bound_by=by,
                            main=(rows == 8 and dt == torch.bfloat16)))
    return results


#: paged attention's cases (TPU row 21): (case, N, Hq, Hkv, S, page
#: dtype, D, P, T). The engine phase's pages (P 64, T 17: 1087 / 64 slots a
#: row, 8 rows): GPT-2's heads (D 64) and the Llama serving path's GQA
#: 32/8 at D 128, decode steps (S 1) and prefill chunks of 64; and the
#: engine's own prefill chunk (`EngineConfig`'s default prefill_chunk 16,
#: hence pages of 16; one row, 1024 positions), GPT-2's and 32/8 heads
PAGED_CASES = [
    ("decode", 8, THEADS, THEADS, 1, "float32", 64, 64, 17),
    ("decode", 8, THEADS, THEADS, 1, "bfloat16", 64, 64, 17),
    ("decode", 8, THEADS, THEADS, 1, "int8", 64, 64, 17),
    ("chunk", 8, THEADS, THEADS, 64, "float32", 64, 64, 17),
    ("chunk", 8, THEADS, THEADS, 64, "bfloat16", 64, 64, 17),
    ("chunk", 8, THEADS, THEADS, 64, "int8", 64, 64, 17),
    ("decode, GQA 12/4", 8, THEADS, 4, 1, "bfloat16", 64, 64, 17),
    ("decode", 8, LHEADS, LKV, 1, "bfloat16", LD, 64, 17),
    ("chunk", 8, LHEADS, LKV, 64, "bfloat16", LD, 64, 17),
    ("engine prefill chunk", 1, THEADS, THEADS, 16, "bfloat16", 64, 16, 64),
    ("engine prefill chunk", 1, LHEADS, LKV, 16, "bfloat16", LD, 16, 64),
]


def paged_inputs(torch, gen, N, hq, hkv, S, pdt, D, P, T):
    """q, the K and V pools, the block table and the lengths of a
    `PAGED_CASES` case on the card: each row's T pages drawn from a pool
    of 1 + (N + 32)·T (page 0 the trash page), lengths 32 .. T·P - S - 2.
    int8 pages hold K at 30x scale and q comes at 1/30 in bf16: the
    scores keep unit spread, so the softmax folds over many positions
    across pages."""
    n_pages = 1 + (N + 32) * T
    perm = torch.randperm(n_pages - 1, generator=gen)[:N * T] + 1
    bt = perm.reshape(N, T).to(torch.int32).cuda()
    lens = torch.randint(32, T * P - S - 1, (N,), generator=gen)
    raw = torch.randn(2, n_pages, hkv, P, D, generator=gen)
    q = torch.randn(N, hq, S, D, generator=gen)
    if pdt == "int8":
        kv = (raw * 30).round().clamp(-127, 127).to(torch.int8).cuda()
        q, q_dt = q / 30, torch.bfloat16
    else:
        kv = raw.to(getattr(torch, pdt)).cuda()
        q_dt = getattr(torch, pdt)
    return (q.to(q_dt).cuda(), kv[0].contiguous(), kv[1].contiguous(), bt,
            lens.to(torch.int32).cuda())


def paged_bound(torch, q, k, bt, L):
    """The least time for a paged attention call: bytes, q and out once,
    K and V up to each row's horizon (len + S positions), the block
    table and lengths; ops, QK and PV, 2 flops each per (query row,
    visible position, d), where chunk query j sees len + j + 1
    positions. The products are bf16 x bf16 (int8 pages convert to bf16
    exactly) on the tensor cores, or fp32 x fp32 off them (TF32 is off).
    Returns (ms, "bytes" or "operations")."""
    N, hq, S, D = q.shape
    hkv = k.shape[1]
    lens = L.cpu().long()
    seen = (lens + S).sum().item()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * seen * hkv * D * k.element_size() + bt.numel() * 4
              + N * 4)
    visible = (S * lens + S * (S + 1) // 2).sum().item()
    return bound_ms(nbytes, 4 * hq * visible * D,
                    F32_OPS_PER_S if q.dtype == torch.float32
                    else BF16_OPS_PER_S)


def check_paged_attend(torch, ops, gen):
    """Kernel 21 against its plain version at every `PAGED_CASES` case,
    within the output dtype's tolerance, and the same bits on a second
    launch (the page split's runs are merged in a fixed order)."""
    from apex1_tpu_torch.ops.paged_decode import paged_attend, paged_geometry
    results = []
    for case, N, hq, hkv, S, pdt, D, P, T in PAGED_CASES:
        q, k, v, bt, L = paged_inputs(torch, gen, N, hq, hkv, S, pdt, D, P,
                                      T)

        def run():
            return paged_attend(q, k, v, bt, L, total_len=T * P)

        got = run()
        same = torch.equal(run(), got)
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS[str(q.dtype)[6:]]
        abs_e, worst = max_errs(got, want, *tol)
        ms = graph_ms(run, iters=20)
        with ops.force_impl("torch"):
            plain = graph_ms(run, iters=5)
        bnd, by = paged_bound(torch, q, k, bt, L)
        splits = paged_geometry(N, hq, hkv, S, D, P, T)[0]
        results.append(dict(
            case=f"{case} N={N} Hq={hq} Hkv={hkv} S={S} D={D} P={P} T={T} "
                 f"{pdt} pages, {splits} splits",
            abs=abs_e, worst=worst, tol=tol, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=bnd, bound_by=by, same_bits=same,
            main=(S == 1 and pdt == "bfloat16" and hq == hkv == THEADS)))
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return results


#: integer and float operations per vocab entry when sampling: a
#: 20-round threefry-2x32 block (~125), the gumbel transform (~10) and
#: two logf (~25), priced at the fp32 rate (the bound's column)
SAMPLE_OPS = 160
#: the integer operations among them (the threefry block's adds,
#: rotations and xors, its key injections, the bits' shift: about 80)
#: and the card's INT32 rate, half its fp32 rate (132 SMs x 64 lanes x
#: 1.98 GHz): the floor the sampler's integer pipes set, printed beside
#: the bound
SAMPLE_INT_OPS = 80
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: the sampler's checks (row 22): (case, rows, vocab, vocab_size): a
#: GPT-2 decode step (8 rows of the padded head), the engine's prefill
#: row (one row a chunk) and `serve-lora`'s verify step (8 slots x 5 over
#: Llama's 32000 columns), each at every `SAMPLE_TEMPS` temperature (the
#: engine's default 0, greedy)
SAMPLE_CASES = [("decode", 8, TV_PAD, TV), ("prefill row", 1, TV_PAD, TV),
                ("serve-lora verify", 40, LV, LV)]
SAMPLE_TEMPS = (0.0, 0.7)


def sample_inputs(torch, gen, R, V):
    """(R, V) logits at 3x unit spread, seeds and positions on the card."""
    lg = (torch.randn(R, V, generator=gen) * 3).cuda()
    seeds = torch.randint(0, 2**31 - 1, (R,), generator=gen).to(
        torch.int32).cuda()
    pos = torch.randint(0, 1024, (R,), generator=gen).to(torch.int32).cuda()
    return lg, seeds, pos


def sample_bound(R, V, greedy):
    """The least time for a sampler call: the logits read once and the
    seeds, positions and ids; when sampling, `SAMPLE_OPS` an entry at the
    fp32 rate. Returns (ms, "bytes" or "operations", the INT32-rate time
    of `SAMPLE_INT_OPS` an entry)."""
    bnd, by = bound_ms(R * V * 4 + 3 * R * 4,
                       R * V * (1 if greedy else SAMPLE_OPS))
    return bnd, by, R * V * SAMPLE_INT_OPS / INT32_OPS_PER_S * 1e3


def check_fused_sample(torch, ops, gen):
    """Kernel 22 against its plain version at every `SAMPLE_CASES` case
    and temperature: the ids exactly, and the same ids on a second
    launch; `torch.argmax` over the vocab as the library call at T 0;
    the split count launched and, when sampling, the INT32-rate time
    beside the bound (`sample_bound`)."""
    from apex1_tpu_torch.ops.paged_decode import fused_sample, sample_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    for case, R, V, v_eff in SAMPLE_CASES:
        lg, seeds, pos = sample_inputs(torch, gen, R, V)
        splits = sample_splits(R, V, sms)[0]
        for temp in SAMPLE_TEMPS:
            def run():
                return fused_sample(lg, seeds, pos, temperature=temp,
                                    vocab_size=v_eff)

            got = run()
            again = run()
            with ops.force_impl("torch"):
                want = run()
            torch.cuda.synchronize()
            mism = int((got != want).sum().item())
            ms = graph_ms(run)
            with ops.force_impl("torch"):
                plain = graph_ms(run, iters=10)
            lib = (graph_ms(lambda: torch.argmax(lg[:, :v_eff], dim=-1))
                   if temp == 0.0 else None)
            bnd, by, int_ms = sample_bound(R, V, temp == 0.0)
            results.append(dict(
                case=f"{case} R={R} V={V} vocab={v_eff} T={temp}, "
                     f"{splits} splits"
                     + ("" if temp == 0.0 else
                        f", INT32-rate bound {int_ms:.4f} ms"),
                abs=float(mism), worst=float(mism), tol=None, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                same_bits=bool(torch.equal(got, again)),
                main=(R == 8 and temp == 0.7)))
        del lg, seeds, pos
    return results


#: the norm backward's checks: (case, rows, H, dtype, RMS), γ (and β)
#: in x's dtype as the amp policies' compute params, fp32 with fp32 x:
#: GPT-2's training rows, the Llama step's RMS rows, T5's (RMS), BERT-
#: base's and BERT-large's, and an H past 6016, the widest row the first
#: kernel took (its shared memory held 8 bytes a column)
NORM_BWD_CASES = [("GPT-2", TB * TS, TH, "bfloat16", False),
                  ("GPT-2", TB * TS, TH, "float16", False),
                  ("GPT-2", TB * TS, TH, "float32", False),
                  ("Llama", LB * LS, LH, "bfloat16", True),
                  ("T5", T5B * T5S, T5E, "bfloat16", True),
                  ("BERT-base", 8 * 512, 768, "bfloat16", False),
                  ("BERT-large", 4 * 512, 1024, "bfloat16", False),
                  ("wide", 64, 8192, "bfloat16", False),
                  ("wide", 64, 8192, "bfloat16", True)]


def norm_bwd_inputs(torch, gen, R, H, dt, rms):
    """x, dy, γ, β and the saved mean/rstd of a `NORM_BWD_CASES` case
    on the card."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    x = (torch.randn(R, H, generator=gen, device="cuda") * 2 + 0.5).to(dt)
    dy = torch.randn(R, H, generator=gen, device="cuda").to(dt)
    g = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(dt)
    b = None if rms else (0.1 * torch.randn(H, generator=gen,
                                            device="cuda")).to(dt)
    _, mean, rstd = layer_norm_fwd(x, g, b, 1e-5, rms)
    return x, dy, g, b, mean, rstd


def norm_bwd_library_ms(torch, x, dy, g, b, mean, rstd, rms):
    """ATen's backward alone, by CUDA-graph replays:
    ``aten.native_layer_norm_backward`` on the saved statistics for LN,
    ``aten._fused_rms_norm_backward`` on ``aten._fused_rms_norm``'s rstd
    for RMS."""
    aten = torch.ops.aten
    H = x.shape[1]
    if rms:
        r2 = aten._fused_rms_norm(x, [H], g, 1e-5)[1]
        return graph_ms(lambda: aten._fused_rms_norm_backward(
            dy, x, [H], r2, g, [True, True]))
    m2, r2 = mean[:, None], rstd[:, None]
    return graph_ms(lambda: aten.native_layer_norm_backward(
        dy, x, [H], m2, r2, g, b, [True, True, True]))


def check_layer_norm_bwd(torch, ops, gen):
    """Kernel 2 at `NORM_BWD_CASES`, each through its wrapper by
    CUDA-graph replays; dx, dγ and dβ must repeat their bits. Library:
    ATen's backward alone (`norm_bwd_library_ms`)."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_bwd
    results = []
    for name, R, H, dts, rms in NORM_BWD_CASES:
        dt = getattr(torch, dts)
        x, dy, g, b, mean, rstd = norm_bwd_inputs(torch, gen, R, H, dt, rms)

        def run():
            return layer_norm_bwd(dy, x, g, mean, rstd, rms, not rms)

        got = [t for t in run() if t is not None]
        again = [t for t in run() if t is not None]
        with ops.force_impl("torch"):
            want = [t for t in run() if t is not None]
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        tol = TOLS[dts]
        abs_e, worst = max_errs_all(zip(got, want), tol)
        ms = graph_ms(run)
        with ops.force_impl("torch"):
            plain = graph_ms(run, iters=10)
        lib = norm_bwd_library_ms(torch, x, dy, g, b, mean, rstd, rms)
        eb, gb = x.element_size(), g.element_size()
        # x, dy read and dx written; γ read, dγ (and dβ) written; mean
        # and rstd read; about 12 flops per element
        bnd, by = bound_ms(3 * R * H * eb + (2 if rms else 3) * H * gb
                           + 2 * R * 4, 12 * R * H)
        results.append(dict(case=f"{name} rows={R} H={H} {dts} x, dy, γ"
                            + (" RMS" if rms else ""),
                            abs=abs_e, worst=worst, tol=tol, ms=ms,
                            plain_ms=plain, library_ms=lib, bound_ms=bnd,
                            bound_by=by, same_bits=same,
                            main=name == "GPT-2" and dts == "bfloat16"))
        del x, dy, g, b, got, again, want
    return results


def check_softmax(torch, ops, gen):
    """Kernels 16 and 17 at the training step's (16, 12, 1024, 1024)
    fp32 scores: causal (the GPT-2 path) and with a broadcast
    (B, 1, 1, Sk) key-padding mask; and at OpenFold's MSA row attention
    with the pair bias (`openfold.attention_core`: 128 clusters x 8
    heads x 256 x 256 fp32 scores, scale 1/sqrt(32), the folded bias1
    (1, 128, 1, 1, 256) + bias2 (1, 1, 8, 256, 256) a full-size mask)."""
    from apex1_tpu_torch.ops.softmax import softmax_bwd, softmax_fwd
    x = torch.randn((TB, THEADS, TS, TS), generator=gen, device="cuda") * 4
    dy = torch.randn((TB, THEADS, TS, TS), generator=gen, device="cuda")
    pad = torch.rand((TB, 1, 1, TS), generator=gen, device="cuda") < 0.1
    mask = torch.where(pad, -1e30, 0.0)
    xo = torch.randn((OF_N, OF_H, OF_S, OF_S), generator=gen,
                     device="cuda") * 4
    dyo = torch.randn((OF_N, OF_H, OF_S, OF_S), generator=gen,
                      device="cuda")
    bias1 = torch.randn((1, OF_N, 1, 1, OF_S), generator=gen, device="cuda")
    bias2 = torch.randn((1, 1, OF_H, OF_S, OF_S), generator=gen,
                        device="cuda")
    mo = (bias1 + bias2).reshape(OF_N, OF_H, OF_S, OF_S)
    # (case, scores, dy, 4-D mask, scale, causal, main)
    cases = [("causal", x, dy, None, 1.0 / 8.0, True, True),
             ("mask (B,1,1,Sk)", x, dy, mask, 1.0 / 8.0, False, False),
             ("OpenFold pair bias, mask (N,H,S,S)", xo, dyo, mo,
              OF_D ** -0.5, False, False)]
    fwd, bwd = [], []
    for case, x, dy, m4, scale, causal, main in cases:
        n, sk = x.numel(), x.shape[-1]

        def run():
            return softmax_fwd(x, m4, scale, causal)

        got = run()
        same = torch.equal(run(), got)
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS["float32"]
        abs_e, worst = max_errs(got, want, *tol)
        ms = event_ms(run)
        with ops.force_impl("torch"):
            plain = event_ms(run, iters=3)
        if causal:
            keep = torch.ones(sk, sk, dtype=torch.bool, device="cuda").tril()
            pre = torch.where(keep, x * scale, -1e30)
        else:
            pre = x * scale + m4
        lib = event_ms(lambda: torch.softmax(pre, dim=-1))
        # causal: only the lower triangle of x is needed; a mask is read
        # at its own (broadcast) size
        n_read = n // sk * (sk + 1) // 2 if causal else n
        mbytes = 0 if m4 is None else m4.numel() * 4
        bnd, by = bound_ms((n_read + n) * 4 + mbytes, 5 * n)
        label = f"{case} {tuple(x.shape)} f32"
        fwd.append(dict(case=label, abs=abs_e, worst=worst, tol=tol, ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=bnd,
                        bound_by=by, same_bits=same, main=main))

        def run_b():
            return softmax_bwd(want, dy, scale)

        got = run_b()
        with ops.force_impl("torch"):
            want_b = run_b()
        torch.cuda.synchronize()
        abs_e, worst = max_errs(got, want_b, *tol)
        ms = event_ms(run_b)
        with ops.force_impl("torch"):
            plain = event_ms(run_b, iters=3)
        # the library's backward lacks the scale: it computes dx / scale
        lib = event_ms(lambda: torch._softmax_backward_data(
            dy, want, -1, torch.float32))
        bnd, by = bound_ms(3 * n * 4, 4 * n)
        bwd.append(dict(case=label, abs=abs_e, worst=worst, tol=tol, ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=bnd,
                        bound_by=by, main=main))
        del got, want, want_b, pre
    return fwd, bwd


#: TPU rows 18-19's cases (`check_xent`, `--compare xent`): (case,
#: logits, smoothing, padding_idx). Logits "gpt2": the fp32 training
#: step's logits[:, :-1] slice of (TB, TS, TV_PAD), TV real classes (the
#: first case is the kernels line's main one); "unaligned": the same
#: slice of unpadded (TB, TS, TV) logits, an odd width, so rows start
#: off 16 bytes and K = TV is off the vector width; "nsp": BERT's NSP
#: head, (8, 2) fp32; "resnet": the ResNet head, (RESNET_B, 1000) fp32,
#: unpadded; "bfloat16", "float16": the contrib phase's
#: `SoftmaxCrossEntropyLoss` head, the gpt2 slice in half, every one of
#: its TV_PAD columns a class. A padding_idx case sets every fifth label
#: to it.
XENT_CASES = (
    ("GPT-2 head", "gpt2", 0.0, None),
    ("GPT-2 head", "gpt2", 0.1, None),
    ("GPT-2 head", "gpt2", 0.0, 0),
    ("GPT-2 head, unpadded width (rows off 16 bytes)", "unaligned", 0.0,
     None),
    ("BERT NSP", "nsp", 0.0, None),
    ("ResNet head", "resnet", 0.0, None),
    ("SoftmaxCrossEntropyLoss", "bfloat16", 0.1, 0),
    ("SoftmaxCrossEntropyLoss", "float16", 0.1, 0),
)


def xent_cases(torch, gen):
    """`XENT_CASES`' inputs on the card, in order, each made when its
    case comes (normal draws: the GPT-2 logits times 2, NSP's times 2,
    the ResNet head's times 4): yields (case label, x (A, T, V), labels,
    smoothing, padding_idx, K, dloss = the mean's 1/rows)."""
    full = torch.randn((TB, TS, TV_PAD), generator=gen, device="cuda") * 2
    t = torch.randint(0, TV, (TB * (TS - 1),), generator=gen, device="cuda")

    def small(B, K, scale):
        x = torch.randn((1, B, K), generator=gen, device="cuda") * scale
        return x, torch.randint(0, K, (B,), generator=gen, device="cuda"), K

    def unaligned():
        u = torch.randn((TB, TS, TV), generator=gen, device="cuda") * 2
        return u[:, :-1], t, TV

    inputs = {"gpt2": lambda: (full[:, :-1], t, TV), "unaligned": unaligned,
              "nsp": lambda: small(8, 2, 2.0),
              "resnet": lambda: small(RESNET_B, 1000, 4.0),
              "bfloat16": lambda: (full[:, :-1].to(torch.bfloat16), t,
                                   TV_PAD),
              "float16": lambda: (full[:, :-1].to(torch.float16), t,
                                  TV_PAD)}
    for case, kind, eps, pad in XENT_CASES:
        x, lab, K = inputs[kind]()
        if pad is not None:
            lab = lab.clone()
            lab[::5] = pad
        n = x.shape[0] * x.shape[1]
        dt = str(x.dtype).replace("torch.", "")
        yield (f"{case} rows={n} V={x.shape[2]} K={K} {dt} eps={eps} "
               f"pad={pad}", x, lab, eps, pad, K,
               torch.full((n,), 1.0 / n, device="cuda"))
        del x, lab
        torch.cuda.empty_cache()


def xent_bounds(x, K: int):
    """Rows 18 and 19's bounds, (ms, by) each: the forward reads the K
    real columns of each row once and the label, and writes loss and lse
    (about 6 flops an element); the backward reads the K columns, the
    label, lse and dloss and writes every dx column (about 5)."""
    n, width, es = x.shape[0] * x.shape[1], x.shape[2], x.element_size()
    return (bound_ms(n * K * es + n * 8 + n * 8, 6 * n * K),
            bound_ms(n * K * es + n * 12 + n * width * es, 5 * n * K))


def xent_library_ms(torch, x, lab, eps, pad, K, dloss, timer):
    """``F.cross_entropy`` with ``label_smoothing`` and ``ignore_index``
    (the same function) on a dense copy of x's K real classes, made
    outside the timing: (its ms by ``timer``, its backward's through
    autograd by CUDA events, host included)."""
    import torch.nn.functional as F
    xl = x.reshape(-1, x.shape[-1])[:, :K].contiguous()
    kw = dict(label_smoothing=eps, reduction="none",
              ignore_index=-100 if pad is None else pad)
    fwd = timer(lambda: F.cross_entropy(xl, lab, **kw))
    xr = xl.detach().requires_grad_()
    loss = F.cross_entropy(xr, lab, **kw)
    bwd = event_ms(lambda: torch.autograd.grad(loss, xr, dloss,
                                               retain_graph=True))
    return fwd, bwd


def check_xent(torch, ops, gen):
    """Kernels 18 and 19 at every `XENT_CASES` case: loss and lse at f32
    tolerance, dx at its dtype's, each the same bits on a second launch;
    the backward takes the plain version's lse. A half dx also gets
    2·`ETA` absolute: with dloss the mean's 1/rows, fp16 dx lies below
    the normal range (6.1e-5), where each side's one rounding is off by
    up to ETA, not by a share of |want|. CUDA events time the
    cases of the GPT-2 head, graph replays NSP's and the ResNet head's
    (a launch's latency), beside the plain versions and
    `xent_library_ms`."""
    from apex1_tpu_torch.ops.xentropy import xent_bwd, xent_fwd
    fwd, bwd = [], []
    for i, (label, x, lab, eps, pad, K, dloss) in enumerate(
            xent_cases(torch, gen)):
        big = x.numel() > 1 << 24
        timer = event_ms if big else graph_ms
        with ops.force_impl("torch"):
            lse = xent_fwd(x, lab, eps, pad, K)[1]
        lib = xent_library_ms(torch, x, lab, eps, pad, K, dloss, timer)
        dt = str(x.dtype).replace("torch.", "")
        for out, run, tol, eta, lib_ms, (bnd, by) in zip(
                (fwd, bwd),
                (lambda: xent_fwd(x, lab, eps, pad, K),
                 lambda: (xent_bwd(x, lab, lse, dloss, eps, pad, K),)),
                (TOLS["float32"], TOLS[dt]), (0.0, 2 * ETA.get(dt, 0.0)), lib,
                xent_bounds(x, K)):
            got, again = run(), run()
            with ops.force_impl("torch"):
                want = run()
                plain = event_ms(run, iters=3 if big else 10)
            torch.cuda.synchronize()
            abs_e, worst = max_errs_all(zip(got, want), tol, eta)
            out.append(dict(
                case=label, abs=abs_e, worst=worst, tol=tol, ms=timer(run),
                plain_ms=plain, library_ms=lib_ms, bound_ms=bnd,
                bound_by=by, main=i == 0,
                same_bits=all(torch.equal(a, b) for a, b in zip(got, again))))
            if eta:
                out[-1]["rule"] = (f"rtol={tol[0]:g} atol={tol[1]:g}*rms "
                                   f"+ {eta:.3g} (two roundings below the "
                                   f"normal range)")
            del got, again, want
    return fwd, bwd


#: the bias-dropout-add kernels' checks: (case, rows, h, dtype, residual
#: dtype or None for x's, bias, main). BERT-base's residual epilogue
#: (B x S = 8 x 512 rows of 768, no bias) is the main case; BERT-large's
#: (4 x 512 rows of 1024), GPT-2's (16 x 1024 rows of 768), a ragged
#: row count, h = 1000 (scalar loads) and an fp32 residual
BDA_CASES = [
    ("BERT-base epilogue", 8 * 512, 768, "bfloat16", None, False, True),
    ("BERT-large epilogue", 4 * 512, 1024, "bfloat16", None, False, False),
    ("GPT-2 epilogue", TB * TS, TH, "bfloat16", None, False, False),
    ("bias, ragged rows", 4096 + 37, 768, "float32", None, True, False),
    ("bias, h 1000 scalar loads", 1000 + 3, 1000, "float16", None, True,
     False),
    ("bias, h 1024", 2048, 1024, "bfloat16", None, True, False),
    ("fp32 residual, bias", 999, 768, "bfloat16", "float32", True, False),
]
#: the dropout rate and seed of the kernel checks
DROP_P, DROP_SEED = 0.1, 4321


def check_bda(torch, ops, gen):
    """Kernels 14 and 15 (bias-dropout-add forward and backward) against
    their plain versions: y and dx must equal them bit for bit (the
    same fp32 operations, each rounded once); dbias (fp32 sums over the
    rows in another order) within f32 tolerance; dx and dbias with the
    same bits on a second run. The witness (x = 1, residual 0, no bias: y is 1/(1-p) or
    0) must show the plain version's mask exactly and keep 1 - p of the
    elements within 3 sigma. Bound: bytes (x, residual and y read or
    written once; dy and dx), no library call computes the function."""
    from apex1_tpu_torch.ops.stochastic import _row_keep, bda_bwd, bda_fwd
    fwd, bwd = [], []
    for case, rows, h, dts, rdts, with_bias, main in BDA_CASES:
        dt = getattr(torch, dts)
        rdt = dt if rdts is None else getattr(torch, rdts)
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        r = torch.randn(rows, h, generator=gen, device="cuda").to(rdt)
        dy = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        b = (torch.randn(h, generator=gen, device="cuda") if with_bias
             else None)

        def run_f():
            return bda_fwd(x, r, b, DROP_SEED, DROP_P)

        def run_b():
            return bda_bwd(dy, DROP_SEED, DROP_P, with_bias)

        y = run_f()
        dx, db = run_b()
        with ops.force_impl("torch"):
            wy = run_f()
            wdx, wdb = run_b()
        dx2, db2 = run_b()
        same_bits = torch.equal(dx2, dx) and (db is None
                                              or torch.equal(db2, db))
        del dx2, db2
        torch.cuda.synchronize()
        label = (f"{case} rows={rows} h={h} {dts}"
                 + (f" residual {rdts}" if rdts else "")
                 + (" bias" if with_bias else ""))
        witness = {}
        if main:
            ones = torch.ones_like(x)
            wit = bda_fwd(ones, torch.zeros_like(x), None, DROP_SEED, DROP_P)
            keep = _row_keep(DROP_SEED, rows, h, DROP_P, "cuda")
            rate = keep.float().mean().item()
            sigma = (DROP_P * (1 - DROP_P) / keep.numel()) ** 0.5
            witness = dict(equal_bits=bool(
                torch.equal(wit != 0, keep)
                and abs(rate - (1 - DROP_P)) < 3 * sigma))
            label += (f"; witness keep rate {rate:.5f} vs {1 - DROP_P} "
                      f"(3 sigma {3 * sigma:.2g})")
            del ones, wit, keep
        ms_f, ms_b = graph_ms(run_f), graph_ms(run_b)
        with ops.force_impl("torch"):
            pl_f, pl_b = event_ms(run_f, iters=3), event_ms(run_b, iters=3)
        eb = x.element_size()
        n = rows * h
        bnd_f = bound_ms(n * (2 * eb + r.element_size())
                         + (4 * h if with_bias else 0), 0)
        bnd_b = bound_ms(2 * n * eb + (4 * h if with_bias else 0), 0)
        fwd.append(dict(case=label, abs=(y.float() - wy.float()).abs()
                        .max().item(), worst=0.0, tol=None, ms=ms_f,
                        plain_ms=pl_f, library_ms=None, bound_ms=bnd_f[0],
                        bound_by=bnd_f[1], main=main,
                        rule="equal to the plain version", **witness))
        e_dx = (dx.float() - wdx.float()).abs().max().item()
        if with_bias:
            e_db = max_errs(db, wdb, *TOLS["float32"])
            row = dict(abs=max(e_dx, e_db[0]),
                       worst=e_db[1] if e_dx == 0 else math.inf,
                       tol=TOLS["float32"],
                       rule="dx equal to the plain version, dbias f32 "
                            "rtol/atol")
        else:
            row = dict(abs=e_dx, worst=0.0, tol=None,
                       rule="equal to the plain version")
        bwd.append(dict(case=label, ms=ms_b, plain_ms=pl_b, library_ms=None,
                        bound_ms=bnd_b[0], bound_by=bnd_b[1], main=main,
                        same_bits=same_bits, **row))
        del x, r, dy, y, dx, wy, wdx
    return fwd, bwd


#: the flash kernels' checks: (case, B, Hq, Hkv, Sq, Sk, dtype, causal,
#: segments (False, True: `doc_segments`, "padding": `padding_segments`),
#: q_off, k_off, dlse, main[, head_dim][, options]); options: "p" the
#: dropout rate, "lib" time the library call (else only the main case),
#: "bias" the additive bias (`flash_bias`; the case then checks dbias
#: too), "dbias_main" dbias's main case
FLASH_CASES = [
    ("GPT-2 causal", TB, THEADS, THEADS, TS, TS, "bfloat16", True, False,
     0, 0, False, True),
    ("causal", 4, THEADS, THEADS, 512, 512, "float16", True, False, 0, 0,
     False, False),
    ("causal", 2, THEADS, THEADS, 256, 256, "float32", True, False, 0, 0,
     False, False),
    ("GQA 12/4", 4, THEADS, 4, 512, 512, "bfloat16", True, False, 0, 0,
     False, False),
    ("packed segments, -1 tail", 4, THEADS, THEADS, TS, TS, "bfloat16",
     True, True, 0, 0, False, False),
    ("non-causal 77x200", 4, THEADS, THEADS, 77, 200, "bfloat16", False,
     False, 0, 0, False, False),
    ("offsets q+64 k+192", 2, THEADS, THEADS, 512, 640, "bfloat16", True,
     False, 64, 192, False, False),
    ("return_lse, dlse", 4, THEADS, THEADS, 512, 512, "bfloat16", True,
     False, 0, 0, True, False),
    ("Llama GQA 32/8 causal", LB, LHEADS, LKV, LS, LS, "bfloat16", True,
     False, 0, 0, False, False, LD, dict(lib=True)),
    ("Llama GQA 32/8 packed segments", LB, LHEADS, LKV, LS, LS, "bfloat16",
     True, True, 0, 0, False, False, LD),
    # llama_3d's attention (one sequence a microbatch)
    ("llama_3d GQA 32/4 causal", 1, 32, 4, 2048, 2048, "bfloat16", True,
     False, 0, 0, False, False, 64),
    ("BERT padding, p=0", 8, THEADS, THEADS, 512, 512, "bfloat16", False,
     "padding", 0, 0, False, False, dict(lib=True)),
    ("BERT padding, dropout", 8, THEADS, THEADS, 512, 512, "bfloat16",
     False, "padding", 0, 0, False, False, dict(p=DROP_P, lib=True)),
    ("GPT-2 causal, dropout", TB, THEADS, THEADS, TS, TS, "bfloat16", True,
     False, 0, 0, False, False, dict(p=DROP_P)),
    ("GQA 12/4, dropout", 4, THEADS, 4, 512, 512, "float16", True, False, 0,
     0, True, False, dict(p=DROP_P)),
    ("offsets q+64 k+192, dropout", 2, THEADS, THEADS, 512, 640, "float32",
     True, False, 64, 192, False, False, dict(p=DROP_P)),
    ("T5 encoder, rel-pos bias", T5B, T5HEADS, T5HEADS, T5S, T5S, "bfloat16",
     False, False, 0, 0, False, False,
     dict(bias="table", lib=True, dbias_main=True)),
    ("T5 decoder, rel-pos bias, causal", T5B, T5HEADS, T5HEADS, T5S, T5S,
     "bfloat16", True, False, 0, 0, False, False,
     dict(bias="table", lib=True)),
    ("key-padding mask, -1e4 and NEG_INF", T5B, T5HEADS, T5HEADS, T5S, T5S,
     "bfloat16", False, False, 0, 0, False, False,
     dict(bias="mask", lib=True)),
    ("T5 bias, padding segments", T5B, T5HEADS, T5HEADS, T5S, T5S,
     "bfloat16", False, "padding", 0, 0, False, False, dict(bias="table")),
    ("T5 bias, dropout", T5B, T5HEADS, T5HEADS, T5S, T5S, "bfloat16", False,
     False, 0, 0, False, False, dict(bias="table", p=DROP_P, lib=True)),
    ("bias (B, Hq), GQA 12/4, ragged, dlse", 2, THEADS, 4, 300, 333,
     "float16", True, False, 0, 0, True, False, dict(bias="full")),
    ("bias (1, 1), f32, offsets", 2, 4, 4, 200, 260, "float32", True, False,
     16, 48, False, False, dict(bias="shared")),
    # generate-t5's cross-attention at a decode step: one query row
    # against the encoder's 512 keys, key padding as segments
    ("T5 cross-attention decode step, key padding", T5B, T5HEADS, T5HEADS,
     1, T5S, "bfloat16", False, "keys", 0, 0, False, False, dict(lib=True)),
]


def doc_segments(B: int, S: int, seed: int):
    """(B, S) int32 segment ids: documents of 64-400 tokens in a row,
    then a padded tail of segment -1 (the shape `pack_documents`
    gives)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = np.full((B, S), -1, np.int32)
    for b in range(B):
        pos, sid = 0, 0
        while True:
            n = int(rng.integers(64, 401))
            if pos + n > S - 50:
                break
            ids[b, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return ids


def padding_segments(B: int, S: int, seed: int):
    """(B, S) int32 segment ids of a BERT padding mask: 1 for the real
    tokens (a row holds 256-512 of them, from the seed), 0 for the
    pads."""
    import numpy as np
    lens = np.random.default_rng(seed).integers(S // 2, S + 1, B)
    return (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)


def flash_witness(torch, ops):
    """The dropout mask made visible: Sk = D = 128 and v the identity,
    so out[q, j] = keep·e/l·(1/(1-p)) and out's zero pattern is the
    kernel's mask at (q, j); it must equal the plain version's and the
    mask `attn_keep_mask` gives (offsets 64/192, GQA 4/2, bf16). dk/dv's
    loop walks the query heads of a kv head's group: with dO one-hot on
    query row 5, dv[key] is zero exactly where every head of the group
    dropped that key. dq: with k and v the identity, dO all ones and δ
    0, dq[q, j] = dS[q, j] = P·inv·scale, zero exactly where (q, j) was
    dropped, in the kernel and in the plain version. Returns (forward
    ok, dk/dv ok, dq ok, keep rate, 3 sigma of it)."""
    from apex1_tpu_torch.ops.attention import (_keep, flash_dkv, flash_dq,
                                               flash_fwd)
    B, Hq, Hkv, S, p = 2, 4, 2, 128, DROP_P
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = (0.1 * torch.randn(B, Hq, S, S, generator=g, device="cuda")).to(
        torch.bfloat16)
    k = (0.1 * torch.randn(B, Hkv, S, S, generator=g, device="cuda")).to(
        torch.bfloat16)
    v = torch.eye(S, device="cuda", dtype=torch.bfloat16).expand(
        B, Hkv, S, S).contiguous()
    args = (None, None, S ** -0.5, False, 64, 192, p, DROP_SEED)
    out, lse = flash_fwd(q, k, v, *args)
    with ops.force_impl("torch"):
        wout, _ = flash_fwd(q, k, v, *args)
    keep = _keep(q, S, 64, 192, p, DROP_SEED)
    fwd_ok = torch.equal(out != 0, keep) and torch.equal(wout != 0, keep)
    do = torch.zeros_like(q)
    do[:, :, 5, :] = 1
    delta = (do.float() * out.float()).sum(-1)
    _, dv = flash_dkv(q, k, v, do, lse, delta, None, *args)
    kept = keep[:, :, 5, :].reshape(B, Hkv, Hq // Hkv, S).any(dim=2)
    _, lse_e = flash_fwd(q, v, v, *args)
    dq_args = (q, v, v, torch.ones_like(q), lse_e,
               torch.zeros(B, Hq, S, device="cuda"), None, *args)
    dq = flash_dq(*dq_args)
    with ops.force_impl("torch"):
        wdq = flash_dq(*dq_args)
    dq_ok = torch.equal(dq != 0, keep) and torch.equal(wdq != 0, keep)
    rate = keep.float().mean().item()
    sigma = (p * (1 - p) / keep.numel()) ** 0.5
    ok_rate = abs(rate - (1 - p)) < 3 * sigma
    return (fwd_ok and ok_rate, torch.equal(dv[..., 0] != 0, kept), dq_ok,
            rate, 3 * sigma)


def sdpa_ms(torch, q, k, v, qseg, kseg, causal, p, do):
    """The library yardstick: ``F.scaled_dot_product_attention`` on the
    same operands (segments as a boolean mask, GQA through
    ``enable_gqa``, dropout from its own generator), forward and whole
    backward; (None, None, why) where this torch has no such call."""
    import torch.nn.functional as F
    kw = dict(dropout_p=p)
    if qseg is not None:
        kw["attn_mask"] = qseg[:, None, :, None] == kseg[:, None, None, :]
    else:
        kw["is_causal"] = causal
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    try:
        f_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                               **kw))
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qr, kr, vr, **kw)
        b_ms = event_ms(lambda: torch.autograd.grad(
            o, (qr, kr, vr), do, retain_graph=True))
        return f_ms, b_ms, None
    except (TypeError, RuntimeError) as e:
        return None, None, f"{type(e).__name__}: {e}"[:160]


def flash_bias(torch, kind, B: int, Hq: int, Sq: int, Sk: int, gen):
    """A flash check's additive bias (fp32) or None: "table" T5's
    (1, Hq, Sq, Sk) relative-position bias, "full" (B, Hq, Sq, Sk),
    "shared" (1, 1, Sq, Sk), each drawn N(0, 1); "mask" a (B, 1, Sq, Sk)
    key-padding mask, 0 on a row's 256-512 real keys
    (`padding_segments`), -10000 on the even pad columns and NEG_INF on
    the odd ones."""
    if kind is None:
        return None
    if kind == "mask":
        real = torch.from_numpy(padding_segments(B, Sk, SEED + 7)).cuda()
        col = torch.arange(Sk, device="cuda")
        pad = torch.where(col % 2 == 0, -10000.0, -1e30)
        m = torch.where(real.bool(), 0.0, pad[None, :])
        return m[:, None, None, :].expand(B, 1, Sq, Sk).contiguous()
    shape = {"table": (1, Hq, Sq, Sk), "full": (B, Hq, Sq, Sk),
             "shared": (1, 1, Sq, Sk)}[kind]
    return torch.randn(shape, generator=gen, device="cuda")


def sdpa_bias_ms(torch, q, k, v, bias, qseg, kseg, causal, p, do):
    """The library yardstick with a bias: ``F.scaled_dot_product_attention``
    with the bias as a float ``attn_mask`` in q's dtype (the causal and
    segment masks folded in as -inf, GQA through ``enable_gqa``, its own
    dropout): forward, whole backward, and the backward with the mask
    taking a gradient too. Returns (forward ms, backward ms, backward
    with the mask's gradient ms, why any is None)."""
    import torch.nn.functional as F
    Sq, Sk = q.shape[2], k.shape[2]
    m = bias.float()
    if causal:
        upper = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).triu(1)
        m = m.masked_fill(upper, float("-inf"))
    if qseg is not None:
        m = m.masked_fill(qseg[:, None, :, None] != kseg[:, None, None, :],
                          float("-inf"))
    m = m.to(q.dtype)
    kw = dict(dropout_p=p)
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    out = [None, None, None]
    why = []
    try:
        out[0] = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, **kw))
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=m, **kw)
        out[1] = event_ms(lambda: torch.autograd.grad(
            o, (qr, kr, vr), do, retain_graph=True))
        mr = m.detach().requires_grad_()
        o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mr, **kw)
        out[2] = event_ms(lambda: torch.autograd.grad(
            o, (qr, kr, vr, mr), do, retain_graph=True))
    except (TypeError, RuntimeError) as e:
        why.append(f"{type(e).__name__}: {e}"[:160])
    return (*out, "; ".join(why) or None)


def flash_case(torch, entry, gen):
    """The operands of a `FLASH_CASES` entry drawn from ``gen``: (D,
    options, dropout p, dtype, q, k, v, dout, dlse, qseg, kseg, the
    kernels' positional arguments after q, k, v, the bias, its keyword
    arguments)."""
    (_, B, Hq, Hkv, Sq, Sk, dts, causal, segs, q_off, k_off, with_dlse,
     _, *extra) = entry
    opts = next((e for e in extra if isinstance(e, dict)), {})
    D = next((e for e in extra if isinstance(e, int)), TH // THEADS)
    p = opts.get("p", 0.0)
    dt = getattr(torch, dts)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v, do = rnd(B, Hq, Sq, D), rnd(B, Hkv, Sk, D), \
        rnd(B, Hkv, Sk, D), rnd(B, Hq, Sq, D)
    dlse = (torch.randn((B, Hq, Sq), generator=gen, device="cuda")
            if with_dlse else None)
    qseg = kseg = None
    if segs == "keys":
        # T5's key padding: every query in segment 0, a padded key in 1
        qseg = torch.zeros(B, Sq, dtype=torch.int32, device="cuda")
        kseg = torch.from_numpy(1 - padding_segments(B, Sk, SEED)).cuda()
    elif segs:
        ids = (padding_segments if segs == "padding" else doc_segments)(
            B, Sq, SEED)
        qseg = kseg = torch.from_numpy(ids).cuda()
    args = (qseg, kseg, 1.0 / math.sqrt(D), causal, q_off, k_off) + (
        (p, DROP_SEED) if p else ())
    bias = flash_bias(torch, opts.get("bias"), B, Hq, Sq, Sk, gen)
    kw = {} if bias is None else dict(bias=bias)
    return D, opts, p, dt, q, k, v, do, dlse, qseg, kseg, args, bias, kw


def check_flash(torch, ops, gen):
    """Kernels 3-6 (flash forward, dq, dk/dv and dbias) against their
    plain versions: out and lse from the forward; dq and dk/dv from the
    same (q, k, v, dout, lse, δ, dlse), each run twice for the same
    bits; with dropout (p > 0) both sides draw the same hash mask, and
    the first dropout case carries `flash_witness`; with a bias
    (`flash_bias`) every kernel reads it and dbias (fp32, f32 tolerance)
    is checked too, also for the same bits twice. Bounds count the
    valid (q, k) pairs of this run's mask: 2 products forward, 3 for
    dq, 4 for dk/dv, 2 for dbias, 2·D flops a pair each; a bias adds its
    bytes to each, dbias's its output's too."""
    from apex1_tpu_torch.ops.attention import (_valid, flash_dbias,
                                               flash_dkv, flash_dq,
                                               flash_fwd)
    fwd, dq_rows, dkv_rows, db_rows = [], [], [], []
    witness = None
    for entry in FLASH_CASES:
        (case, B, Hq, Hkv, Sq, Sk, dts, causal, segs, q_off, k_off,
         with_dlse, main, *extra) = entry
        (D, opts, p, dt, q, k, v, do, dlse, qseg, kseg, args, bias,
         kw) = flash_case(torch, entry, gen)
        tol = TOLS[dts]

        def run_f(vv=None):
            return flash_fwd(q, k, v if vv is None else vv, *args, **kw)

        out, lse = run_f()
        with ops.force_impl("torch"):
            wout, wlse = run_f()
        torch.cuda.synchronize()
        empty = wlse <= -1e29
        if not torch.equal(lse <= -1e29, empty):
            raise RuntimeError(f"flash_fwd {case}: rows without keys differ")
        if dt == torch.float32:
            e1 = max_errs(out, wout, *tol)
        else:
            with ops.force_impl("torch"):
                absprod = run_f(v.abs())[0]
            # a probability or an output below the normal range rounds
            # by up to ETA absolute (fp16 below 6.1e-5): P's other
            # operand is Σ_k |v_k| of the row's kv head
            abs_sum = v.float().abs().sum(2, keepdim=True)
            abs_sum = abs_sum.repeat_interleave(Hq // Hkv, dim=1)
            e1 = rounding_errs(out, wout, absprod, UNIT[dts], 1, ETA[dts],
                               abs_sum)
            del absprod, abs_sum
        e2 = max_errs(torch.where(empty, 0.0, lse),
                      torch.where(empty, 0.0, wlse), *TOLS["float32"])
        delta = (do.float() * wout.float()).sum(-1)
        bwd = (q, k, v, do, wlse, delta, dlse, *args)
        dq = flash_dq(*bwd, **kw)
        dk, dv = flash_dkv(*bwd, **kw)
        with ops.force_impl("torch"):
            wdq = flash_dq(*bwd, **kw)
            wdk, wdv = flash_dkv(*bwd, **kw)
        same_dq = torch.equal(flash_dq(*bwd, **kw), dq)
        dk2, dv2 = flash_dkv(*bwd, **kw)
        same_dkv = torch.equal(dk2, dk) and torch.equal(dv2, dv)
        torch.cuda.synchronize()
        timer = event_ms if main else graph_ms
        ms_f = timer(run_f)
        ms_q = timer(lambda: flash_dq(*bwd, **kw))
        ms_kv = timer(lambda: flash_dkv(*bwd, **kw))
        with ops.force_impl("torch"):
            pl_f = event_ms(run_f, iters=3)
            pl_q = event_ms(lambda: flash_dq(*bwd, **kw), iters=3)
            pl_kv = event_ms(lambda: flash_dkv(*bwd, **kw), iters=3)
        lib_f = lib_b = lib_db = None
        label = f"{case} B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} {dts}"
        if p:
            label += f" p={p}"
        if bias is not None:
            label += f" bias {tuple(bias.shape)}"
        if (main or opts.get("lib")) and bias is not None:
            lib_f, lib_b, lib_db, why = sdpa_bias_ms(
                torch, q, k, v, bias, qseg, kseg, causal, p, do)
            if why:
                label += f"; library call unavailable ({why})"
        elif main or opts.get("lib"):
            lib_f, lib_b, why = sdpa_ms(torch, q, k, v, qseg, kseg, causal,
                                        p, do)
            if why:
                label += f"; library call unavailable ({why})"
        wit = {}
        if p and witness is None:
            witness = flash_witness(torch, ops)
            label += (f"; witness keep rate {witness[3]:.5f} vs {1 - p} "
                      f"(3 sigma {witness[4]:.2g})")
            wit = dict(fwd=dict(equal_bits=witness[0]),
                       dkv=dict(equal_bits=witness[1]),
                       dq=dict(equal_bits=witness[2]))
        mask = _valid(B, Sq, Sk, qseg, kseg, causal, q_off, k_off, "cuda")
        pairs = mask.sum().item() * Hq * (B if mask.shape[0] == 1 else 1)
        eb = q.element_size()
        nq, nkv = B * Hq * Sq * D * eb, B * Hkv * Sk * D * eb
        stats = B * Hq * Sq * 4
        nb = 0 if bias is None else bias.numel() * 4
        peak = F32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
        b_f = bound_ms(2 * nq + 2 * nkv + stats + nb, 4 * D * pairs, peak)
        b_q = bound_ms(3 * nq + 2 * nkv + 3 * stats + nb, 6 * D * pairs,
                       peak)
        b_kv = bound_ms(2 * nq + 4 * nkv + 3 * stats + nb, 8 * D * pairs,
                        peak)
        if bias is not None:
            db = flash_dbias(*bwd, **kw)
            with ops.force_impl("torch"):
                wdb = flash_dbias(*bwd, **kw)
            same_db = torch.equal(flash_dbias(*bwd, **kw), db)
            edb = max_errs(db, wdb, *TOLS["float32"])
            dmain = opts.get("dbias_main", False)
            ms_db = (event_ms if dmain else graph_ms)(
                lambda: flash_dbias(*bwd, **kw))
            with ops.force_impl("torch"):
                pl_db = event_ms(lambda: flash_dbias(*bwd, **kw), iters=3)
            b_db = bound_ms(2 * nq + 2 * nkv + 3 * stats + 2 * nb,
                            4 * D * pairs, peak)
            db_rows.append(dict(case=label, abs=edb[0], worst=edb[1],
                                tol=TOLS["float32"], ms=ms_db,
                                plain_ms=pl_db, library_ms=lib_db,
                                bound_ms=b_db[0], bound_by=b_db[1],
                                main=dmain, same_bits=same_db))
            del db, wdb
        fwd.append(dict(case=label, abs=max(e1[0], e2[0]),
                        worst=max(e1[1], e2[1]), tol=tol, ms=ms_f,
                        plain_ms=pl_f, library_ms=lib_f, bound_ms=b_f[0],
                        bound_by=b_f[1], main=main,
                        **wit.get("fwd", {}),
                        **({} if dt == torch.float32 else {
                            "rule": f"out: rounding bound of P, u="
                                    f"{UNIT[dts]:g}; lse: f32 rtol/atol"})))
        eq = max_errs(dq, wdq, *tol)
        dq_rows.append(dict(case=label, abs=eq[0], worst=eq[1], tol=tol,
                            ms=ms_q, plain_ms=pl_q, library_ms=lib_b,
                            bound_ms=b_q[0], bound_by=b_q[1], main=main,
                            same_bits=same_dq, **wit.get("dq", {})))
        ekv = max_errs_all([(dk, wdk), (dv, wdv)], tol)
        dkv_rows.append(dict(case=label, abs=ekv[0], worst=ekv[1], tol=tol,
                             ms=ms_kv, plain_ms=pl_kv, library_ms=lib_b,
                             bound_ms=b_kv[0], bound_by=b_kv[1], main=main,
                             same_bits=same_dkv, **wit.get("dkv", {})))
        del out, wout, dq, wdq, dk, dv, wdk, wdv, dk2, dv2, bias, kw
        torch.cuda.empty_cache()
    return fwd, dq_rows, dkv_rows, db_rows


#: the linear-xent kernels' checks: (case, T, V_l, dtype, K, col_offset,
#: smoothing, padding_idx, forward mode, main[, H, plain and library
#: timed]). T = 16 x 1023 is the GPT-2 step's head; 8 x 1023 one DPO
#: sequence batch, whose last vocab chunk holds the table's last 50304 -
#: 6 x 8192 = 1152 rows; 2 x 4095 the Llama step's head
LXENT_CASES = [
    ("GPT-2 head", TB * (TS - 1), TV_PAD, "bfloat16", TV, 0, 0.0, None, 0,
     True),
    ("GPT-2 head", TB * (TS - 1), TV_PAD, "float16", TV, 0, 0.0, None, 0,
     False),
    ("small", 1024, 8192, "float32", 8000, 0, 0.0, None, 0, False),
    ("smoothing 0.1, padding_idx 0", 4096, TV_PAD, "bfloat16", TV, 0, 0.1,
     0, 0, False),
    ("shard 3 of 4, labels mostly outside it", 4096, TV_PAD // 4,
     "bfloat16", TV, 2 * TV_PAD // 4, 0.0, None, 1, False),
    ("DPO chunk 7 of 7, ragged", 8 * (TS - 1), TV_PAD - 6 * 8192,
     "bfloat16", TV, 6 * 8192, 0.0, None, 2, False),
    ("Llama head", LB * (LS - 1), LV, "bfloat16", LV, 0, 0.0, None, 0,
     False, LH, True),
    ("Llama head", LB * (LS - 1), LV, "float16", LV, 0, 0.0, None, 0,
     False, LH, False),
    # llama_3d's vocab-parallel head: shard statistics (mode 1) over
    # the step's 4 x 2048 tokens at H 2048
    ("llama_3d head, shard statistics", 4 * 2048, LV, "bfloat16", LV, 0,
     0.0, None, 1, False, 2048, False),
    ("wide, eps 0.1, padding_idx 0, shard", 2000, 20000, "bfloat16", 31000,
     10000, 0.1, 0, 0, False, 1024, False),
    ("wide, ragged", 999, 9001, "float32", 9000, 0, 0.0, None, 1, False,
     200 * 8 + 1, False),
    # BERT's fused MLM head: the ones column makes H + 1 (a 1538-byte
    # bf16 row: scalar loads), labels -1 outside the masked tokens; the
    # model pads it with zero columns to a multiple of 8 (776, 1032:
    # 16-byte copies)
    ("BERT-base MLM head", 8 * 512, 30522, "bfloat16", 30522, 0, 0.0, -1,
     0, False, 769, True),
    ("BERT-large MLM head", 4 * 512, 30522, "bfloat16", 30522, 0, 0.0, -1,
     0, False, 1025, True),
    ("BERT-base MLM head, padded", 8 * 512, 30522, "bfloat16", 30522, 0, 0.0,
     -1, 0, False, 776, True),
    ("BERT-large MLM head, padded", 4 * 512, 30522, "bfloat16", 30522, 0,
     0.0, -1, 0, False, 1032, True),
]


def lxent_grads_ref(torch, x, w, t, lse, dloss, off, K, eps, pad, acc,
                    round_g, absolute=False):
    """dx and dW of the linear-xent backward as the plain versions
    compute them (vocab chunks, fp32 products), but with the logits and
    G evaluated in ``acc`` (float32 or float64) and G rounded to the
    operand type only with ``round_g``. Two of these that differ only in
    ``acc`` differ only by the rounding of the logits' sums. With
    ``absolute`` the products of |G|, |W| and |x| in fp32 (the sums of
    absolute products `rounding_errs` takes)."""
    from apex1_tpu_torch.ops.linear_xent import PLAIN_CHUNK
    T, H = x.shape
    dl = dloss.to(acc)[:, None]
    if pad is not None:
        dl = torch.where(t[:, None] == pad, 0.0, dl)
    lse_a, xa, xf = lse.to(acc)[:, None], x.to(acc), x.float()
    if absolute:
        xf = xf.abs()
    dx = torch.zeros(T, H, dtype=torch.float32, device=x.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    for c0 in range(0, w.shape[0], PLAIN_CHUNK):
        wc = w[c0:c0 + PLAIN_CHUNK]
        s = xa @ wc.to(acc).t()
        gcol = off + c0 + torch.arange(s.shape[1], device=x.device)[None, :]
        valid = gcol < K
        g = (torch.where(valid, torch.exp(s - lse_a), 0.0)
             - (1.0 - eps) * (gcol == t[:, None]).to(acc) - eps / K)
        g = (torch.where(valid, g, 0.0) * dl).float()
        if round_g:
            g = g.to(x.dtype).float()
        wf = wc.float()
        if absolute:
            g, wf = g.abs(), wf.abs()
        dx += g @ wf
        dw[c0:c0 + g.shape[1]] = g.t() @ xf
    if absolute:
        return dx, dw
    return dx.to(x.dtype), dw.to(w.dtype)


def lxent_witness(torch, args, got, plain):
    """Why no flat one-ulp rule holds the backward: the worst error over
    the one-ulp allowance (`TOLS`) of (dx, dW) between the kernel and
    the plain version (``kernel``), between two plain versions that
    differ only in summing the logits in fp32 or fp64 (``rounded``),
    and between the same two without G's rounding to the operand type
    (``unrounded``). ``rounded`` near or past 1 says that G's rounding
    turns a last-bit difference in the logits into an ulp of the output
    (the pass rule is `rounding_errs`).
    ``args`` are `lxent_grads_ref`'s (x, W, labels, lse, dloss,
    col_offset, K, smoothing, padding_idx)."""
    tol = TOLS[str(args[0].dtype)[6:]]
    out = {"kernel": [max_errs(g, p, *tol)[1] for g, p in zip(got, plain)]}
    for label, rnd in (("rounded", True), ("unrounded", False)):
        a = lxent_grads_ref(torch, *args, torch.float32, rnd)
        b = lxent_grads_ref(torch, *args, torch.float64, rnd)
        out[label] = [max_errs(u, v, *tol)[1] for u, v in zip(a, b)]
        del a, b
    return out


def check_lxent(torch, ops, gen):
    """Kernels 7-11 (the linear-xent forward in its three modes, dx, dW)
    against their plain versions. The forward of a mode-1/2 case runs
    both modes and must give the same bits packed; the forward, dx and
    dW each run twice for the same bits; a half-precision case also
    reports `lxent_witness`. Plain versions are timed at the main case and at
    the mode-1/2 cases (kernels 8 and 9). The library yardstick (main
    case) is the materialized pair: ``torch.mm(x, W.T,
    out_dtype=float32)`` and ``F.cross_entropy``, and for the backward
    that pair's backward (the cross-entropy's, then the two products in
    the operand type). Bounds count the valid (token, column) pairs of
    the case: 2·H flops a pair a product (forward 1, dx and dW 2
    each)."""
    import torch.nn.functional as F
    from apex1_tpu_torch.ops.linear_xent import (lxent_dw, lxent_dx, lxent_fwd,
                                                 lxent_grads)
    fwd, dx_rows, dw_rows = [], [], []
    for (case, T, Vl, dts, K, off, eps, pad, mode, main,
         *wide) in LXENT_CASES:
        H, timed_plain = wide if wide else (TH, main or mode != 0)
        dt = getattr(torch, dts)
        # logits of the same spread at every H
        x = (torch.randn(T, H, generator=gen, device="cuda") * 0.5).to(dt)
        w = (torch.randn(Vl, H, generator=gen, device="cuda") * 0.5
             * (TH / H) ** 0.5).to(dt)
        t = torch.randint(0, K, (T,), generator=gen, device="cuda")
        if pad is not None:
            t[::7] = pad
        n_valid = max(0, min(Vl, K - off))
        label = (f"{case} T={T} V_l={Vl} H={H} K={K} off={off} eps={eps} "
                 f"pad={pad} mode={mode} {dts}")
        kw = dict(num_classes=K, col_offset=off)
        fkw = dict(kw, smoothing=eps, padding_idx=pad)
        tol32 = TOLS["float32"]

        def run_f(m=mode):
            return lxent_fwd(x, w, t, mode=m, **(fkw if m == 0 else kw))

        got, again = run_f(), run_f()
        same_f = (torch.equal(got, again) if mode == 2
                  else all(map(torch.equal, got, again)))
        del again
        with ops.force_impl("torch"):
            want = run_f(0 if mode == 0 else 1)
        torch.cuda.synchronize()
        packed_equal = True
        if mode == 0:
            e_f = max_errs_all(zip(got, want), tol32)
            lse_w = want[1]
        else:
            other = run_f(3 - mode)
            pk, four = (got, other) if mode == 2 else (other, got)
            packed_equal = torch.equal(pk, torch.stack(four, dim=1))
            e_f = max_errs_all(zip(four, want), tol32)
            lse_w = want[0] + torch.log(want[1])
        # every case's kernels take 0.5 ms or more: CUDA events suffice
        ms_f = event_ms(run_f)
        pl_f = pl_dx = pl_dw = None
        if timed_plain:
            with ops.force_impl("torch"):
                pl_f = event_ms(run_f, iters=2)
        dloss = (torch.full((T,), 1.0 / T, device="cuda") if main else
                 torch.randn(T, generator=gen, device="cuda"))
        bkw = dict(fkw) if mode == 0 else dict(kw)

        def run_dx():
            return lxent_dx(x, w, t, lse_w, dloss, **bkw)

        def run_dw():
            return lxent_dw(x, w, t, lse_w, dloss, **bkw)

        def run_both():
            return lxent_grads(x, w, t, lse_w, dloss, **bkw)

        gdx, gdw = run_dx(), run_dw()
        # twice alone, and once together (one G for both products)
        both = run_both()
        same_dx = torch.equal(run_dx(), gdx) and torch.equal(both[0], gdx)
        same_dw = torch.equal(run_dw(), gdw) and torch.equal(both[1], gdw)
        del both
        with ops.force_impl("torch"):
            wdx, wdw = run_dx(), run_dw()
        torch.cuda.synchronize()
        if dt == torch.float32:
            e_dx, e_dw = (max_errs(g, p, *TOLS[dts])
                          for g, p in ((gdx, wdx), (gdw, wdw)))
        else:
            absprod = lxent_grads_ref(torch, x, w, t, lse_w, dloss, off, K,
                                      bkw.get("smoothing", 0.0),
                                      bkw.get("padding_idx"), torch.float32,
                                      False, absolute=True)
            # G's other operand: W's rows for dx, x's for dW
            e_dx, e_dw = (
                rounding_errs(g, p, a, UNIT[dts], 2, ETA[dts],
                              o.float().abs().sum(0))
                for g, p, a, o in ((gdx, wdx, absprod[0], w),
                                   (gdw, wdw, absprod[1], x)))
            del absprod
        # the rows past num_classes must be exactly zero
        if gdw[n_valid:].any() or wdw[n_valid:].any():
            e_dw = (e_dw[0], math.inf)
        witness = None
        if dt != torch.float32:
            witness = lxent_witness(
                torch, (x, w, t, lse_w, dloss, off, K, eps, pad),
                (gdx, gdw), (wdx, wdw))
        ms_dx, ms_dw = event_ms(run_dx), event_ms(run_dw)
        ms_both = event_ms(run_both)
        if timed_plain:
            with ops.force_impl("torch"):
                pl_dx = event_ms(run_dx, iters=2)
                pl_dw = event_ms(run_dw, iters=2)
        lib_f = lib_b = None
        if main or (wide and timed_plain):
            wk = w[:n_valid]
            ign = -100 if pad is None else pad

            def lib_logits():
                return (torch.mm(x, wk.t(), out_dtype=torch.float32)
                        if dt != torch.float32 else x @ wk.t())

            lib_f = event_ms(lambda: F.cross_entropy(
                lib_logits(), t, reduction="none", label_smoothing=eps,
                ignore_index=ign))
            lg = lib_logits().requires_grad_()
            ce = F.cross_entropy(lg, t, reduction="none",
                                 label_smoothing=eps, ignore_index=ign)

            def lib_bwd():
                g, = torch.autograd.grad(ce, lg, dloss, retain_graph=True)
                gh = g.to(dt)
                return gh @ wk, gh.t() @ x

            lib_b = event_ms(lib_bwd)
            del lg, ce
        eb = x.element_size()
        ops_f = 2 * T * n_valid * H
        opnd = T * H * eb + Vl * H * eb + T * 4
        peak = F32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
        b_f = bound_ms(opnd + T * 4 * (2 if mode == 0 else 4), ops_f, peak)
        b_dx = bound_ms(opnd + 8 * T + T * H * eb, 2 * ops_f, peak)
        b_dw = bound_ms(opnd + 8 * T + Vl * H * eb, 2 * ops_f, peak)
        fwd.append(dict(case=label, abs=e_f[0], worst=e_f[1], tol=tol32,
                        ms=ms_f, plain_ms=pl_f, library_ms=lib_f,
                        bound_ms=b_f[0], bound_by=b_f[1], main=main,
                        same_bits=same_f,
                        **({} if mode == 0 else
                           {"packed_equal": packed_equal})))
        for i, (rows, e, ms, pl, b, same) in enumerate((
                (dx_rows, e_dx, ms_dx, pl_dx, b_dx, same_dx),
                (dw_rows, e_dw, ms_dw, pl_dw, b_dw, same_dw))):
            rows.append(dict(case=label, abs=e[0], worst=e[1],
                             tol=TOLS[dts], ms=ms, plain_ms=pl,
                             library_ms=lib_b, bound_ms=b[0], bound_by=b[1],
                             main=main, same_bits=same, both_ms=ms_both,
                             **({} if dt == torch.float32 else {
                                 "rule": f"rounding bound of G, u="
                                         f"{UNIT[dts]:g}"}),
                             **({} if witness is None else {"one_ulp": {
                                 k: v[i] for k, v in witness.items()}})))
        del x, w, got, want, gdx, gdw, wdx, wdw
        torch.cuda.empty_cache()
    return fwd, dx_rows, dw_rows


#: the RoPE kernel's checks: (case, x shape (B, S, heads, D), dtype,
#: tables, interleaved, sign (-1: the backward), main)
ROPE_CASES = [
    ("q", (LB, LS, LHEADS, LD), "bfloat16", "shared", False, 1.0, True),
    ("q backward (-sin)", (LB, LS, LHEADS, LD), "bfloat16", "shared", False,
     -1.0, False),
    ("k, 8 KV heads", (LB, LS, LKV, LD), "bfloat16", "shared", False, 1.0,
     False),
    ("q per-row tables", (LB, LS, LHEADS, LD), "bfloat16", "per_row", False,
     1.0, False),
    ("q interleaved", (LB, LS, LHEADS, LD), "bfloat16", "shared", True, 1.0,
     False),
    ("q", (LB, LS, LHEADS, LD), "float16", "shared", False, 1.0, False),
    ("small", (2, 256, LHEADS, LD), "float32", "shared", False, 1.0, False),
    ("head_dim 256", (2, 1024, 8, 256), "bfloat16", "shared", False, 1.0,
     False),
    ("decode step, per-row", (8, 1, LHEADS, LD), "bfloat16", "per_row",
     False, 1.0, False),
    # the speculative phase's target and draft (the bench's decode model,
    # 32 heads of 64): the prefill and a verify chunk of K + 1 = 5
    ("head_dim 64 prefill, per-row", (8, 128, 32, 64), "bfloat16",
     "per_row", False, 1.0, True),
    ("head_dim 64 verify chunk, per-row", (8, 5, 32, 64), "bfloat16",
     "per_row", False, 1.0, False),
    # the bench's llama_3d (LLAMA_08B widths, 1 x L3D_S a microbatch):
    # q and k, forward and backward
    ("llama_3d q", (1, 2048, 32, 64), "bfloat16", "shared", False, 1.0,
     False),
    ("llama_3d q backward (-sin)", (1, 2048, 32, 64), "bfloat16", "shared",
     False, -1.0, False),
    ("llama_3d k, 4 KV heads", (1, 2048, 4, 64), "bfloat16", "shared",
     False, 1.0, False),
    ("llama_3d k backward (-sin)", (1, 2048, 4, 64), "bfloat16", "shared",
     False, -1.0, False),
]


def check_rope(torch, ops, gen):
    """Kernel 12 against its plain version: the same fp32 operations,
    each rounded once in the same order, so the bits must be equal.
    Bytes bound it: x read and the output written once, the tables read
    once. No single PyTorch call computes it (no library time)."""
    from apex1_tpu_torch.ops.rope import rope_tables, rotate
    results = []
    for case, shape, dts, tables, inter, sign, main in ROPE_CASES:
        dt = getattr(torch, dts)
        B, S, _, D = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        if tables == "per_row":
            pos = torch.randint(0, 8192, (B * S,), generator=gen,
                                device="cuda")
            c, s = (t.reshape(B, S, -1) for t in
                    rope_tables(pos, D, base=500000.0))
        else:
            c, s = rope_tables(torch.arange(S, device="cuda"), D,
                               base=500000.0)

        def run():
            return rotate(x, c, s, interleaved=inter, seq_axis=1, sign=sign)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS[dts]
        abs_e, worst = max_errs(got, want, *tol)
        ms = graph_ms(run, iters=20)
        plain = None
        if main:
            with ops.force_impl("torch"):
                plain = graph_ms(run, iters=5)
        bnd, by = bound_ms(2 * x.numel() * x.element_size()
                           + 2 * c.numel() * 4, 3 * x.numel())
        results.append(dict(
            case=f"{case} {tuple(shape)} {dts} {tables} tables"
                 + (" interleaved" if inter else ""),
            abs=abs_e, worst=worst, tol=tol, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=bnd, bound_by=by, main=main,
            equal_bits=bool(torch.equal(got, want))))
        del x, got, want
    return results


#: the fused-glu kernel's checks: (case, T, H, F, dtype, activation, main)
GLU_CASES = [
    ("Llama MLP", LB * LS, LH, LFFN, "bfloat16", "silu", True),
    ("Llama MLP", 2048, LH, LFFN, "float16", "silu", False),
    ("GeGLU", 2048, LH, LFFN, "bfloat16", "gelu", False),
    ("serving chunk, 8 x 64 rows", 8 * 64, LH, LFFN, "bfloat16", "silu",
     False),
    ("small", 512, 1024, 2048, "float32", "silu", False),
    ("ragged", 1000, 200, 1000, "bfloat16", "silu", False),
]


def check_glu(torch, ops, gen):
    """Kernel 13 against its plain version (fp32 products and epilogue,
    one rounding). Operations bound it: 4·T·H·F flops. The library
    yardstick (main case) is the unfused pair: two ``torch.mm`` in the
    operand type and ``F.silu(g) * u``."""
    F = torch.nn.functional
    from apex1_tpu_torch.ops.fused_dense import glu_fwd
    results = []
    for case, T, H, Fo, dts, act, main in GLU_CASES:
        dt = getattr(torch, dts)
        x = torch.randn(T, H, generator=gen, device="cuda").to(dt)
        wg = (torch.randn(H, Fo, generator=gen, device="cuda")
              * H ** -0.5).to(dt)
        wu = (torch.randn(H, Fo, generator=gen, device="cuda")
              * H ** -0.5).to(dt)

        def run():
            return glu_fwd(x, wg, wu, act)

        got = run()
        with ops.force_impl("torch"):
            want = run()
        torch.cuda.synchronize()
        tol = TOLS[dts]
        abs_e, worst = max_errs(got, want, *tol)
        flops = 4 * T * H * Fo
        timer = event_ms if flops > 1e11 else graph_ms
        ms = timer(run)
        plain = lib = None
        if main:
            with ops.force_impl("torch"):
                plain = event_ms(run, iters=2)
            lib = event_ms(lambda: F.silu(torch.mm(x, wg)) * torch.mm(x, wu))
        es = x.element_size()
        bnd, by = bound_ms((T * H + 2 * H * Fo + T * Fo) * es, flops,
                           F32_OPS_PER_S if dt == torch.float32
                           else BF16_OPS_PER_S)
        results.append(dict(case=f"{case} T={T} H={H} F={Fo} {dts} {act}",
                            abs=abs_e, worst=worst, tol=tol, ms=ms,
                            plain_ms=plain, library_ms=lib, bound_ms=bnd,
                            bound_by=by, main=main))
        del x, wg, wu, got, want
        torch.cuda.empty_cache()
    return results


#: the int8 kernel's checks (row 20): (case, T, N, K, main). The decode
#: model's (`LLAMA_08B`) projections at decode's 8 rows and generate's
#: 8 x 128 prefill rows, and a ragged case (K % 16 != 0: scalar loads)
INT8_CASES = [
    ("decode, w_gate/w_up", 8, 5632, 2048, True),
    ("decode, the head", 8, LV, 2048, False),
    ("decode, wk/wv", 8, 256, 2048, False),
    ("decode, w_down", 8, 2048, 5632, False),
    ("prefill, wk/wv", 1024, 256, 2048, False),
    ("prefill, w_gate/w_up", 1024, 5632, 2048, False),
    ("ragged", 5, 200, 72, False),
]


#: the bytes a cold timing cycles its operands' copies over: twice the
#: H100's 50 MB L2, so each call finds its weight in device memory, as a
#: decode step that reads every layer's weights once does
COLD_BYTES = 100e6


def cycled(fns):
    """One function calling ``fns`` in turn, one a call: given copies of
    an operand enough to exceed L2, each call reads it from device
    memory (a CUDA graph captures the turns as they fall)."""
    turn = [0]

    def run():
        fn = fns[turn[0] % len(fns)]
        turn[0] += 1
        return fn()
    return run


def int8_cold(torch, mm, x, wq, s, wb, timer):
    """(kernel ms, library ms) with the weight cold: ``mm`` over copies
    of ``wq`` and ``torch.mm`` over copies of the dequantized ``wb``,
    each cycled over `COLD_BYTES` (`cycled`)."""
    N, K = wq.shape
    ws = [wq.clone() for _ in range(max(1, math.ceil(COLD_BYTES / (N * K))))]
    bs = [wb.clone()
          for _ in range(max(1, math.ceil(COLD_BYTES / (2 * N * K))))]
    ms = timer(cycled([lambda w=w: mm(x, w, s) for w in ws]))
    lib = timer(cycled([lambda b=b: torch.mm(x, b.t()) for b in bs]))
    del ws, bs
    return ms, lib


def check_int8_matmul(torch, ops, gen):
    """Kernel 20 against its plain version (bf16 x against the int8
    values, exact products, fp32 sums, the fp32 scale last): the same
    function summed in another order, held to the fp32 rounding bound
    (`rounding_errs`, no operand rounding); the same bits on a second
    launch. Bound: the bytes N·K + 2·T·K + 4·T·N + 4·N, or 2·T·N·K
    operations at the bf16 tensor-core rate. Library: ``torch.mm`` in
    bf16 over a dequantized bf16 copy of the weight (cuBLAS at twice the
    weight bytes), the dequantization not timed. ms and library ms are
    warm (one weight, L2-resident where it fits; CUDA-graph replays); the
    decode cases also time both cold (`int8_cold`), as a decode step
    finds its weights."""
    from apex1_tpu_torch.ops.quantized import int8_mm, quantize_int8
    results = []
    for case, T, N, K, main in INT8_CASES:
        x = torch.randn(T, K, generator=gen, device="cuda").to(torch.bfloat16)
        wq, s = quantize_int8(torch.randn(N, K, generator=gen,
                                          device="cuda") * 0.02)

        def run():
            return int8_mm(x, wq, s)

        got = run()
        again = run()
        with ops.force_impl("torch"):
            want = run()
            absprod = int8_mm(x.abs(), wq.abs(), s)
        torch.cuda.synchronize()
        abs_e, worst = rounding_errs(got, want, absprod, 2.0 ** -24, 0)
        flops = 2 * T * N * K
        # CUDA-graph replays at every case: a prefill call (0.05 ms) is
        # shorter than its wrapper's host time
        timer = graph_ms
        ms = timer(run)
        with ops.force_impl("torch"):
            plain = event_ms(run, iters=3)
        wb = (wq.float() * s[:, None]).to(torch.bfloat16)
        lib = timer(lambda: torch.mm(x, wb.t()))
        bnd, by = bound_ms(N * K + 2 * T * K + 4 * T * N + 4 * N, flops,
                           BF16_OPS_PER_S)
        row = dict(
            case=f"{case} T={T} N={N} K={K}", abs=abs_e, worst=worst,
            tol=TOLS["float32"], rule="fp32 rounding bound (u=2^-24)",
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
            bound_by=by, main=main, same_bits=bool(torch.equal(got, again)))
        if case.startswith("decode"):
            row["cold_ms"], row["library_cold_ms"] = int8_cold(
                torch, int8_mm, x, wq, s, wb, timer)
        results.append(row)
        del x, wq, s, got, again, want, absprod, wb
        torch.cuda.empty_cache()
    return results


#: the LoRA delta's checks (row 23): (case, slots, verify width K + 1,
#: rank, hidden, vocab, hidden dtype, main). Slots take adapters 0, 1, 2
#: in turn and the last slot none (page 0); a verify repeats each slot's
#: page row over its K + 1 rows
LORA_CASES = [
    ("decode, 8 slots", 8, 1, 16, 2048, LV, "bfloat16", True),
    ("verify, 8 slots x 5", 8, 5, 16, 2048, LV, "bfloat16", False),
    ("prefill row", 1, 1, 16, 2048, LV, "bfloat16", False),
    ("f32, ragged vocab", 3, 2, 3, 100, 1001, "float32", False),
]


def lora_inputs(torch, gen, slots, width, R, H, V, dts):
    """h, the A and B page pools and the block table of a `LORA_CASES`
    case on the card: 1 + 4R pages (page 0 zero), slots taking adapters
    0, 1, 2 in turn and the last slot none, each slot's page row repeated
    over its ``width`` rows."""
    P = 1 + 4 * R
    a = torch.randn(P, H, generator=gen, device="cuda") * H ** -0.5
    b = torch.randn(P, V, generator=gen, device="cuda") * 0.25
    a[0], b[0] = 0.0, 0.0
    rows = torch.zeros(slots, R, dtype=torch.int32)
    for n in range(max(slots - 1, 1)):
        rows[n] = 1 + (n % 3) * R + torch.arange(R)
    bt = rows.repeat_interleave(width, dim=0).cuda()
    h = torch.randn(slots * width, H, generator=gen, device="cuda").to(
        getattr(torch, dts))
    return h, a, b, bt


def lora_bound(torch, h, bt, R, H, V):
    """The least time for a LoRA delta call: the bytes of h, of the
    distinct pages the rows name (each A and B row read once), of the
    block table and of the output; ops 2·N·R·(H + V) at the fp32 rate.
    Returns (ms, "bytes" or "operations", the distinct pages)."""
    N = h.shape[0]
    pages = int(torch.unique(bt).numel())
    bnd, by = bound_ms(h.numel() * h.element_size()
                       + pages * (H + V) * 4 + N * V * 4 + bt.numel() * 4,
                       2 * N * R * (H + V))
    return bnd, by, pages


def check_lora_delta(torch, ops, gen):
    """Kernel 23 against its plain version (gather, then two fp32
    einsums): the fp32 rounding bound; rows naming only page 0 exactly
    0.0; the same bits on a second launch; each row equal, bit for bit,
    to the same row computed in a batch of its own. Bound
    (`lora_bound`): bytes. No single PyTorch call computes it (library:
    none)."""
    from apex1_tpu_torch.ops.lora_epilogue import lora_delta
    results = []
    for case, slots, width, R, H, V, dts, main in LORA_CASES:
        h, a, b, bt = lora_inputs(torch, gen, slots, width, R, H, V, dts)
        N = h.shape[0]

        def run():
            return lora_delta(h, a, b, bt)

        got = run()
        again = run()
        solo = torch.cat([lora_delta(h[n:n + 1], a, b, bt[n:n + 1])
                          for n in range(N)])
        with ops.force_impl("torch"):
            want = run()
            absprod = lora_delta(h.abs(), a.abs(), b.abs(), bt)
        torch.cuda.synchronize()
        abs_e, worst = rounding_errs(got, want, absprod, 2.0 ** -24, 0)
        zero = (bt == 0).all(dim=1)
        ms = graph_ms(run)
        with ops.force_impl("torch"):
            plain = graph_ms(run, iters=5)
        bnd, by, pages = lora_bound(torch, h, bt, R, H, V)
        results.append(dict(
            case=f"{case} N={N} R={R} H={H} V={V} {dts} h, {pages} pages",
            abs=abs_e, worst=worst, tol=TOLS["float32"],
            rule="fp32 rounding bound (u=2^-24)", ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=bnd, bound_by=by, main=main,
            same_bits=bool(torch.equal(got, again)),
            solo_bits=bool(torch.equal(got, solo)),
            zero_rows=bool((got[zero] == 0).all())))
        del a, b, h, got, again, solo, want, absprod
        torch.cuda.empty_cache()
    return results


#: the chunk product's checks (rows 24-25 and row 27's product): (case,
#: leading dims of rows, K, N, dtype, main). The SP boundary MLP at world
#: 1 (`tools/bench_fused_comm.py`'s S 8192, hidden 2048, ffn 8192), a
#: tp = 8 rank's chunks, an (S, mb, hid) operand, ragged, fp16 and f32
CHUNK_CASES = [
    ("world-1 column product", (8192,), 2048, 8192, "bfloat16", True),
    ("world-1 row product", (8192,), 8192, 2048, "bfloat16", False),
    ("tp=8 column chunk", (1024,), 2048, 1024, "bfloat16", False),
    ("tp=8 row chunk", (1024,), 1024, 2048, "bfloat16", False),
    ("(S, mb, hid) operand", (512, 2), 2048, 1024, "bfloat16", False),
    ("ragged", (1000,), 1000, 999, "bfloat16", False),
    ("fp16", (1024,), 2048, 1024, "float16", False),
    ("f32", (1024,), 1024, 1024, "float32", False),
]


def check_chunk_matmul(torch, ops, gen):
    """Kernels 24-25 (and row 27's product) against the plain version,
    ``torch.matmul`` of the operands widened to fp32: the same exact
    products (fp32 rounded ones for f32) summed in another order, held
    to the fp32 rounding bound (`rounding_errs`, no operand rounding);
    the same bits on a second launch; with an fp32 accumulator (the
    rdma ring's epilogue) equal to ``acc + chunk_matmul(rows, w)`` bit
    for bit, its time printed as ``acc_ms``. Bound: the bytes M·K + K·N
    in the operand type and 4·M·N out, or 2·M·N·K operations at the
    operand type's peak. Library: ``torch.mm(..., out_dtype=
    torch.float32)`` on the same operands, the same function, where the
    card's PyTorch has it (else None, said on the case's line), and
    ``torch.mm`` writing the operand type (half the kernel's output
    bytes) named beside it. The case names the tile the kernel launches
    (`chunk_tile`)."""
    from apex1_tpu_torch.ops.fused_collective import chunk_matmul, chunk_tile
    results = []
    for case, lead, K, N, dts, main in CHUNK_CASES:
        dt = getattr(torch, dts)
        rows = (torch.randn(*lead, K, generator=gen, device="cuda")
                * K ** -0.5).to(dt)
        w = torch.randn(K, N, generator=gen, device="cuda").to(dt)
        acc = torch.randn(*lead, N, generator=gen, device="cuda")

        def run():
            return chunk_matmul(rows, w)

        got = run()
        again = run()
        with_acc = chunk_matmul(rows, w, acc)
        with ops.force_impl("torch"):
            want = run()
            absprod = chunk_matmul(rows.abs(), w.abs())
        torch.cuda.synchronize()
        abs_e, worst = rounding_errs(got, want, absprod, 2.0 ** -24, 0)
        M = rows.numel() // K
        flops = 2 * M * N * K
        timer = event_ms if flops > 1e11 else graph_ms
        ms = timer(run)
        acc_ms = timer(lambda: chunk_matmul(rows, w, acc))
        with ops.force_impl("torch"):
            plain = event_ms(run, iters=3)
        r2 = rows.reshape(M, K)
        lowp = timer(lambda: torch.mm(r2, w))
        if dt == torch.float32:
            lib, lib_note = lowp, "torch.mm"
        else:
            try:
                torch.mm(r2[:1], w[:, :1], out_dtype=torch.float32)
                lib = timer(lambda: torch.mm(r2, w, out_dtype=torch.float32))
                lib_note = "torch.mm out_dtype=float32"
            except (TypeError, RuntimeError, NotImplementedError):
                lib, lib_note = None, ("none: this PyTorch's torch.mm has "
                                       "no out_dtype=float32")
            lib_note += f"; torch.mm {dts} out ms={lowp:.4f}"
        es = rows.element_size()
        bnd, by = bound_ms((M * K + K * N) * es + 4 * M * N, flops,
                           F32_OPS_PER_S if dt == torch.float32
                           else BF16_OPS_PER_S)
        bm, bn = chunk_tile(M, N, dt)
        results.append(dict(
            case=f"{case} M={M} K={K} N={N} {dts} tile {bm}x{bn} "
                 f"(library: {lib_note})",
            abs=abs_e, worst=worst, tol=TOLS["float32"],
            rule="fp32 rounding bound (u=2^-24)", ms=ms, acc_ms=acc_ms,
            plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
            main=main, same_bits=bool(torch.equal(got, again)),
            equal_bits=bool(torch.equal(with_acc, acc + got))))
        del rows, w, acc, got, again, with_acc, want, absprod
        torch.cuda.empty_cache()
    return results


#: the merge flash's checks (row 26): (case, B, Hq, Hkv, S shard, dtype,
#: causal, segments, q_off, k_off, main). A cp = 8 rank's step at
#: `llama_longctx`'s 16384 tokens (2048 a shard, heads 32/4 of 64) off
#: and on the diagonal and with document segments, and the world-1 step
#: of the cp phase (all 16384)
MERGE_CASES = [
    ("cp=8 step, off the diagonal", 1, 32, 4, 2048, "bfloat16", True, False,
     3 * 2048, 1 * 2048, False),
    ("cp=8 step, diagonal", 1, 32, 4, 2048, "bfloat16", True, False,
     5 * 2048, 5 * 2048, False),
    ("cp=8 step, segments", 1, 32, 4, 2048, "bfloat16", True, True,
     2 * 2048, 2 * 2048, False),
    ("world 1", 1, 32, 4, 16384, "bfloat16", True, False, 0, 0, True),
    ("f32 ragged", 2, 4, 2, 200, "float32", True, False, 300, 100, False),
]
#: query rows a piece of the plain version (its scores are materialized)
MERGE_PLAIN_ROWS = 2048
#: the merge cases' head dim (`llama_longctx`'s)
MERGE_D = 64


def merge_plain(torch, ops, fn, q, qoff, prev_out, prev_lse, *rest):
    """The plain version of ``fn`` (`flash_fwd_merge`) over query rows in
    pieces of `MERGE_PLAIN_ROWS` (each with its own q offset): rows are
    independent, and the whole (S, S) score matrix of the 16384-token
    case does not fit the card."""
    k, v, qseg, kseg, scale, causal, k_off = rest
    outs, lses = [], []
    with ops.force_impl("torch"):
        for i in range(0, q.shape[2], MERGE_PLAIN_ROWS):
            sl = slice(i, i + MERGE_PLAIN_ROWS)
            o, l = fn(q[:, :, sl], k, v,
                      None if qseg is None else qseg[:, sl], kseg, scale,
                      causal, qoff + i, k_off, prev_out[:, :, sl],
                      prev_lse[:, :, sl])
            outs.append(o)
            lses.append(l)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def merge_case(torch, entry, gen):
    """The operands of a `MERGE_CASES` entry drawn from ``gen``: q, k, v,
    the carried fp32 (out, lse) (NEG_INF in the first rows: nothing
    carried yet), qseg, kseg and the softmax scale."""
    (_, B, Hq, Hkv, S, dts, _, segs, _, _, _) = entry
    dt, D = getattr(torch, dts), MERGE_D

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = rnd(B, Hq, S, D).to(dt), rnd(B, Hkv, S, D).to(dt), \
        rnd(B, Hkv, S, D).to(dt)
    po, plse = rnd(B, Hq, S, D) * 0.5, rnd(B, Hq, S) * 2 + 4
    plse[..., :7] = -1e30
    po[..., :7, :] = 0
    qseg = kseg = None
    if segs:
        qseg = kseg = torch.from_numpy(doc_segments(B, S, SEED)).cuda()
    return q, k, v, po, plse, qseg, kseg, 1.0 / math.sqrt(D)


def check_flash_merge(torch, ops, gen):
    """Kernel 26 (the flash forward's merge epilogue) against its plain
    version, `flash_fwd`'s followed by `merge_partials`, with a carried
    (out, lse) (NEG_INF in the first rows: nothing carried yet): out
    at the flash forward's rounding bound (its shard part rounds P and
    the output to the operand type; `rounding_errs` with the plain
    function on |v| and |prev_out|), lse at f32's; the same bits on a
    second launch. Bound: the valid (q, k) pairs, 4·D flops each at the
    operand type's peak, or the bytes of q, k, v, the carried fp32 (out,
    lse) read and written. No single PyTorch call computes the merged
    step: ``decomposed_ms`` times the port's two-step form, the
    `flash_fwd` kernel and `merge_partials` in PyTorch."""
    from apex1_tpu_torch.ops.attention import (_valid, flash_fwd,
                                               flash_fwd_merge,
                                               merge_partials)
    results = []
    for entry in MERGE_CASES:
        (case, B, Hq, Hkv, S, dts, causal, segs, q_off, k_off, main) = entry
        dt, D = getattr(torch, dts), MERGE_D
        q, k, v, po, plse, qseg, kseg, scale = merge_case(torch, entry, gen)

        def run():
            return flash_fwd_merge(q, k, v, qseg, kseg, scale, causal,
                                   q_off, k_off, po, plse)

        out, lse = run()
        out2, lse2 = run()
        torch.cuda.synchronize()
        rest = (k, v, qseg, kseg, scale, causal, k_off)
        t0 = time.perf_counter()
        wout, wlse = merge_plain(torch, ops, flash_fwd_merge, q, q_off, po,
                                 plse, *rest)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        if dt == torch.float32:
            e1 = max_errs(out, wout, *TOLS["float32"])
        else:
            absprod, _ = merge_plain(torch, ops, flash_fwd_merge, q, q_off,
                                     po.abs(), plse, k, v.abs(), *rest[2:])
            # the kernel rounds P (u·Σp|v|), and both sides round the
            # shard's output to the operand type (2u·|o_t|), weighted
            # by exp(lse_t - lse') <= 1: three sides
            e1 = rounding_errs(out, wout, absprod, UNIT[dts], 3)
            del absprod
        e2 = max_errs(lse, wlse, *TOLS["float32"])
        timer = event_ms if main else graph_ms
        ms = timer(run)

        def decomposed():
            o_t, l_t = flash_fwd(q, k, v, qseg, kseg, scale, causal, q_off,
                                 k_off)
            return merge_partials(po, plse, o_t, l_t)

        dec = timer(decomposed)
        pairs = 0
        for i in range(0, S, MERGE_PLAIN_ROWS):
            m = _valid(B, min(MERGE_PLAIN_ROWS, S - i), S,
                       None if qseg is None else qseg[:, i:i +
                                                       MERGE_PLAIN_ROWS],
                       kseg, causal, q_off + i, k_off, q.device)
            pairs += int(m.expand(B, 1, -1, -1).sum().item())
        es = q.element_size()
        bnd, by = bound_ms((q.numel() + k.numel() + v.numel()) * es
                           + 2 * 4 * (po.numel() + plse.numel()),
                           4 * D * pairs * Hq,
                           F32_OPS_PER_S if dt == torch.float32
                           else BF16_OPS_PER_S)
        results.append(dict(
            case=f"{case} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {dts} "
                 f"q_off={q_off} k_off={k_off}"
                 + (" segments" if segs else "")
                 + f" (decomposed flash_fwd + merge_partials "
                   f"ms={dec:.4f})",
            abs=max(e1[0], e2[0]), worst=max(e1[1], e2[1]),
            tol=TOLS[dts], rule=("flash rounding bound (out), f32 (lse)"
                                 if dt != torch.float32 else None),
            ms=ms, decomposed_ms=dec, plain_ms=plain, library_ms=None,
            bound_ms=bnd, bound_by=by, main=main,
            same_bits=bool(torch.equal(out, out2)
                           and torch.equal(lse, lse2))))
        if results[-1]["rule"] is None:
            del results[-1]["rule"]
        del q, k, v, po, plse, out, lse, out2, lse2, wout, wlse
        torch.cuda.empty_cache()
    return results


# ---- --compare: the kernels against another tree's ----------------------

#: the cases `--compare` times (`FLASH_CASES` and `MERGE_CASES` names)
COMPARE_FLASH = ("GPT-2 causal", "Llama GQA 32/8 causal",
                 "BERT padding, p=0", "T5 encoder, rel-pos bias")
COMPARE_MERGE = ("world 1", "cp=8 step, off the diagonal",
                 "cp=8 step, diagonal")


def other_library(tree: str):
    """The kernel library of the checkout at ``tree``, built by its own
    `_build` in a subprocess and loaded with this tree's flash entry
    points' signatures (unchanged between the two). Returns (library,
    build seconds)."""
    import ctypes
    from apex1_tpu_torch.ops import _build
    t0 = time.perf_counter()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from apex1_tpu_torch.ops import _build; print(_build.build())")
    out = subprocess.run([sys.executable, "-c", code, tree], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"building {tree} failed:\n{out.stdout[-3000:]}"
                           f"{out.stderr[-3000:]}")
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("apex1_flash"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, time.perf_counter() - t0


@contextlib.contextmanager
def kernels_of(lib):
    """Route the wrappers' launches to ``lib`` (None: this tree's)."""
    from apex1_tpu_torch.ops import _build
    prev = _build._STATE["lib"]
    if lib is not None:
        _build._STATE["lib"] = lib
    try:
        yield
    finally:
        _build._STATE["lib"] = prev


def ab_ms(fn, other, timer=None):
    """Device ms of ``fn`` through ``other``'s kernels and this tree's,
    timed in turns (other, this, this, other; by ``timer``, CUDA events
    around 10 calls each by default): (other's, this tree's), each the
    smaller of its two."""
    timer = timer or event_ms
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        with kernels_of(other if who == "other" else None):
            times[who].append(timer(fn))
    return min(times["other"]), min(times["this"])


def tree_ops(tree: str, *files):
    """TREE's own ``apex1_tpu_torch/ops`` modules ``files``, each loaded
    under another name and bound to one copy of TREE's own ``_build``
    (its entry points, signatures and library state): TREE's wrappers
    may launch entry points this tree's library lacks, or launch them in
    another sequence. Returns the modules in order."""
    import importlib.util

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(tree, "apex1_tpu_torch", "ops", rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load("tree_build", "_build.py")
    mods = []
    for rel in files:
        mod = load(f"tree_{rel[:-3]}", rel)
        mod._build = build
        mods.append(mod)
    return mods


def ab2_ms(other_fn, this_fn, timer=None):
    """`ab_ms` for two functions: (other's ms, this tree's ms), timed in
    turns other, this, this, other (by ``timer``, `event_ms` by
    default), each the smaller of its two."""
    timer = timer or event_ms
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        times[who].append(timer(other_fn if who == "other" else this_fn))
    return min(times["other"]), min(times["this"])


def median_ab2(other_fn, this_fn, timer=graph_ms):
    """`ab2_ms` by ``timer`` (CUDA-graph replays by default),
    `SOFTMAX_PAIRS` times: (other's median ms, this tree's median ms, the
    sorted speedups) — for calls of a few microseconds, where one pair's
    spread is the timer's own, or where the spread itself is read."""
    import statistics
    got = [ab2_ms(other_fn, this_fn, timer)
           for _ in range(SOFTMAX_PAIRS)]
    return (statistics.median(p[0] for p in got),
            statistics.median(p[1] for p in got),
            sorted(a / b for a, b in got))


#: `--compare`'s linear-xent heads (bf16): (case, T, V, H, K, padding_idx)
COMPARE_LXENT = (
    ("GPT-2 head", TB * (TS - 1), TV_PAD, TH, TV, None),
    ("Llama head", LB * (LS - 1), LV, LH, LV, None),
    ("BERT-base MLM head", 8 * 512, 30522, 769, 30522, -1),
    ("BERT-base MLM head, padded", 8 * 512, 30522, 776, 30522, -1),
    ("BERT-large MLM head", 4 * 512, 30522, 1025, 30522, -1),
    ("BERT-large MLM head, padded", 4 * 512, 30522, 1032, 30522, -1))
#: `--compare`'s sweep of this tree's `lxent_grads` over the vocab rows
#: of a chunk (`WIDE_G_BYTES` set to hold that many)
COMPARE_CHUNKS = (4096, 8192, 16384, 32768)


def lxent_products_ms(torch, x, w, t, lse, dloss, K, pad):
    """This tree's three bf16/fp16 backward products timed apart over
    every vocab chunk (`wg_chunk` rows), as `lxent_grads` launches them:
    (G ms, dx ms, dW ms), each launched alone (the operands' values do
    not change the work)."""
    from apex1_tpu_torch.ops import _build
    from apex1_tpu_torch.ops._common import DTYPE_CODES
    from apex1_tpu_torch.ops.linear_xent import wg_chunk
    (T, H), V = x.shape, w.shape[0]
    chunk = wg_chunk(T, V, x.element_size())
    ldg = -(-chunk // 8) * 8
    g = torch.zeros(T * ldg, dtype=x.dtype, device="cuda")
    acc = torch.zeros(T, H, dtype=torch.float32, device="cuda")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    t32 = t.to(torch.int32)
    es, code = x.element_size(), DTYPE_CODES[x.dtype]
    vec = int(H % 8 == 0)
    stream = torch.cuda.current_stream().cuda_stream
    chunks = [(c0, min(chunk, V - c0)) for c0 in range(0, V, chunk)]

    def grad():
        for c0, n in chunks:
            _build.launch("apex1_lxent_wg_grad", x.data_ptr(),
                          w.data_ptr() + c0 * H * es, t32.data_ptr(),
                          lse.data_ptr(), dloss.data_ptr(), g.data_ptr(), T,
                          n, H, K, c0, 0.0, int(pad is not None),
                          -1 if pad is None else pad, -(-n // 8) * 8, vec,
                          code, stream)

    def dxp():
        for i, (c0, n) in enumerate(chunks):
            _build.launch("apex1_lxent_wg_dx", g.data_ptr(),
                          w.data_ptr() + c0 * H * es, acc.data_ptr(),
                          dx.data_ptr(), T, n, H, -(-n // 8) * 8,
                          int(i == 0), int(i == len(chunks) - 1), vec, code,
                          stream)

    def dwp():
        for c0, n in chunks:
            _build.launch("apex1_lxent_wg_dw", g.data_ptr(), x.data_ptr(),
                          dw.data_ptr() + c0 * H * es, T, n, H,
                          -(-n // 8) * 8, vec, code, stream)

    return event_ms(grad), event_ms(dxp), event_ms(dwp)


def compare_lxent(torch, card, other):
    """``--compare``'s linear-xent rows (TPU rows 7-11): ``lxent_fwd`` in
    mode 0, ``lxent_dx`` alone, ``lxent_dw`` alone and ``lxent_grads`` at
    `COMPARE_LXENT`'s heads in bf16, and ``lxent_fwd`` in modes 1 and 2
    at `LXENT_CASES`' bf16 shard and DPO cases, through ``other``, TREE's
    own ``linear_xent`` bound to its own library (`tree_ops`), and this
    tree's, in turns on the same inputs (`ab2_ms`); then this tree's
    three backward products apart (`lxent_products_ms`, with their
    TFLOP/s) and ``lxent_grads`` at each `COMPARE_CHUNKS` chunk and at
    `wg_chunk`'s. Returns the rows."""
    from apex1_tpu_torch.ops import linear_xent as lx
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for case, T, V, H, K, pad in COMPARE_LXENT:
        x = (torch.randn(T, H, generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16)
        w = (torch.randn(V, H, generator=gen, device="cuda") * 0.5
             * (TH / H) ** 0.5).to(torch.bfloat16)
        t = torch.randint(0, K, (T,), generator=gen, device="cuda")
        if pad is not None:
            t[::7] = pad
        kw = dict(num_classes=K, padding_idx=pad)
        flop = 2.0 * T * K * H
        was, now = ab2_ms(lambda: other.lxent_fwd(x, w, t, **kw),
                          lambda: lx.lxent_fwd(x, w, t, **kw))
        rows.append(dict(kernel="lxent_fwd",
                         case=f"{case} H={H} mode 0, "
                              f"{flop / now / 1e9:.1f} TFLOP/s",
                         other_ms=was, ms=now, speedup=was / now))
        _, lse = lx.lxent_fwd(x, w, t, **kw)
        dloss = torch.full((T,), 1.0 / T, device="cuda")
        for name in ("lxent_dx", "lxent_dw", "lxent_grads"):
            was, now = ab2_ms(
                lambda: getattr(other, name)(x, w, t, lse, dloss, **kw),
                lambda: getattr(lx, name)(x, w, t, lse, dloss, **kw))
            rows.append(dict(kernel=name, case=f"{case} H={H}",
                             other_ms=was, ms=now, speedup=was / now))
        parts = lxent_products_ms(torch, x, w, t, lse, dloss, K, pad)
        chunk_ms = {}
        prev = lx.WIDE_G_BYTES
        try:
            for c in COMPARE_CHUNKS:
                lx.WIDE_G_BYTES = c * T * x.element_size()
                chunk_ms[c] = event_ms(
                    lambda: lx.lxent_grads(x, w, t, lse, dloss, **kw))
        finally:
            lx.WIDE_G_BYTES = prev
        rows.append(dict(kernel="products", case=f"{case} H={H}",
                         grad_ms=parts[0], dx_ms=parts[1], dw_ms=parts[2],
                         tflops=[flop / m / 1e9 for m in parts],
                         chunk=lx.wg_chunk(T, V, x.element_size()),
                         grads_ms_by_chunk=chunk_ms))
        del x, w, t, lse, dloss
        torch.cuda.empty_cache()
    for case, T, Vl, dts, K, off, _, _, mode, _, *_ in LXENT_CASES:
        if mode == 0 or dts != "bfloat16":
            continue
        x = (torch.randn(T, TH, generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16)
        w = (torch.randn(Vl, TH, generator=gen, device="cuda")
             * 0.5).to(torch.bfloat16)
        t = torch.randint(0, K, (T,), generator=gen, device="cuda")
        kw = dict(num_classes=K, col_offset=off)
        flop = 2.0 * T * max(0, min(Vl, K - off)) * TH
        for m in (1, 2):
            was, now = ab2_ms(lambda: other.lxent_fwd(x, w, t, mode=m, **kw),
                              lambda: lx.lxent_fwd(x, w, t, mode=m, **kw),
                              graph_ms if flop < 1e11 else event_ms)
            rows.append(dict(kernel="lxent_fwd",
                             case=f"{case} T={T} V_l={Vl} mode {m}, "
                                  f"{flop / now / 1e9:.1f} TFLOP/s",
                             other_ms=was, ms=now, speedup=was / now))
        del x, w, t
        torch.cuda.empty_cache()
    for r in rows:
        if r["kernel"] == "products":
            print(f"phase compare: linear-xent products [{r['case']}] "
                  f"G ms={r['grad_ms']:.4f} dx ms={r['dx_ms']:.4f} "
                  f"dW ms={r['dw_ms']:.4f} TFLOP/s "
                  f"{', '.join(f'{v:.1f}' for v in r['tflops'])} "
                  f"(chunks of {r['chunk']} rows); lxent_grads ms by "
                  f"chunk rows "
                  f"{ {k: round(v, 4) for k, v in r['grads_ms_by_chunk'].items()} } "
                  f"[{card}]")
    return rows


def compare_int8(torch, other):
    """``--compare``'s int8_mm rows (TPU row 20): every `INT8_CASES` case
    through ``other``, TREE's own ``quantized`` bound to its own library
    (`tree_ops`: the split plan and launch arguments change with the
    kernel), and this tree's, in turns on the same inputs (`ab2_ms`,
    CUDA-graph replays); the decode cases also cold (each call's weight
    one of copies cycled over `COLD_BYTES`). Returns the rows, each with
    TFLOP/s and the weight's GB/s."""
    from apex1_tpu_torch.ops.quantized import int8_mm, quantize_int8
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for case, T, N, K, _ in INT8_CASES:
        x = torch.randn(T, K, generator=gen, device="cuda").to(torch.bfloat16)
        wq, s = quantize_int8(torch.randn(N, K, generator=gen,
                                          device="cuda") * 0.02)
        flops = 2 * T * N * K
        copies = {"warm": [wq]}
        if case.startswith("decode"):
            copies["cold"] = [wq.clone() for _ in range(
                max(1, math.ceil(COLD_BYTES / (N * K))))]
        for how, ws in copies.items():
            was, now = ab2_ms(*(cycled([lambda w=w, mm=mm: mm(x, w, s)
                                        for w in ws])
                                for mm in (other.int8_mm, int8_mm)),
                              graph_ms)
            rows.append(dict(
                kernel="int8_mm",
                case=f"{case} {T}x{N}x{K} {how}, "
                     f"{flops / now / 1e9:.1f} TFLOP/s, "
                     f"{N * K / now / 1e6:.0f} GB/s of weight",
                other_ms=was, ms=now, speedup=was / now))
        del x, wq, s, copies
        torch.cuda.empty_cache()
    return rows


def compare_glu(torch, other):
    """``--compare``'s glu_fwd rows (TPU row 13): the bf16/fp16
    `GLU_CASES` cases through ``other``, TREE's own ``fused_dense``
    bound to its own library (`tree_ops`), and this tree's, in turns on
    the same inputs (`ab2_ms`). Returns the rows, each with the tile
    this tree launches and its TFLOP/s."""
    from apex1_tpu_torch.ops.fused_dense import glu_fwd, glu_tile
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for case, T, H, Fo, dts, act, _ in GLU_CASES:
        if dts == "float32":
            continue
        dt = getattr(torch, dts)
        x = torch.randn(T, H, generator=gen, device="cuda").to(dt)
        wg = (torch.randn(H, Fo, generator=gen, device="cuda")
              * H ** -0.5).to(dt)
        wu = (torch.randn(H, Fo, generator=gen, device="cuda")
              * H ** -0.5).to(dt)
        flops = 4 * T * H * Fo
        was, now = ab2_ms(lambda: other.glu_fwd(x, wg, wu, act),
                          lambda: glu_fwd(x, wg, wu, act),
                          event_ms if flops > 1e11 else graph_ms)
        bm, bn = glu_tile(T, Fo, dt)
        rows.append(dict(kernel="glu_fwd",
                         case=f"{case} {T}x{H}x{Fo} {dts} {act}, tile "
                              f"{bm}x{bn}, {flops / now / 1e9:.1f} TFLOP/s",
                         other_ms=was, ms=now, speedup=was / now))
        del x, wg, wu
        torch.cuda.empty_cache()
    return rows


def compare_norm(torch, other):
    """``--compare``'s norm forward rows (TPU row 1): every `NORM_CASES`
    case through ``other``, TREE's own ``layer_norm`` bound to its own
    library (`tree_ops`: TREE's wrapper may cast γ/β first), and this
    tree's, in turns on the same inputs (`ab2_ms`, CUDA-graph replays).
    Returns the rows, each with the GB/s it moves."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for R, H, dts, half_g, rms in NORM_CASES:
        dt = getattr(torch, dts)
        x, g, b = norm_inputs(torch, gen, R, H, dt, half_g)
        beta = None if rms else b
        nbytes = 2 * R * H * x.element_size()
        was, now = ab2_ms(
            lambda: other.layer_norm_fwd(x, g, beta, 1e-5, rms),
            lambda: layer_norm_fwd(x, g, beta, 1e-5, rms), graph_ms)
        rows.append(dict(kernel="layer_norm_fwd",
                         case=f"rows={R} H={H} {dts}"
                              + (" half γ/β" if half_g else "")
                              + (" RMS" if rms else "")
                              + f", {nbytes / now / 1e6:.0f} GB/s",
                         other_ms=was, ms=now, speedup=was / now))
        del x, g, b
    return rows


#: `--compare`'s softmax forward cases (TPU row 16): (case, shape,
#: dtype, mask) with mask "causal", "key" (a (B, 1, 1, Sk) key-padding
#: mask) or a `tests/test_torch_kernels_gpu.py` broadcast ("b1qk", "k",
#: "bh"): the kernels phase's two fp32 cases, the same in bf16 and fp16,
#: and the card tests' half-precision shapes
COMPARE_SOFTMAX = (
    [("GPT-2", (TB, THEADS, TS, TS), dts, mask)
     for dts in ("float32", "bfloat16", "float16")
     for mask in ("causal", "key")]
    + [("card test", (2, 3, sq, sk), dts, mask)
       for sq, sk in ((37, 53), (5, 1100))
       for dts in ("bfloat16", "float16")
       for mask in ("causal", "b1qk", "k", "bh")])


def softmax_inputs(torch, gen, shape, dts, mask):
    """x, the 4-D mask (None for causal) and whether causal, of a
    `COMPARE_SOFTMAX` case on the card."""
    B, nh, sq, sk = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(
        getattr(torch, dts))
    mshape = {"causal": None, "key": (B, 1, 1, sk), "b1qk": (B, 1, sq, sk),
              "k": (1, 1, 1, sk), "bh": (B, nh, 1, 1)}[mask]
    m4 = None if mshape is None else torch.where(
        torch.rand(mshape, generator=gen, device="cuda") < 0.1, -1e30, 0.0)
    return x, m4, mask == "causal"


#: `ab2_ms` pairs (`median_ab2`) a small `COMPARE_SOFTMAX` case takes,
#: and as many pairs of this tree's wrapper against itself, whose spread
#: is the timer's own at a call of a few microseconds; the sampler's and
#: the LoRA delta's cases take as many
SOFTMAX_PAIRS = 5


def compare_softmax(torch, other):
    """``--compare``'s softmax forward rows (TPU row 16): every
    `COMPARE_SOFTMAX` case through ``other``, TREE's own ``softmax``
    bound to its own library (`tree_ops`), and this tree's, in turns on
    the same inputs (`ab2_ms`: CUDA events for the GPT-2 shape, graph
    replays for the small ones); the GPT-2 rows also time
    ``torch.softmax`` on the precomputed masked scores, as the kernels
    phase does. A small case takes `SOFTMAX_PAIRS` pairs, and as many of
    this tree against itself (`median_ab2`): its row keeps the median
    times and both ranges of speedups, the second the timer's own spread.
    Returns the rows, each with the GB/s it moves."""
    from apex1_tpu_torch.ops.softmax import softmax_fwd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, shape, dts, mask in COMPARE_SOFTMAX:
        x, m4, causal = softmax_inputs(torch, gen, shape, dts, mask)
        big = x.numel() > 1 << 24
        fns = (lambda: other.softmax_fwd(x, m4, 0.125, causal),
               lambda: softmax_fwd(x, m4, 0.125, causal))
        if big:
            was, now = ab2_ms(*fns)
        else:
            was, now, ups = median_ab2(*fns)
            self_ups = median_ab2(fns[1], fns[1])[2]
        row = dict(kernel="softmax_fwd", case=f"{name} {shape} {dts} {mask}",
                   other_ms=was, ms=now, speedup=was / now)
        if not big:
            row["speedups"], row["self_speedups"] = ups, self_ups
            row["case"] += (
                f", {SOFTMAX_PAIRS} pairs {row['speedups'][0]:.2f}-"
                f"{row['speedups'][-1]:.2f}x, this tree against itself "
                f"{row['self_speedups'][0]:.2f}-"
                f"{row['self_speedups'][-1]:.2f}x")
        else:
            sq, sk = shape[-2:]
            keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril()
            pre = (torch.where(keep, x.float() * 0.125, -1e30) if causal
                   else x.float() * 0.125 + m4).to(x.dtype)
            row["library_ms"] = event_ms(lambda: torch.softmax(pre, dim=-1))
            n_read = x.numel() // sk * (sk + 1) // 2 if causal else x.numel()
            nbytes = (n_read + x.numel()) * x.element_size()
            row["case"] += f", {nbytes / now / 1e6:.0f} GB/s"
            del pre
        rows.append(row)
        del x, m4
        torch.cuda.empty_cache()
    return rows


def compare_norm_bwd(torch, other):
    """``--compare``'s norm backward rows (TPU row 2): every
    `NORM_BWD_CASES` case through ``other``, TREE's own ``layer_norm``
    bound to its own library (`tree_ops`: TREE's wrapper may cast γ
    first), and this tree's, in turns on the same inputs (`ab2_ms`,
    CUDA-graph replays), with ATen's backward alone
    (`norm_bwd_library_ms`) in the same call. Returns the rows, each
    with the GB/s it moves."""
    from apex1_tpu_torch.ops.layer_norm import layer_norm_bwd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, R, H, dts, rms in NORM_BWD_CASES:
        dt = getattr(torch, dts)
        x, dy, g, b, mean, rstd = norm_bwd_inputs(torch, gen, R, H, dt, rms)

        def run_other():
            return other.layer_norm_bwd(dy, x, g, mean, rstd, rms, not rms)

        def run():
            return layer_norm_bwd(dy, x, g, mean, rstd, rms, not rms)

        try:
            run_other()
        except ValueError:  # a width TREE's kernel does not take
            was, now = None, graph_ms(run)
        else:
            was, now = ab2_ms(run_other, run, graph_ms)
        lib = norm_bwd_library_ms(torch, x, dy, g, b, mean, rstd, rms)
        nbytes = 3 * R * H * x.element_size()
        rows.append(dict(kernel="layer_norm_bwd",
                         case=f"{name} rows={R} H={H} {dts}"
                              + (" RMS" if rms else " half γ/β"
                                 if dts != "float32" else "")
                              + f", {nbytes / now / 1e6:.0f} GB/s",
                         other_ms=was, ms=now,
                         speedup=None if was is None else was / now,
                         library_ms=lib))
        del x, dy, g, b
    return rows


#: `--compare`'s dbias cases (TPU row 6): every bias case of
#: `FLASH_CASES` but the fp32 one, in bf16
COMPARE_DBIAS = ("T5 encoder, rel-pos bias",
                 "T5 decoder, rel-pos bias, causal",
                 "key-padding mask, -1e4 and NEG_INF",
                 "T5 bias, padding segments", "T5 bias, dropout",
                 "bias (B, Hq), GQA 12/4, ragged, dlse")


def compare_dbias(torch, other):
    """``--compare``'s dbias rows (TPU row 6): `COMPARE_DBIAS`'s cases in
    bf16 through ``other``'s kernels (the entry point's C signature is
    unchanged, so this tree's wrapper launches either) and this tree's,
    in turns on the same inputs (`ab_ms`: CUDA events for T5's shapes,
    graph replays for the small ragged one), with the library's SDPA
    backward with the mask taking a gradient (`sdpa_bias_ms`). Returns
    the rows."""
    from apex1_tpu_torch.ops.attention import flash_dbias, flash_fwd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for entry in FLASH_CASES:
        if entry[0] not in COMPARE_DBIAS:
            continue
        entry = entry[:6] + ("bfloat16",) + entry[7:]
        (D, _, p, _, q, k, v, do, dlse, qseg, kseg, args, bias,
         kw) = flash_case(torch, entry, gen)
        out, lse = flash_fwd(q, k, v, *args, **kw)
        delta = (do.float() * out.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, dlse, *args)
        big = q.numel() >= 1 << 22
        was, now = ab_ms(lambda: flash_dbias(*bwd, **kw), other,
                         None if big else graph_ms)
        lib = sdpa_bias_ms(torch, q, k, v, bias, qseg, kseg, entry[7], p,
                           do)[2]
        rows.append(dict(kernel="flash_dbias",
                         case=f"{entry[0]} B={entry[1]} Hq={entry[2]} "
                              f"Sq={entry[4]} Sk={entry[5]} D={D} bf16 "
                              f"bias {tuple(bias.shape)}",
                         other_ms=was, ms=now, speedup=was / now,
                         library_ms=lib))
        del q, k, v, do, out, lse, delta, bwd, bias, kw
        torch.cuda.empty_cache()
    return rows


def compare_paged(torch, other):
    """``--compare``'s paged attention rows (TPU row 21): every
    `PAGED_CASES` case through ``other``, TREE's own ``paged_decode``
    bound to its own library (`tree_ops`: the entry point's C signature
    changed with the page split), and this tree's, in turns on the same
    inputs (`ab2_ms`, CUDA-graph replays), with the plain version's time.
    Returns the rows, each with the K/V GB/s it reads and its bound
    (`paged_bound`)."""
    from apex1_tpu_torch.ops import force_impl
    from apex1_tpu_torch.ops.paged_decode import paged_attend, paged_geometry
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for case, N, hq, hkv, S, pdt, D, P, T in PAGED_CASES:
        q, k, v, bt, L = paged_inputs(torch, gen, N, hq, hkv, S, pdt, D, P,
                                      T)
        was, now = ab2_ms(
            lambda: other.paged_attend(q, k, v, bt, L, total_len=T * P),
            lambda: paged_attend(q, k, v, bt, L, total_len=T * P), graph_ms)
        with force_impl("torch"):
            plain = graph_ms(
                lambda: paged_attend(q, k, v, bt, L, total_len=T * P),
                iters=5)
        seen = (L.cpu().long() + S).sum().item()
        kv_bytes = 2 * seen * hkv * D * k.element_size()
        splits = paged_geometry(N, hq, hkv, S, D, P, T)[0]
        bnd, by = paged_bound(torch, q, k, bt, L)
        rows.append(dict(kernel="paged_attend",
                         case=f"{case} N={N} Hq={hq} Hkv={hkv} S={S} D={D} "
                              f"P={P} T={T} {pdt} pages, {splits} splits, "
                              f"{kv_bytes / now / 1e6:.0f} GB/s of K/V",
                         other_ms=was, ms=now, speedup=was / now,
                         plain_ms=plain, bound_ms=bnd, bound_by=by))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def compare_sample(torch, other):
    """``--compare``'s sampler rows (TPU row 22): every `SAMPLE_CASES`
    case at each `SAMPLE_TEMPS` temperature through ``other``, TREE's own
    ``paged_decode`` bound to its own library (`tree_ops`: the entry
    point's C signature changed with the split), and this tree's, in
    turns on the same inputs (`median_ab2`), with the plain version,
    `torch.argmax` at T 0 and the bound (`sample_bound`). Returns the
    rows, each with the split count this tree launches."""
    from apex1_tpu_torch.ops import force_impl
    from apex1_tpu_torch.ops.paged_decode import fused_sample, sample_splits
    gen = torch.Generator().manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for case, R, V, v_eff in SAMPLE_CASES:
        lg, seeds, pos = sample_inputs(torch, gen, R, V)
        for temp in SAMPLE_TEMPS:
            kw = dict(temperature=temp, vocab_size=v_eff)
            was, now, ups = median_ab2(
                lambda: other.fused_sample(lg, seeds, pos, **kw),
                lambda: fused_sample(lg, seeds, pos, **kw))
            with force_impl("torch"):
                plain = graph_ms(lambda: fused_sample(lg, seeds, pos, **kw),
                                 iters=10)
            lib = (graph_ms(lambda: torch.argmax(lg[:, :v_eff], dim=-1))
                   if temp == 0.0 else None)
            bnd, by, int_ms = sample_bound(R, V, temp == 0.0)
            rows.append(dict(
                kernel="fused_sample",
                case=f"{case} R={R} V={V} vocab={v_eff} T={temp}, "
                     f"{sample_splits(R, V, sms)[0]} splits, "
                     f"{SOFTMAX_PAIRS} pairs {ups[0]:.2f}-{ups[-1]:.2f}x"
                     + ("" if temp == 0.0 else
                        f", INT32-rate bound {int_ms:.4f} ms"),
                other_ms=was, ms=now, speedup=was / now, plain_ms=plain,
                library_ms=lib, bound_ms=bnd, bound_by=by))
        del lg, seeds, pos
    return rows


def compare_lora(torch, other):
    """``--compare``'s LoRA delta rows (TPU row 23): every `LORA_CASES`
    case through ``other``, TREE's own ``lora_epilogue`` bound to its own
    library (`tree_ops`), and this tree's, in turns on the same inputs
    (`median_ab2`), with the plain version's time and the bound
    (`lora_bound`). Returns the rows, each with the blocks of this tree's
    stream kernel and the rows each takes (`lora_rows`)."""
    from apex1_tpu_torch.ops import force_impl
    from apex1_tpu_torch.ops.lora_epilogue import (lora_delta, lora_rows,
                                                   lora_tiles)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for case, slots, width, R, H, V, dts, _ in LORA_CASES:
        h, a, b, bt = lora_inputs(torch, gen, slots, width, R, H, V, dts)
        N = h.shape[0]
        was, now, ups = median_ab2(lambda: other.lora_delta(h, a, b, bt),
                                   lambda: lora_delta(h, a, b, bt))
        with force_impl("torch"):
            plain = graph_ms(lambda: lora_delta(h, a, b, bt), iters=5)
        bnd, by, pages = lora_bound(torch, h, bt, R, H, V)
        per = lora_rows(N, V, R, sms)
        rows.append(dict(
            kernel="lora_delta",
            case=f"{case} N={N} R={R} H={H} V={V} {dts} h, {pages} pages, "
                 f"{lora_tiles(V) * -(-N // per)} blocks of {per} rows, "
                 f"{SOFTMAX_PAIRS} pairs {ups[0]:.2f}-{ups[-1]:.2f}x",
            other_ms=was, ms=now, speedup=was / now, plain_ms=plain,
            library_ms=None, bound_ms=bnd, bound_by=by))
        del h, a, b, bt
        torch.cuda.empty_cache()
    return rows


def compare_xent(torch, other):
    """``--compare``'s cross-entropy rows (TPU rows 18-19): every
    `XENT_CASES` case through ``other``, TREE's own ``xentropy`` bound
    to its own library (`tree_ops`: the entry points' C signature may
    differ), and this tree's, in turns on the same inputs:
    `SOFTMAX_PAIRS` pairs (`median_ab2`; CUDA events at the GPT-2 head's
    cases, graph replays at NSP's and the ResNet head's), and as many of
    this tree against itself, whose spread is the timer's own; with the
    check's bounds (`xent_bounds`) and `xent_library_ms`. Returns the
    rows."""
    from apex1_tpu_torch.ops import force_impl
    from apex1_tpu_torch.ops.xentropy import xent_bwd, xent_fwd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, x, lab, eps, pad, K, dloss in xent_cases(torch, gen):
        timer = event_ms if x.numel() > 1 << 24 else graph_ms
        with force_impl("torch"):
            lse = xent_fwd(x, lab, eps, pad, K)[1]
        lib = xent_library_ms(torch, x, lab, eps, pad, K, dloss, timer)
        fns = (("xent_fwd", lambda: other.xent_fwd(x, lab, eps, pad, K),
                lambda: xent_fwd(x, lab, eps, pad, K)),
               ("xent_bwd",
                lambda: other.xent_bwd(x, lab, lse, dloss, eps, pad, K),
                lambda: xent_bwd(x, lab, lse, dloss, eps, pad, K)))
        for (kernel, was_fn, now_fn), lib_ms, (bnd, by) in zip(
                fns, lib, xent_bounds(x, K)):
            was, now, ups = median_ab2(was_fn, now_fn, timer)
            self_ups = median_ab2(now_fn, now_fn, timer)[2]
            rows.append(dict(
                kernel=kernel,
                case=f"{label}, {SOFTMAX_PAIRS} pairs {ups[0]:.2f}-"
                     f"{ups[-1]:.2f}x, this tree against itself "
                     f"{self_ups[0]:.2f}-{self_ups[-1]:.2f}x, "
                     f"{bnd / was:.0%} / {bnd / now:.0%} of the bound",
                other_ms=was, ms=now, speedup=was / now, library_ms=lib_ms,
                bound_ms=bnd, bound_by=by, speedups=ups,
                self_speedups=self_ups))
    return rows


#: `--compare`'s parts; the names after TREE pick some of them, none: all
COMPARE_PARTS = ("flash", "chunk", "lxent", "int8", "glu", "norm",
                 "softmax", "normbwd", "dbias", "paged", "sample", "lora",
                 "xent")


def compare_flash(torch, ops, card, tree: str, parts=COMPARE_PARTS) -> int:
    """``--compare TREE``: the flash forward, dq and dk/dv at
    `COMPARE_FLASH`'s cases and the merge forward at `COMPARE_MERGE`'s,
    through TREE's kernels (a checkout of another commit, built here)
    and this tree's, in turns on the same inputs (`ab_ms`); then the
    chunk product at `CHUNK_CASES`' bf16 cases (CUDA-graph replays
    below 0.1 TFLOP, as the kernels phase times them), the linear-xent
    backward (`compare_lxent`), int8_mm (`compare_int8`) and glu_fwd
    (`compare_glu`), the norm forward (`compare_norm`), the softmax
    forward (`compare_softmax`) and the norm backward
    (`compare_norm_bwd`), each through TREE's own wrappers and library
    (`tree_ops`) and this tree's (`ab2_ms`), dbias (`compare_dbias`, TREE's
    kernels under this tree's wrapper) and paged attention
    (`compare_paged`, TREE's own wrapper), the sampler (`compare_sample`),
    the LoRA delta (`compare_lora`) and the cross-entropy
    (`compare_xent`), each through TREE's own wrapper; ``parts``
    (`COMPARE_PARTS`) picks which. Prints a line
    per kernel and case and writes ``chiprun_out/compare.json``."""
    from apex1_tpu_torch.ops.attention import (flash_dkv, flash_dq,
                                               flash_fwd, flash_fwd_merge)
    from apex1_tpu_torch.ops.fused_collective import chunk_matmul, chunk_tile
    other, secs = other_library(tree)
    (other_lx, other_fc, other_q, other_fd, other_ln, other_sm, other_pd,
     other_lo, other_xe) = tree_ops(
        tree, "linear_xent.py", "fused_collective.py", "quantized.py",
        "fused_dense.py", "layer_norm.py", "softmax.py", "paged_decode.py",
        "lora_epilogue.py", "xentropy.py")
    print(f"phase compare: built {tree} in {secs:.1f} s [{card}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for entry in FLASH_CASES:
        if entry[0] not in COMPARE_FLASH or "flash" not in parts:
            continue
        (D, _, _, _, q, k, v, do, dlse, _, _, args, bias,
         kw) = flash_case(torch, entry, gen)
        out, lse = flash_fwd(q, k, v, *args, **kw)
        delta = (do.float() * out.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, dlse, *args)
        for name, fn in (
                ("flash_fwd", lambda: flash_fwd(q, k, v, *args, **kw)),
                ("flash_dq", lambda: flash_dq(*bwd, **kw)),
                ("flash_dkv", lambda: flash_dkv(*bwd, **kw))):
            was, now = ab_ms(fn, other)
            rows.append(dict(kernel=name, case=entry[0], other_ms=was,
                             ms=now, speedup=was / now))
        del q, k, v, do, out, lse, delta, bwd, bias, kw
        torch.cuda.empty_cache()
    for entry in MERGE_CASES:
        if entry[0] not in COMPARE_MERGE or "flash" not in parts:
            continue
        q, k, v, po, plse, qseg, kseg, scale = merge_case(torch, entry, gen)
        causal, q_off, k_off = entry[6], entry[8], entry[9]
        was, now = ab_ms(lambda: flash_fwd_merge(
            q, k, v, qseg, kseg, scale, causal, q_off, k_off, po, plse),
            other)
        rows.append(dict(kernel="flash_fwd_merge", case=entry[0],
                         other_ms=was, ms=now, speedup=was / now))
        del q, k, v, po, plse
        torch.cuda.empty_cache()
    for case, lead, K, N, dts, _ in CHUNK_CASES:
        if dts != "bfloat16" or "chunk" not in parts:
            continue
        a = (torch.randn(*lead, K, generator=gen, device="cuda")
             * K ** -0.5).to(torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device="cuda").to(
            torch.bfloat16)
        M = a.numel() // K
        flops = 2 * M * N * K
        was, now = ab2_ms(lambda: other_fc.chunk_matmul(a, w),
                          lambda: chunk_matmul(a, w),
                          event_ms if flops > 1e11 else graph_ms)
        bm, bn = chunk_tile(M, N, torch.bfloat16)
        rows.append(dict(kernel="chunk_matmul",
                         case=f"{case} {M}x{K}x{N}, tile {bm}x{bn}, "
                              f"{flops / now / 1e9:.1f} TFLOP/s",
                         other_ms=was, ms=now, speedup=was / now))
        del a, w
        torch.cuda.empty_cache()
    for part, fn in (("lxent", lambda: compare_lxent(torch, card, other_lx)),
                     ("int8", lambda: compare_int8(torch, other_q)),
                     ("glu", lambda: compare_glu(torch, other_fd)),
                     ("norm", lambda: compare_norm(torch, other_ln)),
                     ("softmax", lambda: compare_softmax(torch, other_sm)),
                     ("normbwd", lambda: compare_norm_bwd(torch, other_ln)),
                     ("dbias", lambda: compare_dbias(torch, other)),
                     ("paged", lambda: compare_paged(torch, other_pd)),
                     ("sample", lambda: compare_sample(torch, other_pd)),
                     ("lora", lambda: compare_lora(torch, other_lo)),
                     ("xent", lambda: compare_xent(torch, other_xe))):
        if part in parts:
            rows += fn()
    for r in (r for r in rows if "other_ms" in r):
        lib = ("" if r.get("library_ms") is None
               else f" library ms={r['library_ms']:.4f}")
        if "plain_ms" in r:
            lib += f" plain ms={r['plain_ms']:.4f}"
        if "bound_ms" in r:
            lib += f" bound ms={r['bound_ms']:.4f} ({r['bound_by']})"
        was = ("raises" if r["other_ms"] is None else
               f"ms={r['other_ms']:.4f}")
        speedup = ("" if r["speedup"] is None
                   else f" speedup {r['speedup']:.2f}x")
        print(f"phase compare: {r['kernel']} [{r['case']}] {tree} {was} "
              f"this tree ms={r['ms']:.4f}{speedup}{lib} [{card}]")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "compare.json"), "w") as f:
        json.dump({"card": card, "other": tree, "rows": rows}, f, indent=1)
    return 0


# ---- phases 3 and 4: the engine -----------------------------------------


def workload(vocab: int, seed: int):
    """16 requests: prompt lengths 32-512 from the seed, the first four
    sharing a 192-token prefix; 64 new tokens each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 192).astype(np.int32)
    reqs = []
    for i in range(16):
        n = int(rng.integers(32, 513))
        own = rng.integers(1, vocab, n).astype(np.int32)
        if i < 4:
            # 200-255 tokens: the chunk-aligned share point (the radix
            # cache's auto-registration length) is the shared 192
            own = np.concatenate([shared, own[:8 + n % 56]])
        reqs.append(dict(tokens=own, seed=1000 + i))
    return reqs


def serve(torch, cfg_kw, *, depth, policy, seed, device="cuda",
          llama=False):
    """Build GPT-2 (or with ``llama`` the llama_block model, with
    ``fused_mlp``) at full width, ``depth`` layers, from ``seed`` and
    serve the workload on ``device``; returns (token streams, engine,
    wall s, decode-only step wall ms, config)."""
    from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config,
                                 get_policy, gpt2_decoder,
                                 gpt2_params_from_jax, llama_decoder)
    from apex1_tpu_torch.models.gpt2 import init_params
    if llama:
        cfg, model = make_llama(policy, depth, seed, fused_mlp=True)
        apply_fn, make_cache = llama_decoder(model)
    else:
        cfg = GPT2Config.gpt2_125m(num_layers=depth,
                                   policy=get_policy(policy))
        model = gpt2_params_from_jax(init_params(cfg, seed), cfg, device)
        apply_fn, make_cache = gpt2_decoder(model)
    eng = Engine(apply_fn, make_cache, EngineConfig(**cfg_kw),
                 device=device)
    reqs = workload(cfg.vocab_size, seed)
    ids = [eng.submit(r["tokens"], max_new_tokens=64, seed=r["seed"])
           for r in reqs]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    step_ms = []
    t0 = time.perf_counter()
    while eng.scheduler.depth > 0 or any(s is not None
                                         for s in eng.slot_view()):
        chunks = eng.metrics.get_counter("prefill_chunks")
        ts = time.perf_counter()
        eng.step()
        if eng.metrics.get_counter("prefill_chunks") == chunks:
            step_ms.append((time.perf_counter() - ts) * 1e3)
    sync()
    wall = time.perf_counter() - t0
    streams = [[int(t) for t in eng.results[r].tokens] for r in ids]
    return streams, eng, wall, step_ms, cfg


ENGINE_KW = dict(paged=True, max_slots=8, max_len=1024, prefill_chunk=64,
                 vocab_size=50257, temperature=0.7)


def profile_decode(torch, steps: int = 10) -> dict:
    """``--profile``: where a full-batch decode step's time goes. Eight
    requests (256-token prompts) are admitted, then ``steps`` decode
    steps of GPT-2 124M at O2 run under torch.profiler. Returns the
    step's host wall, the device kernel time per step (the sum of the
    kernels' own device time), the device busy share, and the kernels
    with the most device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from apex1_tpu_torch import (Engine, EngineConfig, GPT2Config,
                                 get_policy, gpt2_decoder,
                                 gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.gpt2_125m(policy=get_policy("O2"))
    model = gpt2_params_from_jax(init_params(cfg, SEED), cfg)
    apply_fn, make_cache = gpt2_decoder(model)
    eng = Engine(apply_fn, make_cache, EngineConfig(**ENGINE_KW))
    rng = np.random.default_rng(SEED)
    for i in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 256).astype(np.int32),
                   max_new_tokens=8 + steps + 4, seed=i)
    for _ in range(4):                   # admit all eight, then warm up
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    return {"active": eng.n_active, **kernel_split(torch, prof, steps,
                                                   wall)}


def kernel_split(torch, prof, steps: int, wall: float, top: int = 12):
    """Per step: host wall, the device kernel time (the sum of the
    kernels' own device time), the device busy share, the linear-xent,
    norm backward and softmax forward kernels' device time, and the
    kernels with the most device time. Device-side entries only: the kernels
    themselves, not the CPU ops that launched them (their device time
    would count twice) nor the user annotations, whose device span is
    the whole step."""
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("serving/")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device = sum(r[1] for r in rows)
    # the fused LM head's kernels: in bf16/fp16 lxent_wg_* (the forward's
    # stats and fold, the backward's G, dx and dW); in fp32
    # lxent_fwd_kernel, lxent_bwd_kernel and, past H 768, lxw_*
    lxent = sum(ms for k, ms, _ in rows if "lxent" in k or "lxw_" in k)
    # the norm backward's kernels (ln_bwd_*) and the softmax forward's
    norm_bwd = sum(ms for k, ms, _ in rows if "ln_bwd" in k)
    sm_fwd = sum(ms for k, ms, _ in rows if "softmax_fwd" in k)
    return {"step_wall_ms": wall, "device_ms_per_step": device,
            "device_busy": device / wall, "lxent_ms_per_step": lxent,
            "norm_bwd_ms_per_step": norm_bwd,
            "softmax_fwd_ms_per_step": sm_fwd,
            "top": [{"name": k[:80], "ms_per_step": ms, "calls": c}
                    for k, ms, c in rows[:top]]}


def profiled_calls(torch, fn, calls: int = 3, top: int = 12) -> dict:
    """`kernel_split` of ``calls`` calls of ``fn()`` under
    torch.profiler (a call's host wall, device ms and busy share, the
    ``top`` largest kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    return kernel_split(torch, prof, calls, wall, top=top)


def profiled_steps(torch, state, step, batch, steps: int = 3) -> dict:
    """``steps`` more steps under torch.profiler: the step's host wall,
    device kernel ms and busy share, and the largest kernels."""
    box = [state]

    def one():
        box[0], _ = step(box[0], *batch)

    return profiled_calls(torch, one, steps, top=25)


def profile_train(torch, use_flash: bool, fuse_head: bool = False,
                  steps: int = 3) -> dict:
    """``--profile``: where a GPT-2 124M O2 training step's time goes
    (B x S tokens, the train phases' configuration, ``use_flash`` and
    ``fuse_head`` as given): two warm-up steps, then ``steps`` steps
    under torch.profiler; with the step's peak memory. (With 2 profiled
    steps, the third profiler session of a process once reported every
    kernel at half its time; 3 steps read consistently in any order.)"""
    _, state, step, batch = make_trainer(torch, "O2", 12, SEED,
                                         use_flash=use_flash,
                                         fuse_head=fuse_head)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, *batch)
    prof = profiled_steps(torch, state, step, batch, steps)
    return {"use_flash": use_flash, "fuse_head": fuse_head,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, **prof}


def profile_llama(torch, fused_mlp: bool, steps: int = 3) -> dict:
    """``--profile``: where a llama_block O2 training step's time goes
    (train-llama's configuration, ``fused_mlp`` as given), as
    `profile_train` measures it."""
    _, state, step, batch = make_llama_trainer(torch, "O2", LLAYERS, SEED,
                                               fused_mlp=fused_mlp)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, *batch)
    out = {"fused_mlp": fused_mlp,
           **profiled_steps(torch, state, step, batch, steps),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state, step, batch
    torch.cuda.empty_cache()
    return out


# ---- phases 5 to 8: training ---------------------------------------------


#: the head's kernels: the fused LM-head cross-entropy, or the
#: cross-entropy on materialized logits
HEAD_KERNELS = {True: ("lxent_fwd", "lxent_dx", "lxent_dw"),
                False: ("xent_fwd", "xent_bwd")}


def train_launches(num_layers: int, use_flash: bool,
                   fuse_head: bool = False, dropout: bool = False) -> dict:
    """Kernel launches per GPT-2 training step: two norms a block and
    the final one; one causal attention a block (the fused softmax, or
    the flash forward, dq and dk/dv); one head cross-entropy (the
    materialized one's forward and backward, or the fused head's
    forward, dx and dW); with dropout two bias-dropout-adds a block
    (the residual adds)."""
    n_norm = 2 * num_layers + 1
    attn = (("flash_fwd", "flash_dq", "flash_dkv") if use_flash
            else ("softmax_fwd", "softmax_bwd"))
    drop = ("bda_fwd", "bda_bwd") if dropout else ()
    return {"layer_norm_fwd": n_norm, "layer_norm_bwd": n_norm,
            **{name: num_layers for name in attn},
            **{name: 2 * num_layers for name in drop},
            **{name: 1 for name in HEAD_KERNELS[fuse_head]}}


def packed_batch(torch, vocab: int):
    """(tokens, segment_ids, positions), each (B, S) on the card: the
    first B rows `pack_documents` packs from documents of 64-2048
    tokens drawn from ``np.random.default_rng(1)``, chunk positions
    restarting at 0 (GPT-2's learned table)."""
    import numpy as np
    from apex1_tpu_torch.runtime import pack_documents
    rng = np.random.default_rng(1)
    docs = []
    while sum(map(len, docs)) < 2 * TB * TS:
        docs.append(rng.integers(0, vocab, int(rng.integers(64, 2049))))
    packed = pack_documents(docs, TS, restart_chunk_positions=True)
    return tuple(torch.from_numpy(a[:TB]).cuda() for a in packed)


def make_trainer(torch, level: str, depth: int, seed: int, factor=False,
                 use_flash=False, packed=False, fuse_head=False,
                 dropout=0.0, grad_psum_axes=(), tx=None, fsdp=False,
                 offset=False):
    """GPT-2 124M at full width (``depth`` layers), weights from
    ``seed``, under ``Amp(fused_adam(1e-4, weight_decay=0.01),
    opt_level=level)`` (or the optimizer ``tx``), its loss
    ``gpt2_loss_fn(fuse_head=...)``, and its batch: the B x S tokens of
    ``np.random.default_rng(0)``, or with ``packed`` a `packed_batch`;
    with ``dropout`` the model's dropout rate, the batch ending in an
    int base seed (``dropout_rng``, the tokens not packed).
    With ``factor`` the step takes a factor before the batch that
    multiplies the loss (inf forces an overflow), with ``offset`` one
    added to it (NaN poisons the loss and leaves the gradients finite:
    a step only the sentinel refuses); ``grad_psum_axes``
    averages the gradients over those mesh axes (the ddp phase). With
    ``fsdp`` the master params and the Adam moments are placed on
    `parallel_state`'s mesh by `fsdp_param_specs` and
    `shard_opt_state_specs`, and the loss gathers the params first
    (`core.mesh.gather`: ZeRO-3, the train-fsdp phase)."""
    import numpy as np
    from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                                 gpt2_loss_fn, gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.gpt2_125m(num_layers=depth, use_flash=use_flash,
                               policy=get_policy(level), dropout=dropout)
    model = gpt2_params_from_jax(init_params(cfg, seed), cfg, "cuda")
    amp = Amp(tx or fused_adam(1e-4, weight_decay=0.01), opt_level=level,
              grad_psum_axes=grad_psum_axes)
    params = dict(model.named_parameters())
    if fsdp:
        state = fsdp_state(amp, params)
        base0 = gpt2_loss_fn(model, fuse_head=fuse_head)

        def base(p, *b):
            from apex1_tpu_torch.core.mesh import gather
            return base0(gather(p), *b)
    else:
        state = amp.init(params)
        base = gpt2_loss_fn(model, fuse_head=fuse_head)
    loss_fn = ((lambda p, f, *b: base(p, *b) * f) if factor else
               (lambda p, o, *b: base(p, *b) + o) if offset else base)
    if packed:
        batch = packed_batch(torch, cfg.vocab_size)
    else:
        batch = (torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (TB, TS))).cuda(),)
    if dropout > 0.0:
        batch = batch + (None, None, SEED)
    return cfg, state, amp.make_train_step(loss_fn), batch


def fsdp_state(amp, params: dict):
    """``amp.init`` of ``params`` placed on `parallel_state`'s mesh by
    `fsdp_param_specs` (divisor: the fsdp degree), its moments placed
    by `shard_opt_state_specs` (each split as its parameter)."""
    import dataclasses
    from apex1_tpu_torch.core.mesh import place
    from apex1_tpu_torch.parallel.distributed_optimizer import (
        fsdp_param_specs, shard_opt_state_specs)
    from apex1_tpu_torch.transformer import parallel_state as ps
    mesh = ps.get_mesh()
    specs = fsdp_param_specs(params, divisor=mesh.size("fsdp"))
    state = amp.init(place(params, specs, mesh))
    opt = state.opt_state
    sspecs = shard_opt_state_specs(opt, param_specs=specs)
    opt = dataclasses.replace(opt, **{
        f: place(getattr(opt, f), getattr(sspecs, f), mesh)
        for f in ("exp_avg", "exp_avg_sq")})
    return dataclasses.replace(state, opt_state=opt)


def train(torch, ops, level: str, use_flash=False, packed=False,
          steps: int = 6, fuse_head=False, dropout=0.0):
    """``steps`` training steps of GPT-2 124M at ``level``; per step the
    loss, loss scale, skipped count, host wall (ending in a
    synchronize) and the kernel launches it made; and the peak device
    memory."""
    cfg, state, step, batch = make_trainer(torch, level, 12, SEED,
                                           use_flash=use_flash,
                                           packed=packed,
                                           fuse_head=fuse_head,
                                           dropout=dropout)
    return (cfg, *run_steps(torch, ops, state, step, batch, steps))


def scalar(x) -> float:
    """A 0-d tensor's value; a DTensor's (a placed step's grad norm)
    after its reduction."""
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).item()


def run_steps(torch, ops, state, step, batch, steps: int,
              return_state: bool = False):
    """``steps`` steps from ``state``: per step the loss, grad norm,
    loss scale, skipped count, host wall (ending in a synchronize) and
    the kernel launches it made; and the peak device memory (GiB); with
    ``return_state`` also the state the steps leave."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, prev = [], ops.launch_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        now = ops.launch_counts()
        rows.append(dict(step=i + 1, wall_ms=wall, loss=scalar(m["loss"]),
                         grad_norm=scalar(m["grad_norm"]),
                         loss_scale=scalar(m["loss_scale"]),
                         skipped=int(scalar(m["skipped_steps"])),
                         launches={k: now[k] - prev[k] for k in now
                                   if now[k] != prev[k]}))
        prev = now
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (rows, peak, state) if return_state else (rows, peak)


#: train-parity's O2_fp16 run: at most this many steps (the forced
#: overflow waits for the dynamic scale's first finite step)
FP16_MAX_STEPS = 6


def train_parity(torch, ops, use_flash: bool, fuse_head: bool = False,
                 depth: int = 2, steps: int = 3, make=None):
    """GPT-2 at full width, ``depth`` layers, through the kernels and
    through the plain versions on the card: O0 losses and grad norms
    per step (on the dense batch, and with ``use_flash`` and the
    materialized head also on the packed one: the fused head sees the
    same hidden states either way); O2_fp16 with the loss multiplied by
    inf on both sides at the step after the first finite one (step 2,
    unless the dynamic scale still overflows by itself while it
    calibrates down from 2^16, as BERT's does at step 1), then one more
    step, with whether the forced step left every param bit for bit as
    the step before left it. ``make(level, packed, factor) -> (cfg,
    state, step, batch)`` builds another model's trainer (dense batch
    only)."""
    import contextlib
    if make is None:
        def make(level, packed, factor):
            return make_trainer(torch, level, depth, SEED + 1, factor=factor,
                                use_flash=use_flash, packed=packed,
                                fuse_head=fuse_head)
        batches = (False, True) if use_flash and not fuse_head else (False,)
    else:
        batches = (False,)
    out = {}
    for impl in ("kernel", "torch"):
        ctx = (ops.force_impl("torch") if impl == "torch"
               else contextlib.nullcontext())
        ops.reset_launches()
        with ctx:
            o0 = {}
            for packed in batches:
                _, state, step, batch = make("O0", packed, False)
                o0["packed" if packed else "dense"] = rows = []
                for _ in range(steps):
                    state, m = step(state, *batch)
                    rows.append((m["loss"].item(), m["grad_norm"].item()))
                del state
            _, state, step, batch = make("O2_fp16", False, True)
            fp16, params, forced = [], [], None
            while len(fp16) < FP16_MAX_STEPS and (
                    forced is None or len(fp16) <= forced + 1):
                i = len(fp16)
                f = torch.tensor(float("inf") if i == forced else 1.0,
                                 device="cuda")
                state, m = step(state, f, *batch)
                params.append(state.params)
                fp16.append(dict(
                    finite=bool(m["grads_finite"].item()),
                    skipped=int(m["skipped_steps"].item()),
                    scale_used=m["loss_scale"].item(),
                    scale_after=state.loss_scale.scale.item()))
                if forced is None and fp16[-1]["finite"]:
                    forced = i + 1
            kept = forced is not None and forced < len(params) and all(
                torch.equal(params[forced][k], params[forced - 1][k])
                for k in params[0])
            del state, params
        out[impl] = dict(o0=o0, fp16=fp16, forced=forced,
                         step2_params_kept=kept,
                         launches={k: n for k, n in
                                   ops.launch_counts().items() if n})
        torch.cuda.empty_cache()
    return out


def run_train_phase(torch, ops, card, phase, use_flash, packed, levels,
                    launches, fuse_head=False, fused_mlp=None, dropout=0.0):
    """Train ``steps`` steps at each (level, steps) of ``levels``; print
    every step and the summary line; add this phase's launches to
    ``launches``. GPT-2 124M (with ``dropout``, its training dropout),
    or with ``fused_mlp`` True or False the llama_block model (its
    fused head, the flash path). Returns (results, failure or None)."""
    if fused_mlp is None:
        per_step = train_launches(12, use_flash, fuse_head, dropout > 0)
        n_tok = TB * TS
    else:
        per_step, n_tok = llama_launches(LLAYERS, fused_mlp), LB * LS
    results = {}
    for level, steps in levels:
        ops.reset_launches()
        if fused_mlp is None:
            tcfg, rows, peak = train(torch, ops, level, use_flash=use_flash,
                                     packed=packed, steps=steps,
                                     fuse_head=fuse_head, dropout=dropout)
            desc = (f"GPT-2 124M {level} use_flash={use_flash} fuse_head="
                    f"{fuse_head} dropout {tcfg.dropout} "
                    f"{'packed ' if packed else ''}B={TB} S={TS} "
                    f"width {tcfg.hidden_size} layers {tcfg.num_layers} "
                    f"vocab {tcfg.vocab_size}/{tcfg.padded_vocab}")
        else:
            tcfg, state, step, batch = make_llama_trainer(
                torch, level, LLAYERS, SEED, fused_mlp=fused_mlp,
                packed=packed)
            rows, peak = run_steps(torch, ops, state, step, batch, steps)
            del state, step, batch
            desc = (f"llama_block {level} fused_mlp={fused_mlp} fuse_head="
                    f"True remat {'packed ' if packed else ''}B={LB} S={LS} "
                    f"hidden {tcfg.hidden_size} ffn {tcfg.ffn_size} heads "
                    f"{tcfg.num_heads}/{tcfg.num_kv_heads} head_dim "
                    f"{tcfg.head_dim} layers {tcfg.num_layers} vocab "
                    f"{tcfg.vocab_size}")
        for name, n in ops.launch_counts().items():
            launches[name] = launches.get(name, 0) + n
        walls = sorted(r["wall_ms"] for r in rows[1:])
        med = walls[len(walls) // 2]
        results[level] = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
                              tokens_per_s=n_tok / med * 1e3)
        for r in rows:
            print(f"phase {phase}: {level} step {r['step']} loss "
                  f"{r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
                  f"loss_scale {r['loss_scale']:g} skipped_steps "
                  f"{r['skipped']} wall {r['wall_ms']:.1f} ms launches "
                  f"{r['launches']} [{card}]")
        print(f"phase {phase}: {desc}; step wall "
              f"{med:.2f} ms (median of steps 2-{len(rows)}), "
              f"{n_tok / med * 1e3:.0f} tokens/s, peak memory "
              f"{peak:.2f} GiB [{card}]")
        losses = [r["loss"] for r in rows]
        if not all(math.isfinite(v) for v in losses):
            return results, f"{phase} {level}: a loss is not finite: {losses}"
        if level == "O2" and steps >= 6 and not losses[-1] < losses[0]:
            return results, f"{phase} O2: the loss did not fall: {losses}"
        for r in rows:
            if r["launches"] != per_step:
                return results, (f"{phase} {level} step {r['step']}: "
                                 f"launches {r['launches']}, expected "
                                 f"{per_step}")
        torch.cuda.empty_cache()
    return results, None


def check_train_parity(par, card, label, use_flash, fuse_head=False,
                       kernels=None, phase="train-parity"):
    """Print train-parity's results; the failure, or None. The kernel
    side must have launched its attention path's and head's kernels
    and not the other paths'; the plain side no kernel. ``kernels``:
    another model's (launched, not launched) kernel names."""
    k, p = par["kernel"], par["torch"]
    attn, other = ((("flash_fwd", "flash_dq", "flash_dkv"),
                    ("softmax_fwd", "softmax_bwd")) if use_flash else
                   (("softmax_fwd", "softmax_bwd"),
                    ("flash_fwd", "flash_dq", "flash_dkv")))
    attn = attn + HEAD_KERNELS[fuse_head]
    other = other + HEAD_KERNELS[not fuse_head]
    if kernels is not None:
        attn, other = kernels
    print(f"phase {phase}: {label} launches, kernels {k['launches']} "
          f"plain {p['launches']} [{card}]")
    if (p["launches"] or not all(k["launches"].get(n) for n in attn)
            or any(n in k["launches"] for n in other)):
        return (f"{phase} {label}: launches kernels {k['launches']} "
                f"plain {p['launches']}")
    for batch in k["o0"]:
        print(f"phase {phase}: {label} O0 depth 2 {batch} batch "
              f"(loss, grad_norm) per step kernels {k['o0'][batch]} plain "
              f"{p['o0'][batch]} [{card}]")
        for (kl, kg), (pl, pg) in zip(k["o0"][batch], p["o0"][batch]):
            if (abs(kl - pl) > 1e-5 * abs(pl)
                    or abs(kg - pg) > 1e-4 * abs(pg)):
                return (f"{phase} {label} O0 {batch}: kernels "
                        f"{k['o0'][batch]} vs plain {p['o0'][batch]}")
    for side in ("kernel", "torch"):
        f, k = par[side]["fp16"], par[side]["forced"]
        print(f"phase {phase}: {label} O2_fp16 inf at step "
              f"{None if k is None else k + 1}, {side}: {f}, its params "
              f"kept bit for bit {par[side]['step2_params_kept']} [{card}]")
        # the steps before the first finite one overflowed by themselves;
        # the forced step must be skipped on its own and the next one
        # finite
        if (k is None or [r["finite"] for r in f]
                != [False] * (k - 1) + [True, False, True]
                or f[k]["skipped"] != f[k - 1]["skipped"] + 1
                or f[-1]["skipped"] != f[k]["skipped"]
                or f[k]["scale_after"] != f[k]["scale_used"] / 2
                or not par[side]["step2_params_kept"]):
            return (f"{phase} {label} O2_fp16 ({side}): the forced "
                    f"overflow did not skip its step cleanly: {f}")
    return None


# ---- the DPO step -----------------------------------------------------------

#: DPO's batch: this many chosen and as many rejected rows of S tokens
DPO_ROWS = 8
#: the DPO phase's Adam learning rate and β. At 1e-4 one Adam step over
#: 1023 random tokens a row moves each sequence logp by so much that
#: β·margin saturates the sigmoid from step 2 on (loss and gradient 0
#: in fp32); at this rate steps 2-3 stay inside (0, ln 2)
DPO_LR, DPO_BETA = 1e-6, 0.1


def dpo_launches(num_layers: int, n_chunks: int) -> dict:
    """Kernel launches per DPO step: one flash forward pass of the 16
    rows (norms and attention, forward and backward), and per sequence
    batch (chosen, rejected) the head's forward, dx and dW once a vocab
    chunk."""
    n_norm = 2 * num_layers + 1
    return {"layer_norm_fwd": n_norm, "layer_norm_bwd": n_norm,
            "flash_fwd": num_layers, "flash_dq": num_layers,
            "flash_dkv": num_layers, "lxent_fwd": 2 * n_chunks,
            "lxent_dx": 2 * n_chunks, "lxent_dw": 2 * n_chunks}


def make_dpo(torch, seed: int, lr: float):
    """GPT-2 124M at full width, O2, weights from ``seed``, under
    ``Amp(fused_adam(lr, weight_decay=0.01))``, with the chunked-DPO
    loss (β `DPO_BETA`, the default vocab chunk) over 8 chosen and 8
    rejected rows of S tokens from ``np.random.default_rng(3)``, run as
    one 16-row forward. The reference sequence logps come from
    ``chunked_logprob`` under ``torch.no_grad`` through the initial
    state's compute-dtype params (``Amp.model_params``): the same
    function the step runs, so the first step's margin is 0 and its
    loss ln 2. Returns (cfg, state, step, batch, the reference logps'
    seconds, margins: a state's per-row β·margin, the loss's argument,
    under ``torch.no_grad``)."""
    import numpy as np
    from apex1_tpu_torch import (Amp, GPT2Config, fused_adam, get_policy,
                                 gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    from apex1_tpu_torch.ops.chunked_loss import (chunked_dpo_loss,
                                                  chunked_logprob)
    cfg = GPT2Config.gpt2_125m(policy=get_policy("O2"))
    model = gpt2_params_from_jax(init_params(cfg, seed), cfg, "cuda")
    amp = Amp(fused_adam(lr, weight_decay=0.01), opt_level="O2")
    state = amp.init(dict(model.named_parameters()))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2 * DPO_ROWS, TS))).cuda()

    def heads(params, toks):
        h = torch.func.functional_call(model, params, (toks,),
                                       dict(return_hidden=True))
        return (h[:DPO_ROWS, :-1], h[DPO_ROWS:, :-1],
                params["wte"].to(h.dtype))

    def loss_fn(params, toks, ref_c, ref_r):
        hc, hr, w = heads(params, toks)
        return chunked_dpo_loss(hc, hr, w, toks[:DPO_ROWS, 1:],
                                toks[DPO_ROWS:, 1:], ref_c, ref_r,
                                beta=DPO_BETA, num_classes=cfg.vocab_size)

    def seq_logps(params):
        with torch.no_grad():
            hc, hr, w = heads(params, toks)
            return tuple(chunked_logprob(
                h, w, t, num_classes=cfg.vocab_size).sum(dim=-1)
                for h, t in ((hc, toks[:DPO_ROWS, 1:]),
                             (hr, toks[DPO_ROWS:, 1:])))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_c, ref_r = seq_logps(amp.model_params(state))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0

    def margins(state):
        pc, pr = seq_logps(amp.model_params(state))
        return DPO_BETA * ((pc - pr) - (ref_c - ref_r))

    return (cfg, state, amp.make_train_step(loss_fn), (toks, ref_c, ref_r),
            ref_s, margins)


def run_dpo(torch, ops, card, launches, steps: int = 3):
    """The DPO phase: the reference logps, then ``steps`` steps; print
    each step and the summary; add the reference pass's and the steps'
    launches to ``launches``.
    Returns (results, failure or None)."""
    from apex1_tpu_torch.ops.chunked_loss import _auto_chunk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    cfg, state, step, batch, ref_s, margins = make_dpo(torch, SEED, DPO_LR)
    n_chunks = -(-cfg.padded_vocab // _auto_chunk(cfg.padded_vocab, None))
    ref_launches = {k: n for k, n in ops.launch_counts().items() if n}
    rows = []
    for i in range(steps):
        # β·margin at the params the step's loss sees (no_grad forwards,
        # launched before the step's count starts)
        bm = margins(state)
        prev = ops.launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        now = ops.launch_counts()
        rows.append(dict(step=i + 1, wall_ms=wall, loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(),
                         beta_margin=[bm.mean().item(), bm.min().item(),
                                      bm.max().item()],
                         launches={k: now[k] - prev[k] for k in now
                                   if now[k] != prev[k]}))
    # the main path's run: the reference pass and the steps, not the
    # β·margin forwards between them
    for counted in (ref_launches, *(r["launches"] for r in rows)):
        for name, n in counted.items():
            launches[name] = launches.get(name, 0) + n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in rows:
        print(f"phase dpo: step {r['step']} loss {r['loss']:.6e} "
              f"beta*margin mean {r['beta_margin'][0]:.6g} min "
              f"{r['beta_margin'][1]:.6g} max {r['beta_margin'][2]:.6g} "
              f"grad_norm {r['grad_norm']:.6e} wall {r['wall_ms']:.1f} ms "
              f"launches {r['launches']} [{card}]")
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med = walls[len(walls) // 2]
    print(f"phase dpo: GPT-2 124M O2 use_flash=True, {DPO_ROWS} chosen + "
          f"{DPO_ROWS} rejected rows of {TS} tokens, {n_chunks} vocab "
          f"chunks; reference logps {ref_s:.2f} s (launches "
          f"{ref_launches}); step wall {med:.2f} ms (median of steps "
          f"2-{steps}), peak memory {peak:.2f} GiB; Adam lr {DPO_LR:g}, "
          f"beta {DPO_BETA:g}; step-1 loss {rows[0]['loss']:.6f} vs ln 2 "
          f"{math.log(2):.6f} [{card}]")
    results = dict(steps=rows, ref_s=ref_s, ref_launches=ref_launches,
                   step_wall_ms=med, peak_gib=peak, n_chunks=n_chunks)
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        return results, f"dpo: a loss is not finite: {losses}"
    if abs(losses[0] - math.log(2)) > 1e-4:
        return results, f"dpo: step-1 loss {losses[0]} is not ln 2"
    if not all(0 < v < math.log(2) for v in losses[1:]):
        return results, (f"dpo: losses after step 1 must lie in (0, ln 2): "
                         f"{losses}")
    want_ref = {"layer_norm_fwd": 2 * cfg.num_layers + 1,
                "flash_fwd": cfg.num_layers, "lxent_fwd": 2 * n_chunks}
    if ref_launches != want_ref:
        return results, (f"dpo: reference launches {ref_launches}, "
                         f"expected {want_ref}")
    per_step = dpo_launches(cfg.num_layers, n_chunks)
    for r in rows:
        if r["launches"] != per_step:
            return results, (f"dpo step {r['step']}: launches "
                             f"{r['launches']}, expected {per_step}")
    return results, None


# ---- the Llama slice: the JAX bench's llama_block ----------------------------

#: serve-llama's engine: ENGINE_KW at the bench's vocab
LLAMA_ENGINE_KW = dict(ENGINE_KW, vocab_size=LV)
#: generate-llama: new tokens a prompt
LLAMA_GEN_NEW = 32
#: train-llama-parity: depth, sequence length (full width) and learning
#: rate. At the bench's lr 1e-4 the depth-2 model memorizes its one
#: batch in two steps (O0 loss 11.20 -> 2.25 -> 0.0095 on an H100):
#: step 3's loss
#: is then a difference of two logits about 1e3 times its size, and its
#: 1e-5 comparison reads their rounding, not the kernels
LPAR_DEPTH, LPAR_S, LPAR_LR = 2, 1024, 1e-5
#: the kernels of every Llama training step, besides its head's and glu
LLAMA_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "rope", "flash_fwd",
                 "flash_dq", "flash_dkv")


#: the llama_block widths (Llama-3 8B, the bench's vocab 32000), and the
#: bench's llama_longctx / decode model (`bench.py:333-347`, `:403-463`):
#: hidden 2048, 32 query and 4 KV heads of 64, ffn 5632, 16 layers
LLAMA_BLOCK = dict(vocab_size=LV, hidden_size=LH, num_heads=LHEADS,
                   num_kv_heads=LKV, ffn_size=LFFN)
LLAMA_08B = dict(vocab_size=LV, hidden_size=2048, num_heads=32,
                 num_kv_heads=4, ffn_size=5632)


def make_llama(policy: str, depth: int, seed: int, fused_mlp=False,
               widths=None, remat=True, max_seq_len: int = LS):
    """The llama_block model (or the ``widths`` given), ``depth`` layers
    at ``policy``, remat under ``nothing_saveable`` unless ``remat`` is
    False, its weights drawn on the card from ``seed`` (`init_weights`:
    normal(0.02), norm scales 1). Returns (cfg, model)."""
    from apex1_tpu_torch import Llama, LlamaConfig, get_policy
    from apex1_tpu_torch.models.llama import init_weights
    cfg = LlamaConfig(**(widths or LLAMA_BLOCK), max_seq_len=max_seq_len,
                      num_layers=depth, remat=remat, fused_mlp=fused_mlp,
                      policy=get_policy(policy))
    return cfg, init_weights(Llama(cfg, device="cuda"), seed)


def llama_batch(torch, S: int, packed: bool, B: int = LB):
    """The B x S batch on the card: the tokens of
    ``np.random.default_rng(0)``; or with ``packed`` (tokens,
    segment_ids, positions), the first B rows `pack_documents` packs
    from documents of 64-2048 tokens drawn from
    ``np.random.default_rng(1)``, positions restarting per document."""
    import numpy as np
    from apex1_tpu_torch.runtime import pack_documents
    if not packed:
        return (torch.from_numpy(np.random.default_rng(0).integers(
            0, LV, (B, S))).cuda(),)
    rng = np.random.default_rng(1)
    docs = []
    while sum(map(len, docs)) < 2 * B * S:
        docs.append(rng.integers(0, LV, int(rng.integers(64, 2049))))
    return tuple(torch.from_numpy(a[:B]).cuda()
                 for a in pack_documents(docs, S))


def make_llama_trainer(torch, level: str, depth: int, seed: int, *,
                       fused_mlp=False, fuse_head=True, packed=False,
                       factor=False, S: int = LS, lr: float = 1e-4,
                       widths=None, B: int = LB):
    """`make_llama` under ``Amp(fused_adam(lr, weight_decay=0.01),
    opt_level=level)`` (the bench's optimizer at lr 1e-4), its loss
    ``llama_loss_fn(fuse_head=...)`` and its `llama_batch`. With
    ``factor`` the step takes a factor before the batch that multiplies
    the loss (inf forces an overflow)."""
    from apex1_tpu_torch import Amp, fused_adam, llama_loss_fn
    cfg, model = make_llama(level, depth, seed, fused_mlp, widths,
                            max_seq_len=S)
    amp = Amp(fused_adam(lr, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    base = llama_loss_fn(model, fuse_head=fuse_head)
    loss_fn = (lambda p, f, *b: base(p, *b) * f) if factor else base
    return (cfg, state, amp.make_train_step(loss_fn),
            llama_batch(torch, S, packed, B))


def llama_launches(num_layers: int, fused_mlp: bool,
                   fuse_head: bool = True) -> dict:
    """Kernel launches per Llama training step under remat. Each block's
    forward runs twice (the step's, and its recompute in the backward):
    two RMS norms, q and k rotated, the flash forward and, with
    ``fused_mlp``, the glu. The backward runs once a block: two norms,
    q and k rotated by -θ, flash dq and dk/dv. The final norm and the
    head run once."""
    L = num_layers
    out = {"layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1,
           "rope": 6 * L, "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
           **{name: 1 for name in HEAD_KERNELS[fuse_head]}}
    if fused_mlp:
        out["glu_fwd"] = 2 * L
    return out


def run_llama_parity(torch, ops, card):
    """train-llama-parity: depth 2, full width, B x 1024 tokens, lr
    1e-5, through the kernels and the plain versions (`train_parity`),
    for (fused_mlp,
    fuse_head) = (False, True), (True, True), (False, False); then the
    fused head's step-1 O0 loss against the materialized head's on the
    same weights. Returns (results, failure or None)."""
    par = {}
    for fused_mlp, fuse in ((False, True), (True, True), (False, False)):
        label = f"fused_mlp={fused_mlp} fuse_head={fuse}"

        def make(level, packed, factor, fused_mlp=fused_mlp, fuse=fuse):
            return make_llama_trainer(torch, level, LPAR_DEPTH, SEED + 1,
                                      fused_mlp=fused_mlp, fuse_head=fuse,
                                      factor=factor, S=LPAR_S, lr=LPAR_LR)

        par[label] = train_parity(torch, ops, True, fuse, make=make)
        need = LLAMA_KERNELS + HEAD_KERNELS[fuse] + (
            ("glu_fwd",) if fused_mlp else ())
        other = (("softmax_fwd", "softmax_bwd") + HEAD_KERNELS[not fuse]
                 + (() if fused_mlp else ("glu_fwd",)))
        err = check_train_parity(par[label], card, label, True, fuse,
                                 kernels=(need, other),
                                 phase="train-llama-parity")
        if err:
            return par, err
    lf = par["fused_mlp=False fuse_head=True"]["kernel"]["o0"]["dense"][0][0]
    lm = par["fused_mlp=False fuse_head=False"]["kernel"]["o0"]["dense"][0][0]
    print(f"phase train-llama-parity: O0 depth {LPAR_DEPTH} step-1 loss on "
          f"the same weights, fuse_head=True {lf:.7f} vs fuse_head=False "
          f"{lm:.7f}, relative difference {abs(lf - lm) / abs(lm):.2e} "
          f"[{card}]")
    if abs(lf - lm) > 1e-5 * abs(lm):
        return par, (f"train-llama-parity: the fused head's loss {lf} is "
                     f"not the materialized head's {lm}")
    return par, None


def run_serve_llama(torch, ops, card, launches):
    """serve-llama: llama_block (3 layers, ``fused_mlp``) at O2 through
    the paged engine (`LLAMA_ENGINE_KW`, the GPT-2 engine's workload),
    then one greedy `generate` through `llama_decoder` (8 ragged
    prompts, 32 new tokens); serve-llama-parity: the engine at O0, depth
    2, through the kernels and the plain versions. Adds the main runs'
    launches to ``launches``. Returns (results, failure or None)."""
    ops.reset_launches()
    streams, eng, wall, step_ms, cfg = serve(
        torch, LLAMA_ENGINE_KW, depth=LLAYERS, policy="O2", seed=SEED,
        llama=True)
    got = ops.launch_counts()
    for name, n in got.items():
        launches[name] = launches.get(name, 0) + n
    summ = eng.metrics.summary()
    n_fwd = (eng.metrics.get_counter("prefill_chunks")
             + eng.metrics.get_counter("decode_steps"))
    L = cfg.num_layers
    expect = {name: 0 for name in got}
    expect.update({"layer_norm_fwd": n_fwd * (2 * L + 1),
                   "rope": n_fwd * 2 * L, "paged_attend": n_fwd * L,
                   "glu_fwd": n_fwd * L, "fused_sample": n_fwd})
    n_tok = sum(len(s) for s in streams)
    statuses = {r.status for r in eng.results.values()}
    out = dict(wall_s=wall, tokens=n_tok, step_ms=step_ms, summary=summ)
    print(f"phase serve-llama: llama_block O2 fused_mlp=True hidden "
          f"{cfg.hidden_size} heads {cfg.num_heads}/{cfg.num_kv_heads} "
          f"layers {L} vocab {cfg.vocab_size}; {len(streams)} requests, "
          f"{n_tok} tokens generated, wall {wall:.2f} s, "
          f"{n_tok / wall:.1f} tok/s, mean decode-step wall "
          f"{sum(step_ms) / len(step_ms):.2f} ms over {len(step_ms)} steps, "
          f"prefill chunks {eng.metrics.get_counter('prefill_chunks')}, "
          f"decode steps {eng.metrics.get_counter('decode_steps')}, "
          f"prefix hit rate {summ.get('prefix_hit_rate', 0):.3f}, "
          f"ttft p50 {summ.get('ttft_p50_ms', 0):.1f} ms [{card}]")
    print(f"phase serve-llama: launches {got} expected {expect} [{card}]")
    if statuses != {"done"} or any(len(s) != 64 for s in streams):
        return out, (f"serve-llama: statuses {statuses}, lengths "
                     f"{sorted({len(s) for s in streams})}")
    if got != expect:
        return out, f"serve-llama: launches {got}, expected {expect}"
    if any(min(s) < 0 or max(s) >= cfg.vocab_size for s in streams):
        return out, "serve-llama: a token outside the vocabulary"
    del eng
    torch.cuda.empty_cache()

    run, gcfg = make_generator(torch, LLAYERS, "O2", SEED, llama=True,
                               new_tokens=LLAMA_GEN_NEW)
    ops.reset_launches()
    toks, gwall = run(0.0)
    counts = ops.launch_counts()
    for name, n in counts.items():
        launches[name] += n
    out["generate"] = dict(wall_s=gwall, tokens_per_s=toks.size / gwall,
                           launches=counts)
    print(f"phase serve-llama: generate via llama_decoder, O2 greedy, "
          f"{GEN_ROWS} prompts of 32-{GEN_WIDTH} tokens, {LLAMA_GEN_NEW} "
          f"new tokens each, cache {GEN_SLOTS} slots; wall {gwall:.2f} s, "
          f"{toks.size / gwall:.1f} tok/s, launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    del run
    torch.cuda.empty_cache()
    if counts["flash_fwd"] != gcfg.num_layers:
        return out, (f"serve-llama: the generate prefill launched flash_fwd "
                     f"{counts['flash_fwd']} times, expected "
                     f"{gcfg.num_layers}")
    if toks.shape != (GEN_ROWS, LLAMA_GEN_NEW) or toks.min() < 0 \
            or toks.max() >= gcfg.vocab_size:
        return out, f"serve-llama: generate gave {toks.shape} or a token " \
                    f"outside the vocabulary"

    kern, _, kwall, _, _ = serve(torch, LLAMA_ENGINE_KW, depth=LPAR_DEPTH,
                                 policy="O0", seed=SEED + 1, llama=True)
    with ops.force_impl("torch"):
        plain, _, pwall, _, _ = serve(torch, LLAMA_ENGINE_KW,
                                      depth=LPAR_DEPTH, policy="O0",
                                      seed=SEED + 1, llama=True)
    diff = sum(a != b for a, b in zip(kern, plain))
    out["parity"] = dict(kernel_wall_s=kwall, plain_wall_s=pwall, differ=diff)
    print(f"phase serve-llama-parity: O0 depth {LPAR_DEPTH}, {len(kern)} "
          f"requests, kernel wall {kwall:.2f} s, plain wall {pwall:.2f} s, "
          f"streams differing {diff} [{card}]")
    if diff:
        return out, (f"serve-llama-parity: {diff} token streams differ "
                     f"between the kernels and the plain versions")
    return out, None


# ---- phases 9 and 10: generate ---------------------------------------------

#: generate's workload: 8 prompts of 32-512 tokens right-padded to 512,
#: 64 new tokens, a dense cache of 1024 slots
GEN_ROWS, GEN_WIDTH, GEN_NEW, GEN_SLOTS = 8, 512, 64, 1024


def make_generator(torch, depth: int, policy: str, seed: int,
                   llama: bool = False, new_tokens: int = GEN_NEW):
    """GPT-2 (or with ``llama`` the llama_block model, ``fused_mlp``) at
    full width, ``depth`` layers, from ``seed`` and its ragged prompts
    (lengths 32-512 from ``np.random.default_rng(2)``); returns
    ``run(temperature, record=None) -> (tokens (8, new_tokens) numpy,
    wall s)``. ``record`` collects each step's last-position logits."""
    import numpy as np
    from apex1_tpu_torch import (GPT2Config, get_policy, gpt2_decoder,
                                 gpt2_params_from_jax, llama_decoder)
    from apex1_tpu_torch.models.generate import generate
    from apex1_tpu_torch.models.gpt2 import init_params
    if llama:
        cfg, model = make_llama(policy, depth, seed, fused_mlp=True)
        apply_fn, make_cache = llama_decoder(model)
    else:
        cfg = GPT2Config.gpt2_125m(num_layers=depth,
                                   policy=get_policy(policy))
        model = gpt2_params_from_jax(init_params(cfg, seed), cfg, "cuda")
        apply_fn, make_cache = gpt2_decoder(model)
    rng = np.random.default_rng(2)
    lens = rng.integers(32, GEN_WIDTH + 1, GEN_ROWS)
    toks = np.zeros((GEN_ROWS, GEN_WIDTH), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    prompts = torch.from_numpy(toks).cuda()
    plens = torch.from_numpy(lens).cuda()

    def run(temperature: float, record=None):
        fn = apply_fn
        if record is not None:
            def fn(*a, **kw):
                logits, cache = apply_fn(*a, **kw)
                record.append(logits[:, -1].float())
                return logits, cache
        cache = make_cache(GEN_ROWS, GEN_SLOTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(fn, prompts, max_new_tokens=new_tokens, cache=cache,
                       temperature=temperature, vocab_size=cfg.vocab_size,
                       prompt_lens=plens)
        torch.cuda.synchronize()
        return out.cpu().numpy(), time.perf_counter() - t0

    return run, cfg


# ---- the BERT slice: the JAX bench's bert, bert_dropout, bert_large ---------

#: the bench's BERT configurations (`bench.py:220-258`): BERT-base or
#: BERT-large at full width and depth, O2, B x 512 tokens, dropout, and
#: the A100 proxy BASELINE.md pins (tokens/s)
BERT_RUNS = {
    "bert": dict(large=False, B=8, dropout=0.0, proxy=173_000.0),
    "bert_dropout": dict(large=False, B=8, dropout=0.1, proxy=173_000.0),
    "bert_large": dict(large=True, B=4, dropout=0.0, proxy=57_500.0),
}
BERT_S = 512
#: train-bert-large's O2 steps: the smallest count >= 6 at which the
#: loss-fell gate (last loss below the first) holds at every seed of
#: GATE_SEEDS for every count up to GATE_STEPS, on the kernels and on
#: the plain path (``--gate-sweep``; PERF.md holds the sweep's table)
BERT_LARGE_STEPS = 8
GATE_SEEDS = tuple(range(1234, 1242))
GATE_STEPS = 30
#: train-bert-parity: depth (full BERT-base width), batch rows, learning
#: rate (Llama's parity showed a depth-2 model memorizing its one batch
#: at 1e-4, after which 1e-5 loss comparisons read rounding)
BPAR_DEPTH, BPAR_B, BPAR_LR = 2, 8, 1e-5


def make_bert(level: str, large: bool, seed: int, dropout: float,
              depth=None):
    """BertPretrain at the bench's widths (BERT-base, or BERT-large with
    ``large``), ``depth`` layers (the config's when None), at ``level``,
    its weights drawn on the card from ``seed`` (`init_weights`).
    Returns (cfg, model)."""
    from apex1_tpu_torch import BertConfig, BertPretrain, get_policy
    from apex1_tpu_torch.models.bert import init_weights
    mk = BertConfig.bert_large if large else BertConfig.bert_base
    kw = {} if depth is None else dict(num_layers=depth)
    cfg = mk(policy=get_policy(level), dropout=dropout, **kw)
    return cfg, init_weights(BertPretrain(cfg, device="cuda"), seed)


def bert_batch(torch, vocab: int, B: int, dropout: float, padded: bool):
    """The bench's batch (`bench.py:233-239`): B x 512 tokens of
    ``np.random.default_rng(0)``, MLM labels -1 outside a 15 % draw,
    NSP labels in {0, 1}; with ``dropout`` an int base seed as
    ``dropout_rng``; with ``padded`` an ``attention_mask`` whose rows
    hold 256-512 real tokens (``default_rng(2)``), pads unlabelled."""
    import numpy as np
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, BERT_S))
    mlm = np.where(rng.random((B, BERT_S)) < 0.15,
                   rng.integers(0, vocab, (B, BERT_S)), -1)
    nsp = rng.integers(0, 2, (B,))
    batch = {}
    if padded:
        mask = padding_segments(B, BERT_S, 2)
        mlm = np.where(mask == 1, mlm, -1)
        batch["attention_mask"] = torch.from_numpy(mask)
    batch.update(tokens=torch.from_numpy(tokens),
                 mlm_labels=torch.from_numpy(mlm),
                 nsp_labels=torch.from_numpy(nsp))
    batch = {k: v.cuda() for k, v in batch.items()}
    if dropout > 0.0:
        batch["dropout_rng"] = SEED
    return batch


def make_bert_trainer(torch, level: str, large: bool, seed: int, *, B: int,
                      dropout: float, depth=None, fuse_head=True,
                      factor=False, padded=False, lr: float = 1e-4,
                      tx=None):
    """`make_bert` under ``Amp(fused_adam(lr, weight_decay=0.01),
    opt_level=level)`` (the bench's optimizer at lr 1e-4; or the
    optimizer ``tx``), its loss ``bert_pretrain_loss_fn(fuse_head=...)``
    and its `bert_batch`. With ``factor`` the step takes a factor before
    the batch that multiplies the loss (inf forces an overflow)."""
    from apex1_tpu_torch import Amp, bert_pretrain_loss_fn, fused_adam
    cfg, model = make_bert(level, large, seed, dropout, depth)
    amp = Amp(tx or fused_adam(lr, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    base = bert_pretrain_loss_fn(model, fuse_head=fuse_head)
    loss_fn = (lambda p, f, b: base(p, b) * f) if factor else base
    return (cfg, state, amp.make_train_step(loss_fn),
            (bert_batch(torch, cfg.vocab_size, B, dropout, padded),))


def bert_launches(num_layers: int, dropout: bool,
                  fuse_head: bool = True) -> dict:
    """Kernel launches per BERT pretraining step: the embedding norm,
    two norms a layer and the MLM head's norm (2L + 2, forward and
    backward); one non-causal flash attention a layer; with dropout two
    bias-dropout-adds a layer (the two residual epilogues); the MLM
    head (the fused head's forward, dx and dW, or the materialized
    cross-entropy) and the NSP cross-entropy."""
    L = num_layers
    out = {"layer_norm_fwd": 2 * L + 2, "layer_norm_bwd": 2 * L + 2,
           "flash_fwd": L, "flash_dq": L, "flash_dkv": L,
           "xent_fwd": 1, "xent_bwd": 1}
    for name in HEAD_KERNELS[fuse_head]:
        out[name] = out.get(name, 0) + 1
    if dropout:
        out.update(bda_fwd=2 * L, bda_bwd=2 * L)
    return out


def run_bert_phase(torch, ops, card, phase: str, bench: str, levels,
                   launches, padded: bool = False):
    """Train the bench configuration ``bench`` (`BERT_RUNS`) for each
    (level, steps) of ``levels``; print every step and the summary line
    (tokens/s = B x S over the median step wall of steps 2..n beside
    the A100 proxy, device ms a step from 3 more profiled steps, peak
    memory); add the counted steps' launches to ``launches``. Returns
    (results, failure or None)."""
    run = BERT_RUNS[bench]
    results = {}
    for level, steps in levels:
        ops.reset_launches()
        cfg, state, step, batch = make_bert_trainer(
            torch, level, run["large"], SEED, B=run["B"],
            dropout=run["dropout"], padded=padded)
        per_step = bert_launches(cfg.num_layers, run["dropout"] > 0)
        rows, peak, state = run_steps(torch, ops, state, step, batch, steps,
                                      return_state=True)
        for name, n in ops.launch_counts().items():
            launches[name] = launches.get(name, 0) + n
        prof = profiled_steps(torch, state, step, batch)
        del state, step, batch
        n_tok = run["B"] * BERT_S
        walls = sorted(r["wall_ms"] for r in rows[1:])
        med = walls[len(walls) // 2]
        results[level] = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
                              tokens_per_s=n_tok / med * 1e3,
                              proxy_tokens_per_s=run["proxy"], profile=prof)
        for r in rows:
            print(f"phase {phase}: {level} step {r['step']} loss "
                  f"{r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
                  f"loss_scale {r['loss_scale']:g} skipped_steps "
                  f"{r['skipped']} wall {r['wall_ms']:.1f} ms launches "
                  f"{r['launches']} [{card}]")
        print(f"phase {phase}: {bench} {level} dropout {cfg.dropout} "
              f"{'padded ' if padded else ''}B={run['B']} S={BERT_S} width "
              f"{cfg.hidden_size} layers {cfg.num_layers} heads "
              f"{cfg.num_heads} ffn {cfg.intermediate_size} vocab "
              f"{cfg.vocab_size}; step wall {med:.2f} ms (median of steps "
              f"2-{len(rows)}), {n_tok / med * 1e3:.0f} tokens/s (A100 "
              f"proxy {run['proxy']:.0f}, bench.py), device "
              f"{prof['device_ms_per_step']:.2f} ms a step ("
              f"{prof['device_busy']:.0%} busy over 3 profiled steps), "
              f"peak memory {peak:.2f} GiB [{card}]")
        losses = [r["loss"] for r in rows]
        if not all(math.isfinite(v) for v in losses):
            return results, f"{phase} {level}: a loss is not finite: {losses}"
        if level == "O2" and not losses[-1] < losses[0]:
            return results, f"{phase} O2: the loss did not fall: {losses}"
        for r in rows:
            if r["launches"] != per_step:
                return results, (f"{phase} {level} step {r['step']}: "
                                 f"launches {r['launches']}, expected "
                                 f"{per_step}")
        torch.cuda.empty_cache()
    return results, None


def gate_sweep(torch, ops, card, paths) -> int:
    """``--gate-sweep``: train `bert_large` at O2 for GATE_STEPS steps
    at every seed of GATE_SEEDS through each of ``paths`` ("kernels",
    and "plain": ``ops.force_impl("torch")``); print each run's losses,
    the counts n at which its gate ``losses[n-1] < losses[0]`` fails,
    and N: the smallest count >= 6 from which the gate holds in every
    run up to GATE_STEPS. Non-zero when a kernel run fails the gate at
    a count from BERT_LARGE_STEPS on."""
    run = BERT_RUNS["bert_large"]
    runs = {}
    for path in paths:
        for seed in GATE_SEEDS:
            ctx = (ops.force_impl("torch") if path == "plain"
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                _, state, step, batch = make_bert_trainer(
                    torch, "O2", True, seed, B=run["B"],
                    dropout=run["dropout"])
                losses = []
                for _ in range(GATE_STEPS):
                    state, m = step(state, *batch)
                    losses.append(m["loss"].item())
            del state, step, batch
            torch.cuda.empty_cache()
            fails = [n for n in range(2, GATE_STEPS + 1)
                     if not losses[n - 1] < losses[0]]
            runs[(path, seed)] = losses
            print(f"phase gate-sweep: bert_large O2 {path} seed {seed} "
                  f"losses {[round(v, 6) for v in losses]} gate fails at "
                  f"counts {fails} ({time.perf_counter() - t0:.1f} s) "
                  f"[{card}]")

    def smallest_n(keys):
        n = GATE_STEPS + 1
        while n - 1 >= 6 and all(runs[k][n - 2] < runs[k][0] for k in keys):
            n -= 1
        return n if n <= GATE_STEPS else None

    per_path = {p: smallest_n([k for k in runs if k[0] == p]) for p in paths}
    print(f"phase gate-sweep: N over all {len(runs)} runs "
          f"{smallest_n(list(runs))}, per path {per_path}; "
          f"train-bert-large runs {BERT_LARGE_STEPS} steps [{card}]")
    bad = [k for k in runs if k[0] == "kernels"
           and any(not runs[k][n - 1] < runs[k][0]
                   for n in range(BERT_LARGE_STEPS, GATE_STEPS + 1))]
    if bad:
        return fail(f"gate-sweep: the kernels fail the gate at a count "
                    f">= {BERT_LARGE_STEPS} at seeds {[k[1] for k in bad]}")
    return 0


def run_bert_parity(torch, ops, card):
    """train-bert-parity: BERT-base width, depth 2, B x 512 tokens,
    dropout 0.1 with the same seeds, lr 1e-5, through the kernels and
    the plain versions (`train_parity`: O0 losses and grad norms, the
    O2_fp16 forced overflow), with the fused and the materialized MLM
    head; then the fused head's step-1 O0 loss against the materialized
    head's on the same weights. Returns (results, failure or None)."""
    par = {}
    for fuse in (True, False):
        label = f"dropout 0.1 fuse_head={fuse}"

        def make(level, packed, factor, fuse=fuse):
            return make_bert_trainer(torch, level, False, SEED + 1,
                                     B=BPAR_B, dropout=0.1, depth=BPAR_DEPTH,
                                     fuse_head=fuse, factor=factor,
                                     lr=BPAR_LR)

        par[label] = train_parity(torch, ops, True, fuse, make=make)
        need = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_dq",
                "flash_dkv", "xent_fwd", "xent_bwd", "bda_fwd", "bda_bwd"
                ) + HEAD_KERNELS[fuse]
        other = ("softmax_fwd", "softmax_bwd") + (
            () if fuse else HEAD_KERNELS[True])
        err = check_train_parity(par[label], card, label, True, fuse,
                                 kernels=(need, other),
                                 phase="train-bert-parity")
        if err:
            return par, err
    lf = par["dropout 0.1 fuse_head=True"]["kernel"]["o0"]["dense"][0][0]
    lm = par["dropout 0.1 fuse_head=False"]["kernel"]["o0"]["dense"][0][0]
    print(f"phase train-bert-parity: O0 depth {BPAR_DEPTH} step-1 loss on "
          f"the same weights, fuse_head=True {lf:.7f} vs fuse_head=False "
          f"{lm:.7f}, relative difference {abs(lf - lm) / abs(lm):.2e} "
          f"[{card}]")
    if abs(lf - lm) > 1e-5 * abs(lm):
        return par, (f"train-bert-parity: the fused head's loss {lf} is "
                     f"not the materialized head's {lm}")
    return par, None


def profile_bert(torch, bench: str = "bert_large", steps: int = 3) -> dict:
    """``--profile``: where a BERT O2 training step's time goes (the
    bench configuration ``bench``), as `profile_train` measures it."""
    run = BERT_RUNS[bench]
    _, state, step, batch = make_bert_trainer(
        torch, "O2", run["large"], SEED, B=run["B"], dropout=run["dropout"])
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, *batch)
    out = {"bench": bench, **profiled_steps(torch, state, step, batch, steps),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state, step, batch
    torch.cuda.empty_cache()
    return out


# ---- the T5 slice: the JAX bench's t5, multihead attention ------------------

#: train-t5-parity: depth of each stack (full T5-large width), learning
#: rate (as train-llama-parity: at 1e-4 a depth-2 model memorizes its
#: batch and the loss comparison reads rounding)
T5PAR_DEPTH, T5PAR_LR = 2, 1e-5
#: the bench's A100 proxy for ``t5`` (tokens/s, `bench.py:400`)
T5_PROXY = 48_000.0


def make_t5(level: str, depth: int, seed: int):
    """The bench's ``t5`` model (`bench.py:381-384`: T5-large widths,
    ``depth`` encoder and ``depth`` decoder layers, remat) at ``level``,
    its weights drawn on the card from ``seed`` (`init_weights`).
    Returns (cfg, model)."""
    from apex1_tpu_torch import T5, T5Config, get_policy
    from apex1_tpu_torch.models.t5 import init_weights
    cfg = T5Config.t5_large(policy=get_policy(level),
                            num_encoder_layers=depth,
                            num_decoder_layers=depth, remat=True)
    return cfg, init_weights(T5(cfg, device="cuda"), seed)


def t5_batch(torch, vocab: int):
    """The bench's batch (`bench.py:386-389`): B x S_enc encoder and
    B x S_dec decoder tokens of ``np.random.default_rng(0)``."""
    import numpy as np
    rng = np.random.default_rng(0)
    enc = rng.integers(0, vocab, (T5B, T5S))
    dec = rng.integers(0, vocab, (T5B, T5S))
    return (torch.from_numpy(enc).cuda(), torch.from_numpy(dec).cuda())


def make_t5_trainer(torch, level: str, depth: int, seed: int, *,
                    fuse_head=True, factor=False, lr: float = 1e-4):
    """`make_t5` under ``Amp(fused_adam(lr, weight_decay=0.01),
    opt_level=level)`` (the bench's optimizer at lr 1e-4), its loss
    ``t5_loss_fn(fuse_head=...)`` and its `t5_batch`. With ``factor``
    the step takes a factor before the batch that multiplies the loss
    (inf forces an overflow)."""
    from apex1_tpu_torch import Amp, fused_adam, t5_loss_fn
    cfg, model = make_t5(level, depth, seed)
    amp = Amp(fused_adam(lr, weight_decay=0.01), opt_level=level)
    state = amp.init(dict(model.named_parameters()))
    base = t5_loss_fn(model, fuse_head=fuse_head)
    loss_fn = (lambda p, f, *b: base(p, *b) * f) if factor else base
    return (cfg, state, amp.make_train_step(loss_fn),
            t5_batch(torch, cfg.vocab_size))


def t5_launches(n_enc: int, n_dec: int, fuse_head: bool = True) -> dict:
    """Kernel launches per T5 training step under remat. Each block's
    forward runs twice (the step's, and its recompute in the backward):
    an encoder block two RMS norms and one flash forward, a decoder
    block three norms and two (self and cross). The backward runs once a
    block: its norms, flash dq and dk/dv per attention, and dbias for
    the self-attention's relative-position bias (the cross-attention has
    none). Each stack's final norm and the head run once."""
    norms, attn = 2 * n_enc + 3 * n_dec, n_enc + 2 * n_dec
    return {"layer_norm_fwd": 2 * norms + 2, "layer_norm_bwd": norms + 2,
            "flash_fwd": 2 * attn, "flash_dq": attn, "flash_dkv": attn,
            "flash_dbias": n_enc + n_dec,
            **{name: 1 for name in HEAD_KERNELS[fuse_head]}}


def run_t5_phase(torch, ops, card, launches, steps: int = 6):
    """train-t5: the bench's ``t5`` at O2 for ``steps`` steps; prints
    every step and the summary line (tokens/s = B·(S_enc + S_dec) over
    the median step wall of steps 2..n beside the A100 proxy, device ms
    a step and the busy share from 3 more profiled steps, the largest
    kernels, peak memory); adds the counted steps' launches to
    ``launches``. Returns (results, failure or None)."""
    ops.reset_launches()
    cfg, state, step, batch = make_t5_trainer(torch, "O2", T5LAYERS, SEED)
    per_step = t5_launches(T5LAYERS, T5LAYERS)
    rows, peak, state = run_steps(torch, ops, state, step, batch, steps,
                                  return_state=True)
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    prof = profiled_steps(torch, state, step, batch)
    del state, step, batch
    n_tok = T5B * 2 * T5S
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med = walls[len(walls) // 2]
    out = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
               tokens_per_s=n_tok / med * 1e3, proxy_tokens_per_s=T5_PROXY,
               profile=prof)
    for r in rows:
        print(f"phase train-t5: O2 step {r['step']} loss {r['loss']:.6f} "
              f"grad_norm {r['grad_norm']:.4f} loss_scale "
              f"{r['loss_scale']:g} skipped_steps {r['skipped']} wall "
              f"{r['wall_ms']:.1f} ms launches {r['launches']} [{card}]")
    print(f"phase train-t5: t5 O2 remat B={T5B} S_enc={T5S} S_dec={T5S} "
          f"d_model {cfg.d_model} heads {cfg.num_heads}x{cfg.head_dim} d_ff "
          f"{cfg.d_ff} layers {cfg.num_encoder_layers}+"
          f"{cfg.num_decoder_layers} vocab {cfg.vocab_size}; step wall "
          f"{med:.2f} ms (median of steps 2-{len(rows)}), "
          f"{n_tok / med * 1e3:.0f} tokens/s (A100 proxy {T5_PROXY:.0f}, "
          f"bench.py), device {prof['device_ms_per_step']:.2f} ms a step "
          f"({prof['device_busy']:.0%} busy over 3 profiled steps), peak "
          f"memory {peak:.2f} GiB [{card}]")
    top = [(t["name"][:60], round(t["ms_per_step"], 3), t["calls"])
           for t in prof["top"][:14]]
    print(f"phase train-t5: largest kernels a step (name, ms, calls) {top} "
          f"[{card}]")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        return out, f"train-t5: a loss is not finite: {losses}"
    for r in rows:
        if r["launches"] != per_step:
            return out, (f"train-t5 step {r['step']}: launches "
                         f"{r['launches']}, expected {per_step}")
    torch.cuda.empty_cache()
    return out, None


def rel_pos_grads(torch, ops, card):
    """The relative-position tables' O0 gradients at depth
    `T5PAR_DEPTH` through the kernels and through the plain versions.
    The check: each table's gradient norm within 1e-4 relative
    (train-parity's grad-norm rule). Each row of a layer's dbias sums to
    0 exactly (Σ_j p·(dp - δ) = δ - δ), so a table cell that covers most
    of a row is a small difference of large fp32 sums, and the cells'
    relative difference says little; dbias itself is held element by
    element against its plain version in the kernels phase. Printed
    beside the norms: the relative Frobenius difference, that difference
    over the cells' sums of absolute terms A (A = one-hotᵀ·|dL/dbias|
    from the plain run, itself already summed over the layers and the
    batch), and the cancellation ‖g‖/‖A‖. Returns (results, failure or
    None)."""
    cfg, model = make_t5("O0", T5PAR_DEPTH, SEED + 1)
    from apex1_tpu_torch import t5_loss_fn
    params = dict(model.named_parameters())
    stacks = (model.encoder, model.decoder)
    names = ("encoder.rel_pos.rel_bias", "decoder.rel_pos.rel_bias")
    batch = t5_batch(torch, cfg.vocab_size)
    got, biases = {}, []
    hooks = [st.rel_pos.register_forward_hook(
        lambda m, i, out: biases.append(out)) for st in stacks]
    for impl in ("kernel", "torch"):
        biases.clear()
        with ops.force_impl("auto" if impl == "kernel" else "torch"):
            loss = t5_loss_fn(model)(params, *batch)
            got[impl] = torch.autograd.grad(
                loss, [params[n] for n in names] + biases)
    for h in hooks:
        h.remove()
    out = {}
    for i, (n, st) in enumerate(zip(names, stacks)):
        gk, gp, db = got["kernel"][i], got["torch"][i], got["torch"][2 + i]
        S = db.shape[-1]
        A = st.rel_pos.one_hot(S, S).t() @ db[0].abs().permute(1, 2, 0) \
            .reshape(S * S, -1)
        dn = (gk - gp).norm().item()
        out[n] = dict(norm_rel=abs(gk.norm() - gp.norm()).item()
                      / gp.norm().item(),
                      diff_rel=dn / gp.norm().item(),
                      diff_over_abs_sums=dn / A.norm().item(),
                      cancellation=(gp.norm() / A.norm()).item())
    print(f"phase train-t5-parity: O0 depth {T5PAR_DEPTH} rel-pos table "
          f"gradients, kernels vs plain {out} [{card}]")
    del model, params, got, biases
    torch.cuda.empty_cache()
    bad = {n: v for n, v in out.items() if not v["norm_rel"] <= 1e-4}
    return out, (f"train-t5-parity: rel-pos table gradients differ {bad}"
                 if bad else None)


def run_t5_parity(torch, ops, card):
    """train-t5-parity: T5-large width, depth `T5PAR_DEPTH` a stack,
    the bench's batch, lr 1e-5, through the kernels and the plain
    versions (`train_parity`: O0 losses and grad norms, the O2_fp16
    forced overflow) with the fused and the materialized head; the
    fused head's step-1 O0 loss against the materialized head's on the
    same weights; and `rel_pos_grads`. Returns (results, failure or
    None)."""
    par = {}
    for fuse in (True, False):
        label = f"fuse_head={fuse}"

        def make(level, packed, factor, fuse=fuse):
            return make_t5_trainer(torch, level, T5PAR_DEPTH, SEED + 1,
                                   fuse_head=fuse, factor=factor,
                                   lr=T5PAR_LR)

        par[label] = train_parity(torch, ops, True, fuse, make=make)
        need = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_dq",
                "flash_dkv", "flash_dbias") + HEAD_KERNELS[fuse]
        other = ("softmax_fwd", "softmax_bwd") + HEAD_KERNELS[not fuse]
        err = check_train_parity(par[label], card, label, True, fuse,
                                 kernels=(need, other),
                                 phase="train-t5-parity")
        if err:
            return par, err
    lf = par["fuse_head=True"]["kernel"]["o0"]["dense"][0][0]
    lm = par["fuse_head=False"]["kernel"]["o0"]["dense"][0][0]
    print(f"phase train-t5-parity: O0 depth {T5PAR_DEPTH} step-1 loss on "
          f"the same weights, fuse_head=True {lf:.7f} vs fuse_head=False "
          f"{lm:.7f}, relative difference {abs(lf - lm) / abs(lm):.2e} "
          f"[{card}]")
    if abs(lf - lm) > 1e-5 * abs(lm):
        return par, (f"train-t5-parity: the fused head's loss {lf} is not "
                     f"the materialized head's {lm}")
    par["rel_pos"], err = rel_pos_grads(torch, ops, card)
    return par, err


#: mha: fairseq's transformer-big width (1024, 16 heads) at S x B
MHA_E, MHA_H, MHA_S, MHA_B = 1024, 16, 512, 8


def run_mha(torch, ops, card, launches):
    """mha: `SelfMultiheadAttn(1024, 16, dropout=0.1,
    include_norm_add=True)` and `EncdecMultiheadAttn` at the same width,
    bf16 (S, B, E) inputs with a (B, 1, 1, S) additive key-padding mask
    (-10000 and NEG_INF on the pads), forward and backward in training
    (seed `SEED`) through the kernels and through the plain versions:
    the output by the bf16 rule of the kernels phase, every gradient (the
    inputs' and the parameters') within 1e-2 relative (Frobenius); the
    kernels' launches exactly LN 1/1, flash 1/1/1, dbias 0 (the mask
    takes no gradient), bias-dropout-add 1/1. Adds the launches to
    ``launches``. Returns (results, failure or None)."""
    from apex1_tpu_torch import EncdecMultiheadAttn, SelfMultiheadAttn
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    x, mem = rnd(MHA_S, MHA_B, MHA_E), rnd(MHA_S, MHA_B, MHA_E)
    dout = rnd(MHA_S, MHA_B, MHA_E)
    mask = flash_bias(torch, "mask", MHA_B, 1, 1, MHA_S, None)
    want_launches = {"layer_norm_fwd": 1, "layer_norm_bwd": 1,
                     "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                     "bda_fwd": 1, "bda_bwd": 1}
    results = {}
    for name, mod, inputs in (
            ("self", SelfMultiheadAttn(MHA_E, MHA_H, dropout=0.1,
                                       include_norm_add=True,
                                       device="cuda", seed=SEED), (x,)),
            ("encdec", EncdecMultiheadAttn(MHA_E, MHA_H, dropout=0.1,
                                           include_norm_add=True,
                                           device="cuda", seed=SEED),
             (x, mem))):
        def run():
            xs = [t.detach().requires_grad_() for t in inputs]
            for p in mod.parameters():
                p.grad = None
            out = mod(*xs, attn_mask=mask, is_training=True,
                      dropout_seed=SEED)
            out.backward(dout)
            return out.detach(), {**{f"d_input{i}": t.grad
                                     for i, t in enumerate(xs)},
                                  **{n: p.grad.clone() for n, p in
                                     mod.named_parameters()}}

        ops.reset_launches()
        out, grads = run()
        torch.cuda.synchronize()
        got = {n: c for n, c in ops.launch_counts().items() if c}
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        with ops.force_impl("torch"):
            wout, wgrads = run()
        eo = max_errs(out, wout, *TOLS["bfloat16"])
        rel = {n: ((g.float() - wgrads[n].float()).norm()
                   / wgrads[n].float().norm()).item()
               for n, g in grads.items()}
        ms = event_ms(run, iters=5)
        with ops.force_impl("torch"):
            pl_ms = event_ms(run, iters=3)
        results[name] = dict(out_abs=eo[0], out_worst=eo[1],
                             grad_rel=rel, launches=got, ms=ms,
                             plain_ms=pl_ms)
        print(f"phase mha: {type(mod).__name__}({MHA_E}, {MHA_H}, "
              f"dropout=0.1, include_norm_add=True) S={MHA_S} B={MHA_B} "
              f"bf16, key-padding mask; out max_abs={eo[0]:.3g} "
              f"worst/allowed={eo[1]:.3g}; grads relative "
              f"{ {n: float(f'{v:.3g}') for n, v in rel.items()} }; "
              f"forward+backward {ms:.3f} ms (plain {pl_ms:.3f}); launches "
              f"{got} [{card}]")
        if got != want_launches:
            return results, (f"mha {name}: launches {got}, expected "
                             f"{want_launches}")
        if eo[1] > 1 or any(not v <= 1e-2 for v in rel.values()):
            return results, (f"mha {name}: kernels disagree with the plain "
                             f"versions: out {eo}, grads {rel}")
        del mod, out, grads, wout, wgrads
        torch.cuda.empty_cache()
    return results, None


# ---- the bench's llama_longctx and decode -----------------------------------

#: llama_longctx (`bench.py:333-347`): B x S, layers, A100 proxy
LCTX_B, LCTX_S, LCTX_LAYERS, LCTX_PROXY = 1, 16384, 16, 11_100.0
#: decode (`bench.py:403-463`): rows, prompt, new tokens, timed calls,
#: A100 proxy
DEC_B, DEC_S0, DEC_N, DEC_ITERS, DEC_PROXY = 8, 128, 128, 3, 6_100.0


def run_longctx(torch, ops, card, launches, steps: int = 3):
    """train-llama-longctx: the bench's ``llama_longctx`` (hidden 2048,
    GQA 32/4 of 64, ffn 5632, 16 layers, vocab 32000, remat, fused head)
    at B x S = 1 x 16384, ``steps`` O2 steps: finite losses, exact
    launches (`llama_launches`), tokens/s beside the A100 proxy, peak
    memory. Adds the launches to ``launches``. Returns (results,
    failure or None)."""
    ops.reset_launches()
    cfg, state, step, batch = make_llama_trainer(
        torch, "O2", LCTX_LAYERS, SEED, S=LCTX_S, B=LCTX_B,
        widths=LLAMA_08B)
    rows, peak = run_steps(torch, ops, state, step, batch, steps)
    del state, step, batch
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    per_step = llama_launches(LCTX_LAYERS, False)
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med = walls[len(walls) // 2]
    n_tok = LCTX_B * LCTX_S
    out = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
               tokens_per_s=n_tok / med * 1e3,
               proxy_tokens_per_s=LCTX_PROXY)
    for r in rows:
        print(f"phase train-llama-longctx: O2 step {r['step']} loss "
              f"{r['loss']:.6f} grad_norm {r['grad_norm']:.4f} wall "
              f"{r['wall_ms']:.1f} ms launches {r['launches']} [{card}]")
    print(f"phase train-llama-longctx: llama_longctx O2 remat fuse_head="
          f"True B={LCTX_B} S={LCTX_S} hidden {cfg.hidden_size} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim} ffn "
          f"{cfg.ffn_size} layers {cfg.num_layers} vocab {cfg.vocab_size}; "
          f"step wall {med:.2f} ms (median of steps 2-{len(rows)}), "
          f"{n_tok / med * 1e3:.0f} tokens/s (A100 proxy "
          f"{LCTX_PROXY:.0f}, bench.py), peak memory {peak:.2f} GiB "
          f"[{card}]")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        return out, f"train-llama-longctx: a loss is not finite: {losses}"
    for r in rows:
        if r["launches"] != per_step:
            return out, (f"train-llama-longctx step {r['step']}: launches "
                         f"{r['launches']}, expected {per_step}")
    torch.cuda.empty_cache()
    return out, None


def run_decode(torch, ops, card, launches):
    """decode: the bench's ``decode`` (the llama_longctx model without
    remat, O2) through `generate` with `llama_decoder`: 8 prompts of 128
    tokens of ``np.random.default_rng(0)``, 128 new tokens greedy, a
    dense cache of 257 slots; one warm-up call, then `DEC_ITERS` timed
    calls: tokens/s = B·N over the median call wall beside the A100
    proxy, peak memory, the flash prefill (16 launches a call), tokens
    inside the vocabulary. Adds the timed calls' launches to
    ``launches``. Returns (results, failure or None)."""
    import numpy as np
    from apex1_tpu_torch import llama_decoder
    from apex1_tpu_torch.models.generate import generate
    cfg, model = make_llama("O2", LCTX_LAYERS, SEED, widths=LLAMA_08B,
                            remat=False, max_seq_len=DEC_S0 + DEC_N + 8)
    apply_fn, make_cache = llama_decoder(model)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DEC_B, DEC_S0))).cuda()

    def run():
        cache = make_cache(DEC_B, DEC_S0 + DEC_N + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(apply_fn, prompt, max_new_tokens=DEC_N, cache=cache,
                        vocab_size=cfg.vocab_size)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    run()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    walls = []
    for _ in range(DEC_ITERS):
        toks, wall = run()
        walls.append(wall)
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    for n, c in counts.items():
        launches[n] = launches.get(n, 0) + c
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(walls)[len(walls) // 2]
    rate = DEC_B * DEC_N / med
    out = dict(walls_s=walls, tokens_per_s=rate, proxy_tokens_per_s=DEC_PROXY,
               peak_gib=peak, launches=counts)
    print(f"phase decode: llama_longctx widths, {cfg.num_layers} layers, O2, "
          f"no remat; {DEC_B} prompts of {DEC_S0} tokens, {DEC_N} new tokens "
          f"greedy, dense cache {DEC_S0 + DEC_N + 1} slots; call walls "
          f"{[round(w, 3) for w in walls]} s, {rate:.0f} tokens/s (A100 "
          f"proxy {DEC_PROXY:.0f}, bench.py), peak memory {peak:.2f} GiB, "
          f"launches over {DEC_ITERS} calls {counts} [{card}]")
    del model, apply_fn
    torch.cuda.empty_cache()
    if counts.get("flash_fwd") != DEC_ITERS * cfg.num_layers:
        return out, (f"decode: the prefill launched flash_fwd "
                     f"{counts.get('flash_fwd')} times over {DEC_ITERS} "
                     f"calls, expected {DEC_ITERS * cfg.num_layers}")
    if toks.shape != (DEC_B, DEC_N) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        return out, (f"decode: generate gave {tuple(toks.shape)} or a token "
                     f"outside the vocabulary")
    return out, None


# ---- the decode slice: int8 weight-only decode, LoRA, speculative verify ---

#: the bench's ``decode_int8`` (`bench.py:403-463`, ``quant=True``): the
#: decode phase's model and workload through `llama_quant_decoder`
DEC8_PROXY = 12_200.0
#: int8_mm launches a forward of the Llama decoder: q, k, v, o, gate, up
#: and down a layer, and the head
INT8_PER_LAYER = 7


def representable(torch, model, seed: int):
    """Every projection and the head of a `Llama` replaced by q · 2^-9
    with q drawn in [-127, 127] on the card and each output channel
    reaching |q| = 127: int8 with per-channel scales and bf16 both hold
    these weights exactly (2^-9 about the 2e-3 of
    tests/test_quantized.py, a power of two so bf16 keeps it), so the
    int8 and bf16 decoders compute with the same weights."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_norm") or name in ("norm", "tok_embeddings"):
                continue
            q = torch.randint(-127, 128, p.shape, generator=gen,
                              device="cuda")
            if name == "output":       # (vocab, hidden): channels are rows
                q[:, 0] = 127
            else:                      # (in, out): channels are columns
                q[0, :] = 127
            p.copy_(q.float() * 2.0 ** -9)
    return model


def decode_model(torch, depth: int, exact: bool = False,
                 policy: str = "O2"):
    """The bench's decode model (`LLAMA_08B` widths, ``depth`` layers,
    ``policy``, no remat), weights drawn on the card (`representable`
    with ``exact``), and its prompt: 8 x 128 tokens of
    ``np.random.default_rng(0)``."""
    import numpy as np
    cfg, model = make_llama(policy, depth, SEED, widths=LLAMA_08B,
                            remat=False, max_seq_len=DEC_S0 + DEC_N + 8)
    if exact:
        representable(torch, model, SEED + 3)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DEC_B, DEC_S0))).cuda()
    return cfg, model, prompt


def decode_call(torch, apply_fn, make_cache, prompt, vocab: int,
                record=None):
    """One greedy `generate` of `DEC_N` tokens on a dense cache; returns
    (tokens (B, DEC_N) numpy, wall s). ``record`` collects each step's
    last-position logits."""
    from apex1_tpu_torch.models.generate import generate
    fn = apply_fn
    if record is not None:
        def fn(*a, **kw):
            logits, cache = apply_fn(*a, **kw)
            record.append(logits[:, -1].float())
            return logits, cache
    cache = make_cache(DEC_B, DEC_S0 + DEC_N + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(fn, prompt, max_new_tokens=DEC_N, cache=cache,
                    vocab_size=vocab)
    torch.cuda.synchronize()
    return toks.cpu().numpy(), time.perf_counter() - t0


def run_decode_int8(torch, ops, card, launches):
    """decode-int8: the bench's ``decode_int8``: `run_decode`'s model
    and workload (16 layers, O2, 8 prompts of 128 tokens, 128 new
    tokens greedy) through `llama_quant_decoder` and `generate`; one
    warm-up call, then `DEC_ITERS` timed calls. Prints tokens/s beside
    the A100 proxy, peak memory and the int8 weight bytes; every forward
    launches int8_mm 7 times a layer and once for the head, and each
    call's prefill flash 16 times. Adds the timed calls' launches to
    ``launches``. Returns (results, failure or None)."""
    from apex1_tpu_torch import llama_quant_decoder
    cfg, model, prompt = decode_model(torch, LCTX_LAYERS)
    apply_fn, make_cache, qp = llama_quant_decoder(model)
    del model
    torch.cuda.empty_cache()
    leaves = [qp["output"]] + [v for k, lp in qp.items()
                               if k.startswith("layer")
                               for v in lp.values() if isinstance(v, dict)]
    w_bytes = sum(v["q"].numel() for v in leaves)
    decode_call(torch, apply_fn, make_cache, prompt, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    walls = []
    for _ in range(DEC_ITERS):
        toks, wall = decode_call(torch, apply_fn, make_cache, prompt,
                                 cfg.vocab_size)
        walls.append(wall)
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    for n, c in counts.items():
        launches[n] = launches.get(n, 0) + c
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(walls)[len(walls) // 2]
    rate = DEC_B * DEC_N / med
    L = cfg.num_layers
    want = {"int8_mm": DEC_ITERS * DEC_N * (INT8_PER_LAYER * L + 1),
            "flash_fwd": DEC_ITERS * L}
    out = dict(walls_s=walls, tokens_per_s=rate,
               proxy_tokens_per_s=DEC8_PROXY, peak_gib=peak,
               int8_weight_bytes=w_bytes, launches=counts)
    print(f"phase decode-int8: llama_longctx widths, {L} layers, O2, int8 "
          f"weights ({w_bytes / 1e9:.3f} GB int8, {len(leaves)} matrices), "
          f"{DEC_B} prompts of {DEC_S0} tokens, {DEC_N} new tokens greedy; "
          f"call walls {[round(w, 3) for w in walls]} s, {rate:.0f} "
          f"tokens/s (A100 proxy {DEC8_PROXY:.0f}, bench.py), peak memory "
          f"{peak:.2f} GiB, launches over {DEC_ITERS} calls {counts} "
          f"[{card}]")
    del apply_fn, qp
    torch.cuda.empty_cache()
    for name, n in want.items():
        if counts.get(name) != n:
            return out, (f"decode-int8: {name} launched {counts.get(name)} "
                         f"times over {DEC_ITERS} calls, expected {n}")
    if toks.shape != (DEC_B, DEC_N) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        return out, (f"decode-int8: generate gave {toks.shape} or a token "
                     f"outside the vocabulary")
    return out, None


#: decode-int8-parity's pairs: (policy, run, reference). A first
#: differing token is a near-tie when the reference's top-2 gap
#: (relative) is below the largest difference of the two runs' logits at
#: that step (relative to the top logit; both runs computed it from the
#: same tokens), and that difference is at most `DEC8_MOVE`. The int8
#: path rounds every activation to bf16 (its matmul's contract, at O0
#: too), so a sum that lands on the other side of a bf16 rounding moves
#: the next layer's inputs by an ulp, and the logits by about one bf16
#: ulp (2^-7) of the top logit: the 1e-4 of the fp32 parity phases does
#: not apply (measured on the H100: differences of 3e-3 to 1e-2)
DEC8_PAR = (("O2", "int8", "bf16"), ("O0", "int8", "int8 plain"))
DEC8_MOVE = 2.0 ** -6


def run_decode_int8_parity(torch, ops, card):
    """decode-int8-parity: depth 2 at decode-int8's widths, weights
    exactly representable (`representable`), greedy. At O2 the int8
    decode against the bf16 `llama_decoder` stream on the same weights;
    at O0 the int8 decode through the kernels against the plain
    versions on the card. Equal streams, or a first differing token at
    a near-tie (`DEC8_PAR`). Returns (results, failure or None)."""
    from apex1_tpu_torch import llama_decoder, llama_quant_decoder
    from apex1_tpu_torch.models.near_tie import first_flips, top2_gap
    out, fail_msg = {}, None
    for policy, a, b in DEC8_PAR:
        cfg, model, prompt = decode_model(torch, 2, exact=True,
                                          policy=policy)
        q_apply, q_make, _ = llama_quant_decoder(model)
        f_apply, f_make = llama_decoder(model)
        runs, recs = {}, {}
        for label, fn, make, impl in (
                ("int8", q_apply, q_make, "auto"),
                ("int8 plain", q_apply, q_make, "torch"),
                ("bf16", f_apply, f_make, "auto")):
            if label not in (a, b):
                continue
            recs[label] = []
            with ops.force_impl(impl):
                runs[label] = decode_call(torch, fn, make, prompt,
                                          cfg.vocab_size, recs[label])[0]
        flips = first_flips(runs[a], runs[b], lambda r, t: top2_gap(
            recs[b][t], r, t, 0.0, cfg.vocab_size))
        moved = [((recs[a][t][r] - recs[b][t][r]).abs().max()
                  / recs[b][t][r].abs().max()).item() for r, t, _ in flips]
        out[f"{a} vs {b}"] = dict(policy=policy, flips=flips,
                                  logit_moved=moved)
        print(f"phase decode-int8-parity: depth 2, {policy}, exactly "
              f"representable weights, greedy, {a} vs {b}: streams "
              f"differing {len(flips)} of {DEC_B}; (row, step, top-2 gap "
              f"relative) at the first differing token {flips}, the "
              f"logits' largest difference there relative to the top "
              f"logit {moved} (a near-tie: gap below it, it at most "
              f"{DEC8_MOVE:g}) [{card}]")
        if fail_msg is None and any(
                g >= m or m > DEC8_MOVE
                for (_, _, g), m in zip(flips, moved)):
            fail_msg = (f"decode-int8-parity {a} vs {b}: streams differ "
                        f"where the top-2 gap is not a near-tie: {flips}, "
                        f"logits moved {moved}")
        del model, q_apply, f_apply, recs
        torch.cuda.empty_cache()
    return out, fail_msg


#: serve-lora: the paged engine over the decode model at `LLAMA_08B`
#: widths with three rank-16 tenants; request i of `workload` goes to
#: tenant i % 4 (3: adapterless)
LORA_RANK = 16
TENANTS = ("tenant-0", "tenant-1", "tenant-2")
LORA_ENGINE_KW = dict(LLAMA_ENGINE_KW, lora_rank=LORA_RANK,
                      lora_max_adapters=4)
#: serve-lora's requests re-run alone (two tenants and an adapterless one)
LORA_SOLO = (4, 6, 7)


def tenant_of(i: int):
    return TENANTS[i % 4] if i % 4 < len(TENANTS) else None


class sampling_record:
    """Records, while active, the fp32 logits row each engine sampling
    call draws from, keyed by (seed, output position): the last draw at
    a key is the one a stream emitted."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        import apex1_tpu_torch.serving.engine as em
        self.em, self.real = em, em.fused_sample
        store, real = self.store, self.real

        def fn(logits, seeds, positions, **kw):
            for r, key in enumerate(zip(seeds.tolist(), positions.tolist())):
                store[key] = logits[r].float().clone()
            return real(logits, seeds, positions, **kw)

        em.fused_sample = fn
        return self

    def __exit__(self, *exc):
        self.em.fused_sample = self.real


def sample_top2(torch, row, seed: int, pos: int, temperature: float,
                vocab: int):
    """The two largest scores the counter-keyed sampler took its argmax
    over: the logits / temperature plus the gumbel noise of
    ``fold_in(key(seed), pos)`` (the logits when greedy)."""
    from apex1_tpu_torch.ops.paged_decode import (_bits_to_gumbel, _row_keys,
                                                  _uniform_bits)
    sc = row.double().cpu().clone()
    sc[vocab:] = -1e30
    if temperature:
        k1, k2 = _row_keys(torch.tensor([seed]), torch.tensor([pos]))
        col = torch.arange(sc.numel())[None]
        g = _bits_to_gumbel(_uniform_bits(k1[:, None], k2[:, None], col,
                                          sc.numel()))[0]
        sc = sc / temperature + g.double()
    top = torch.topk(sc, 2).values
    return top[0].item(), top[1].item()


def sample_gap(torch, row, seed: int, pos: int, temperature: float,
               vocab: int) -> float:
    """(top1 - top2) / |top1| of the sampling scores (`sample_top2`)."""
    t1, t2 = sample_top2(torch, row, seed, pos, temperature, vocab)
    return (t1 - t2) / abs(t1)


def serve_lora(torch, model, cfg, *, lora=True, num_draft=0, only=None,
               record=None):
    """The workload (`workload`, 64 new tokens at T = 0.7) through the
    paged engine over ``model``: with ``lora``, three tenants registered
    (A ~ N(0, 1/H), B ~ N(0, 1/16) drawn on the card from a seed, scale
    = rank) and request i sent as `tenant_of`; ``num_draft`` > 0 runs
    speculative verify; ``only`` keeps those request indices. Returns
    ({index: stream}, engine, wall s, decode-only step walls ms)."""
    from apex1_tpu_torch import Engine, EngineConfig, llama_decoder
    apply_fn, make_cache = llama_decoder(model)
    kw = dict(LORA_ENGINE_KW if lora else LLAMA_ENGINE_KW,
              num_draft=num_draft)
    eng = Engine(apply_fn, make_cache, EngineConfig(**kw),
                 device=model.device,
                 lora_head=model.output if lora else None)
    if lora:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        H, V = cfg.hidden_size, cfg.vocab_size
        for name in TENANTS:
            eng.register_adapter(
                name, torch.randn(H, LORA_RANK, generator=gen,
                                  device="cuda") * H ** -0.5,
                torch.randn(LORA_RANK, V, generator=gen, device="cuda")
                * 0.25, scale=float(LORA_RANK))
    ids = {}
    for i, r in enumerate(workload(cfg.vocab_size, SEED)):
        if only is None or i in only:
            ids[i] = eng.submit(r["tokens"], max_new_tokens=64,
                                seed=r["seed"], tenant=tenant_of(i))
    step_ms = []
    with (contextlib.nullcontext() if record is None
          else sampling_record(record)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.scheduler.depth > 0 or any(s is not None
                                             for s in eng.slot_view()):
            chunks = eng.metrics.get_counter("prefill_chunks")
            ts = time.perf_counter()
            eng.step()
            if eng.metrics.get_counter("prefill_chunks") == chunks:
                step_ms.append((time.perf_counter() - ts) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    streams = {i: [int(t) for t in eng.results[r].tokens]
               for i, r in ids.items()}
    return streams, eng, wall, step_ms


def run_serve_lora(torch, ops, card, launches):
    """serve-lora: the decode model (`LLAMA_08B` widths, 16 layers, O2)
    through the paged engine with ``lora_rank=16``: the 16 requests
    mixing three tenants and adapterless ones; lora_delta launched once
    per decode step and prefill chunk; every tenant's stream differs
    from the same request's adapterless stream; `LORA_SOLO` re-run alone
    give their streams bit for bit; every adapterless stream equals the
    same request's on a ``lora_rank=0`` engine. Then the same load with
    ``num_draft=4`` (accept rate, tokens/s). Adds the runs' launches to
    ``launches``. Returns (results, failure or None)."""
    cfg, model = make_llama("O2", LCTX_LAYERS, SEED, widths=LLAMA_08B,
                            remat=False)
    out, runs = {}, {}
    ops.reset_launches()
    for label, kw in (("mixed", {}), ("base", dict(lora=False)),
                      *((f"solo {i}", dict(only={i})) for i in LORA_SOLO),
                      ("spec", dict(num_draft=4))):
        before = ops.launch_counts()
        streams, eng, wall, step_ms = serve_lora(torch, model, cfg, **kw)
        got = {k: v - before[k] for k, v in ops.launch_counts().items()
               if v != before[k]}
        m = eng.metrics
        fwd = (m.get_counter("decode_steps") + m.get_counter("verify_steps")
               + m.get_counter("prefill_chunks"))
        n_tok = sum(len(v) for v in streams.values())
        summ = m.summary()
        runs[label] = streams
        out[label] = dict(wall_s=wall, tokens=n_tok, launches=got,
                          forwards=fwd, summary=summ,
                          step_ms=sum(step_ms) / max(len(step_ms), 1))
        print(f"phase serve-lora: {label}: llama_longctx widths, "
              f"{cfg.num_layers} layers, O2, "
              f"lora_rank={eng.cfg.lora_rank} num_draft={eng.cfg.num_draft};"
              f" {len(streams)} requests, {n_tok} tokens, wall {wall:.2f} s,"
              f" {n_tok / wall:.1f} tok/s, mean decode-step wall "
              f"{out[label]['step_ms']:.2f} ms over {len(step_ms)} steps, "
              f"prefill chunks {m.get_counter('prefill_chunks')}, decode "
              f"steps {m.get_counter('decode_steps')}, verify steps "
              f"{m.get_counter('verify_steps')}, accept rate "
              f"{summ.get('accept_rate', 0):.3f}, launches {got} [{card}]")
        bad = [i for i, v in streams.items() if len(v) != 64
               or min(v) < 0 or max(v) >= cfg.vocab_size]
        if {r.status for r in eng.results.values()} != {"done"} or bad:
            return out, f"serve-lora {label}: requests {bad} not done right"
        want = fwd if eng.cfg.lora_rank else 0
        if got.get("lora_delta", 0) != want or got.get("fused_sample") != fwd:
            return out, (f"serve-lora {label}: lora_delta launched "
                         f"{got.get('lora_delta', 0)} and fused_sample "
                         f"{got.get('fused_sample')} times over {fwd} "
                         f"forwards")
        del eng
        torch.cuda.empty_cache()
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    mixed, base = runs["mixed"], runs["base"]
    same_tenant = [i for i in mixed if tenant_of(i) and mixed[i] == base[i]]
    diff_plain = [i for i in mixed if not tenant_of(i)
                  and mixed[i] != base[i]]
    diff_solo = [i for i in LORA_SOLO if runs[f"solo {i}"][i] != mixed[i]]
    spec_equal = sum(runs["spec"][i] == mixed[i] for i in mixed)
    out["checks"] = dict(tenant_equal_to_base=same_tenant,
                         adapterless_differing=diff_plain,
                         solo_differing=diff_solo,
                         spec_streams_equal=spec_equal)
    print(f"phase serve-lora: tenant streams equal to the adapterless "
          f"stream {same_tenant} (must be none); adapterless streams "
          f"differing from lora_rank=0 {diff_plain} (none); solo re-runs "
          f"{list(LORA_SOLO)} differing {diff_solo} (none); num_draft=4 "
          f"streams equal to num_draft=0 {spec_equal} of {len(mixed)} "
          f"[{card}]")
    del model
    torch.cuda.empty_cache()
    if same_tenant or diff_plain or diff_solo:
        return out, f"serve-lora: {out['checks']}"
    return out, None


def run_serve_lora_parity(torch, ops, card):
    """serve-lora-parity: depth 2, O0, the workload with three tenants:
    the kernels against the plain versions on the card, and
    ``num_draft=2`` against ``num_draft=0`` with and without LoRA. Equal
    streams, or a first differing token where the reference run's
    sampling scores have a top-2 gap below 1e-4 relative. Returns
    (results, failure or None)."""
    from apex1_tpu_torch.models.near_tie import first_flips
    cfg, model = make_llama("O0", LPAR_DEPTH, SEED + 1, widths=LLAMA_08B,
                            remat=False)
    seeds = [r["seed"] for r in workload(cfg.vocab_size, SEED)]
    runs, recs, out = {}, {}, {}
    for label, impl, kw, rec in (
            ("lora", "auto", {}, True),
            ("lora plain", "torch", {}, True),
            ("lora spec", "auto", dict(num_draft=2), False),
            ("base", "auto", dict(lora=False), True),
            ("base spec", "auto", dict(lora=False, num_draft=2), False)):
        recs[label] = {} if rec else None
        with ops.force_impl(impl):
            streams, _, wall, _ = serve_lora(torch, model, cfg,
                                             record=recs[label], **kw)
        runs[label] = [streams[i] for i in sorted(streams)]
        out[label] = dict(wall_s=wall)
    temp = LLAMA_ENGINE_KW["temperature"]
    for a, b in (("lora", "lora plain"), ("lora spec", "lora"),
                 ("base spec", "base")):
        ref = recs[b]

        def gap_at(r, t):
            row = ref.get((seeds[r], t))
            return (float("inf") if row is None else
                    sample_gap(torch, row, seeds[r], t, temp, cfg.vocab_size))

        flips = first_flips(runs[a], runs[b], gap_at)
        out[f"{a} vs {b}"] = flips
        print(f"phase serve-lora-parity: O0 depth {LPAR_DEPTH}, "
              f"{len(runs[a])} requests, {a} vs {b}: streams differing "
              f"{len(flips)}; (request, token, top-2 gap relative) at the "
              f"first differing token {flips} [{card}]")
    if runs["lora"] == runs["base"]:
        return out, "serve-lora-parity: the adapters changed no stream"
    del model, recs
    torch.cuda.empty_cache()
    for name, flips in out.items():
        if isinstance(flips, list) and any(g >= 1e-4 for _, _, g in flips):
            return out, (f"serve-lora-parity {name}: streams differ where "
                         f"the top-2 gap is not a near-tie: {flips}")
    return out, None


def profile_decode_int8(torch, steps: int = 16) -> dict:
    """``--profile``: where a decode-int8 token step's time goes: the
    prompt's prefill, then ``steps`` greedy decode steps of the 16-layer
    int8 decoder under torch.profiler (device ms a step, busy share, the
    largest kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from apex1_tpu_torch import llama_quant_decoder
    cfg, model, prompt = decode_model(torch, LCTX_LAYERS)
    apply_fn, make_cache, _ = llama_quant_decoder(model)
    del model
    cache = make_cache(DEC_B, DEC_S0 + 8 + steps + 1)
    logits, cache = apply_fn(prompt, cache, 0)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    idx = DEC_S0
    for _ in range(4):                           # warm up
        logits, cache = apply_fn(tok[:, None], cache, idx)
        tok, idx = logits[:, -1].argmax(-1).to(torch.int32), idx + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = apply_fn(tok[:, None], cache, idx)
            tok, idx = logits[:, -1].argmax(-1).to(torch.int32), idx + 1
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    out = kernel_split(torch, prof, steps, wall)
    del apply_fn, cache
    torch.cuda.empty_cache()
    return out


def profile_serve_lora(torch, steps: int = 10) -> dict:
    """``--profile``: where a serve-lora decode step's time goes: 8
    requests (256-token prompts; tenants 0-2 and one adapterless in
    turn) admitted, then ``steps`` decode steps of the 16-layer model at
    O2 with ``lora_rank=16`` under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg, model = make_llama("O2", LCTX_LAYERS, SEED, widths=LLAMA_08B,
                            remat=False)
    streams, eng, _, _ = serve_lora(torch, model, cfg, only=set())
    rng = np.random.default_rng(SEED)
    for i in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 256).astype(np.int32),
                   max_new_tokens=8 + steps + 4, seed=i, tenant=tenant_of(i))
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    out = {"active": eng.n_active, **kernel_split(torch, prof, steps, wall)}
    del eng, model
    torch.cuda.empty_cache()
    return out


def profile_t5(torch, steps: int = 3) -> dict:
    """``--profile``: where a ``t5`` O2 training step's time goes, as
    `profile_train` measures it."""
    _, state, step, batch = make_t5_trainer(torch, "O2", T5LAYERS, SEED)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, *batch)
    out = {"bench": "t5", **profiled_steps(torch, state, step, batch, steps),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state, step, batch
    torch.cuda.empty_cache()
    return out


# ---- ResNet-50 and GPT-2 under O1_fp16: the optimizers and amp slice -----

#: the JAX bench's ``resnet`` (`bench.py:261-300`): ResNet-50 at B
#: images of HW x HW x 3 under O2 with FusedSGD, the running statistics
#: carried as the step's aux; RESNET_STEPS steps
RESNET_B, RESNET_HW, RESNET_STEPS = 64, 224, 6
#: resnet-parity's reduced ResNet: stages, width, images, steps
RESNET_PAR = dict(stage_sizes=(1, 1, 1, 1), width=64, hw=64, steps=2)
#: the JAX bench's ``gpt2_fp16`` (`bench.py:188-216`): GPT-2 124M at
#: B x S under O1_fp16 (dynamic loss scale), default use_flash and
#: fuse_head, 10 steps
GPT2_FP16_STEPS = 10


def make_resnet_trainer(torch, level: str, seed: int, B: int, hw: int,
                        **cfg_kw):
    """ResNet (ResNet-50 unless ``cfg_kw`` cut it) on the card, weights
    from ``seed``, under ``Amp(fused_sgd(0.1, momentum=0.9,
    weight_decay=1e-4), opt_level=level)`` with ``has_aux=True``; its
    batch: B images of hw x hw x 3 and their labels from
    ``np.random.default_rng(seed)``. The step carries ``(amp state,
    running statistics)`` as the bench does."""
    import numpy as np
    from apex1_tpu_torch import (Amp, ResNet, ResNetConfig, fused_sgd,
                                 get_policy, resnet_loss_fn)
    cfg = ResNetConfig.resnet50(policy=get_policy(level), **cfg_kw)
    model = ResNet(cfg, device="cuda", seed=seed)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(B, hw, hw, 3)).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, (B,))).cuda()
    amp = Amp(fused_sgd(0.1, momentum=0.9, weight_decay=1e-4),
              opt_level=level)
    inner = amp.make_train_step(resnet_loss_fn(model), has_aux=True)

    def step(carry, images, labels):
        state, stats = carry
        state, m = inner(state, images, labels, stats)
        return (state, m["aux"]), m

    carry = (amp.init(dict(model.named_parameters())),
             {k: v.clone() for k, v in model.named_buffers()})
    return cfg, carry, step, (images, labels)


def run_resnet(torch, ops, card, launches):
    """train-resnet: the bench's ``resnet``, RESNET_STEPS O2 steps, then
    3 steps under torch.profiler. Finite losses, one cross-entropy
    forward and backward launch a step and nothing else; images/s from
    the median wall of steps 2-n, device ms a step and busy share,
    peak memory."""
    ops.reset_launches()
    cfg, carry, step, batch = make_resnet_trainer(
        torch, "O2", SEED, RESNET_B, RESNET_HW)
    rows, peak, carry = run_steps(torch, ops, carry, step, batch,
                                  RESNET_STEPS, return_state=True)
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    prof = profiled_steps(torch, carry, step, batch)
    del carry, step, batch
    torch.cuda.empty_cache()
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med = walls[len(walls) // 2]
    for r in rows:
        print(f"phase train-resnet: O2 step {r['step']} loss "
              f"{r['loss']:.6f} grad_norm {r['grad_norm']:.4f} wall "
              f"{r['wall_ms']:.1f} ms launches {r['launches']} [{card}]")
    top = ", ".join(f"{t['name'][:48]} {t['ms_per_step']:.3f} ms x"
                    f"{t['calls']}" for t in prof["top"][:8])
    out = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
               images_per_s=RESNET_B / med * 1e3, profile=prof)
    print(f"phase train-resnet: ResNet-50 O2 fused_sgd(0.1, momentum 0.9, "
          f"wd 1e-4), running stats as the aux, B={RESNET_B} "
          f"{RESNET_HW}x{RESNET_HW}x3, {cfg.num_classes} classes; step wall "
          f"{med:.2f} ms (median of steps 2-{len(rows)}), "
          f"{out['images_per_s']:.1f} images/s (bench's A100 proxy 2,900), "
          f"device {prof['device_ms_per_step']:.3f} ms a step in a "
          f"{prof['step_wall_ms']:.2f} ms profiled step (busy "
          f"{prof['device_busy']:.3f}), peak memory {peak:.2f} GiB; "
          f"largest kernels a step: {top} [{card}]")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        return out, f"train-resnet: a loss is not finite: {losses}"
    for r in rows:
        if r["launches"] != {"xent_fwd": 1, "xent_bwd": 1}:
            return out, (f"train-resnet step {r['step']}: launches "
                         f"{r['launches']}, expected xent_fwd 1, xent_bwd 1")
    return out, None


def run_resnet_parity(torch, ops, card):
    """resnet-parity: the reduced ResNet (RESNET_PAR) at O0 through the
    kernels and through the plain versions on the card: per step the
    loss within 1e-5 relative, the grad norm within 1e-4 and every new
    running statistic within 1e-5 of its tensor's largest value; the
    kernel side launches the cross-entropy once a step each way, the
    plain side nothing."""
    import contextlib
    p = dict(RESNET_PAR)
    hw, steps = p.pop("hw"), p.pop("steps")
    out = {}
    for impl in ("kernel", "torch"):
        ctx = (ops.force_impl("torch") if impl == "torch"
               else contextlib.nullcontext())
        ops.reset_launches()
        with ctx:
            _, carry, step, batch = make_resnet_trainer(
                torch, "O0", SEED + 1, RESNET_B, hw, **p)
            rows, stats = [], []
            for _ in range(steps):
                carry, m = step(carry, *batch)
                rows.append((m["loss"].item(), m["grad_norm"].item()))
                stats.append(carry[1])
        out[impl] = dict(rows=rows, stats=stats, launches={
            k: n for k, n in ops.launch_counts().items() if n})
        del carry, step, batch
    k, pl = out["kernel"], out["torch"]
    stat_err = max(
        ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30)).item()
        for a, b in zip(k["stats"], pl["stats"]) for n in b)
    print(f"phase resnet-parity: O0 stages {p['stage_sizes']} width "
          f"{p['width']} B={RESNET_B} {hw}x{hw}, {steps} steps, (loss, "
          f"grad_norm) kernels {k['rows']} plain {pl['rows']}; running "
          f"stats worst error over their tensor's largest value "
          f"{stat_err:.3g}; launches kernels {k['launches']} plain "
          f"{pl['launches']} [{card}]")
    res = dict(rows={i: out[i]["rows"] for i in out}, stat_err=stat_err,
               launches={i: out[i]["launches"] for i in out})
    if pl["launches"] or k["launches"] != {"xent_fwd": steps,
                                           "xent_bwd": steps}:
        return res, f"resnet-parity: launches {res['launches']}"
    for (kl, kg), (ql, qg) in zip(k["rows"], pl["rows"]):
        if abs(kl - ql) > 1e-5 * abs(ql) or abs(kg - qg) > 1e-4 * abs(qg):
            return res, (f"resnet-parity: kernels {k['rows']} vs plain "
                         f"{pl['rows']}")
    if not stat_err <= 1e-5:
        return res, f"resnet-parity: running stats differ by {stat_err:.3g}"
    return res, None


def run_gpt2_fp16(torch, ops, card, launches):
    """train-gpt2-fp16: the bench's ``gpt2_fp16``, GPT2_FP16_STEPS
    O1_fp16 steps (flash, fused head) from a loss scale of 2^16, then
    one step with the loss multiplied by inf: it must be skipped, leave
    the params and the Adam moments bit for bit and halve the scale.
    Every loss finite; exact launches a step."""
    ops.reset_launches()
    cfg, state, step, batch = make_trainer(torch, "O1_fp16", 12, SEED,
                                           factor=True, use_flash=True,
                                           fuse_head=True)
    one = torch.ones((), device="cuda")
    rows, peak, state = run_steps(torch, ops, state, step, (one, *batch),
                                  GPT2_FP16_STEPS, return_state=True)
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    before = state
    after, m = step(before, torch.full((), float("inf"), device="cuda"),
                    *batch)
    kept = all(torch.equal(after.params[k], before.params[k])
               and torch.equal(after.opt_state.exp_avg[k],
                               before.opt_state.exp_avg[k])
               and torch.equal(after.opt_state.exp_avg_sq[k],
                               before.opt_state.exp_avg_sq[k])
               for k in before.params)
    forced = dict(finite=bool(m["grads_finite"].item()),
                  skipped=int(m["skipped_steps"].item()),
                  scale_used=m["loss_scale"].item(),
                  scale_after=after.loss_scale.scale.item(), kept=kept)
    del state, before, after, step, batch
    torch.cuda.empty_cache()
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med = walls[len(walls) // 2]
    per_step = train_launches(12, True, True)
    for r in rows:
        print(f"phase train-gpt2-fp16: O1_fp16 step {r['step']} loss "
              f"{r['loss']:.6f} grad_norm {r['grad_norm']:.4f} loss_scale "
              f"{r['loss_scale']:g} skipped_steps {r['skipped']} wall "
              f"{r['wall_ms']:.1f} ms launches {r['launches']} [{card}]")
    out = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
               tokens_per_s=TB * TS / med * 1e3,
               skipped=rows[-1]["skipped"],
               final_scale=rows[-1]["loss_scale"], forced=forced)
    print(f"phase train-gpt2-fp16: GPT-2 124M O1_fp16 use_flash=True "
          f"fuse_head=True B={TB} S={TS}; step wall {med:.2f} ms (median "
          f"of steps 2-{len(rows)}), {out['tokens_per_s']:.0f} tokens/s "
          f"(bench's A100 proxy 145,000), skipped steps {out['skipped']} "
          f"of {len(rows)}, loss scale at step {len(rows)} "
          f"{out['final_scale']:g}, peak memory {peak:.2f} GiB; forced "
          f"overflow {forced} [{card}]")
    # the steps before the first finite one overflowed while the scale
    # fell from 2^16; from there on every loss must be finite
    first = next((i for i, r in enumerate(rows)
                  if r["skipped"] == (rows[i - 1]["skipped"] if i else 0)),
                 len(rows))
    losses = [r["loss"] for r in rows[first:]]
    if not losses or not all(math.isfinite(v) for v in losses):
        return out, (f"train-gpt2-fp16: a loss after calibration is not "
                     f"finite: {[r['loss'] for r in rows]}")
    if rows[-1]["skipped"] >= len(rows) // 2:
        return out, (f"train-gpt2-fp16: {rows[-1]['skipped']} of "
                     f"{len(rows)} steps skipped")
    for r in rows:
        if r["launches"] != per_step:
            return out, (f"train-gpt2-fp16 step {r['step']}: launches "
                         f"{r['launches']}, expected {per_step}")
    if (forced["finite"] or not kept
            or forced["skipped"] != rows[-1]["skipped"] + 1
            or forced["scale_after"] != forced["scale_used"] / 2):
        return out, (f"train-gpt2-fp16: the forced overflow did not skip "
                     f"its step cleanly: {forced}")
    return out, None


def profile_resnet(torch, steps: int = 3) -> dict:
    """``--profile``: where a ``resnet`` O2 training step's time goes,
    as `profile_train` measures it."""
    _, carry, step, batch = make_resnet_trainer(torch, "O2", SEED,
                                                RESNET_B, RESNET_HW)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        carry, _ = step(carry, *batch)
    out = {"bench": "resnet", **profiled_steps(torch, carry, step, batch,
                                               steps),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del carry, step, batch
    torch.cuda.empty_cache()
    return out


# ---- the multi-GPU slice: tensor, sequence and context parallelism ------

#: the JAX package's A/B shapes (tools/bench_fused_comm.py:104-108): the
#: SP boundary MLP (S x hidden, ffn) and context-parallel attention at
#: `llama_longctx`'s shape (heads 32/4 of 64, 16384 tokens); the vocab-
#: parallel head at `llama_longctx`'s (16384 tokens x 2048 against 32000)
SP_S, SP_HID, SP_FFN = 8192, 2048, 8192
CP_B, CP_HQ, CP_HKV, CP_S, CP_D = 1, 32, 4, 16384, 64
VP_T, VP_H, VP_V = 16384, 2048, 32000
#: timed repetitions of a phase's step (the median is printed)
PAR_REPS = 3


def start_nccl(torch):
    """A one-rank NCCL process group (a file rendezvous in a temporary
    directory: no port) and `parallel_state`'s mesh over it. Returns the
    directory, for `stop_nccl`."""
    import tempfile
    from apex1_tpu_torch.parallel import init_distributed
    from apex1_tpu_torch.transformer import parallel_state as ps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    init_distributed("nccl", init_method=f"file://{tmp}/store", rank=0,
                     world_size=1)
    ps.initialize_model_parallel(1)
    return tmp


def stop_nccl(tmp: str) -> None:
    import shutil
    import torch.distributed as dist
    from apex1_tpu_torch.transformer import parallel_state as ps
    ps.destroy_model_parallel()
    dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)


def wall_ms(torch, fn, reps: int = PAR_REPS) -> float:
    """Host wall ms of ``fn()`` ending in a synchronize: the median of
    ``reps`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2]


def counted(torch, ops, fn):
    """``fn()``'s result, the kernel launches it made and its collective
    calls (every count reset just before, read just after)."""
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    ops.reset_launches()
    mappings.reset_collectives()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in ops.launch_counts().items() if v}, \
        mappings.collective_counts()


def vjp_f32(torch, fn, x, w, g):
    """(fn(x, w), dx, dw) for the fp32 cotangent ``g``."""
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(xs, ws)
    dx, dw = torch.autograd.grad(y, (xs, ws), g)
    return y.detach(), dx, dw


def run_tp_sp(torch, ops, card, launches):
    """tp-sp: the SP boundary MLP (x (S, hidden) bf16 through
    `column_parallel_linear` then `row_parallel_linear`, both
    ``sequence_parallel_enabled``) on the one-rank tensor-parallel group,
    forward and backward: monolithic collectives, ``overlap=True``
    (`mappings`' rings, cuBLAS products), ``fused=True`` (the rings with
    the `chunk_matmul` kernel) and the serialized gather (forward only):
    host wall of each; the fused step's launches (chunk_matmul 4: the two
    forward products and the two dual products of the backward; dW stays
    ``torch.matmul``) and every form's collectives. Then each fused op
    against its decomposed form on the same operands and fp32
    cotangent: output and dx within the fp32 rounding bound (kernel
    against cuBLAS fp32), dW equal bit for bit (both ``torch.matmul``).
    Adds the fused step's launches to ``launches``. Returns (results,
    failure or None)."""
    from apex1_tpu_torch.ops import fused_collective as fc
    from apex1_tpu_torch.transformer import parallel_state as ps
    from apex1_tpu_torch.transformer import tensor_parallel as tp
    from apex1_tpu_torch.transformer.tensor_parallel.mappings import dot_f32
    grp = ps.get_tensor_model_parallel_group()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = rnd(SP_S, SP_HID).to(bf)
    w1 = rnd(SP_HID, SP_FFN, scale=SP_HID ** -0.5).to(bf)
    w2 = rnd(SP_FFN, SP_HID, scale=SP_FFN ** -0.5).to(bf)
    dy = rnd(SP_S, SP_HID).to(bf)
    modes = {"monolithic": {}, "overlap": dict(overlap=True),
             "fused": dict(fused=True)}

    def step(mode, backward=True):
        xs, a, b = (t.detach().requires_grad_(backward) for t in (x, w1, w2))
        with torch.set_grad_enabled(backward):
            if mode == "serial":
                h = fc.fused_all_gather_matmul_serial(xs, a, grp).to(bf)
                y = fc.fused_matmul_reduce_scatter(h, b, grp).to(bf)
            else:
                h = tp.column_parallel_linear(
                    xs, a, sequence_parallel_enabled=True, group=grp,
                    **modes[mode])
                y = tp.row_parallel_linear(
                    h, b, sequence_parallel_enabled=True, group=grp,
                    **modes[mode])
            if backward:
                y.backward(dy)
        return y

    out = {"fwd_ms": {}, "step_ms": {}, "collectives": {}}
    for mode in ("monolithic", "overlap", "fused", "serial"):
        out["fwd_ms"][mode] = wall_ms(torch, lambda: step(mode, False))
        if mode != "serial":
            out["step_ms"][mode] = wall_ms(torch, lambda: step(mode))
            _, n, coll = counted(torch, ops, lambda: step(mode))
            out["collectives"][mode] = coll
            if mode == "fused":
                out["launches"] = n
                for k, v in n.items():
                    launches[k] = launches.get(k, 0) + v
    flops = 2 * 2 * SP_S * SP_HID * SP_FFN
    print(f"phase tp-sp: SP boundary MLP S={SP_S} hidden={SP_HID} "
          f"ffn={SP_FFN} bf16, world 1 (NCCL), forward wall ms "
          f"{ {k: round(v, 3) for k, v in out['fwd_ms'].items()} }, "
          f"forward+backward wall ms "
          f"{ {k: round(v, 3) for k, v in out['step_ms'].items()} } "
          f"({flops * 3 / 1e12:.3f} TFLOP a step); fused step launches "
          f"{out['launches']}; collectives a step "
          f"{out['collectives']} [{card}]")
    if out["launches"].get("chunk_matmul") != 4:
        return out, (f"tp-sp: the fused step launched chunk_matmul "
                     f"{out['launches'].get('chunk_matmul', 0)} times, "
                     f"expected 4")
    # each fused op against its decomposed form
    g1 = rnd(SP_S, SP_FFN)
    g2 = rnd(SP_S, SP_HID)
    h = rnd(SP_S, SP_FFN).to(bf)
    errs = {}
    for name, fused, dec, xin, w, g in (
            ("column", fc.fused_all_gather_matmul, tp.all_gather_matmul,
             x, w1, g1),
            ("row", fc.fused_matmul_reduce_scatter, tp.matmul_reduce_scatter,
             h, w2, g2)):
        got = vjp_f32(torch, lambda a, b: fused(a, b, grp), xin, w, g)
        want = vjp_f32(torch, lambda a, b: dec(a, b, grp), xin, w, g)
        with torch.no_grad():
            ab_y = dot_f32(xin.abs(), w.abs())
            ab_dx = dot_f32(g.abs(), w.abs().t())
        e_y = rounding_errs(got[0], want[0], ab_y, 2.0 ** -24, 0)
        e_dx = rounding_errs(got[1], want[1], ab_dx, 2.0 ** -24, 0)
        errs[name] = dict(y=e_y, dx=e_dx,
                          dw_equal=bool(torch.equal(got[2], want[2])))
        del got, want, ab_y, ab_dx
        torch.cuda.empty_cache()
    out["fused_vs_overlap"] = errs
    print(f"phase tp-sp: fused against decomposed, (max |diff|, worst / "
          f"fp32 rounding bound) {errs} [{card}]")
    for name, e in errs.items():
        if e["y"][1] > 1 or e["dx"][1] > 1 or not e["dw_equal"]:
            return out, f"tp-sp: the fused {name} op disagrees: {e}"
    del x, w1, w2, dy, g1, g2, h
    torch.cuda.empty_cache()
    return out, None


def run_cp(torch, ops, card, launches):
    """cp: causal attention at `llama_longctx`'s shape (1 x 32/4 heads x
    16384 x 64, bf16) on the one-rank context-parallel group, forward and
    backward, through `ring_attention` (flash_fwd, then the merge in
    PyTorch) and `all_gather_flash_attention` (the merge in the flash
    kernel's epilogue): host walls, exact launches (the fused form's
    merge flash once a forward, dq and dk/dv once a backward; the ring's
    flash_fwd once), and the two forms' out, dq, dk, dv within flash's
    bf16 tolerance (bitwise equality printed). Adds both forms'
    launches to ``launches``."""
    from apex1_tpu_torch.ops.fused_collective import \
        all_gather_flash_attention
    from apex1_tpu_torch.parallel.ring_attention import ring_attention
    from apex1_tpu_torch.transformer import parallel_state as ps
    grp = ps.get_context_parallel_group()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf = torch.bfloat16
    q = torch.randn(CP_B, CP_HQ, CP_S, CP_D, generator=gen,
                    device="cuda").to(bf)
    k, v = (torch.randn(CP_B, CP_HKV, CP_S, CP_D, generator=gen,
                        device="cuda").to(bf) for _ in range(2))
    do = torch.randn(CP_B, CP_HQ, CP_S, CP_D, generator=gen,
                     device="cuda").to(bf)
    fns = {"ring": ring_attention, "all_gather_flash": \
           all_gather_flash_attention}

    def run(name, backward=True):
        qs, ks, vs = (t.detach().requires_grad_(backward) for t in (q, k, v))
        with torch.set_grad_enabled(backward):
            o = fns[name](qs, ks, vs, grp, causal=True)
            if backward:
                o.backward(do)
                return o.detach(), qs.grad, ks.grad, vs.grad
        return (o,)

    out = {"fwd_ms": {}, "step_ms": {}, "launches": {}}
    res = {}
    for name in fns:
        out["fwd_ms"][name] = wall_ms(torch, lambda: run(name, False))
        out["step_ms"][name] = wall_ms(torch, lambda: run(name))
        res[name], n, _ = counted(torch, ops, lambda: run(name))
        out["launches"][name] = n
        for kk, vv in n.items():
            launches[kk] = launches.get(kk, 0) + vv
    errs = [max_errs(a, b, *TOLS["bfloat16"])
            for a, b in zip(res["all_gather_flash"], res["ring"])]
    out["errs"] = errs
    out["bitwise"] = [bool(torch.equal(a, b))
                      for a, b in zip(res["all_gather_flash"], res["ring"])]
    print(f"phase cp: causal attention B={CP_B} Hq={CP_HQ} Hkv={CP_HKV} "
          f"S={CP_S} D={CP_D} bf16, world 1 (NCCL); forward wall ms "
          f"{ {k: round(v, 3) for k, v in out['fwd_ms'].items()} }, "
          f"forward+backward wall ms "
          f"{ {k: round(v, 3) for k, v in out['step_ms'].items()} }; "
          f"launches {out['launches']}; all_gather_flash vs ring (out, "
          f"dq, dk, dv) (max |diff|, worst/allowed) {errs} bitwise "
          f"{out['bitwise']} [{card}]")
    want = {"ring": dict(flash_fwd=1, flash_dq=1, flash_dkv=1),
            "all_gather_flash": dict(flash_fwd_merge=1, flash_dq=1,
                                     flash_dkv=1)}
    if out["launches"] != want:
        return out, f"cp: launches {out['launches']}, expected {want}"
    if any(e[1] > 1 for e in errs):
        return out, f"cp: the fused form disagrees with the ring: {errs}"
    del q, k, v, do, res
    torch.cuda.empty_cache()
    return out, None


def run_vp_ce(torch, ops, card, launches):
    """vp-ce: `vocab_parallel_linear_cross_entropy` at `llama_longctx`'s
    head (16384 tokens x 2048 against a 32000-row shard, bf16) on the
    one-rank tensor-parallel group, ``fused=False`` (shard_stats, the
    four-all-reduce merge) and ``fused=True`` (shard_stats_packed, two):
    loss, dx and dW equal bit for bit, the forward's all-reduces 2
    against 4, launches (lxent_fwd, dx and dW once each), host walls.
    Adds the launches to ``launches``."""
    from apex1_tpu_torch.transformer import parallel_state as ps
    from apex1_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_linear_cross_entropy)
    grp = ps.get_tensor_model_parallel_group()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(VP_T, VP_H, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(VP_V, VP_H, generator=gen, device="cuda")
         * VP_H ** -0.5).to(torch.bfloat16)
    labels = torch.randint(0, VP_V, (VP_T,), generator=gen, device="cuda")

    def run(fused, backward=True):
        xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
        loss = vocab_parallel_linear_cross_entropy(xs, ws, labels,
                                                   group=grp, fused=fused)
        if not backward:
            return (loss,)
        loss.mean().backward()
        return loss.detach(), xs.grad, ws.grad

    out = {"fwd_ms": {}, "step_ms": {}, "launches": {}, "collectives": {}}
    res = {}
    for fused in (False, True):
        key = "fused" if fused else "decomposed"
        _, _, fwd_coll = counted(torch, ops, lambda: run(fused, False))
        out["collectives"][key] = fwd_coll
        out["fwd_ms"][key] = wall_ms(torch, lambda: run(fused, False))
        out["step_ms"][key] = wall_ms(torch, lambda: run(fused))
        res[key], n, _ = counted(torch, ops, lambda: run(fused))
        out["launches"][key] = n
        for kk, vv in n.items():
            launches[kk] = launches.get(kk, 0) + vv
    out["bitwise"] = [bool(torch.equal(a, b))
                      for a, b in zip(res["fused"], res["decomposed"])]
    ar = {k: c["all_reduce"] for k, c in out["collectives"].items()}
    print(f"phase vp-ce: T={VP_T} H={VP_H} V={VP_V} bf16, world 1 "
          f"(NCCL); loss {res['fused'][0].float().mean().item():.6f}; "
          f"forward wall ms "
          f"{ {k: round(v, 3) for k, v in out['fwd_ms'].items()} }, "
          f"forward+backward wall ms "
          f"{ {k: round(v, 3) for k, v in out['step_ms'].items()} }; "
          f"forward all-reduces {ar}; launches {out['launches']}; fused "
          f"== decomposed bit for bit (loss, dx, dW) {out['bitwise']} "
          f"[{card}]")
    if not all(out["bitwise"]):
        return out, "vp-ce: the fused form is not the decomposed form's bits"
    if ar != {"decomposed": 4, "fused": 2}:
        return out, f"vp-ce: forward all-reduces {ar}, expected 4 and 2"
    one = dict(lxent_fwd=1, lxent_dx=1, lxent_dw=1)
    if out["launches"] != {"decomposed": one, "fused": one}:
        return out, f"vp-ce: launches {out['launches']}"
    del x, w, labels, res
    torch.cuda.empty_cache()
    return out, None


def run_ddp(torch, ops, card, launches, steps: int = 3):
    """ddp: GPT-2 124M (flash, fused head) at O2 on the training batch
    (B x S tokens), ``steps`` steps through ``Amp(fused_adam(1e-4,
    weight_decay=0.01), grad_psum_axes=("dp",))`` on the one-rank
    data-parallel group, against the same steps without it: losses and
    parameters bit for bit (the mean over one rank is exact). Adds the
    DDP run's launches to ``launches``."""
    runs = {}
    for name, axes in (("plain", ()), ("ddp", ("dp",))):
        ops.reset_launches()
        _, state, step, batch = make_trainer(
            torch, "O2", 12, SEED, use_flash=True, fuse_head=True,
            grad_psum_axes=axes)
        rows, peak, state = run_steps(torch, ops, state, step, batch, steps,
                                      return_state=True)
        if name == "ddp":
            for kk, vv in ops.launch_counts().items():
                launches[kk] = launches.get(kk, 0) + vv
        runs[name] = dict(rows=rows, peak=peak, params=state.params)
        del state, step, batch
        torch.cuda.empty_cache()
    same_loss = [a["loss"] == b["loss"] for a, b in
                 zip(runs["ddp"]["rows"], runs["plain"]["rows"])]
    same_params = all(torch.equal(runs["ddp"]["params"][k], p)
                      for k, p in runs["plain"]["params"].items())
    walls = {k: [round(r["wall_ms"], 2) for r in v["rows"]]
             for k, v in runs.items()}
    print(f"phase ddp: GPT-2 124M O2 flash fused head B={TB} S={TS}, "
          f"{steps} steps, grad_psum_axes=('dp',) on a one-rank NCCL dp "
          f"group vs none: losses "
          f"{[r['loss'] for r in runs['ddp']['rows']]} equal {same_loss}, "
          f"params bit-identical {same_params}; step walls ms {walls} "
          f"[{card}]")
    out = dict(rows={k: v["rows"] for k, v in runs.items()},
               same_loss=same_loss, same_params=same_params)
    del runs
    torch.cuda.empty_cache()
    if not (all(same_loss) and same_params):
        return out, "ddp: the data-parallel steps differ from the plain ones"
    return out, None


def run_rdma(torch, ops, card):
    """rdma: `matmul_reduce_scatter_rdma` on the one-rank group raises
    its ring-size ValueError (its ring needs two ranks; its product,
    chunk_matmul's accumulator mode, is checked in the kernels phase)."""
    from apex1_tpu_torch.ops.fused_collective import \
        matmul_reduce_scatter_rdma
    from apex1_tpu_torch.transformer import parallel_state as ps
    x = torch.zeros(256, 128, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(128, 128, device="cuda", dtype=torch.bfloat16)
    try:
        matmul_reduce_scatter_rdma(x, w, ps.get_tensor_model_parallel_group())
    except ValueError as e:
        msg = str(e)
    else:
        msg = "no error"
    ok = msg.startswith("matmul_reduce_scatter_rdma needs a ring of >= 2")
    print(f"phase rdma: world 1 raises: {msg!r} {'ok' if ok else 'WRONG'} "
          f"[{card}]")
    return {"message": msg}, None if ok else f"rdma: {msg}"


# ---- the pipeline and expert parallelism slice: the bench's llama_3d ------

#: the bench's ``llama_3d`` (`bench.py:466-547`) at its one-card layout
#: (dp = pp = cp = ep = tp = 1, ``schedule`` "scan", 4 microbatches of 1
#: sequence, ``num_chunks`` 1: `planner.make_plan` at one device): the
#: llama_longctx-class model (`LLAMA_08B`) at S 2048, 8 layers, remat,
#: O2, fused Adam at lr 1e-4, 6 steps; the A100 proxy the bench prints
L3D_S, L3D_LAYERS, L3D_M, L3D_STEPS, L3D_PROXY = 2048, 8, 4, 6, 11_100.0
#: train-llama-3d-1f1b's steps; llama-3d-parity's depth and its MoE
#: variant (every FFN routed: 8 experts, top-2, the LlamaConfig defaults
#: for capacity and the balance weight)
L3D_1F1B_STEPS, L3D_PAR_DEPTH = 3, 2
#: train-llama-3d-1f1b's step-1 limit on every grad leaf's relative
#: error against the scan's: one bf16 unit roundoff (2^-8), since the
#: head's dW is rounded to bf16 once over the step's tokens under scan
#: and once a microbatch under 1F1B; every other leaf sums the same
#: bf16 partials in fp32
L3D_1F1B_LEAF = 2.0 ** -8
L3D_MOE = dict(moe_every=1, num_experts=8, moe_top_k=2)


def l3d_model(level: str, depth: int, moe: bool = False):
    """The bench's llama_3d `LlamaConfig` at ``depth`` layers and
    ``level``."""
    from apex1_tpu_torch import LlamaConfig, get_policy
    return LlamaConfig(**LLAMA_08B, max_seq_len=L3D_S, num_layers=depth,
                       remat=True, policy=get_policy(level),
                       **(L3D_MOE if moe else {}))


def l3d_planned(level: str, depth: int):
    """The bench's llama_3d layout as the JAX bench chooses it
    (`bench.py:496-526`): ``ModelShape.from_llama`` of the model at
    global batch `L3D_M`, `planner.make_plan` at one device for the
    detected card without ZeRO, `planner.llama3d_config_from_plan`.
    Returns (plan, cfg)."""
    from apex1_tpu_torch import planner
    from apex1_tpu_torch.core.capability import detect_generation
    mcfg = l3d_model(level, depth)
    shape = planner.ModelShape.from_llama(mcfg, global_batch=L3D_M,
                                          name="llama_3d")
    plan = planner.make_plan(shape, 1, generation=detect_generation(),
                             allow_zero=False)
    return plan, planner.llama3d_config_from_plan(plan, mcfg,
                                                  learning_rate=1e-4)


def make_llama_3d(torch, level: str, depth: int, *, schedule="scan",
                  num_chunks: int = 1, moe: bool = False, params=None,
                  seed: int = SEED, cfg=None):
    """The bench's llama_3d config at ``depth`` layers and ``level``
    (`Llama3DConfig` at the one-card layout, or ``cfg``) on
    `parallel_state`'s one-rank mesh, its train step and state from the
    global ``params`` (or `init_params(cfg, seed)`: the JAX package's
    numpy draws), and the bench's batch: tokens (M, S, 1) of
    ``np.random.default_rng(seed)``, labels the tokens rolled by one
    along the sequence. Returns (cfg, step, state, (tokens, labels))."""
    import numpy as np
    from apex1_tpu_torch.models import llama_3d as L3
    if cfg is None:
        cfg = L3.Llama3DConfig(model=l3d_model(level, depth, moe),
                               num_microbatches=L3D_M, microbatch_size=1,
                               schedule=schedule, num_chunks=num_chunks,
                               moe=moe, learning_rate=1e-4)
    mcfg = cfg.model
    step, state, _ = L3.make_train_step(cfg, params=params, device="cuda",
                                        seed=seed)
    tokens = np.random.default_rng(seed).integers(
        0, mcfg.vocab_size, (L3D_M, L3D_S, 1))
    labels = np.roll(tokens, -1, axis=1)
    return cfg, step, state, tuple(torch.from_numpy(a).to("cuda")
                                   for a in (tokens, labels))


def llama_3d_launches(layers: int, schedule: str) -> dict:
    """Kernel launches a llama_3d step (remat): each layer of each of
    the M microbatches runs its forward twice (the step's and the
    recompute: two RMS norms, q and k rotated, the flash forward) and
    its backward once (two norms, q and k rotated by -θ, flash dq and
    dk/dv). The final norm and the vocab-parallel head (shard_stats,
    then dx and dW) run once over all 4 x 2048 tokens under "scan", once
    a microbatch under "1f1b"."""
    M, L = L3D_M, layers
    head = 1 if schedule == "scan" else M
    return {"layer_norm_fwd": 4 * M * L + head,
            "layer_norm_bwd": 2 * M * L + head, "rope": 6 * M * L,
            "flash_fwd": 2 * M * L, "flash_dq": M * L, "flash_dkv": M * L,
            "lxent_fwd": head, "lxent_dx": head, "lxent_dw": head}


def l3d_step_rows(torch, ops, state, step, batch, steps: int):
    """``steps`` llama_3d steps: per step the loss, host wall (ending in
    a synchronize) and launches; the peak memory (GiB) and the state
    left."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, prev = [], ops.launch_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        now = ops.launch_counts()
        rows.append(dict(step=i + 1, wall_ms=wall, loss=loss.item(),
                         launches={k: now[k] - prev[k] for k in now
                                   if now[k] != prev[k]}))
        prev = now
    return rows, torch.cuda.max_memory_allocated() / 2 ** 30, state


def l3d_loss_grads(torch, cfg, state, batch):
    """One forward and backward of `llama_3d.loss_and_grads` on the
    state's params: (loss, grads, total grad norm)."""
    from apex1_tpu_torch.models import llama_3d as L3
    loss, grads = L3.loss_and_grads(cfg, state["params"], *batch)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    return loss.item(), grads, norm.item()


def run_llama_3d(torch, ops, card, launches):
    """train-llama-3d and train-llama-3d-1f1b: the bench's llama_3d at
    full width and depth on one card. The scan schedule: L3D_STEPS
    steps (finite losses, exact launches), tokens/s from the median
    wall of steps 2-n beside the A100 proxy, device ms a step and busy
    share over 3 profiled steps, peak memory. Then the same params and
    batch on ``schedule="1f1b"``: step 1 (one forward and backward
    each, on the initial params): the loss within 1e-5 relative, the
    grad norm within 1e-4 and every grad leaf within `L3D_1F1B_LEAF`
    (`l3d_leaf_errs`; the scan's grads held on the host), then
    L3D_1F1B_STEPS steps with their launches, wall and peak memory beside
    the scan's. Adds both schedules' launches to ``launches``."""
    import dataclasses
    from apex1_tpu_torch.models import llama_3d as L3
    out = {}
    plan, cfg = l3d_planned("O2", L3D_LAYERS)
    hand = L3.Llama3DConfig(model=cfg.model, num_microbatches=L3D_M,
                            microbatch_size=1, learning_rate=1e-4)
    if cfg != hand:
        return out, (f"train-llama-3d: the planner picked "
                     f"{dataclasses.asdict(cfg)}, not the one-card hand "
                     f"layout {dataclasses.asdict(hand)}")
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg, step, state, batch = make_llama_3d(torch, "O2", L3D_LAYERS,
                                            cfg=cfg)
    init_s = time.perf_counter() - t0
    m = cfg.model
    n_tok = L3D_M * L3D_S
    n_w = sum(v.numel() for k, v in state["params"].items()
              if k not in ("shared.emb", "shared.head"))
    start = {k: v.clone() for k, v in state["params"].items()}
    loss1, g1, norm1 = l3d_loss_grads(torch, cfg, state, batch)
    # held on the host so the scan steps' peak memory leaves them out
    scan1 = (loss1, {k: v.cpu() for k, v in g1.items()}, norm1)
    del g1
    ops.reset_launches()
    rows, peak, state = l3d_step_rows(torch, ops, state, step, batch,
                                      L3D_STEPS)
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    prof = profiled_steps(torch, state, step, batch)
    del state, step
    torch.cuda.empty_cache()
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med = walls[len(walls) // 2]
    for r in rows:
        print(f"phase train-llama-3d: O2 step {r['step']} loss "
              f"{r['loss']:.6f} wall {r['wall_ms']:.1f} ms launches "
              f"{r['launches']} [{card}]")
    top = ", ".join(f"{t['name'][:48]} {t['ms_per_step']:.3f} ms x"
                    f"{t['calls']}" for t in prof["top"][:8])
    out["scan"] = dict(steps=rows, peak_gib=peak, step_wall_ms=med,
                       tokens_per_s=n_tok / med * 1e3, profile=prof,
                       weights=n_w, init_s=init_s)
    print(f"phase train-llama-3d: llama_3d at the one-card layout (dp pp "
          f"cp ep tp 1, schedule scan, M {L3D_M} x 1 sequence, V 1) O2 "
          f"remat, fused Adam lr 1e-4; hidden {m.hidden_size} heads "
          f"{m.num_heads}/{m.num_kv_heads} head_dim {m.head_dim} ffn "
          f"{m.ffn_size} layers {m.num_layers} vocab {m.vocab_size} S "
          f"{L3D_S}; {n_w} weights outside the embedding and head; init "
          f"{init_s:.1f} s; step wall {med:.2f} ms (median of steps "
          f"2-{len(rows)}), {n_tok / med * 1e3:.0f} tokens/s (bench's A100 "
          f"proxy {L3D_PROXY:.0f}), device {prof['device_ms_per_step']:.3f}"
          f" ms a step in a {prof['step_wall_ms']:.2f} ms profiled step "
          f"(busy {prof['device_busy']:.3f}), peak memory {peak:.2f} GiB; "
          f"largest kernels a step: {top} [{card}]")
    pr, mem = plan["predicted"], plan["memory"]
    dev_ms = prof["device_ms_per_step"]
    out["scan"]["planned"] = dict(
        generation=plan["generation"], mesh=plan["mesh"],
        schedule=plan["schedule"], step_ms=pr["step_ms"],
        calibrated_step_ms=pr["calibrated_step_ms"], bound=pr["bound"],
        mfu=pr["mfu"], calibration=pr["calibration"]["source"],
        hbm_gib=mem["total"], n_enumerated=plan["search"]["n_enumerated"],
        wall_ratio=pr["calibrated_step_ms"] / med,
        device_ratio=pr["calibrated_step_ms"] / dev_ms,
        memory_ratio=mem["total"] / peak)
    print(f"phase train-llama-3d: planned by make_plan ({plan['generation']}"
          f", {plan['search']['n_enumerated']} layout enumerated, the hand "
          f"layout): predicted {pr['calibrated_step_ms']:.3f} ms a step "
          f"(analytic {pr['step_ms']:.3f}, bound {pr['bound']}, mfu "
          f"{pr['mfu']:.3f}, {pr['calibration']['source']}), {mem['total']:.2f}"
          f" GiB (weights {mem['weights']:.2f}, grads {mem['grads']:.2f}, opt"
          f" {mem['opt']:.2f}, acts {mem['acts']:.2f}); measured wall "
          f"{med:.2f} ms (predicted/measured {pr['calibrated_step_ms'] / med:.4f})"
          f", device {dev_ms:.3f} ms ({pr['calibrated_step_ms'] / dev_ms:.4f}),"
          f" peak {peak:.2f} GiB ({mem['total'] / peak:.4f}) [{card}]")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        return out, f"train-llama-3d: a loss is not finite: {losses}"
    want = llama_3d_launches(L3D_LAYERS, "scan")
    for r in rows:
        if r["launches"] != want:
            return out, (f"train-llama-3d step {r['step']}: launches "
                         f"{r['launches']}, expected {want}")

    # the same model, params and batch on the 1F1B schedule
    params = {"chunk": {}, "shared": {}}
    for k, v in start.items():
        kind, name = k.split(".", 1)
        params[kind][name] = v[:, None] if kind == "chunk" else v
    del start
    cfg, step, state, batch = make_llama_3d(torch, "O2", L3D_LAYERS,
                                            schedule="1f1b", params=params)
    del params
    f1 = l3d_loss_grads(torch, cfg, state, batch)
    errs = l3d_leaf_errs(torch, f1[1], scan1[1])
    worst = max(errs, key=errs.get)
    f1, scan1 = (f1[0], None, f1[2]), (scan1[0], None, scan1[2])
    ops.reset_launches()
    rows, peak1, state = l3d_step_rows(torch, ops, state, step, batch,
                                       L3D_1F1B_STEPS)
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    del state, step
    torch.cuda.empty_cache()
    walls = sorted(r["wall_ms"] for r in rows[1:])
    med1 = walls[len(walls) // 2]
    for r in rows:
        print(f"phase train-llama-3d-1f1b: O2 step {r['step']} loss "
              f"{r['loss']:.6f} wall {r['wall_ms']:.1f} ms launches "
              f"{r['launches']} [{card}]")
    out["1f1b"] = dict(steps=rows, peak_gib=peak1, step_wall_ms=med1,
                       step1=[f1[0], f1[2]], scan_step1=[scan1[0],
                                                          scan1[2]])
    dl = abs(f1[0] - scan1[0]) / abs(scan1[0])
    dg = abs(f1[2] - scan1[2]) / abs(scan1[2])
    print(f"phase train-llama-3d-1f1b: step-1 loss {f1[0]:.6f} vs scan "
          f"{scan1[0]:.6f} (relative {dl:.2e}), grad norm {f1[2]:.6f} vs "
          f"scan {scan1[2]:.6f} (relative {dg:.2e}), worst leaf {worst} "
          f"{errs[worst]:.2e} (limit {L3D_1F1B_LEAF:.2e}); step wall "
          f"{med1:.2f} vs scan {med:.2f} ms, peak memory {peak1:.2f} vs "
          f"scan {peak:.2f} GiB [{card}]")
    out["1f1b"]["leaf_errs"] = errs
    if not all(math.isfinite(r["loss"]) for r in rows):
        return out, f"train-llama-3d-1f1b: a loss is not finite: {rows}"
    if dl > 1e-5 or dg > 1e-4 or errs[worst] > L3D_1F1B_LEAF:
        return out, (f"train-llama-3d-1f1b: step 1 is not the scan's: "
                     f"loss {f1[0]} vs {scan1[0]}, grad norm {f1[2]} vs "
                     f"{scan1[2]}, leaf {worst} {errs[worst]}")
    want = llama_3d_launches(L3D_LAYERS, "1f1b")
    for r in rows:
        if r["launches"] != want:
            return out, (f"train-llama-3d-1f1b step {r['step']}: launches "
                         f"{r['launches']}, expected {want}")
    return out, None


def l3d_leaf_errs(torch, got: dict, want: dict):
    """Per leaf ||got - want|| / ||want|| (0 where want is all zeros
    and got too)."""
    errs = {}
    for k, w in want.items():
        d = (got[k].float() - w.to(got[k].device).float()).norm().item()
        n = w.float().norm().item()
        errs[k] = d / n if n else d
    return errs


def run_llama_3d_parity(torch, ops, card):
    """llama-3d-parity at depth L3D_PAR_DEPTH, full width, O0 fp32, one
    forward and backward on the bench's batch: (1) kernels against the
    plain versions: loss 1e-5 relative, the grad norm and every leaf's
    1e-4; (2) the step against the flat `models.llama.Llama` on the same
    params (the mean CE of the 4 sequences, the fused head) through the
    kernels: loss and leaves the same; (3) ``num_chunks=2`` against 1;
    (4) ``moe=True`` (8 experts, top-2, ep 1), kernels against plain,
    the dispatch tensors of every router call equal bit for bit; (5)
    O2_fp16: steps until one is finite, then one with the embedding's
    master times 1e8 (its fp16 copy overflows): skipped, params and both
    Adam moments bit-identical, the scale halved."""
    from apex1_tpu_torch import Llama, LlamaConfig, get_policy
    from apex1_tpu_torch.ops.linear_xent import linear_cross_entropy
    from apex1_tpu_torch.transformer import moe as moe_mod
    out = {}

    def one(fn, plain=False):
        ops.reset_launches()
        with ops.force_impl("torch") if plain else contextlib.nullcontext():
            res = fn()
        torch.cuda.synchronize()
        return res, {k: v for k, v in ops.launch_counts().items() if v}

    def grads_of(moe=False, num_chunks=1, params=None):
        cfg, _, state, batch = make_llama_3d(
            torch, "O0", L3D_PAR_DEPTH, moe=moe, num_chunks=num_chunks,
            params=params, seed=SEED + 3)
        return cfg, state, batch, l3d_loss_grads(torch, cfg, state, batch)

    def report(label, a, b, la, lb):
        errs = l3d_leaf_errs(torch, a[1], b[1])
        dl = abs(a[0] - b[0]) / abs(b[0])
        dn = abs(a[2] - b[2]) / abs(b[2])
        worst = max(errs.values())
        print(f"phase llama-3d-parity: {label}: loss {a[0]:.7f} vs "
              f"{b[0]:.7f} (relative {dl:.2e}), grad norm {a[2]:.6f} vs "
              f"{b[2]:.6f} (relative {dn:.2e}), worst leaf "
              f"{max(errs, key=errs.get)} {worst:.2e}; launches {la} vs "
              f"{lb} [{card}]")
        out[label] = dict(loss=[a[0], b[0]], norm=[a[2], b[2]],
                          leaf_errs=errs, launches=[la, lb])
        if dl > 1e-5 or dn > 1e-4 or worst > 1e-4:
            return f"llama-3d-parity {label}: {out[label]}"
        return None

    # (1) kernels against the plain versions
    (cfg, state, batch, k), kl = one(grads_of)
    (_, _, _, p), pl = one(grads_of, plain=True)
    err = report("O0 kernels vs plain", k, p, kl, pl)
    if err or pl or not all(kl.get(n) for n in llama_3d_launches(1, "scan")):
        return out, err or f"llama-3d-parity: launches {kl} / {pl}"

    # (2) the flat Llama on the same params, through the kernels
    flat_cfg = LlamaConfig(**LLAMA_08B, max_seq_len=L3D_S,
                           num_layers=L3D_PAR_DEPTH, remat=True,
                           policy=get_policy("O0"))
    flat = Llama(flat_cfg, device="cuda")
    names = {"wg": "moe.router"}
    named = {"tok_embeddings": state["params"]["shared.emb"],
             "output": state["params"]["shared.head"],
             "norm": state["params"]["shared.final_norm"]}
    for key, v in state["params"].items():
        if key.startswith("chunk."):
            for j in range(L3D_PAR_DEPTH):
                leaf = key[6:]
                named[f"layer{j}.{names.get(leaf, leaf)}"] = v[0, j]
    tokens, labels = batch
    toks = tokens[..., 0].long()            # (M, S): one sequence each
    lbls = labels[..., 0].long()
    params = {k: named[k].detach().clone().requires_grad_()
              for k, _ in flat.named_parameters()}
    ops.reset_launches()
    h = torch.func.functional_call(flat, params, (toks,),
                                   dict(return_hidden=True))
    loss = linear_cross_entropy(h, params["output"].to(h.dtype),
                                lbls).mean()
    g = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    fl = {k: n for k, n in ops.launch_counts().items() if n}
    gflat = dict(zip(params, g))
    mapped = {"shared.emb": gflat["tok_embeddings"],
              "shared.head": gflat["output"],
              "shared.final_norm": gflat["norm"]}
    for key in k[1]:
        if key.startswith("chunk."):
            leaf = key[6:]
            mapped[key] = torch.stack([gflat[f"layer{j}.{leaf}"] for j in
                                       range(L3D_PAR_DEPTH)])[None]
    fnorm = torch.sqrt(sum((v.float() ** 2).sum()
                           for v in mapped.values())).item()
    err = report("O0 llama_3d vs the flat Llama", k,
                 (loss.item(), mapped, fnorm), kl, fl)
    del flat, params, h, g, gflat
    if err:
        return out, err

    # (3) num_chunks=2 against num_chunks=1 on the same params
    glob = {"chunk": {}, "shared": {}}
    for key, v in state["params"].items():
        kind, name = key.split(".", 1)
        glob[kind][name] = (v.reshape((2, 1, L3D_PAR_DEPTH // 2)
                                      + tuple(v.shape[2:]))
                            if kind == "chunk" else v)
    (cfg2, _, _, v2), v2l = one(lambda: grads_of(num_chunks=2, params=glob))
    v2g = {key: (v.reshape((1, L3D_PAR_DEPTH) + tuple(v.shape[2:]))
                 if key.startswith("chunk.") else v)
           for key, v in v2[1].items()}
    err = report("O0 num_chunks=2 vs 1", (v2[0], v2g, v2[2]), k, v2l, kl)
    del state, glob, v2, v2g, k, p
    torch.cuda.empty_cache()
    if err:
        return out, err

    # (4) MoE, kernels against plain, the routing bit for bit
    base = moe_mod.router
    for side in ("kernel", "plain"):
        seen = []

        def rec(*a, **kw):
            res = base(*a, **kw)
            seen.append(res[0].detach().clone())
            return res

        moe_mod.router = rec
        try:
            (_, _, _, res), lc = one(lambda: grads_of(moe=True),
                                     plain=side == "plain")
        finally:
            moe_mod.router = base
        out[f"moe_{side}"] = (res, lc, seen)
    (mk, mkl, mks), (mp_, mpl, mps) = out.pop("moe_kernel"), \
        out.pop("moe_plain")
    same = len(mks) == len(mps) and all(torch.equal(a, b)
                                        for a, b in zip(mks, mps))
    print(f"phase llama-3d-parity: MoE (8 experts, top-2, ep 1) router "
          f"calls {len(mks)}, dispatch equal bit for bit {same} [{card}]")
    err = report("O0 MoE kernels vs plain", mk, mp_, mkl, mpl)
    out["moe_routing_equal"] = same
    del mk, mp_, mks, mps
    torch.cuda.empty_cache()
    if err or not same:
        return out, err or "llama-3d-parity: the MoE routing differs"

    # (5) O2_fp16: a forced overflow skips its step
    cfg, step, state, batch = make_llama_3d(torch, "O2_fp16", L3D_PAR_DEPTH,
                                            seed=SEED + 3)
    rows = []
    for _ in range(FP16_MAX_STEPS):
        before = state
        state, loss = step(state, *batch)
        rows.append(dict(loss=loss.item(),
                         skipped=int(state["scale"].overflow_count),
                         scale=state["scale"].scale.item()))
        if int(state["scale"].overflow_count) == int(
                before["scale"].overflow_count):
            break
    poisoned = dict(state["params"])
    poisoned["shared.emb"] = poisoned["shared.emb"] * 1e8
    before = dict(state, params=poisoned)
    after, loss = step(before, *batch)
    kept = {name: all(torch.equal(x[n], y[n]) for n in poisoned)
            for name, x, y in (
                ("params", after["params"], before["params"]),
                ("exp_avg", after["opt"].exp_avg, before["opt"].exp_avg),
                ("exp_avg_sq", after["opt"].exp_avg_sq,
                 before["opt"].exp_avg_sq))}
    s0, s1 = before["scale"].scale.item(), after["scale"].scale.item()
    o0, o1 = (int(x["scale"].overflow_count) for x in (before, after))
    out["fp16"] = dict(rows=rows, kept=kept, scale=[s0, s1],
                       overflow=[o0, o1], forced_loss=loss.item())
    print(f"phase llama-3d-parity: O2_fp16 steps before the forced one "
          f"{rows}; forced step (embedding x 1e8): loss {loss.item()}, "
          f"bit-identical {kept}, scale {s0} -> {s1}, skipped {o0} -> "
          f"{o1} [{card}]")
    del state, before, after, step
    torch.cuda.empty_cache()
    if (not all(kept.values()) or s1 != s0 / 2 or o1 != o0 + 1
            or not math.isfinite(rows[-1]["loss"])):
        return out, f"llama-3d-parity O2_fp16: {out['fp16']}"
    return out, None


# ---- the sharded data-parallel slice: fsdp, ZeRO, LAMB, halo ------------

#: train-fsdp, train-zero and train-bert-lamb: steps of each run
ZERO_STEPS = 3
#: spatial-bottleneck: ResNet-50's stage-1 stride-1 bottleneck, the
#: train-resnet batch: 64 x 56 x 56 x 256 in, features 64
SPATIAL_B, SPATIAL_HW, SPATIAL_F = 64, 56, 64


def full_params(params: dict) -> dict:
    """The state's params as plain full tensors (placed ones gathered)."""
    from apex1_tpu_torch.core.mesh import gather
    return {k: v.detach() for k, v in gather(params).items()}


def zero_pair(torch, ops, names, make, steps: int = ZERO_STEPS):
    """Two trainers (``make(name) -> (cfg, state, step, batch)``) run
    ``steps`` steps each: per run the rows, the full params, the
    kernel launches and the collective calls (all counted from 0), then
    3 more steps under torch.profiler (`profiled_steps`)."""
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    runs = {}
    for name in names:
        ops.reset_launches()
        mappings.reset_collectives()
        cfg, state, step, batch = make(name)
        rows, peak, state = run_steps(torch, ops, state, step, batch, steps,
                                      return_state=True)
        runs[name] = dict(rows=rows, peak=peak, cfg=cfg,
                          params=full_params(state.params),
                          launches={k: v for k, v in
                                    ops.launch_counts().items() if v},
                          collectives={k: v for k, v in
                                       mappings.collective_counts().items()
                                       if v})
        runs[name]["profile"] = profiled_steps(torch, state, step, batch)
        del state, step, batch
        torch.cuda.empty_cache()
    return runs


def step_walls(runs: dict) -> str:
    """Each run's step walls, then its device ms a step and busy share
    over the profiled steps."""
    return "; ".join(
        f"{k}: step walls ms {[round(r['wall_ms'], 2) for r in v['rows']]}, "
        f"device {v['profile']['device_ms_per_step']:.3f} ms a step in a "
        f"{v['profile']['step_wall_ms']:.2f} ms profiled step (busy "
        f"{v['profile']['device_busy']:.3f})" for k, v in runs.items())


def run_fsdp(torch, ops, card, launches):
    """train-fsdp: GPT-2 124M (flash, fused head) at O2 on the training
    batch, ZERO_STEPS steps with the fp32 masters and the Adam moments
    placed on the one-rank NCCL fsdp mesh (`fsdp_param_specs`,
    `shard_opt_state_specs`) and gathered in the loss (ZeRO-3), against
    the same steps unplaced: losses and params bit for bit (the mean
    over one rank is exact), the same kernel launches a step. Then a
    placed (DTensor) operand handed to a kernel wrapper must raise,
    naming the kernel, and launch nothing. Adds the placed run's
    launches to ``launches``."""
    runs = zero_pair(torch, ops, ("plain", "fsdp"), lambda name: (
        make_trainer(torch, "O2", 12, SEED, use_flash=True, fuse_head=True,
                     fsdp=name == "fsdp")))
    for k, v in runs["fsdp"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    same_loss = [a["loss"] == b["loss"] for a, b in
                 zip(runs["fsdp"]["rows"], runs["plain"]["rows"])]
    same_params = all(torch.equal(runs["fsdp"]["params"][k], p)
                      for k, p in runs["plain"]["params"].items())
    same_launches = ([r["launches"] for r in runs["fsdp"]["rows"]]
                     == [r["launches"] for r in runs["plain"]["rows"]])
    # a DTensor at a kernel wrapper: the fsdp-placed token embedding
    from apex1_tpu_torch.core.mesh import place
    from apex1_tpu_torch.ops.layer_norm import layer_norm_fwd
    from apex1_tpu_torch.parallel.specs import P
    from apex1_tpu_torch.transformer import parallel_state as ps
    x = place({"x": torch.randn(4096, 768, device="cuda")},
              {"x": P("fsdp", None)}, ps.get_mesh())["x"]
    g = torch.ones(768, device="cuda")
    ops.reset_launches()
    try:
        layer_norm_fwd(x, g, g, 1e-5, False)
        refused = "no error"
    except (TypeError, RuntimeError) as e:
        refused = f"{type(e).__name__}: {e}"
    dtensor_ok = ("layer_norm_fwd" in refused
                  and not any(ops.launch_counts().values()))
    print(f"phase train-fsdp: GPT-2 124M O2 flash fused head B={TB} S={TS}, "
          f"{ZERO_STEPS} steps, masters and moments placed by "
          f"fsdp_param_specs on a one-rank NCCL fsdp mesh and gathered in "
          f"the loss vs unplaced: losses "
          f"{[r['loss'] for r in runs['fsdp']['rows']]} equal {same_loss}, "
          f"params bit-identical {same_params}, launches a step equal "
          f"{same_launches} ({runs['fsdp']['rows'][0]['launches']}); "
          f"collectives {runs['fsdp']['collectives']}; {step_walls(runs)}; "
          f"peak GiB "
          f"{runs['fsdp']['peak']:.2f} vs {runs['plain']['peak']:.2f}; a "
          f"DTensor at layer_norm_fwd: {refused!r} [{card}]")
    out = dict(rows={k: v["rows"] for k, v in runs.items()},
               same_loss=same_loss, same_params=same_params,
               same_launches=same_launches, dtensor_refused=refused)
    del runs, x
    torch.cuda.empty_cache()
    if not (all(same_loss) and same_params and same_launches):
        return out, "train-fsdp: the placed steps differ from the plain ones"
    if not dtensor_ok:
        return out, f"train-fsdp: a DTensor at a kernel wrapper: {refused}"
    return out, None


def run_zero(torch, ops, card, launches):
    """train-zero: the train-fsdp trainer unplaced, its optimizer
    ``distributed_fused_adam(1e-4, weight_decay=0.01)`` on the one-rank
    fsdp group against ``fused_adam`` with the same arguments: the same
    element-wise fp32 update on the flat slice, so losses and params
    bit for bit; one reduce-scatter and one all-gather a step; the same
    kernel launches. Adds the ZeRO run's launches to ``launches``."""
    from apex1_tpu_torch import fused_adam
    from apex1_tpu_torch.contrib import distributed_fused_adam
    txs = {"fused_adam": fused_adam(1e-4, weight_decay=0.01),
           "zero": distributed_fused_adam(1e-4, weight_decay=0.01)}
    runs = zero_pair(torch, ops, tuple(txs), lambda name: make_trainer(
        torch, "O2", 12, SEED, use_flash=True, fuse_head=True,
        tx=txs[name]))
    for k, v in runs["zero"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    same_loss = [a["loss"] == b["loss"] for a, b in
                 zip(runs["zero"]["rows"], runs["fused_adam"]["rows"])]
    same_params = all(torch.equal(runs["zero"]["params"][k], p)
                      for k, p in runs["fused_adam"]["params"].items())
    same_launches = runs["zero"]["launches"] == runs["fused_adam"]["launches"]
    coll = runs["zero"]["collectives"]
    want_coll = {"reduce_scatter": ZERO_STEPS, "all_gather": ZERO_STEPS}
    print(f"phase train-zero: GPT-2 124M O2 flash fused head B={TB} "
          f"S={TS}, {ZERO_STEPS} steps, distributed_fused_adam(1e-4, "
          f"weight_decay=0.01) on a one-rank NCCL fsdp group vs fused_adam: "
          f"losses {[r['loss'] for r in runs['zero']['rows']]} equal "
          f"{same_loss}, params bit-identical {same_params}, launches equal "
          f"{same_launches}; collectives {coll} (want {want_coll}); "
          f"{step_walls(runs)} [{card}]")
    out = dict(rows={k: v["rows"] for k, v in runs.items()},
               same_loss=same_loss, same_params=same_params,
               collectives=coll)
    del runs
    if not (all(same_loss) and same_params and same_launches):
        return out, "train-zero: the ZeRO steps differ from fused_adam's"
    if coll != want_coll:
        return out, f"train-zero: collectives {coll}, expected {want_coll}"
    return out, None


def run_bert_lamb(torch, ops, card, launches):
    """train-bert-lamb: the bench's ``bert`` (BERT-base, B x 512, O2),
    ZERO_STEPS steps with ``distributed_fused_lamb(1e-4,
    weight_decay=0.01)`` on the one-rank fsdp group against
    ``fused_lamb`` with the same arguments: losses within 1e-6
    relative, every param within 1e-6 of its tensor's largest value
    (the trust ratios' sums round in another order), each step's
    launches those of train-bert, and a step's collectives one
    reduce-scatter, one all-gather and three all-reduces (the gradient
    norm, the two per-tensor sums). Adds the LAMB run's launches to
    ``launches``."""
    from apex1_tpu_torch import fused_lamb
    from apex1_tpu_torch.contrib import distributed_fused_lamb
    run = BERT_RUNS["bert"]
    txs = {"fused_lamb": fused_lamb(1e-4, weight_decay=0.01),
           "zero": distributed_fused_lamb(1e-4, weight_decay=0.01)}
    runs = zero_pair(torch, ops, tuple(txs), lambda name: make_bert_trainer(
        torch, "O2", False, SEED, B=run["B"], dropout=0.0, tx=txs[name]))
    for k, v in runs["zero"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    per_step = bert_launches(runs["zero"]["cfg"].num_layers, False)
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
                   zip(runs["zero"]["rows"], runs["fused_lamb"]["rows"]))
    param_err = max(
        ((runs["zero"]["params"][k] - p).abs().max()
         / p.abs().max().clamp(min=1e-30)).item()
        for k, p in runs["fused_lamb"]["params"].items())
    launches_ok = all(r["launches"] == per_step
                      for v in runs.values() for r in v["rows"])
    coll = runs["zero"]["collectives"]
    want_coll = {"reduce_scatter": ZERO_STEPS, "all_gather": ZERO_STEPS,
                 "all_reduce": 3 * ZERO_STEPS}
    print(f"phase train-bert-lamb: bert O2 B={run['B']} S={BERT_S}, "
          f"{ZERO_STEPS} steps, distributed_fused_lamb(1e-4, "
          f"weight_decay=0.01) on a one-rank NCCL fsdp group vs fused_lamb: "
          f"losses {[r['loss'] for r in runs['zero']['rows']]} vs "
          f"{[r['loss'] for r in runs['fused_lamb']['rows']]}, worst "
          f"relative {loss_err:.3g}; worst param error over its tensor's "
          f"largest value {param_err:.3g}; launches a step {per_step} "
          f"{launches_ok}; collectives {coll} (want {want_coll}); "
          f"{step_walls(runs)} [{card}]")
    out = dict(rows={k: v["rows"] for k, v in runs.items()},
               loss_err=loss_err, param_err=param_err, collectives=coll)
    del runs
    if not (loss_err <= 1e-6 and param_err <= 1e-6):
        return out, (f"train-bert-lamb: losses {loss_err:.3g} or params "
                     f"{param_err:.3g} beyond 1e-6")
    if not launches_ok:
        return out, "train-bert-lamb: launches differ from train-bert's"
    if coll != want_coll:
        return out, (f"train-bert-lamb: collectives {coll}, expected "
                     f"{want_coll}")
    return out, None


def run_spatial(torch, ops, card, launches):
    """spatial-bottleneck: ResNet-50's stage-1 stride-1 bottleneck at
    the train-resnet batch (SPATIAL_B x 56 x 56 x 256, features 64,
    channels-last) as `SpatialBottleneck` on the one-rank cp group
    (the halo exchange and the batch statistics synced over it) against
    the plain `Bottleneck` with the same weights, at O2 (the resnet
    phase's dtype) and O0, train and eval: the output and the gradient
    of x and of every param each no farther from the plain block's
    (the norm of the difference over the plain one's) than twice the
    plain block's own distance from its float64 run, plus the dtype's
    unit roundoff (a rounding witness: train-mode batch norm and ReLU
    make single gradient elements ill-conditioned, so no elementwise
    bound holds); the new running statistics within 1e-5 of their
    largest value. Both walls (forward and backward). No kernel
    launches (cuDNN)."""
    import dataclasses
    from apex1_tpu_torch import get_policy
    from apex1_tpu_torch.models.resnet import (Bottleneck, ResNetConfig,
                                               SpatialBottleneck)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    F_, C = SPATIAL_F, 4 * SPATIAL_F
    x = torch.randn(SPATIAL_B, SPATIAL_HW, SPATIAL_HW, C, generator=gen,
                    device="cuda")
    ct = torch.randn(SPATIAL_B, SPATIAL_HW, SPATIAL_HW, C, generator=gen,
                     device="cuda").permute(0, 3, 1, 2)
    p64 = dataclasses.replace(get_policy("O0"), param_dtype=torch.float64,
                              compute_dtype=torch.float64)
    out, bad = {}, []
    ops.reset_launches()
    for level in ("O2", "O0"):
        cfg = ResNetConfig.resnet50(policy=get_policy(level))
        dt = cfg.policy.compute_dtype
        unit = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}[dt]
        spatial = SpatialBottleneck(cfg, F_, "cp", device="cuda", seed=SEED)
        plain = Bottleneck(cfg, C, F_, device="cuda")
        plain.load_state_dict(spatial.state_dict())
        plain64 = Bottleneck(ResNetConfig.resnet50(policy=p64), C, F_,
                             device="cuda").double()
        plain64.load_state_dict({k: v.double() for k, v in
                                 spatial.state_dict().items()})
        for train in (True, False):
            def run(block, dtype=dt):
                xs = x.detach().double().requires_grad_() \
                    if dtype == torch.float64 else x.detach().requires_grad_()
                names, params = zip(*block.named_parameters())
                stats = {}
                y = block(xs.permute(0, 3, 1, 2).to(dtype), train=train,
                          stats=stats, prefix="b")
                grads = torch.autograd.grad((y.double() * ct).sum(),
                                            [xs, *params])
                return dict(zip(("y", "dx") + names, (y,) + grads)), stats

            got, gstats = run(spatial)
            want, wstats = run(plain)
            ref, _ = run(plain64, torch.float64)
            ratios = {}
            for k, w in want.items():
                w, r = w.double(), ref[k]
                gap = ((got[k].double() - w).norm() / w.norm()).item()
                own = ((w - r).norm() / r.norm()).item()
                ratios[k] = gap / (2 * own + unit)
            worst = max(ratios, key=ratios.get)
            stat_err = max([((gstats[k] - w).abs().max()
                             / w.abs().max().clamp(min=1e-30)).item()
                            for k, w in wstats.items()] or [0.0])
            walls = {name: wall_ms(torch, lambda b=b: run(b))
                     for name, b in (("spatial", spatial),
                                     ("plain", plain))}
            dev = {name: profiled_calls(torch, lambda b=b: run(b))[
                "device_ms_per_step"] for name, b in (("spatial", spatial),
                                                      ("plain", plain))}
            key = f"{level} train={train}"
            out[key] = dict(ratios=ratios, stat_err=stat_err, walls=walls,
                            device_ms=dev)
            print(f"phase spatial-bottleneck: {key} {SPATIAL_B}x"
                  f"{SPATIAL_HW}x{SPATIAL_HW}x{C} features {F_} "
                  f"{str(dt).split('.')[-1]} channels-last, one-rank cp "
                  f"group: output and {len(ratios) - 1} gradients, "
                  f"distance from plain over twice plain's from float64 "
                  f"+ {unit:g}: worst {ratios[worst]:.3g} ({worst}); "
                  f"running stats {stat_err:.3g}; wall ms (forward + "
                  f"backward) spatial {walls['spatial']:.2f} plain "
                  f"{walls['plain']:.2f}, device ms spatial "
                  f"{dev['spatial']:.3f} plain {dev['plain']:.3f} [{card}]")
            if ratios[worst] > 1 or stat_err > 1e-5:
                bad.append(key)
            del got, want, ref
        del spatial, plain, plain64
        torch.cuda.empty_cache()
    n = {k: v for k, v in ops.launch_counts().items() if v}
    if n:
        bad.append(f"launches {n}")
    return out, (f"spatial-bottleneck: {bad}" if bad else None)


# ---- the T5 generation and contrib slice -----------------------------------

#: generate-t5: the bench's ``t5`` model (`make_t5`, 12 + 12 layers, O2)
#: decoding T5GEN_NEW tokens for the bench's B x S_enc encoder batch,
#: the last T5GEN_PAD encoder positions of the first T5GEN_PAD_ROWS rows
#: key-padded; beam search at T5GEN_BEAMS beams with length penalty 0.6;
#: sampling at T 0.7, top-k 50 from the key data (0, SEED)
T5GEN_NEW, T5GEN_PAD, T5GEN_PAD_ROWS, T5GEN_BEAMS = 32, 100, 2, 4
#: at O2 a greedy stream may leave its reference only at a near-tie:
#: the reference's top-2 gap (relative) below the two runs' largest
#: logit difference at that step (relative to the top logit), and that
#: difference at most T5GEN_ROUNDING times the O2 path's own rounding,
#: measured in the same call as the O2 plain path's first-step logits
#: against the O0 plain path's on the same weights (two O2 paths, each
#: that far from the fp32 logits, lie at most twice that far apart).
#: T5 has no 1/sqrt(d)
#: attention scale, so its softmax rows are peaked and one bf16 rounding
#: of a score moves a row's weights by several per cent: a depth-24
#: stack turns the two paths' different roundings into logits several
#: per cent apart. At O0 the kernels compute the plain functions: a
#: flip only where the plain run's top-2 gap is below T5GEN_O0_GAP (the
#: generate-parity rule)
T5GEN_ROUNDING, T5GEN_O0_GAP = 2.0, 1e-4


def t5gen_launches(n_enc: int, n_dec: int, steps: int) -> dict:
    """Kernel launches of one `t5_generate` call: the encoder's 2 RMS
    norms and 1 flash forward a layer and its final norm; each of the
    ``steps`` decoder forwards 3 norms a layer (self, cross, FFN) and
    the final norm, and the cross-attention's flash forward a layer at
    Sq = 1. The self-attention is `cache_attend`, a composite, as in the
    JAX package."""
    return {"layer_norm_fwd": 2 * n_enc + 1 + steps * (3 * n_dec + 1),
            "flash_fwd": n_enc + steps * n_dec}


@contextlib.contextmanager
def recording(model, record: list):
    """``model.decode`` appends each call's last-position logits (fp32)
    to ``record`` while the context is open."""
    decode = model.decode

    def rec(*a, **kw):
        out = decode(*a, **kw)
        record.append((out[0] if isinstance(out, tuple) else out)[:, -1]
                      .float())
        return out

    model.decode = rec
    try:
        yield
    finally:
        del model.decode


def near_tie_flips(torch, got, want, rec_got, rec_want, vocab: int,
                   limit: float):
    """(flips, moved, bad): `first_flips` of ``got`` against ``want``,
    the two runs' largest logit difference at each flip relative to the
    top logit, and the flips that are not near-ties: the reference's
    top-2 gap not below that difference, or the difference above
    ``limit``."""
    from apex1_tpu_torch.models.near_tie import (first_flips, logits_moved,
                                                 top2_gap)
    flips = first_flips(got, want, lambda r, t: top2_gap(
        rec_want[t], r, t, 0.0, vocab))
    moved = [logits_moved(rec_got[t][r:r + 1], rec_want[t][r:r + 1])
             for r, t, _ in flips]
    bad = [f for f, m in zip(flips, moved) if f[2] >= m or m > limit]
    return flips, moved, bad


def run_generate_t5(torch, ops, card, launches):
    """generate-t5: `t5_generate` over the bench's ``t5`` at full width
    and depth (O2, weights from `SEED`) for the bench's 8 x 512 encoder
    tokens with key padding on two rows, 32 new tokens: greedy through
    the kernels (timed after a warm-up call) and through the plain
    versions, the port's uncached greedy loop (the decoder over the
    whole growing context, through the kernels), beam search (4 beams,
    length penalty 0.6) and `beam_search` at one beam, sampling at T 0.7
    and top-k 50 twice from one key; then the same model at O0, greedy
    through the kernels and the plain versions. Checks: exact launches
    of every kernel call (`t5gen_launches`), the greedy streams equal or
    apart first at a near-tie (`near_tie_flips`: at O2 within
    `T5GEN_ROUNDING` times the O2 path's own rounding, at O0 the
    generate-parity rule), beam 1 equal to greedy, the two sampled
    streams equal, every id inside the vocabulary. Prints
    tokens/s and the wall of each call, the encode's wall, and the
    device ms of a decoder step (one profiled call less one profiled
    encode, over its 32 steps). Adds the kernel calls' launches to
    ``launches``. Returns (results, failure or None)."""
    from torch.profiler import ProfilerActivity, profile
    from apex1_tpu_torch.models.generate import (beam_search, init_cache,
                                                 t5_generate)
    from apex1_tpu_torch.models.near_tie import logits_moved
    cfg, model = make_t5("O2", T5LAYERS, SEED)
    enc = t5_batch(torch, cfg.vocab_size)[0]
    keep = torch.ones(T5B, T5S, dtype=torch.bool, device="cuda")
    keep[:T5GEN_PAD_ROWS, -T5GEN_PAD:] = False
    N, V = T5GEN_NEW, cfg.vocab_size
    per_call = t5gen_launches(T5LAYERS, T5LAYERS, N)

    def call(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = t5_generate(model, enc, max_new_tokens=N, enc_pad_mask=keep,
                           **kw)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    def encode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.encode(enc, keep)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()                                     # warm-up
    enc_s = encode()
    out, err, runs = {}, None, {}
    for label, kw in (
            ("greedy", {}),
            ("beam", dict(num_beams=T5GEN_BEAMS, length_penalty=0.6)),
            ("sampled", dict(temperature=0.7, top_k=50, rng=(0, SEED))),
            ("sampled again", dict(temperature=0.7, top_k=50,
                                   rng=(0, SEED)))):
        ops.reset_launches()
        rec = []
        with recording(model, rec):
            toks, wall = call(**kw)
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        runs[label] = (toks, rec)
        out[label] = dict(wall_s=wall, tokens_per_s=T5B * N / wall,
                          launches=counts)
        print(f"phase generate-t5: {label} t5 O2 d_model {cfg.d_model} "
              f"layers {cfg.num_encoder_layers}+{cfg.num_decoder_layers} "
              f"vocab {V}; B={T5B} x S_enc={T5S} (rows 0-"
              f"{T5GEN_PAD_ROWS - 1} key-padded over their last "
              f"{T5GEN_PAD}), {N} new tokens, {kw or 'greedy'}: wall "
              f"{wall:.3f} s, {T5B * N / wall:.1f} tokens/s, launches "
              f"{counts} expected {per_call} [{card}]")
        if counts != per_call and err is None:
            err = (f"generate-t5 {label}: launches {counts}, expected "
                   f"{per_call}")
        bad_ids = (tuple(toks.shape) != (T5B, N) or toks.dtype != torch.int32
                   or toks.min() < 0 or toks.max() >= V)
        if bad_ids and err is None:
            err = (f"generate-t5 {label}: tokens {tuple(toks.shape)} "
                   f"{toks.dtype} or an id outside the vocabulary")
    greedy, rec_k = runs["greedy"]
    # the references: the plain versions, the uncached loop, beam 1
    rec_p, rec_u = [], []
    with ops.force_impl("torch"), recording(model, rec_p):
        plain, _ = call()
    with torch.no_grad():
        memory = model.encode(enc, keep)
        dec = torch.zeros((T5B, 1), dtype=torch.int64, device="cuda")
        for _ in range(N):
            logits = model.decode(dec, memory, keep)[:, -1].float()
            rec_u.append(logits)
            dec = torch.cat([dec, logits.argmax(-1)[:, None]], 1)
    uncached = dec[:, 1:]

    @torch.no_grad()
    def apply_fn(tokens, cache, idx):
        return model.decode(tokens, memory, enc_pad_mask=keep, cache=cache,
                            cache_index=idx)

    beam1, _ = beam_search(apply_fn, torch.zeros((T5B, 1), dtype=torch.int32,
                                                 device="cuda"),
                           max_new_tokens=N, cache=init_cache(
                               cfg.num_decoder_layers, T5B, cfg.num_heads,
                               1 + N, cfg.head_dim, torch.bfloat16,
                               device="cuda"), num_beams=1)
    # the O2 path's own rounding: its plain first-step logits against
    # the O0 plain path's on the same weights; and the O0 parity run
    _, model0 = make_t5("O0", T5LAYERS, SEED)
    rec_k0, rec_p0 = [], []
    with recording(model0, rec_k0):
        greedy0 = t5_generate(model0, enc, max_new_tokens=N,
                              enc_pad_mask=keep)
    with ops.force_impl("torch"), recording(model0, rec_p0):
        plain0 = t5_generate(model0, enc, max_new_tokens=N,
                             enc_pad_mask=keep)
    del model0
    rounding = logits_moved(rec_p[0], rec_p0[0])
    limit = T5GEN_ROUNDING * rounding
    out["o2_rounding"] = rounding
    print(f"phase generate-t5: the O2 path's rounding: its plain "
          f"first-step logits against the O0 plain path's, largest "
          f"difference over the top logit {rounding:.4g}; the kernels' "
          f"against the plain versions' at O2 "
          f"{logits_moved(rec_k[0], rec_p[0]):.4g}, at O0 "
          f"{logits_moved(rec_k0[0], rec_p0[0]):.3g} [{card}]")
    g = greedy.cpu().numpy()
    for label, got, ref, rec_g, rec_r, lim in (
            ("O2, against the plain versions", g, plain, rec_k, rec_p,
             limit),
            ("O2, against the uncached loop", g, uncached, rec_k, rec_u,
             limit),
            ("O0, against the plain versions", greedy0.cpu().numpy(),
             plain0, rec_k0, rec_p0, None)):
        flips, moved, bad = near_tie_flips(torch, got, ref.cpu().numpy(),
                                           rec_g, rec_r, V,
                                           float("inf") if lim is None
                                           else lim)
        if lim is None:     # O0: the generate-parity rule
            bad = [f for f in flips if f[2] >= T5GEN_O0_GAP]
        out[f"greedy vs {label}"] = dict(flips=flips, logit_moved=moved)
        rule = (f"gap below {T5GEN_O0_GAP:g}" if lim is None else
                f"gap below it, it at most {lim:.4g}")
        print(f"phase generate-t5: greedy through the kernels, {label}: "
              f"streams differing {len(flips)} of {T5B}; (row, step, "
              f"top-2 gap relative) at the first differing token {flips}, "
              f"the logits' largest difference there relative to the top "
              f"logit {moved} (a near-tie: {rule}) [{card}]")
        if bad and err is None:
            err = (f"generate-t5: greedy ({label}) differs where the "
                   f"top-2 gap is not a near-tie: {bad}")
    same_beam1 = torch.equal(beam1, greedy)
    same_sampled = torch.equal(runs["sampled"][0], runs["sampled again"][0])
    beam_rows_differ = int((runs["beam"][0] != greedy).any(1).sum())
    print(f"phase generate-t5: beam_search at 1 beam equals greedy "
          f"{same_beam1}; {T5GEN_BEAMS} beams differ from greedy in "
          f"{beam_rows_differ} of {T5B} rows; the sampled streams equal "
          f"twice {same_sampled} [{card}]")
    if err is None and not (same_beam1 and same_sampled):
        err = (f"generate-t5: beam 1 equal to greedy {same_beam1}, sampled "
               f"twice equal {same_sampled}")
    # device time: one profiled greedy call less one profiled encode
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = call()
    pc = kernel_split(torch, prof, 1, wall * 1e3, top=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ewall = encode()
    pe = kernel_split(torch, prof, 1, ewall * 1e3)
    step_ms = (pc["device_ms_per_step"] - pe["device_ms_per_step"]) / N
    out.update(encode_wall_s=enc_s, profile_call=pc, profile_encode=pe,
               device_ms_per_decoder_step=step_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    top = [(t["name"][:60], round(t["ms_per_step"], 3), t["calls"])
           for t in pc["top"][:10]]
    print(f"phase generate-t5: encode wall {enc_s * 1e3:.2f} ms; a greedy "
          f"call (profiled) {wall * 1e3:.2f} ms wall, "
          f"{pc['device_ms_per_step']:.3f} ms device "
          f"({pc['device_busy']:.0%} busy), the encode "
          f"{pe['device_ms_per_step']:.3f} ms device; device ms a decoder "
          f"step {step_ms:.4f}; largest kernels of the call (name, ms, "
          f"calls) {top} [{card}]")
    del model, memory, apply_fn
    torch.cuda.empty_cache()
    return out, err


#: the contrib phase's kernel-free modules, each once on the card
#: against the same call on the CPU at one realistic shape: (name, the
#: shape it is named by)
CONTRIB_PLAIN = (
    "focal_loss RetinaNet (2, 182403 anchors, 80 classes)",
    "group_norm SD UNet block (2, 64, 64, 320) 32 groups SiLU bf16",
    "index_mul_2d OpenFold (65536 x 128 gathered by 131072)",
    "transducer joint (hidden 320, ReLU) + loss B 8 T 256 U 65 V 1024 "
    "fp32, grad of the joint's output projection",
    "ASP m4n2 mask (4096, 4096) + permutation_search (256, 64)",
    "LSTM / GRU / RNNReLU / RNNTanh T 32 B 64 1024 -> 1024, 2 layers",
    "WeightNormDense 1024 -> 4096 on 4096 rows bf16",
    "FusedDense / FusedDenseGeluDense / MLP on 8192 x 1024 bf16")


def contrib_plain_cases(torch):
    """Each kernel-free contrib module at its `CONTRIB_PLAIN` shape:
    (name, fn(device) -> tuple of output tensors, dtype of the
    comparison). ``fn`` builds its inputs and modules from one seed on
    the CPU and moves them to ``device``, so the card and the CPU run
    the same call on the same numbers."""
    import copy
    from apex1_tpu_torch import contrib, reparameterization, rnn
    from apex1_tpu_torch.contrib import sparsity, transducer
    from apex1_tpu_torch.ops import fused_dense as fd
    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    fl_x = rnd(2, 182403, 80, scale=2.0)
    fl_t = torch.randint(-1, 80, (2, 182403), generator=gen)
    gn_x = rnd(2, 64, 64, 320, scale=2.0).bfloat16()
    gn_g, gn_b = 1 + 0.1 * rnd(320), 0.1 * rnd(320)
    im1, im2 = rnd(65536, 128), rnd(131072, 128)
    im_i = torch.randint(0, 65536, (131072,), generator=gen)
    tr_f, tr_g = rnd(8, 256, 320), rnd(8, 65, 320)
    tr_w = rnd(320, 1024, scale=0.05)
    tr_t = torch.randint(1, 1024, (8, 64), generator=gen)
    tr_fl = torch.tensor([256, 250, 240, 230, 220, 210, 200, 128])
    tr_yl = torch.tensor([64, 60, 50, 40, 30, 20, 10, 5])
    sp_w = rnd(4096, 4096).bfloat16()
    sp_small = rnd(256, 64)
    rnn_x = rnd(32, 64, 1024)
    rnns = [cls(1024, 1024, num_layers=2, device="cpu")
            for cls in (rnn.LSTM, rnn.GRU, rnn.RNNReLU, rnn.RNNTanh)]
    wn = reparameterization.WeightNormDense(1024, 4096, device="cpu")
    wn_x = rnd(4096, 1024).bfloat16()
    dense = [fd.FusedDense(1024, 4096, device="cpu"),
             fd.FusedDenseGeluDense(1024, 4096, 1024, device="cpu"),
             fd.MLP((1024, 4096, 4096, 1024), device="cpu")]
    fd_x = rnd(8192, 1024).bfloat16()

    def on(dev, *ts):
        return [t.to(dev) for t in ts]

    def mods(dev, ms):
        return [copy.deepcopy(m).to(dev) for m in ms]

    def focal(dev):
        x, t = on(dev, fl_x, fl_t)
        return (contrib.focal_loss(x, t, reduction="none"),)

    def gnorm(dev):
        x, g, b = on(dev, gn_x, gn_g, gn_b)
        return (contrib.group_norm(x, 32, g, b, act="silu"),)

    def imul(dev):
        a, b, i = on(dev, im1, im2, im_i)
        return (contrib.index_mul_2d(a, b, i),)

    def trans(dev):
        f, g, w, t, fl, yl = on(dev, tr_f, tr_g, tr_w, tr_t, tr_fl, tr_yl)
        w.requires_grad_()
        h = transducer.transducer_joint(f, g, relu=True)
        logits = h @ w
        loss = transducer.transducer_loss(logits, t, fl, yl,
                                          reduction="none")
        gw, = torch.autograd.grad(loss.sum(), w)
        return loss.detach(), gw

    def asp(dev):
        w, ws = on(dev, sp_w, sp_small)
        perm, mask, eff = sparsity.permutation_search(ws, max_swaps=16)
        return (sparsity.compute_m4n2_mask(w).float(), eff.reshape(1),
                sparsity.mask_efficacy(ws, mask).reshape(1))

    def rnns_run(dev):
        x, = on(dev, rnn_x)
        outs = []
        with torch.no_grad():
            for m in mods(dev, rnns):
                y, fin = m(x)
                outs += [y, fin[0] if isinstance(fin, tuple) else fin]
        return tuple(outs)

    def wnorm(dev):
        x, = on(dev, wn_x)
        with torch.no_grad():
            return (mods(dev, [wn])[0](x),)

    def dense_run(dev):
        x, = on(dev, fd_x)
        with torch.no_grad():
            return tuple(m(x) for m in mods(dev, dense))

    fns = (focal, gnorm, imul, trans, asp, rnns_run, wnorm, dense_run)
    dts = ("float32", "bfloat16", "float32", "float32", "float32",
           "float32", "bfloat16", "bfloat16")
    return list(zip(CONTRIB_PLAIN, fns, dts))


def run_contrib(torch, ops, card, launches):
    """contrib: the kernel-bearing contrib modules on the card at their
    users' shapes, each through the kernels and through the plain
    versions in the same call, within their rows' check bounds:
    `openfold.attention_core` at AlphaFold2's MSA row attention with
    pair bias (q/k/v (1, 128, 8, 256, 32) bf16, bias1 (1, 128, 1, 1,
    256), bias2 (1, 1, 8, 256, 256)), forward and backward (rows 16-17:
    softmax fwd and bwd once each); `openfold.layer_norm` at c_m 256
    (128 x 256 rows) and c_z 128 (256 x 256 rows) (row 1 once each);
    `SoftmaxCrossEntropyLoss.apply` at the GPT-2 head (16 x 1023 x 50304
    bf16, smoothing 0.1, padding_idx 0, half_to_float), forward and
    backward (rows 18-19 once each). Then every kernel-free module
    (`CONTRIB_PLAIN`) once on the card against the same call on the
    CPU: outputs on the card, no kernel launched, within the f32 or
    bf16 tolerance. Adds the kernel calls' launches to ``launches``.
    Returns (results, failure or None)."""
    from apex1_tpu_torch.contrib import SoftmaxCrossEntropyLoss, openfold
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out, err = {}, None

    def rnd(*shape, dt=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    q, k, v, do = (rnd(1, OF_N, OF_H, OF_S, OF_D) for _ in range(4))
    b1 = rnd(1, OF_N, 1, 1, OF_S, dt=torch.float32)
    b2 = rnd(1, 1, OF_H, OF_S, OF_S, dt=torch.float32)

    def attn():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = openfold.attention_core(qq, kk, vv, bias1=b1, bias2=b2)
        return (o, *torch.autograd.grad(o, (qq, kk, vv), do))

    x_m = rnd(1, OF_N, OF_S, OF_CM, scale=2.0)
    x_z = rnd(1, OF_S, OF_S, OF_CZ, scale=2.0)
    g_m, g_z = (1 + 0.1 * rnd(c, dt=torch.float32) for c in (OF_CM, OF_CZ))
    be_m, be_z = (0.1 * rnd(c, dt=torch.float32) for c in (OF_CM, OF_CZ))
    logits = rnd(TB, TS - 1, TV_PAD, scale=2.0)
    labels = torch.randint(0, TV_PAD, (TB, TS - 1), generator=gen,
                           device="cuda")
    labels[:, ::7] = 0

    def xent():
        x = logits.detach().requires_grad_()
        loss = SoftmaxCrossEntropyLoss.apply(x, labels, 0.1, 0, True)
        dx, = torch.autograd.grad(loss.sum() / loss.numel(), x)
        return loss, dx

    kernel_cases = (
        ("attention_core MSA row + pair bias (1, 128, 8, 256, 32) bf16",
         attn, {"softmax_fwd": 1, "softmax_bwd": 1}),
        ("layer_norm c_m 256 (128 x 256 rows) bf16",
         lambda: (openfold.layer_norm(x_m, g_m, be_m),),
         {"layer_norm_fwd": 1}),
        ("layer_norm c_z 128 (256 x 256 rows) bf16",
         lambda: (openfold.layer_norm(x_z, g_z, be_z),),
         {"layer_norm_fwd": 1}),
        ("SoftmaxCrossEntropyLoss.apply (16, 1023, 50304) bf16 eps 0.1 "
         "pad 0 half_to_float", xent, {"xent_fwd": 1, "xent_bwd": 1}))
    for case, fn, want_launches in kernel_cases:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        with ops.force_impl("torch"):
            want = fn()
        torch.cuda.synchronize()
        # bf16 outputs at bf16's rule; the loss (fp32) at f32's, its dx
        # (bf16, autograd's cast of the kernel's fp32 dx) at bf16's
        errs = [max_errs(a, b, *TOLS[str(a.dtype)[6:]])
                for a, b in zip(got, want)]
        abs_e, worst = max(e[0] for e in errs), max(e[1] for e in errs)
        out[case] = dict(abs=abs_e, worst=worst, wall_s=wall,
                         launches=counts)
        ok = worst <= 1 and counts == want_launches and all(
            t.is_cuda for t in got)
        print(f"phase contrib: {case}: kernels vs plain max_abs={abs_e:.3g} "
              f"worst/allowed={worst:.3g} wall {wall * 1e3:.2f} ms "
              f"launches {counts} expected {want_launches} "
              f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok and err is None:
            err = (f"contrib {case}: worst/allowed {worst}, launches "
                   f"{counts} (expected {want_launches})")
        del got, want
    del q, k, v, do, b1, b2, x_m, x_z, logits
    torch.cuda.empty_cache()
    for case, fn, dts in contrib_plain_cases(torch):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        want = fn("cpu")
        errs = [max_errs(a.cpu(), b, *TOLS[dts]) for a, b in zip(got, want)]
        abs_e, worst = max(e[0] for e in errs), max(e[1] for e in errs)
        on_card = all(t.is_cuda for t in got)
        ok = worst <= 1 and on_card and not counts
        out[case] = dict(abs=abs_e, worst=worst, wall_s=wall,
                         on_card=on_card)
        print(f"phase contrib: {case}: card vs CPU max_abs={abs_e:.3g} "
              f"worst/allowed={worst:.3g} (rtol={TOLS[dts][0]:g} "
              f"atol={TOLS[dts][1]:g}*rms) on the card {on_card}, wall "
              f"{wall * 1e3:.2f} ms, launches {counts} "
              f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok and err is None:
            err = (f"contrib {case}: worst/allowed {worst}, on the card "
                   f"{on_card}, launches {counts}")
        del got, want
    torch.cuda.empty_cache()
    return out, err


# ---- the serving-tier slice: the dense pool, the fleet, disagg, speculative

#: the fleet's engines: the engine phase's model and sampling over a pool
#: sized to the fleet's requests (prompts of 16-200 tokens, 32 new)
FLEET_ENGINE_KW = dict(ENGINE_KW, max_len=256)
FLEET_N, FLEET_NEW, FLEET_KILL_STEP = 32, 32, 10
#: the fleet's special requests: cancelled mid-stream, expiring
#: mid-stream, hedged, infeasible at the door
FLEET_CANCEL, FLEET_EXPIRE, FLEET_HEDGE, FLEET_INFEASIBLE = 9, 5, 20, 31
#: a flip between two runs of one sampled stream is a near-tie when the
#: reference's top-2 score gap is below twice the two runs' largest logit
#: difference there (over T), and that difference is at most
#: `SERVE_MOVE` of the top logit (about one bf16 rounding, as DEC8_MOVE)
SERVE_MOVE = 2.0 ** -6


def gpt2_serving_model(torch, depth: int = 12, policy: str = "O2",
                       seed: int = SEED):
    """GPT-2 124M (``depth`` layers) with the engine phase's weights on
    the card and its decoder pair: (cfg, apply_fn, make_cache)."""
    from apex1_tpu_torch import (GPT2Config, get_policy, gpt2_decoder,
                                 gpt2_params_from_jax)
    from apex1_tpu_torch.models.gpt2 import init_params
    cfg = GPT2Config.gpt2_125m(num_layers=depth, policy=get_policy(policy))
    model = gpt2_params_from_jax(init_params(cfg, seed), cfg, "cuda")
    return (cfg, *gpt2_decoder(model))


def drive(torch, eng, reqs, new: int, record=None):
    """Submit ``reqs`` ({tokens, seed}) to ``eng`` and step it dry (with
    ``record``, every sampling row kept, `sampling_record`); returns
    (streams, wall s, decode-only step walls ms)."""
    ids = [eng.submit(r["tokens"], max_new_tokens=new, seed=r["seed"])
           for r in reqs]
    step_ms = []
    with (contextlib.nullcontext() if record is None
          else sampling_record(record)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.scheduler.depth > 0 or any(s is not None
                                             for s in eng.slot_view()):
            chunks = eng.metrics.get_counter("prefill_chunks")
            ts = time.perf_counter()
            eng.step()
            if eng.metrics.get_counter("prefill_chunks") == chunks:
                step_ms.append((time.perf_counter() - ts) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [[int(t) for t in eng.results[i].tokens] for i in ids], wall, \
        step_ms


def engine_forwards(engines) -> int:
    return sum(e.metrics.get_counter("prefill_chunks")
               + e.metrics.get_counter("decode_steps") for e in engines)


def gpt2_launches(n_fwd: int, layers: int, paged: bool) -> dict:
    """Exact launches of ``n_fwd`` GPT-2 engine forwards: the norm twice
    a layer and once at the end, paged attention a layer (none on the
    dense pool: the `cache_attend` composite), one sampler."""
    return {"layer_norm_fwd": n_fwd * (2 * layers + 1),
            "paged_attend": n_fwd * layers if paged else 0,
            "fused_sample": n_fwd}


def launches_ok(got: dict, want: dict) -> bool:
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def sampled_flips(torch, got, want, seeds, rec_got, rec_want,
                  temperature: float, vocab: int):
    """(flips, bad): at each stream's first differing token (request,
    token, reference's top-2 score gap, twice the runs' largest logit
    difference over T, that difference over the top |logit|); ``bad``
    the flips that are not near-ties (gap not below the move, the move
    above `SERVE_MOVE`, or a row not recorded)."""
    from apex1_tpu_torch.models.near_tie import first_flips
    flips, bad = [], []
    for r, t, _ in first_flips(got, want, lambda r, t: 0.0):
        a, b = rec_got.get((seeds[r], t)), rec_want.get((seeds[r], t))
        if a is None or b is None:
            bad.append((r, t, None, None, None))
            continue
        diff = (a - b).abs().max().item()
        rel = diff / b.abs().max().item()
        t1, t2 = sample_top2(torch, b, seeds[r], t, temperature, vocab)
        f = (r, t, t1 - t2, 2 * diff / (temperature or 1.0), rel)
        flips.append(f)
        if not (f[2] < f[3] and rel <= SERVE_MOVE):
            bad.append(f)
    return flips, bad


def run_serve_dense(torch, ops, card, launches):
    """serve-dense: the engine phase's GPT-2 124M (O2, 12 layers, seed
    1234) and 16 requests through ``EngineConfig(paged=False)``, the
    dense pool (per-row device indices, the `cache_attend` composite,
    `fused_sample`): its streams against the paged engine's (recorded
    again here as the reference), a flip only at a near-tie
    (`sampled_flips`); exact launches (the norm and the sampler each
    forward, paged attention never); prefix hits counted; the same run
    with ``prefix_cache=False`` gives the same streams. Adds the dense
    run's launches to ``launches``. Returns (results, failure or None)."""
    from apex1_tpu_torch import Engine, EngineConfig
    cfg, apply_fn, make_cache = gpt2_serving_model(torch)
    reqs = workload(cfg.vocab_size, SEED)
    seeds = [r["seed"] for r in reqs]
    L, temp = cfg.num_layers, ENGINE_KW["temperature"]
    out, runs, recs = {}, {}, {}
    for label, kw, rec in (("paged", {}, True), ("dense", dict(paged=False),
                                                True),
                           ("dense, prefix_cache=False",
                            dict(paged=False, prefix_cache=False), False)):
        eng = Engine(apply_fn, make_cache, EngineConfig(**{**ENGINE_KW,
                                                           **kw}),
                     device="cuda")
        recs[label] = {} if rec else None
        ops.reset_launches()
        streams, wall, step_ms = drive(torch, eng, reqs, 64, recs[label])
        got = {k: v for k, v in ops.launch_counts().items() if v}
        n_fwd = engine_forwards([eng])
        want = gpt2_launches(n_fwd, L, paged=kw.get("paged", True))
        m = eng.metrics
        n_tok = sum(len(s) for s in streams)
        runs[label] = streams
        out[label] = dict(wall_s=wall, tokens=n_tok, launches=got,
                          forwards=n_fwd, summary=m.summary(),
                          step_ms=sum(step_ms) / max(len(step_ms), 1))
        print(f"phase serve-dense: {label}: GPT-2 124M O2 layers {L}; "
              f"{len(streams)} requests, {n_tok} tokens, wall {wall:.2f} s, "
              f"{n_tok / wall:.1f} tok/s, mean decode-step wall "
              f"{out[label]['step_ms']:.2f} ms over {len(step_ms)} steps, "
              f"prefill chunks {m.get_counter('prefill_chunks')}, decode "
              f"steps {m.get_counter('decode_steps')}, prefix hits "
              f"{m.get_counter('prefix_hits')} of "
              f"{m.get_counter('prefix_lookups')} lookups, ttft p50 "
              f"{m.summary().get('ttft_p50_ms', 0):.1f} ms, launches {got} "
              f"expected {want} [{card}]")
        if {r.status for r in eng.results.values()} != {"done"} or any(
                len(s) != 64 or min(s) < 0 or max(s) >= cfg.vocab_size
                for s in streams):
            return out, f"serve-dense {label}: a request did not finish right"
        if not launches_ok(got, want):
            return out, (f"serve-dense {label}: launches {got}, expected "
                         f"{want}")
        if label == "dense":
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
            if m.get_counter("prefix_hits") < 3:
                return out, (f"serve-dense: {m.get_counter('prefix_hits')} "
                             f"prefix hits, the 4 sharers give at least 3")
        del eng
        torch.cuda.empty_cache()
    flips, bad = sampled_flips(torch, runs["dense"], runs["paged"], seeds,
                               recs["dense"], recs["paged"], temp,
                               cfg.vocab_size)
    same_off = runs["dense, prefix_cache=False"] == runs["dense"]
    out["flips"], out["prefix_cache_off_equal"] = flips, same_off
    print(f"phase serve-dense: dense vs paged streams differing "
          f"{len(flips)} of {len(reqs)}; (request, token, top-2 score gap, "
          f"2 x logit difference / T, difference / top logit) at the first "
          f"differing token {flips}; prefix_cache=False streams equal "
          f"{same_off} [{card}]")
    if bad:
        return out, f"serve-dense: streams differ off a near-tie: {bad}"
    if not same_off:
        return out, "serve-dense: prefix_cache=False changed a stream"
    return out, None


def fleet_traffic(vocab: int):
    """The fleet's 32 requests: prompts of 16-200 tokens from the seed,
    32 new tokens each, guaranteed and sheddable alternating, seeds
    2000 + i; `FLEET_HEDGE` is the hedged tenant's."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    return [dict(tokens=rng.integers(1, vocab, int(rng.integers(16, 201)))
                 .astype(np.int32), seed=2000 + i,
                 qos="guaranteed" if i % 2 == 0 else "sheddable",
                 tenant="hedged" if i == FLEET_HEDGE else None)
            for i in range(FLEET_N)]


def run_serve_fleet(torch, ops, card, launches):
    """serve-fleet: `ServingFrontend` over 2 `ReplicaSupervisor`s, each an
    `Engine` (paged, `FLEET_ENGINE_KW`) of the engine phase's GPT-2 124M
    (one model, the same weights), pump mode: 32 requests
    (`fleet_traffic`) with one cancelled mid-stream, one whose deadline
    passes mid-stream (the engines' clock moved past it), one hedged
    (its tenant's TTFT budget 0), one infeasible deadline rejected at
    the door, and replica 0 killed at its step 10, restarted, its
    requests resubmitted; then the same traffic (the plain requests)
    with ``max_restarts=0`` (failover to replica 1) and in threaded
    mode. Every completed stream equals an undisturbed single engine's
    run of the same (prompt, seed) bit for bit; statuses and reasons as
    the drill sets them; free pages back to their start; one kernel
    library load; exact launches in the pump runs. Adds the first run's
    launches to ``launches``. Returns (results, failure or None)."""
    from apex1_tpu_torch import Engine, EngineConfig
    from apex1_tpu_torch.ops import _build
    from apex1_tpu_torch.serving import (Backpressure, FrontendConfig,
                                         ReplicaConfig, ServingFrontend)
    from apex1_tpu_torch.testing.chaos import ReplicaKill
    cfg, apply_fn, make_cache = gpt2_serving_model(torch)
    L = cfg.num_layers
    traffic = fleet_traffic(cfg.vocab_size)
    bump = [0.0]
    built = []

    def clock():
        return time.monotonic() + bump[0]

    def make_engine():
        e = Engine(apply_fn, make_cache, EngineConfig(**FLEET_ENGINE_KW),
                   device="cuda", clock=clock)
        built.append(e)
        return e

    special = (FLEET_CANCEL, FLEET_EXPIRE, FLEET_INFEASIBLE)
    ref_eng = Engine(apply_fn, make_cache, EngineConfig(**FLEET_ENGINE_KW),
                     device="cuda")
    ref, ref_wall, _ = drive(torch, ref_eng, [r for i, r in
                                              enumerate(traffic)
                                              if i != FLEET_INFEASIBLE],
                             FLEET_NEW)
    ref = dict(zip([i for i in range(FLEET_N) if i != FLEET_INFEASIBLE],
                   ref))
    del ref_eng
    out = {"reference_wall_s": ref_wall}

    def front_for(max_restarts, fault=None):
        return ServingFrontend(make_engine, FrontendConfig(
            n_replicas=2, capacity_per_replica=24, hedge_after_s=None,
            enter_shed=2.0, enter_degraded=3.0, seed=0,
            replica=ReplicaConfig(watchdog_s=120.0,
                                  max_restarts=max_restarts)),
            fault=fault)

    def check_run(label, front, rids, t_run, n_built, exact):
        res = {i: front.poll(rid) for i, rid in rids.items()}
        done = {i: r for i, r in res.items()
                if r is not None and r.status == "done"}
        differ = [i for i, r in done.items()
                  if [int(t) for t in r.tokens] != ref[i]]
        s = front.summary()
        engines = built[-n_built:] if n_built else []
        got = {k: v for k, v in ops.launch_counts().items() if v}
        want = gpt2_launches(engine_forwards(engines), L, paged=True)
        pages_back = []
        for rep in front.replicas:
            eng = rep.engine
            if rep.state == "failed" or eng is None:
                continue
            for key in list(eng.kv._prefixes):
                eng.kv.evict_prefix(key)
            pages_back.append(eng.kv.n_free_pages == eng.kv.num_pages - 1
                              and eng.kv.n_free == eng.cfg.max_slots)
        n_tok = sum(r.tokens.size for r in done.values())
        modes = [(t["frm"], t["to"]) for t in front.metrics.transitions
                 if t["event"] == "mode"]
        out[label] = dict(
            wall_s=t_run, tokens=n_tok, statuses={
                i: (r.status, r.reason) if r else None
                for i, r in res.items()},
            restarts=[r.restarts for r in front.replicas],
            engines_built=[r.engines_built for r in front.replicas],
            hedges=s["counters"].get("hedges_fired", 0),
            hedges_won=s["counters"].get("hedges_won", 0),
            modes=modes, launches=got, launches_expected=want,
            ttft_p50_ms=s.get("ttft_p50_ms"), differing=differ,
            pages_back=pages_back, library_loads=_build.load_count())
        print(f"phase serve-fleet: {label}: 2 replicas of GPT-2 124M O2 "
              f"(paged, 8 slots each) on one card; {len(rids)} requests, "
              f"{len(done)} done, {n_tok} tokens in {t_run:.2f} s, "
              f"{n_tok / t_run:.1f} tok/s (the undisturbed single engine "
              f"{ref_wall:.2f} s), ttft p50 "
              f"{(s.get('ttft_p50_ms') or 0):.1f} ms, replica states "
              f"{front.replica_states()}, restarts "
              f"{out[label]['restarts']}, engines built "
              f"{out[label]['engines_built']}, kernel library loads "
              f"{_build.load_count()}, hedges fired {out[label]['hedges']} "
              f"won {out[label]['hedges_won']}, mode transitions {modes}, "
              f"failovers {[t['rerouted'] for t in front.metrics.transitions if t['event'] == 'failover']}, "
              f"streams differing from the undisturbed run {differ}, free "
              f"pages back {pages_back}, launches {got} expected "
              f"{want if exact else '(threads: not checked)'} [{card}]")
        if differ:
            return f"serve-fleet {label}: streams {differ} differ"
        if not all(pages_back):
            return f"serve-fleet {label}: free pages not back: {pages_back}"
        if _build.load_count() != 1:
            return (f"serve-fleet {label}: the kernel library loaded "
                    f"{_build.load_count()} times")
        if exact and not launches_ok(got, want):
            return f"serve-fleet {label}: launches {got}, expected {want}"
        return None

    # run 1: the drill
    ops.reset_launches()
    kill = ReplicaKill(replica=0, at_step=FLEET_KILL_STEP)
    front = front_for(3, kill)
    front.set_hedge_budget(0.0, "hedged")
    n0 = len(built)
    t0 = time.perf_counter()
    rids = {}
    for i, r in enumerate(traffic):
        if i == FLEET_INFEASIBLE:
            continue
        rids[i] = front.submit(
            r["tokens"], max_new_tokens=FLEET_NEW, qos=r["qos"],
            tenant=r["tenant"], seed=r["seed"],
            deadline=(clock() + 3600.0 if i == FLEET_EXPIRE else None))
    rejected = None
    while front.total_inflight:
        front.pump()
        if rejected is None and all(rep.step_ewma > 0
                                    for rep in front.replicas):
            try:
                front.submit(traffic[FLEET_INFEASIBLE]["tokens"],
                             max_new_tokens=FLEET_NEW,
                             seed=traffic[FLEET_INFEASIBLE]["seed"],
                             deadline=time.monotonic() + 1e-3)
                rejected = "admitted"
            except Backpressure as e:
                rejected = e.reason
        seen = {i: any(front.replicas[k].first_token_seen(rids[i])
                       for k in front._route.get(rids[i], []))
                for i in (FLEET_CANCEL, FLEET_EXPIRE)}
        if seen[FLEET_CANCEL] and front.poll(rids[FLEET_CANCEL]) is None \
                and rids[FLEET_CANCEL] not in front._shed_rids \
                and "cancel" not in out:
            out["cancel"] = front.cancel(rids[FLEET_CANCEL])
        if seen[FLEET_EXPIRE] and not bump[0]:
            bump[0] = 7200.0            # the engines' clock passes it
    t_run = time.perf_counter() - t0
    err = check_run("kill and restart", front, rids, t_run,
                    len(built) - n0, True)
    if err:
        return out, err
    for name, n in ops.launch_counts().items():
        launches[name] = launches.get(name, 0) + n
    st = {i: (front.poll(rids[i]).status, front.poll(rids[i]).reason)
          for i in (FLEET_CANCEL, FLEET_EXPIRE)}
    print(f"phase serve-fleet: cancelled mid-stream {st[FLEET_CANCEL]}, "
          f"deadline passed mid-stream {st[FLEET_EXPIRE]}, infeasible "
          f"deadline at the door: {rejected!r}, kill fired {kill.fired} "
          f"[{card}]")
    if st[FLEET_CANCEL] != ("cancelled", "cancelled running"):
        return out, f"serve-fleet: the cancel gave {st[FLEET_CANCEL]}"
    if st[FLEET_EXPIRE][0] != "evicted" or \
            "deadline" not in st[FLEET_EXPIRE][1]:
        return out, f"serve-fleet: the expiry gave {st[FLEET_EXPIRE]}"
    if rejected is None or "feasibly" not in rejected:
        return out, f"serve-fleet: the infeasible deadline gave {rejected}"
    r1 = out["kill and restart"]
    if kill.fired != 1 or r1["restarts"] != [1, 0] or \
            r1["engines_built"] != [2, 1] or r1["hedges"] != 1:
        return out, (f"serve-fleet: kill {kill.fired}, restarts "
                     f"{r1['restarts']}, engines {r1['engines_built']}, "
                     f"hedges {r1['hedges']}")
    others = {i: s for i, s in r1["statuses"].items()
              if i not in special}
    if any(s != ("done", "length") for s in others.values()):
        return out, f"serve-fleet: statuses {others}"
    bump[0] = 0.0
    plain = [i for i in range(FLEET_N) if i not in special]

    # runs 2 and 3: failover, then threads
    for label, mode in (("failover", "pump"), ("threaded", "threads")):
        ops.reset_launches()
        front = (front_for(0, ReplicaKill(replica=0, at_step=FLEET_KILL_STEP))
                 if mode == "pump" else front_for(3))
        n0 = len(built)
        if mode == "threads":
            front.start()
        t0 = time.perf_counter()
        try:
            rids = {i: front.submit(traffic[i]["tokens"],
                                    max_new_tokens=FLEET_NEW,
                                    qos=traffic[i]["qos"],
                                    seed=traffic[i]["seed"])
                    for i in plain}
            front.run_until_drained(timeout_s=300.0)
        finally:
            front.stop()
        t_run = time.perf_counter() - t0
        err = check_run(label, front, rids, t_run, len(built) - n0,
                        mode == "pump")
        if err:
            return out, err
        sts = out[label]["statuses"]
        if any(s != ("done", "length") for s in sts.values()):
            return out, f"serve-fleet {label}: statuses {sts}"
        if mode == "pump" and (front.replicas[0].state != "failed" or [
                t["source"] for t in front.metrics.transitions
                if t["event"] == "failover"] != [0]):
            return out, (f"serve-fleet failover: states "
                         f"{front.replica_states()}")
    del built[:]
    torch.cuda.empty_cache()
    return out, None


def run_disagg(torch, ops, card, launches):
    """disagg: `DisaggFrontend` with one prefill and one decode engine
    (paged, `ENGINE_KW`) of the engine phase's GPT-2 124M on one card,
    the engine phase's 16 requests: every handoff digest-verified (no
    failure, no token-0 mismatch), streams against the colocated paged
    engine's (recorded here), a flip only at a near-tie; then 2 requests under a `HandoffCorruption` (the first
    handoff) and a `HandoffWindowKill` (the second): both typed, both
    re-routed, no stream lost. Exact launches over every engine built.
    Adds the first run's launches to ``launches``. Returns (results,
    failure or None)."""
    from apex1_tpu_torch import Engine, EngineConfig
    from apex1_tpu_torch.serving import FrontendConfig, ReplicaConfig
    from apex1_tpu_torch.serving.disagg import DisaggConfig, DisaggFrontend
    from apex1_tpu_torch.testing.chaos import (ChaosSchedule,
                                               HandoffCorruption,
                                               HandoffWindowKill)
    cfg, apply_fn, make_cache = gpt2_serving_model(torch)
    L, temp = cfg.num_layers, ENGINE_KW["temperature"]
    reqs = workload(cfg.vocab_size, SEED)
    seeds = [r["seed"] for r in reqs]
    ref_rec = {}
    ref, _, _ = drive(torch, Engine(apply_fn, make_cache,
                                    EngineConfig(**ENGINE_KW),
                                    device="cuda"), reqs, 64, ref_rec)
    built = []

    def make_engine():
        e = Engine(apply_fn, make_cache, EngineConfig(**ENGINE_KW),
                   device="cuda")
        built.append(e)
        return e

    def front_for(fault=None):
        pool = dict(n_replicas=1, capacity_per_replica=16,
                    hedge_after_s=None, enter_shed=2.0, enter_degraded=3.0,
                    replica=ReplicaConfig(watchdog_s=120.0))
        return DisaggFrontend(make_engine, DisaggConfig(
            prefill=FrontendConfig(**pool), decode=FrontendConfig(**pool),
            prefill_chunk=ENGINE_KW["prefill_chunk"]), fault=fault)

    out = {}
    for label, idx, fault in (
            ("clean", list(range(len(reqs))), None),
            ("corrupt + window kill", [4, 6],
             ChaosSchedule([HandoffCorruption(at_handoff=0),
                            HandoffWindowKill(at_handoff=1)]))):
        ops.reset_launches()
        n0 = len(built)
        front = front_for(fault)
        rec = {}
        with sampling_record(rec):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [front.submit(reqs[i]["tokens"], max_new_tokens=64,
                                 seed=reqs[i]["seed"]) for i in idx]
            front.run_until_drained(timeout_s=300.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res = [front.poll(r) for r in rids]
        got = [[int(t) for t in r.tokens] for r in res]
        flips, bad = sampled_flips(torch, got, [ref[i] for i in idx],
                                   [seeds[i] for i in idx], rec,
                                   ref_rec, temp, cfg.vocab_size)
        c = front.summary()["counters"]
        handoffs = [t for t in front.metrics.transitions
                    if t["event"] == "handoff"]
        fails = [t["failure"] for t in front.metrics.transitions
                 if t["event"] == "handoff_failure"]
        glaunch = {k: v for k, v in ops.launch_counts().items() if v}
        want = gpt2_launches(engine_forwards(built[n0:]), L, paged=True)
        n_tok = sum(len(s) for s in got)
        out[label] = dict(wall_s=wall, tokens=n_tok, handoffs=len(handoffs),
                          failures=fails, counters=c, flips=flips,
                          launches=glaunch, launches_expected=want)
        print(f"phase disagg: {label}: 1 prefill + 1 decode engine of "
              f"GPT-2 124M O2 (paged) on one card; {len(rids)} requests, "
              f"{n_tok} tokens in {wall:.2f} s, {n_tok / wall:.1f} tok/s; "
              f"digest-verified handoffs {len(handoffs)}, handoff failures "
              f"{fails}, re-routes {c.get('handoff_reroutes', 0)}, token-0 "
              f"mismatches {c.get('handoff_parity_mismatches', 0)}, "
              f"replica states {front.replica_states()}; streams differing "
              f"from the colocated engine {len(flips)} "
              f"(request, token, gap, move, difference / top) {flips}; "
              f"launches {glaunch} expected {want} [{card}]")
        front.stop()
        if any(r.status != "done" or len(s) != 64 for r, s in zip(res, got)):
            return out, (f"disagg {label}: statuses "
                         f"{[(r.status, r.reason) for r in res]}")
        if bad:
            return out, f"disagg {label}: streams differ off a near-tie: {bad}"
        if not launches_ok(glaunch, want):
            return out, f"disagg {label}: launches {glaunch}, expected {want}"
        if c.get("handoff_parity_mismatches", 0):
            return out, f"disagg {label}: a token 0 differed across a handoff"
        if fault is None:
            long_ = sum(1 for r in reqs if (len(r["tokens"]) - 1) // 64 >= 1)
            if fails or len(handoffs) != long_:
                return out, (f"disagg: {len(handoffs)} handoffs for {long_} "
                             f"long prompts, failures {fails}")
            for name, n in glaunch.items():
                launches[name] = launches.get(name, 0) + n
        elif fails != ["integrity", "window_kill"] or \
                c.get("handoff_reroutes") != 2:
            return out, f"disagg {label}: failures {fails}, counters {c}"
        del front
    del built[:]
    torch.cuda.empty_cache()
    return out, None


#: speculative's workload: `run_decode`'s (8 x 128 prompt, 128 new), 4
#: drafts a round
SPEC_K = 4


def run_speculative(torch, ops, card, launches):
    """speculative: `speculative_generate` with the bench's ``decode``
    model (`LLAMA_08B`, 16 layers, O2; `decode_model`) as the target and
    its own `llama_quant_decoder` int8 copy as the draft, B 8, S0 128, N
    128, `SPEC_K` drafts a round. Greedy: the tokens against greedy
    `generate` of the target (the same call), a flip only where the
    target's top-2 gap (relative) is below the chunk-verify against
    step-decode logit difference there (relative to the top logit), and
    that difference at most twice the largest the two paths show where
    the streams still agree (every token before each row's first flip:
    at O2 the verify chunk's bf16 products round otherwise than the
    step's, 1-2 % of the top logit at this depth); exact launches (RMS
    norm and
    RoPE each forward of either model, flash at both prefills, int8_mm
    each draft forward). T 0.7: tokens in the vocabulary, two calls the
    same bits. Prints target forwards per row, the accept rate, tokens/s
    beside plain `generate`. Adds the greedy call's launches to
    ``launches``. Returns (results, failure or None)."""
    from apex1_tpu_torch import llama_decoder, llama_quant_decoder
    from apex1_tpu_torch.models import near_tie
    from apex1_tpu_torch.models.generate import speculative_generate
    cfg, model, prompt = decode_model(torch, LCTX_LAYERS)
    t_fn, mk_t = llama_decoder(model)
    d_fn, mk_d, _ = llama_quant_decoder(model)
    L, V, K, N = cfg.num_layers, cfg.vocab_size, SPEC_K, DEC_N
    S = DEC_S0 + N + K + 1
    verify = []
    t_rec = near_tie.recorder(t_fn, verify, chunks=True)

    def spec(fn, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, rounds = speculative_generate(
            fn, d_fn, prompt, max_new_tokens=N, target_cache=mk_t(DEC_B, S),
            draft_cache=mk_d(DEC_B, S), num_draft=K, vocab_size=V, **kw)
        torch.cuda.synchronize()
        return toks.cpu().numpy(), rounds.cpu().numpy(), \
            time.perf_counter() - t0

    spec(t_fn)                                   # warm-up
    rec = []
    want, gwall = decode_call(torch, t_fn, mk_t, prompt, V, rec)
    ops.reset_launches()
    toks, rounds, swall = spec(t_rec)
    got = {k: v for k, v in ops.launch_counts().items() if v}
    for name, n in got.items():
        launches[name] = launches.get(name, 0) + n
    loops = int(rounds.max())
    tf, df = 1 + loops, 1 + loops * (K + 1)
    expect = {"layer_norm_fwd": (tf + df) * (2 * L + 1),
              "rope": (tf + df) * 2 * L, "flash_fwd": 2 * L,
              "int8_mm": df * (INT8_PER_LAYER * L + 1)}

    # the near-tie rule (`models.near_tie.judge`): a first flip only
    # where the target's top-2 gap is below the verify-vs-step logit
    # difference there, itself at most twice the largest difference
    # where the streams still agree
    verdict = near_tie.judge(toks, want,
                             near_tie.verify_logits(verify, DEC_S0, K),
                             near_tie.step_logits(rec), V)
    flips, moved, floor, bad = (verdict[k] for k in
                                ("flips", "moved", "floor", "bad"))
    accept = (N - 1 - rounds) / (K * rounds)
    out = dict(greedy_wall_s=swall, generate_wall_s=gwall,
               rounds=rounds.tolist(), accept_rate=accept.tolist(),
               launches=got, launches_expected=expect, flips=flips,
               moved=moved, agreeing_difference=floor)
    print(f"phase speculative: target the bench's decode model (llama_longctx "
          f"widths, {L} layers, O2, head_dim {cfg.head_dim}), draft its "
          f"int8 copy; B {DEC_B}, S0 {DEC_S0}, N {N}, K {K}, greedy: wall "
          f"{swall:.2f} s, {DEC_B * N / swall:.0f} tokens/s against plain "
          f"generate {gwall:.2f} s, {DEC_B * N / gwall:.0f} tokens/s; "
          f"target forwards per row {rounds.tolist()} (+1 prefill), accept "
          f"rate per row {[round(a, 3) for a in accept.tolist()]}, rounds "
          f"run {loops}; launches {got} expected {expect}; streams "
          f"differing from generate {len(flips)} (row, token, top-2 gap, "
          f"verify vs step logit difference) "
          f"{[(r, t, g, m) for (r, t, g), m in zip(flips, moved)]}; the "
          f"largest verify vs step difference where the streams agree "
          f"{floor:.5f} (a flip's may be twice it) [{card}]")
    if not launches_ok(got, expect):
        return out, f"speculative: launches {got}, expected {expect}"
    if bad:
        return out, f"speculative: greedy differs off a near-tie: {bad}"
    del verify[:], rec[:]
    samp = [spec(t_fn, temperature=0.7, rng=(0, 7)) for _ in range(2)]
    (s1, r1, w1), (s2, _, _) = samp
    out["sampled"] = dict(wall_s=w1, rounds=r1.tolist(),
                          same_bits=bool((s1 == s2).all()))
    print(f"phase speculative: T 0.7: wall {w1:.2f} s, "
          f"{DEC_B * N / w1:.0f} tokens/s, target forwards per row "
          f"{r1.tolist()}, accept rate per row "
          f"{[round(a, 3) for a in ((N - 1 - r1) / (K * r1)).tolist()]}, "
          f"tokens in the vocabulary {bool(s1.min() >= 0 and s1.max() < V)},"
          f" two calls the same bits {out['sampled']['same_bits']} [{card}]")
    del model, t_fn, d_fn
    torch.cuda.empty_cache()
    if not out["sampled"]["same_bits"] or s1.min() < 0 or s1.max() >= V:
        return out, "speculative: T 0.7 tokens out of range or not repeatable"
    return out, None


# ---- the checkpointing and resilience slice ----------------------------------


def scratch_dir(card, phase: str) -> str:
    """A fresh temporary directory for a phase's checkpoints, its free
    disk printed first."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    du = shutil.disk_usage(d)
    print(f"phase {phase}: checkpoint dir {d}, disk total "
          f"{du.total / 2 ** 30:.1f} GiB free {du.free / 2 ** 30:.1f} GiB "
          f"[{card}]")
    return d


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def save_split(timing: dict) -> str:
    return (f"host copy {timing['copy_s']:.2f} s, write "
            f"{timing['write_s']:.2f} s, digests {timing['digest_s']:.2f} s")


def same_params(torch, a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def same_tree(torch, a, b) -> bool:
    """Two trees of tensors with the same key paths and equal leaves,
    bit for bit."""
    from apex1_tpu_torch.core.pytree import keystr, tree_flatten_with_path
    la, lb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    return ([keystr(p) for p, _ in la] == [keystr(p) for p, _ in lb]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb)))


def run_train_resume(torch, ops, card, launches, steps: int = 4):
    """train-resume: the ddp phase's trainer (GPT-2 124M, flash, fused
    head, O2, B x S tokens). Run A takes ``steps`` steps. Run B takes
    step 1, queues an async `ResilientCheckpointer.save(1)`, takes step 2
    with that save in flight, and inside a `PreemptionHandler` a SIGTERM
    to itself (`chaos.sigterm_self_at`) makes it `save_sync(2)` and exit
    resumable (the `SystemExit` caught, its code checked). Run C builds
    the trainer from another seed, restores the newest valid checkpoint
    (step 2, data step 2) and takes steps 3-4, step 4 with an async save
    of step 3 in flight: its losses, final params and launches must
    equal A's steps 3-4 bit for bit. Then step 4 is saved too, the newest checkpoint bit-flipped and the next truncated:
    `find_restorable` must fall back to the oldest and restoring either
    damaged one must raise `IntegrityError`. Adds run A's launches to
    ``launches``."""
    import shutil
    from apex1_tpu_torch.resilience import (EXIT_RESUMABLE, IntegrityError,
                                            PreemptionHandler,
                                            ResilientCheckpointer,
                                            find_restorable)
    from apex1_tpu_torch.testing import chaos
    out = {}
    ops.reset_launches()
    _, state, step, batch = make_trainer(torch, "O2", 12, SEED,
                                         use_flash=True, fuse_head=True)
    rows_a, _, state = run_steps(torch, ops, state, step, batch, steps,
                                 return_state=True)
    for k, v in ops.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    params_a = state.params
    del state, step
    d = scratch_dir(card, "train-resume")
    try:
        # run B: step 1, an async save, step 2 with the save in flight,
        # then the preemption
        _, state, step, batch = make_trainer(torch, "O2", 12, SEED,
                                             use_flash=True, fuse_head=True)
        ck = ResilientCheckpointer(d, keep=3)
        state, _ = step(state, *batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, state, meta={"data_step": 1})
        enqueue_s = time.perf_counter() - t0
        code = None
        try:
            with PreemptionHandler() as pre:
                for i in (2,):
                    t0 = time.perf_counter()
                    state, _ = step(state, *batch)
                    torch.cuda.synchronize()
                    inflight_ms = (time.perf_counter() - t0) * 1e3
                    inflight = not ck.timings
                    chaos.sigterm_self_at(i, 2)
                    if pre.triggered:
                        t0 = time.perf_counter()
                        ck.save_sync(i, state, meta={"data_step": i})
                        sync_s = time.perf_counter() - t0
                        pre.exit_resumable(f"preempted at step {i}")
        except SystemExit as e:
            code = e.code
        ck.close()
        del state, step
        torch.cuda.empty_cache()
        t_b = list(ck.timings)
        n_bytes = dir_bytes(os.path.join(d, "step_00000002"))
        # run C: another seed's trainer, the newest valid checkpoint
        _, state, step, batch = make_trainer(torch, "O2", 12, SEED + 7,
                                             use_flash=True, fuse_head=True)
        ck = ResilientCheckpointer(d, keep=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, man = ck.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ops.reset_launches()
        # step 3, an async save of it, step 4 with that save in flight
        # (the host's pinned buffers now warm from run B's saves)
        rows_c, _, state = run_steps(torch, ops, state, step, batch, 1,
                                     return_state=True)
        ck.save(steps - 1, state, meta={"data_step": steps - 1})
        rows_c4, _, state = run_steps(torch, ops, state, step, batch, 1,
                                      return_state=True)
        warm_inflight = not ck.timings
        rows_c += rows_c4
        launch_c = ops.launch_counts()
        launch_a = {}
        for r in rows_a[2:]:
            for k, v in r["launches"].items():
                launch_a[k] = launch_a.get(k, 0) + v
        launch_c = {k: v for k, v in launch_c.items() if v}
        losses_a = [r["loss"] for r in rows_a[2:]]
        losses_c = [r["loss"] for r in rows_c]
        same = same_params(torch, params_a, state.params)
        # damage: step 4 saved (keep=3 collects step 1), the newest
        # bit-flipped, the next truncated; the scan falls back to the
        # oldest
        ck.save_sync(steps, state, meta={"data_step": steps})
        del state, step
        torch.cuda.empty_cache()
        names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        chaos.bitflip_checkpoint(os.path.join(d, names[-1]))
        chaos.truncate_checkpoint(os.path.join(d, names[-2]))
        t0 = time.perf_counter()
        best = find_restorable(d)
        scan_s = time.perf_counter() - t0
        refused = []
        for n in names[-2:]:
            try:
                ck.restore(None, path=os.path.join(d, n))
                refused.append(False)
            except IntegrityError:
                refused.append(True)
        ck.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    wall_a2 = rows_a[1]["wall_ms"]
    out.update(step4_inflight_ms=rows_c[-1]["wall_ms"],
               step4_a_ms=rows_a[-1]["wall_ms"], warm_in_flight=warm_inflight,
               save3=ck.timings[0])
    out.update(code=code, manifest_step=man.step, meta=man.meta,
               losses_a=losses_a, losses_c=losses_c, same_params=same,
               launches_a=launch_a, launches_c=launch_c, bytes=n_bytes,
               saves=t_b, sync_s=sync_s, enqueue_s=enqueue_s,
               restore_s=restore_s, step2_inflight_ms=inflight_ms,
               step2_a_ms=wall_a2, save_in_flight=inflight,
               scan=os.path.basename(best or ""), scan_s=scan_s,
               dirs=names, refused=refused)
    print(f"phase train-resume: GPT-2 124M O2 flash fused head B={TB} "
          f"S={TS}; run B exit code {code} (EXIT_RESUMABLE "
          f"{EXIT_RESUMABLE}); run C restored step {man.step} data_step "
          f"{man.meta.get('data_step')}; steps 3-4 losses C {losses_c} A "
          f"{losses_a} equal {losses_c == losses_a}; final params "
          f"bit-identical {same}; launches C {launch_c} A {launch_a} "
          f"[{card}]")
    print(f"phase train-resume: {n_bytes} bytes a checkpoint; async save "
          f"queued in {enqueue_s * 1e3:.1f} ms (the packed snapshot copy), save 1 "
          f"{save_split(t_b[0])}; step 2 wall {inflight_ms:.2f} ms with "
          f"that save in flight ({inflight}) vs {wall_a2:.2f} ms in run "
          f"A; run C's step 4 {out['step4_inflight_ms']:.2f} ms with step "
          f"3's save in flight ({warm_inflight}; that save "
          f"{save_split(out['save3'])}) vs "
          f"{out['step4_a_ms']:.2f} ms in run A; preemption save_sync "
          f"{sync_s:.2f} s ({save_split(t_b[1])});"
          f" restore {restore_s:.2f} s (verify, read, copy to the card, "
          f"leaf digests) [{card}]")
    print(f"phase train-resume: dirs {names}; {names[-1]} bit-flipped, "
          f"{names[-2]} truncated: find_restorable -> {out['scan']} in "
          f"{scan_s:.2f} s; restore of each damaged one raised "
          f"IntegrityError {refused} [{card}]")
    if code != EXIT_RESUMABLE:
        return out, f"train-resume: run B exited {code}, not resumable"
    if man.step != 2 or man.meta.get("data_step") != 2:
        return out, (f"train-resume: restored step {man.step} meta "
                     f"{man.meta}, expected step 2 data_step 2")
    if losses_c != losses_a or not same:
        return out, (f"train-resume: the resumed steps differ from the "
                     f"uninterrupted run: {losses_c} vs {losses_a}, "
                     f"params equal {same}")
    if launch_c != launch_a:
        return out, (f"train-resume: resumed launches {launch_c}, "
                     f"uninterrupted {launch_a}")
    if out["scan"] != names[0] or refused != [True, True]:
        return out, (f"train-resume: the scan picked {out['scan']} (want "
                     f"{names[0]}), damaged restores refused {refused}")
    return out, None


def save_inflight(torch, ops, card, reps: int = 3) -> int:
    """``--save-inflight``: what a step pays while an async
    `ResilientCheckpointer.save` of GPT-2 124M's O2 state runs (the
    ddp phase's trainer). For each variant of the save's worker, after
    one save that warms the pinned host buffer, ``reps`` times: queue a
    save, then take steps until it has committed, each step's wall
    ending in a synchronize; beside them plain steps. Variants: as
    shipped (``ASYNC_THREADS`` threads), pools of 2 and 8 threads, and
    the host copy alone (no digests or writes). Then `torch.profiler`
    of a plain step and of the first step with a save in flight (as
    shipped): the host ops' summed times, the device's kernel and copy
    time and the ops whose host time grew most."""
    import shutil

    import numpy as np
    import apex1_tpu_torch.resilience.checkpointer as ckmod
    from apex1_tpu_torch.resilience import ResilientCheckpointer
    _, state, step, batch = make_trainer(torch, "O2", 12, SEED,
                                         use_flash=True, fuse_head=True)
    for _ in range(3):
        state, _m = step(state, *batch)
    torch.cuda.synchronize()
    shipped, write_dir = ResilientCheckpointer.ASYNC_THREADS, \
        ckmod.write_step_dir

    def timed_step():
        nonlocal state
        t0 = time.perf_counter()
        state, _m = step(state, *batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    variants = [(f"shipped (pool {shipped})", shipped, write_dir),
                ("pool2", 2, write_dir), ("pool8", 8, write_dir),
                ("copy-only", shipped,
                 lambda *a, **k: {"digest_s": 0.0, "write_s": 0.0})]
    d = scratch_dir(card, "save-inflight")
    try:
        for name, threads, wd in variants:
            ResilientCheckpointer.ASYNC_THREADS = threads
            ckmod.write_step_dir = wd
            try:
                ck = ResilientCheckpointer(d, keep=2)
                plain = [timed_step() for _ in range(5)]
                first, per, counts, save_s = [], [], [], []
                # save 0 warms the pinned host buffer (the process's
                # first save: cold)
                for r in range(-1, reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ck.save(r + 1, state)
                    walls = []
                    while ck._q.unfinished_tasks:
                        walls.append(timed_step())
                    ck.wait()
                    save_s.append(time.perf_counter() - t0)
                    first.append(walls[0] if walls else 0.0)
                    per.append(float(np.mean(walls)) if walls else 0.0)
                    counts.append(len(walls))
                ck.close()
            finally:
                ResilientCheckpointer.ASYNC_THREADS = shipped
                ckmod.write_step_dir = write_dir
            p = float(np.median(plain))
            print(f"save-inflight {name}: plain step {p:.2f} ms (median "
                  f"of 5); with a save in flight (the first one's pinned "
                  f"buffer cold in the first variant): first step "
                  f"{[round(v, 2) for v in first]} ms, mean "
                  f"{[round(v, 2) for v in per]} ms over {counts} steps "
                  f"(extra host time a save "
                  f"{[round((v - p) * n / 1e3, 3) for v, n in zip(per, counts)]}"
                  f" s); save to commit {[round(v, 3) for v in save_s]} s; "
                  f"splits {[save_split(t) for t in ck.timings]} "
                  f"[{card}]")
        # the trace: a plain step and the first step with a save in
        # flight, the shipped pool
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        ck = ResilientCheckpointer(d, keep=2)
        ck.save_sync(10, state)
        traces = {}
        for name in ("plain", "in-flight"):
            torch.cuda.synchronize()
            if name == "in-flight":
                ck.save(11, state)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = timed_step()
            ck.wait()
            ev = prof.key_averages()
            host = {e.key: e.self_cpu_time_total for e in ev}
            dev = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                      for e in ev if e.device_type == DeviceType.CUDA)
            traces[name] = dict(wall_ms=wall, host=host, dev_ms=dev / 1e3,
                                host_ms=sum(host.values()) / 1e3,
                                calls=sum(e.count for e in ev))
        ck.close()
        grew = sorted(((traces["in-flight"]["host"].get(k, 0) - v, k)
                       for k, v in traces["plain"]["host"].items()),
                      reverse=True)[:8]
        for name, t in traces.items():
            print(f"save-inflight trace {name}: wall {t['wall_ms']:.2f} ms "
                  f"(profiled), host ops' self time {t['host_ms']:.2f} ms "
                  f"over {t['calls']} calls, device kernels and copies "
                  f"{t['dev_ms']:.2f} ms [{card}]")
        print(f"save-inflight trace: the host ops whose self time grew "
              f"most (us): {[(k, round(g, 1)) for g, k in grew]} [{card}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


def sync_count(torch, fn) -> int:
    """The synchronizing CUDA calls ``fn()`` makes: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in got)


def run_train_sentinel(torch, ops, card, launches):
    """train-sentinel: the same trainer wrapped by ``Sentinel(ckpt,
    check_every=1, rollback_after=2).guard(...)``, `chaos.poison_at_steps`
    added to its loss (NaN at steps 3 and 4 of the first attempt, a
    device-side pick from the state's step): the loss is NaN and the
    gradients finite, so the Amp step would apply them and only the
    sentinel refuses the step. Steps 1-2 clean, a sync save at step 2;
    step 3 is skipped (the kept params, Adam moments and loss-scale
    state are step 2's bit for bit, where the bare step alone moves the
    params and moments; the counters as tests/test_resilience.py:388
    expects);
    after step 4 ``poll`` says "rollback", and `Sentinel.rollback`
    restores step 2 with a banked record. Two more steps on batches
    drawn from `refold_seed(SEED, 1)` stay finite and equal a control run
    restored from the same checkpoint bit for bit. Under
    ``torch.cuda.set_sync_debug_mode("warn")`` the guarded step makes no
    more synchronizing calls than the bare step (both printed)."""
    import json as _json
    import shutil

    import numpy as np
    from apex1_tpu_torch.resilience import (ResilientCheckpointer,
                                            Sentinel, refold_seed,
                                            sentinel_init)
    from apex1_tpu_torch.testing import chaos
    cfg, state, bare, batch = make_trainer(torch, "O2", 12, SEED,
                                           use_flash=True, fuse_head=True,
                                           offset=True)
    d = scratch_dir(card, "train-sentinel")
    out = {}
    try:
        ck = ResilientCheckpointer(d, keep=3)
        sent = Sentinel(ck, check_every=1, rollback_after=2)
        guarded = sent.guard(bare)
        zero = torch.zeros((), device="cuda")
        carry = (state, sentinel_init())
        del state

        def factor(st):
            # the 1-based number of the step about to run is step + 1
            if sent.rollbacks_done:
                return zero
            return chaos.poison_at_steps(zero, st.step + 1, (3, 4))

        # the sync count: bare and guarded clean steps from the same
        # state (results dropped), twice each; the second is held
        n_bare = [sync_count(torch, lambda: bare(carry[0], zero, *batch))
                  for _ in range(2)]
        n_guard = [sync_count(torch, lambda: guarded(carry, zero, *batch))
                   for _ in range(2)]
        rows, kept_ok, action = [], None, None
        for i in (1, 2, 3, 4):
            prev = carry[0] if i == 3 else None
            f = factor(carry[0])
            carry, m = guarded(carry, f, *batch)
            s = carry[1]
            action = sent.poll(s)
            rows.append(dict(step=i, healthy=bool(m["sentinel_healthy"]),
                             loss=scalar(m["loss"]),
                             counters=[int(s.steps_seen),
                                       int(s.consecutive_bad),
                                       int(s.total_bad),
                                       int(s.last_bad_step)],
                             action=action))
            if i == 2:
                ck.save_sync(2, carry[0], meta={"data_step": 2})
            if i == 3:
                # params, Adam moments and loss-scale state all step 2's;
                # the bare step alone applies the finite gradients, so
                # the keep is the sentinel's, not the Amp skip's
                kept_ok = {k: same_tree(torch, getattr(prev, k),
                                        getattr(carry[0], k))
                           for k in ("params", "opt_state", "loss_scale")}
                moved = bare(prev, f, *batch)[0]
                kept_ok["bare_step_moved"] = not (
                    same_tree(torch, prev.params, moved.params)
                    or same_tree(torch, prev.opt_state, moved.opt_state))
                del moved
        good, man, s0 = (sent.rollback(template=carry[0])
                         if action == "rollback" else (None, None, None))
        recs = sorted(os.listdir(os.path.join(d, "diagnostics")))
        with open(os.path.join(d, "diagnostics", recs[-1])) as f:
            banked = _json.load(f)
        # the retry: two steps on batches from the refolded seed
        seed2 = refold_seed(SEED, sent.rollbacks_done)
        rng = np.random.default_rng(seed2)
        retry = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (TB, TS)))
                 .cuda() for _ in range(2)]
        carry = (good, s0)
        retry_losses = []
        for tok in retry:
            carry, m = guarded(carry, factor(carry[0]), tok)
            retry_losses.append(scalar(m["loss"]))
        params_r = carry[0].params
        del carry, good
        torch.cuda.empty_cache()
        # the control: another seed's trainer restored from step 2
        _, ctrl, step_c, _ = make_trainer(torch, "O2", 12, SEED + 7,
                                          use_flash=True, fuse_head=True,
                                          offset=True)
        ctrl, man_c = ck.restore(ctrl, path=os.path.join(d,
                                                         "step_00000002"))
        ctrl_losses = []
        for tok in retry:
            ctrl, m = step_c(ctrl, zero, tok)
            ctrl_losses.append(scalar(m["loss"]))
        same = same_params(torch, params_r, ctrl.params)
        ck.close()
        del ctrl, params_r
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out.update(rows=rows, kept=kept_ok, restored_step=getattr(man, "step",
                                                              None),
               records=[r["action"] for r in sent.records], banked=banked,
               retry=retry_losses, control=ctrl_losses, same=same,
               syncs={"bare": n_bare, "guarded": n_guard})
    for r in rows:
        print(f"phase train-sentinel: step {r['step']} loss {r['loss']} "
              f"healthy {r['healthy']} counters (steps_seen, "
              f"consecutive_bad, total_bad, last_bad_step) "
              f"{r['counters']} poll {r['action']} [{card}]")
    print(f"phase train-sentinel: step 3's kept params, opt_state and "
          f"loss_scale are step 2's bit for bit, and the bare step alone "
          f"moves them: {kept_ok}; rollback restored step {out['restored_step']}"
          f" (records {out['records']}, banked {banked['action']} with "
          f"consecutive_bad {banked['consecutive_bad']}); two steps on "
          f"refold_seed({SEED}, 1) = {seed2} batches: losses "
          f"{retry_losses}, control from the same checkpoint "
          f"{ctrl_losses}, params equal {same}; synchronizing calls a "
          f"step (set_sync_debug_mode warn; a first and a second call): "
          f"bare {n_bare}, guarded {n_guard} [{card}]")
    want = [[1, 0, 0, -1], [2, 0, 0, -1], [3, 1, 1, 2], [4, 2, 2, 3]]
    if [r["counters"] for r in rows] != want or \
            [r["action"] for r in rows] != [None, None, "skip", "rollback"]:
        return out, (f"train-sentinel: counters "
                     f"{[r['counters'] for r in rows]} actions "
                     f"{[r['action'] for r in rows]}, expected {want}")
    if not all(kept_ok.values()) or out["restored_step"] != 2 or \
            out["records"] != ["skip", "rollback"]:
        return out, "train-sentinel: the skip or the rollback is wrong"
    if not (all(math.isfinite(v) for v in retry_losses)
            and retry_losses == ctrl_losses and same):
        return out, (f"train-sentinel: the retry {retry_losses} is not the "
                     f"control's {ctrl_losses} (params equal {same})")
    if n_guard[-1] > n_bare[-1]:
        return out, (f"train-sentinel: the guarded step synchronizes "
                     f"{n_guard} times, the bare step {n_bare}")
    return out, None


def l3d_plan(cfg, num_chunks: int) -> dict:
    """The ``apex1-plan-v1`` document of the one-card llama_3d layout at
    ``num_chunks``: `planner.plan_for_layout` of its stated layout, the
    document the llama_3d example banks."""
    from apex1_tpu_torch.planner import Layout, ModelShape, plan_for_layout
    shape = ModelShape.from_llama(
        cfg.model, global_batch=cfg.num_microbatches * cfg.microbatch_size,
        name="llama_3d")
    return plan_for_layout(shape, Layout(
        num_microbatches=cfg.num_microbatches,
        microbatch_size=cfg.microbatch_size, num_chunks=num_chunks))


def run_llama_3d_resume(torch, ops, card, launches):
    """llama-3d-resume: the bench's llama_3d at its one-card layout (8
    layers, O2, remat). Step 1, then `gather_state` (the global tree)
    committed by ``ResilientCheckpointer(plan=(1, 1, 8)).save_sync``.
    Two plain step-2s from that state must agree bit for bit (printed).
    The checkpoint restored (a meta template: `abstract_state` gathered)
    into `local_state` and one step must equal them bit for bit. Then
    `reshard_checkpoint` onto ``num_chunks=2`` (stack (2, 1, 4)), restored
    into a ``Llama3DConfig(num_chunks=2)`` trainer: its step-2 loss within
    2e-5 relative of the original stack's, every chunk leaf of the three
    trees restacked, conserved. Adds the two resumed steps' launches to
    ``launches``."""
    import dataclasses
    import shutil
    from apex1_tpu_torch.models import llama_3d as L3
    from apex1_tpu_torch.resilience import (ResilientCheckpointer,
                                            reshard_checkpoint)
    out = {}
    cfg, step, state, batch = make_llama_3d(torch, "O2", L3D_LAYERS)
    state, loss1 = step(state, *batch)
    d = scratch_dir(card, "llama-3d-resume")
    try:
        plan_a, plan_b = l3d_plan(cfg, 1), l3d_plan(cfg, 2)
        src_dir = os.path.join(d, "a")
        ck = ResilientCheckpointer(src_dir, plan=plan_a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src = ck.save_sync(1, L3.gather_state(cfg, state),
                           meta={"data_step": 1})
        save_s = time.perf_counter() - t0
        timing = ck.timings[-1]
        n_bytes = dir_bytes(src)
        # two plain step-2s from the same state
        s2a, l2a = step(state, *batch)
        p2a = s2a["params"]
        del s2a
        s2b, l2b = step(state, *batch)
        plain_same = (torch.equal(l2a, l2b)
                      and same_params(torch, p2a, s2b["params"]))
        del s2b, state
        torch.cuda.empty_cache()
        # the same stack, restored
        template = L3.gather_state(cfg, L3.abstract_state(cfg)[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, man = ck.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        state = L3.local_state(cfg, g)
        del g
        ops.reset_launches()
        state, l2r = step(state, *batch)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        same_resume = (torch.equal(l2r, l2a)
                       and same_params(torch, p2a, state["params"]))
        rel_same = abs(l2r.item() - l2a.item()) / abs(l2a.item())
        del state, p2a
        ck.close()
        torch.cuda.empty_cache()
        # another stack: num_chunks 2
        cfg_b = dataclasses.replace(cfg, num_chunks=2)
        t0 = time.perf_counter()
        dst, man_b, report = reshard_checkpoint(
            src, template, plan_b, os.path.join(d, "b", "step_00000001"))
        reshard_s = time.perf_counter() - t0
        ck_b = ResilientCheckpointer(os.path.join(d, "b"), plan=plan_b)
        t0 = time.perf_counter()
        g_b, _ = ck_b.restore(L3.gather_state(
            cfg_b, L3.abstract_state(cfg_b)[0]), path=dst)
        torch.cuda.synchronize()
        restore_b_s = time.perf_counter() - t0
        step_b, _ = L3.build_step(cfg_b)
        state_b = L3.local_state(cfg_b, g_b)
        del g_b
        state_b, l2x = step_b(state_b, *batch)
        torch.cuda.synchronize()
        now = ops.launch_counts()
        for k, v in now.items():
            launches[k] = launches.get(k, 0) + v
        ck_b.close()
        del state_b, step_b
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_chunk = len(L3._layer_leaf_shapes(cfg))
    rel_x = abs(l2x.item() - l2a.item()) / abs(l2a.item())
    out.update(loss1=loss1.item(), loss2=[l2a.item(), l2b.item()],
               plain_same=plain_same, resumed=l2r.item(),
               same_resume=same_resume, rel_same=rel_same,
               restacked=l2x.item(), rel_restacked=rel_x, report=report,
               bytes=n_bytes, save_s=save_s, save=timing,
               restore_s=restore_s, reshard_s=reshard_s,
               restore_b_s=restore_b_s, launches=got,
               manifest_step=man.step, meta_b=man_b.meta.get("data_step"))
    print(f"phase llama-3d-resume: llama_3d one card, {L3D_LAYERS} layers, "
          f"O2 remat; step 1 loss {loss1.item():.6f}; two plain step-2s "
          f"agree bit for bit {plain_same} ({l2a.item()!r}, "
          f"{l2b.item()!r}); the same stack restored (step {man.step}) and "
          f"stepped: loss {l2r.item()!r}, loss and params bit for bit "
          f"{same_resume}; num_chunks 2 restored: loss {l2x.item()!r}, "
          f"relative {rel_x:.2e} (limit 2e-5) [{card}]")
    print(f"phase llama-3d-resume: reshard stack {report['stack_from']} -> "
          f"{report['stack_to']}: {report['n_restacked']} chunk leaves "
          f"restacked ({n_chunk} a tree, params and both moments), "
          f"{report['n_copied']} copied, conserved {report['conserved']} "
          f"({report['n_checks']} checks) [{card}]")
    print(f"phase llama-3d-resume: {n_bytes} bytes a checkpoint; save_sync "
          f"{save_s:.2f} s ({save_split(timing)}); restore {restore_s:.2f} "
          f"s; reshard_checkpoint {reshard_s:.2f} s (verify, read, remap, "
          f"write, digests); restore onto num_chunks 2 {restore_b_s:.2f} s "
          f"[{card}]")
    want = llama_3d_launches(L3D_LAYERS, "scan")
    if got != {k: want.get(k, 0) for k in got}:
        return out, (f"llama-3d-resume: the resumed step launched {got}, "
                     f"expected {want}")
    if not (report["conserved"] and report["n_restacked"] == 3 * n_chunk):
        return out, f"llama-3d-resume: reshard report {report}"
    if plain_same and not same_resume:
        return out, ("llama-3d-resume: the restored step differs from "
                     "continuing while two plain steps agree")
    if not plain_same and rel_same > 2e-5:
        return out, (f"llama-3d-resume: the restored step's loss is "
                     f"{rel_same:.2e} relative from continuing")
    if not math.isfinite(l2x.item()) or rel_x > 2e-5:
        return out, (f"llama-3d-resume: num_chunks 2 after the reshard "
                     f"gives {l2x.item()} vs {l2a.item()} ({rel_x:.2e})")
    return out, None


# ---- the host runtime and the examples --------------------------------------

#: the examples phase: GPT-2 124M's and ResNet-50's arguments (the train
#: phases' batch, `bench.py`'s ``resnet``), the steps of each run and the
#: step the resilient run is preempted after
EX_GPT2 = ["--opt-level", "O2", "--batch", str(TB), "--seq", str(TS),
           "--steps", "12"]
EX_RESNET = ["--opt-level", "O2", "--batch", "64", "--image", "224",
             "--steps", "12"]
EX_STEPS, EX_KILL = 12, 6
#: PrefetchLoader witness: batches, their shape (uint8 images
#: normalized on the worker) and the consumer stream's sleep before each
#: second comparison (cycles of the SM clock, about a millisecond)
PF_BATCHES, PF_SHAPE, PF_SLEEP = 50, (16, 224, 224, 3), 2_000_000


@contextlib.contextmanager
def numpy_runtime():
    """The runtime's NumPy fallback: its library handle replaced by None
    while the block runs."""
    from apex1_tpu_torch import runtime
    lib = runtime._lib
    runtime._lib = lambda: None
    try:
        yield
    finally:
        runtime._lib = lib


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of ``fn()`` over ``reps`` calls after one."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2]


def median_wall(rows) -> float:
    walls = sorted(rows[1:])
    return walls[len(walls) // 2]


def runtime_checks(torch, card, tmp: str):
    """The host runtime on the card's machine: native present, native
    against NumPy, the prefetcher's witness, host timings. Returns (out,
    error or None)."""
    import numpy as np
    from apex1_tpu_torch import runtime as rt
    out = {}
    if not rt.native_available():
        return out, ("examples: the native runtime did not build:\n"
                     + rt.build_log())
    path = os.path.join(tmp, "tokens.bin")
    n_seq = 4096
    rt.write_token_file(path, np.random.default_rng(SEED).integers(
        0, TV, n_seq * (TS + 1)).astype(np.uint16))
    kw = dict(seq_len=TS + 1, batch_size=TB, seed=SEED)
    ds = rt.TokenDataset(path, **kw)
    with numpy_runtime():
        ds_np = rt.TokenDataset(path, **kw)
    edge = ds.steps_per_epoch()
    steps = (0, 1, edge - 1, edge, edge + 1, 2 * edge + 3)
    same_tok = ds.native and not ds_np.native and all(
        np.array_equal(ds.batch_at(i), ds_np.batch_at(i)) for i in steps)
    out["batch_at_ms"] = host_ms(lambda: ds.batch_at(edge))
    out["batch_at_numpy_ms"] = host_ms(lambda: ds_np.batch_at(edge))
    imgs = np.random.default_rng(SEED).integers(0, 256, (64, 224, 224, 3),
                                                dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = rt.normalize_images(imgs, mean, std)
    with numpy_runtime():
        want = rt.normalize_images(imgs, mean, std)
        out["normalize_numpy_ms"] = host_ms(
            lambda: rt.normalize_images(imgs, mean, std), 3)
    out["normalize_ms"] = host_ms(lambda: rt.normalize_images(imgs, mean,
                                                              std), 3)
    norm_err = float(np.max(np.abs(got - want) / (np.abs(want) + 1.0)))
    arrays = [np.random.default_rng(i).standard_normal(
        2 ** 22, dtype=np.float32) for i in range(16)]   # 256 MiB
    nbytes = sum(a.nbytes for a in arrays)
    out["flatten_gbs"] = nbytes / host_ms(lambda: rt.flatten(arrays),
                                          3) / 1e6
    with numpy_runtime():
        out["flatten_numpy_gbs"] = nbytes / host_ms(
            lambda: rt.flatten(arrays), 3) / 1e6
    ds.close()
    ds_np.close()
    del arrays, imgs, got, want

    # the prefetcher's witness: each batch against a copy made inline
    # before the loop, compared as soon as it is yielded (a batch read
    # before its copy landed shows as a diff), then again after a sleep
    # on the consumer's stream, the batch freed and a fresh tensor
    # written there (a block recycled too early by the allocator, or a
    # pinned buffer reused while its copy ran, shows as a diff)
    rng = np.random.default_rng(SEED + 1)
    host = [rng.integers(0, 256, PF_SHAPE, dtype=np.uint8)
            for _ in range(PF_BATCHES)]
    wants = [torch.from_numpy(rt.normalize_images(h, mean, std)).cuda()
             for h in host]
    torch.cuda.synchronize()
    diffs = []
    loader = rt.PrefetchLoader(
        iter(host), prefetch=2,
        transform=lambda b: rt.normalize_images(b, mean, std))
    for i, batch in enumerate(loader):
        diffs.append((batch != wants[i]).sum())
        torch.cuda._sleep(PF_SLEEP)
        diffs.append((batch != wants[i]).sum())
        del batch
        torch.empty(PF_SHAPE, dtype=torch.float32,
                    device="cuda").fill_(float(i))
    torch.cuda.synchronize()
    n_diff = int(sum(d.item() for d in diffs))
    n_read = len(diffs) // 2
    del wants, host
    out.update(tokens_equal=same_tok, normalize_rel_err=norm_err,
               prefetch_batches=n_read, prefetch_diff=n_diff)
    print(f"phase examples: runtime native {rt.native_available()} "
          f"(g++ {' '.join(rt.GXX_FLAGS)}); TokenDataset.batch_at native "
          f"== NumPy at steps {steps} (epoch {edge} steps): {same_tok}; "
          f"normalize_images native vs NumPy max rel err {norm_err:.3g} "
          f"(1e-6 allowed); PrefetchLoader {n_read} batches of "
          f"{PF_SHAPE} uint8 normalized on the worker, prefetch 2, "
          f"against torch.from_numpy(b).cuda(): {n_diff} elements differ "
          f"[{card}]")
    print(f"phase examples: host ms (median): batch_at {TB} x {TS + 1} "
          f"native {out['batch_at_ms']:.3f} / NumPy "
          f"{out['batch_at_numpy_ms']:.3f}; normalize_images 64 x 224 x "
          f"224 x 3 native {out['normalize_ms']:.2f} / NumPy "
          f"{out['normalize_numpy_ms']:.2f}; flatten 16 x 16 MiB native "
          f"{out['flatten_gbs']:.2f} / NumPy {out['flatten_numpy_gbs']:.2f}"
          f" GB/s; host {os.cpu_count()} cores [{card}]")
    if not same_tok:
        return out, "examples: TokenDataset native and NumPy batches differ"
    if norm_err > 1e-6:
        return out, f"examples: normalize_images native vs NumPy {norm_err}"
    if n_diff or n_read != PF_BATCHES:
        return out, (f"examples: PrefetchLoader batches differ from the "
                     f"inline copies ({n_diff} elements, {n_read} "
                     f"batches)")
    return out, None


def gpt2_flops(cfg, B: int, S: int) -> int:
    """The model FLOPs of a GPT-2 training step on B x S tokens: 6 x
    (matmul weights, head included) x tokens + 12 x L x S x H x
    tokens."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.padded_vocab
    weights = L * (4 * H * H + 2 * cfg.mlp_ratio * H * H) + V * H
    return 6 * weights * B * S + 12 * L * S * H * B * S


def run_examples(torch, ops, card, launches):
    """examples: the host runtime, then gpt2_amp (prefetched and inline,
    FLOPs, the preempted and resumed run with its spine file),
    imagenet_amp (prefetched and inline, profiled) and
    distributed_data_parallel in a one-rank NCCL group. Adds the
    prefetched gpt2_amp and imagenet_amp runs' launches to
    ``launches``."""
    import shutil
    import tempfile
    from apex1_tpu_torch.examples import (distributed_data_parallel,
                                          gpt2_amp, imagenet_amp)
    from apex1_tpu_torch.obs import read_events
    from apex1_tpu_torch.utils.observability import flops_per_step
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        out, err = runtime_checks(torch, card, tmp)
        if err:
            return out, err
        torch.cuda.empty_cache()

        # gpt2_amp through the prefetcher, then inline
        ops.reset_launches()
        pre = gpt2_amp.main(EX_GPT2)
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        got = {k: v for k, v in counts.items() if v}
        want = {k: EX_STEPS * v for k, v in
                train_launches(12, True, True).items()}
        cfg, tokens = pre["cfg"], pre["tokens_per_step"]
        batch = torch.zeros((TB, TS), dtype=torch.int32, device="cuda")
        flops = flops_per_step(pre["step"], pre["state"], batch)
        model_f = gpt2_flops(cfg, TB, TS)
        del pre["state"], pre["step"]
        torch.cuda.empty_cache()
        inline = gpt2_amp.main(EX_GPT2 + ["--prefetch", "0"])
        del inline["state"], inline["step"]
        torch.cuda.empty_cache()
        walls = {k: median_wall(r["step_ms"]) for k, r in
                 (("prefetch", pre), ("inline", inline))}
        out["gpt2"] = dict(losses=pre["losses"], launches=got,
                           step_ms={"prefetch": pre["step_ms"],
                                    "inline": inline["step_ms"]},
                           flops=flops, flops_model=model_f)
        print(f"phase examples: gpt2_amp GPT-2 124M {' '.join(EX_GPT2)}: "
              f"losses {pre['losses']}; launches {got} expected {want}; "
              f"step wall (median of steps 2-{EX_STEPS}) through "
              f"PrefetchLoader {walls['prefetch']:.2f} ms "
              f"({tokens / walls['prefetch'] * 1e3:.0f} tokens/s), copied "
              f"inline {walls['inline']:.2f} ms "
              f"({tokens / walls['inline'] * 1e3:.0f} tokens/s) [{card}]")
        print(f"phase examples: gpt2_amp flops_per_step {flops!r} (plain "
              f"path on meta tensors, no recomputation); the model count "
              f"6 x weights + 12 x L x S x H a token {model_f!r} (ratio "
              f"{flops / model_f!r}, 5 % allowed) [{card}]")
        if not all(math.isfinite(v) for v in pre["losses"] +
                   inline["losses"]):
            return out, "examples: a gpt2_amp loss is not finite"
        if got != want:
            return out, (f"examples: gpt2_amp launches {got}, expected "
                         f"{want}")
        if abs(flops - model_f) > 0.05 * model_f:
            return out, (f"examples: flops_per_step {flops} vs the model "
                         f"count {model_f}")

        # the resilient loop: preempted after step EX_KILL, resumed
        ck, obs = os.path.join(tmp, "ck"), os.path.join(tmp, "obs")
        drill = EX_GPT2 + ["--ckpt-dir", ck, "--ckpt-every", str(EX_STEPS),
                           "--obs-dir", obs]
        os.environ["APEX1_CHAOS_SIGTERM_STEP"] = str(EX_KILL)
        t0 = time.perf_counter()
        try:
            gpt2_amp.main(drill)
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            del os.environ["APEX1_CHAOS_SIGTERM_STEP"]
        kill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = gpt2_amp.main(drill)
        resume_s = time.perf_counter() - t0
        del resumed["state"], resumed["step"]
        torch.cuda.empty_cache()
        events = [r for f in sorted(os.listdir(obs))
                  for r in read_events(os.path.join(obs, f))]
        kinds = {}
        for r in events:
            key = r.get("name") or r["kind"]
            kinds[key] = kinds.get(key, 0) + 1
        same = resumed["losses"] == pre["losses"][EX_KILL:]
        out["resume"] = dict(code=code, losses=resumed["losses"],
                             same=same, events=kinds, kill_s=kill_s,
                             resume_s=resume_s)
        print(f"phase examples: gpt2_amp --ckpt-dir, SIGTERM after step "
              f"{EX_KILL}: exit {code} in {kill_s:.1f} s; --resume auto "
              f"steps {EX_KILL}-{EX_STEPS - 1} in {resume_s:.1f} s, losses "
              f"{resumed['losses']} equal the uninterrupted run's {same}; "
              f"spine events {kinds} [{card}]")
        if code != 75:
            return out, f"examples: the preempted gpt2_amp exited {code}"
        if not same:
            return out, "examples: the resumed gpt2_amp losses differ"
        if not (kinds.get("run") and kinds.get("metrics")
                and kinds.get("checkpoint.save") == 2
                and kinds.get("checkpoint.restore") == 1):
            return out, f"examples: the spine file holds {kinds}"

        # imagenet_amp through the prefetcher (then 3 profiled steps),
        # then inline
        ops.reset_launches()
        im = imagenet_amp.main(EX_RESNET)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        prof = profiled_steps(torch, im["state"], im["step"], im["batch"])
        del im["state"], im["step"], im["batch"]
        torch.cuda.empty_cache()
        im_inline = imagenet_amp.main(EX_RESNET + ["--prefetch", "0"])
        del im_inline["state"], im_inline["step"], im_inline["batch"]
        torch.cuda.empty_cache()
        iw = {k: median_wall(r["step_ms"]) for k, r in
              (("prefetch", im), ("inline", im_inline))}
        n_img = im["images_per_step"]
        out["imagenet"] = dict(losses=im["losses"], launches=counts,
                               step_ms={"prefetch": im["step_ms"],
                                        "inline": im_inline["step_ms"]},
                               profile=prof)
        print(f"phase examples: imagenet_amp ResNet-50 "
              f"{' '.join(EX_RESNET)}: losses {im['losses']}; launches "
              f"{counts}; step wall (median of steps 2-{EX_STEPS}) through "
              f"PrefetchLoader {iw['prefetch']:.2f} ms "
              f"({n_img / iw['prefetch'] * 1e3:.1f} images/s), normalized "
              f"and copied inline {iw['inline']:.2f} ms "
              f"({n_img / iw['inline'] * 1e3:.1f} images/s); 3 profiled "
              f"steps: device {prof['device_ms_per_step']:.3f} ms a step in "
              f"{prof['step_wall_ms']:.2f} ms (busy "
              f"{prof['device_busy']:.3f}) [{card}]")
        if not all(math.isfinite(v) for v in im["losses"] +
                   im_inline["losses"]):
            return out, "examples: an imagenet_amp loss is not finite"
        if counts != {"xent_fwd": EX_STEPS, "xent_bwd": EX_STEPS}:
            return out, (f"examples: imagenet_amp launches {counts}, "
                         f"expected xent_fwd and xent_bwd {EX_STEPS}")

        # distributed_data_parallel in a one-rank NCCL group
        nccl_dir = start_nccl(torch)
        try:
            ddp = distributed_data_parallel.main([])
        finally:
            stop_nccl(nccl_dir)
        out["ddp"] = ddp["losses"]
        print(f"phase examples: distributed_data_parallel, one-rank NCCL "
              f"group, 10 steps: losses {ddp['losses']} [{card}]")
        if not (all(math.isfinite(v) for v in ddp["losses"])
                and ddp["losses"][-1] < ddp["losses"][0]):
            return out, f"examples: the DDP losses {ddp['losses']}"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the JAX package's other seven examples -----------------------------------

#: examples-parallel: gpt2_pp_tied at GPT-2 124M widths through its own
#: flags (fp32, logits 4 x 2 x 1024 x 50304), llama_3d's one-card layout
#: and the step its SIGTERM drill is preempted after
EX_PP_TIED = ["--pp", "1", "--layers", "12", "--hidden", "768", "--heads",
              "12", "--vocab", "50304", "--seq", "1024", "--mb", "2",
              "--microbatches", "4", "--steps", "20"]
EX_L3D = ["--dp", "1", "--pp", "1", "--tp", "1"]
EX_L3D_KILL = 10
#: examples-encdec's gates, from the JAX scripts' runs on the CPU
#: (JAX_PLATFORMS=cpu, their defaults): T5's greedy sort accuracy 0.625,
#: the RNN-T's exact greedy decodes 4 of 4. The port fails under half
#: the accuracy, or more than one exact decode fewer.
JAX_T5_ACCURACY, JAX_RNNT_EXACT = 0.625, 4


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def add_launches(launches: dict, counts: dict) -> None:
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def llama_step_launches(L: int, M: int = 1, head: int = 1) -> dict:
    """Kernel launches of a Llama training step without remat, ``M``
    microbatches of ``L`` layers: each layer's forward once (two RMS
    norms, q and k rotated, the flash forward) and its backward once
    (two norms, q and k rotated by -θ, flash dq and dk/dv); the final
    norm and the fused head ``head`` times (llama_3d's 1F1B runs it a
    microbatch)."""
    n = M * L
    return {"layer_norm_fwd": 2 * n + head, "layer_norm_bwd": 2 * n + head,
            "rope": 4 * n, "flash_fwd": n, "flash_dq": n, "flash_dkv": n,
            "lxent_fwd": head, "lxent_dx": head, "lxent_dw": head}


def pp_tied_launches(L: int, M: int) -> dict:
    """Kernel launches of a gpt2_pp_tied step at pp 1: each block of
    each microbatch two layer norms and the causal softmax, forward and
    backward; one cross-entropy over the stacked head."""
    return {"layer_norm_fwd": 2 * L * M, "layer_norm_bwd": 2 * L * M,
            "softmax_fwd": L * M, "softmax_bwd": L * M, "xent_fwd": 1,
            "xent_bwd": 1}


def scaled(counts: dict, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def run_examples_parallel(torch, ops, card, launches):
    """examples-parallel (a one-rank NCCL group): llama_distributed (10
    O2 steps, its params placed by their TP specs on the one-rank mesh),
    gpt2_pp_tied at GPT-2 124M widths (`EX_PP_TIED`: step walls, tokens/s,
    peak memory), llama_3d on its one-card layout with ``--schedule scan
    --chunks 2`` and ``--schedule 1f1b``; its SIGTERM drill (exit 75
    after step `EX_L3D_KILL`, then ``--resume auto`` bit for bit); ``--tp
    3`` exits 2 naming tp-heads. Every run's launches exact. Adds them
    to ``launches``. Returns (results, failure or None)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from apex1_tpu_torch.examples import (gpt2_pp_tied, llama_3d,
                                          llama_distributed)
    out = {}

    def counted_run(fn):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = nonzero(ops.launch_counts())
        add_launches(launches, got)
        return res, got, wall, torch.cuda.max_memory_allocated() / 2 ** 30

    ld, got, wall, _ = counted_run(lambda: llama_distributed.main(
        ["--tp", "1"]))
    want = scaled(llama_step_launches(ld["cfg"].num_layers), 10)
    out["llama_distributed"] = dict(losses=ld["losses"], launches=got,
                                    wall_s=wall, step_ms=ld["step_ms"])
    del ld["state"], ld["params"]
    print(f"phase examples-parallel: llama_distributed (tiny Llama, O2, "
          f"params placed by TP specs on the one-rank mesh) 10 steps in "
          f"{wall:.2f} s: losses {ld['losses']}; median step "
          f"{median_wall(ld['step_ms']):.2f} ms; launches {got} expected "
          f"{want} [{card}]")
    if not all(math.isfinite(v) for v in ld["losses"]):
        return out, "examples-parallel: a llama_distributed loss is not finite"
    if not launches_ok(got, want):
        return out, (f"examples-parallel: llama_distributed launched {got}, "
                     f"expected {want}")

    pp, got, wall, peak = counted_run(lambda: gpt2_pp_tied.main(EX_PP_TIED))
    want = scaled(pp_tied_launches(12, 4), 20)
    med = median_wall(pp["step_ms"])
    tokens = 4 * 2 * 1024
    out["gpt2_pp_tied"] = dict(losses=pp["losses"], launches=got,
                               step_ms=pp["step_ms"], peak_gib=peak,
                               wall_s=wall)
    del pp["params"]
    torch.cuda.empty_cache()
    print(f"phase examples-parallel: gpt2_pp_tied GPT-2 124M widths "
          f"{' '.join(EX_PP_TIED)} (fp32) in {wall:.2f} s: losses "
          f"{pp['losses'][0]:.4f} -> {pp['losses'][-1]:.4f}; step wall "
          f"(median of steps 2-20) {med:.2f} ms, {tokens / med * 1e3:.0f} "
          f"tokens/s; peak memory {peak:.2f} GiB; launches {got} expected "
          f"{want} [{card}]")
    if not (all(math.isfinite(v) for v in pp["losses"])
            and pp["losses"][-1] < pp["losses"][0]):
        return out, f"examples-parallel: gpt2_pp_tied losses {pp['losses']}"
    if not launches_ok(got, want):
        return out, (f"examples-parallel: gpt2_pp_tied launched {got}, "
                     f"expected {want}")

    runs = {}
    for name, extra in (("scan_chunks2", ["--schedule", "scan", "--chunks",
                                          "2"]),
                        ("1f1b", ["--schedule", "1f1b"])):
        r, got, wall, peak = counted_run(lambda: llama_3d.main(
            EX_L3D + extra))
        L = r["cfg"].model.num_layers
        head = 4 if name == "1f1b" else 1
        want = scaled(llama_step_launches(L, 4, head), 20)
        runs[name] = r
        out[f"llama_3d_{name}"] = dict(losses=r["losses"], launches=got,
                                       step_ms=r["step_ms"], wall_s=wall)
        print(f"phase examples-parallel: llama_3d {' '.join(EX_L3D + extra)}"
              f" (4 layers, hidden 64, M 4, O2) 20 steps in {wall:.2f} s: "
              f"losses {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
              f"median step {median_wall(r['step_ms']):.2f} ms; launches "
              f"{got} expected {want} [{card}]")
        if not all(math.isfinite(v) for v in r["losses"]):
            return out, f"examples-parallel: llama_3d {name} loss not finite"
        if not launches_ok(got, want):
            return out, (f"examples-parallel: llama_3d {name} launched "
                         f"{got}, expected {want}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_l3d_")
    try:
        drill = EX_L3D + ["--schedule", "scan", "--chunks", "2",
                          "--ckpt-dir", tmp]
        os.environ["APEX1_CHAOS_SIGTERM_STEP"] = str(EX_L3D_KILL)
        try:
            llama_3d.main(drill)
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            del os.environ["APEX1_CHAOS_SIGTERM_STEP"]
        resumed = llama_3d.main(drill)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    full = runs["scan_chunks2"]["losses"]
    same = (resumed["start"] == EX_L3D_KILL
            and resumed["losses"] == full[EX_L3D_KILL:])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            llama_3d.main(["--tp", "3"])
            illegal = 0
        except SystemExit as e:
            illegal = e.code
    named = "[tp-heads]" in err.getvalue()
    out["llama_3d_drill"] = dict(code=code, resumed=resumed["losses"],
                                 same=same, illegal_exit=illegal,
                                 tp_heads=named)
    print(f"phase examples-parallel: llama_3d SIGTERM after step "
          f"{EX_L3D_KILL}: exit {code}; --resume auto from data step "
          f"{resumed['start']}: losses equal the uninterrupted run's bit "
          f"for bit {same}; --tp 3 exits {illegal}, naming tp-heads {named}"
          f" [{card}]")
    if code != 75 or not same:
        return out, (f"examples-parallel: the llama_3d drill exited {code}, "
                     f"resumed equal {same}")
    if illegal != 2 or not named:
        return out, (f"examples-parallel: --tp 3 exited {illegal}, "
                     f"tp-heads named {named}")
    return out, None


def t5_example_launches(steps: int, seq: int) -> dict:
    """t5_seq2seq's launches: ``steps`` training steps of the 2 + 2
    layer T5 without remat (each block's norms and attentions once
    forward and once backward, dbias for each self-attention's
    relative-position bias, each stack's final norm and the fused head
    once), then one `t5_generate` call of ``seq`` decoder steps."""
    n_enc = n_dec = 2
    norms, attn = 2 * n_enc + 3 * n_dec, n_enc + 2 * n_dec
    step = {"layer_norm_fwd": norms + 2, "layer_norm_bwd": norms + 2,
            "flash_fwd": attn, "flash_dq": attn, "flash_dkv": attn,
            "flash_dbias": n_enc + n_dec, "lxent_fwd": 1, "lxent_dx": 1,
            "lxent_dw": 1}
    out = scaled(step, steps)
    for k, v in t5gen_launches(n_enc, n_dec, seq).items():
        out[k] += v
    return out


#: the RNN-T learner in a process of its own (it and T5 are host-bound:
#: one Python thread each, beside each other on the card); its result is
#: the last line it prints
RNNT_CHILD = (
    "import json, sys, torch\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "from apex1_tpu_torch import ops\n"
    "from apex1_tpu_torch.examples import rnnt_speech\n"
    "r = rnnt_speech.main([])\n"
    "print(json.dumps({**{k: r[k] for k in ('losses', 'step_ms', 'hyps',"
    " 'labels', 'exact', 'train_s', 'decode_s')},"
    " 'launches': {k: v for k, v in ops.launch_counts().items() if v}}))\n")


def run_examples_encdec(torch, ops, card, launches):
    """examples-encdec: t5_seq2seq (1500 O2 steps, then the greedy sort
    of 8 held-out rows), rnnt_speech (800 steps, greedy decode of 4; in
    a child process at the same time, `RNNT_CHILD`) and dcgan_amp (20
    steps), the JAX scripts' defaults. Gates against the JAX scripts'
    CPU runs (`JAX_T5_ACCURACY`, `JAX_RNNT_EXACT`); finite losses; exact
    launches (the RNN-T and the DCGAN launch none: LSTMs, the
    transducer, cuDNN convolutions and the flax batch norm are plain
    PyTorch). Adds the launches to ``launches``."""
    from apex1_tpu_torch.examples import dcgan_amp, t5_seq2seq
    out = {}
    child = subprocess.Popen([sys.executable, "-c", RNNT_CHILD, HERE],
                             stdout=subprocess.PIPE, text=True)
    try:
        err = _t5_and_dcgan(torch, ops, card, launches, out, t5_seq2seq,
                            dcgan_amp)
        t0 = time.perf_counter()
        text, _ = child.communicate(timeout=600)
        waited = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if err:
        return out, err
    print(text, end="")
    if child.returncode != 0:
        return out, f"examples-encdec: rnnt_speech exited {child.returncode}"
    rn = json.loads(text.strip().splitlines()[-1])
    got = rn["launches"]
    out["rnnt_speech"] = dict(loss=rn["losses"][-1], exact=rn["exact"],
                              hyps=rn["hyps"], launches=got,
                              step_ms=median_wall(rn["step_ms"]),
                              train_s=rn["train_s"], decode_s=rn["decode_s"],
                              waited_s=waited)
    print(f"phase examples-encdec: rnnt_speech (its own process, beside "
          f"the rest) 800 O2 steps in {rn['train_s']:.1f} s (median step "
          f"{median_wall(rn['step_ms']):.2f} ms), final nll "
          f"{rn['losses'][-1]:.4f}; greedy exact {rn['exact']}/4 (JAX on "
          f"the CPU {JAX_RNNT_EXACT}/4), decode {rn['decode_s']:.2f} s; "
          f"launches {got} (none expected); waited {waited:.1f} s for it "
          f"after T5 and the DCGAN [{card}]")
    if not all(math.isfinite(v) for v in rn["losses"]):
        return out, "examples-encdec: an rnnt_speech loss is not finite"
    if rn["exact"] < JAX_RNNT_EXACT - 1:
        return out, (f"examples-encdec: rnnt_speech decodes {rn['exact']}/4 "
                     f"exactly, JAX {JAX_RNNT_EXACT}/4")
    if got:
        return out, f"examples-encdec: rnnt_speech launched {got}"
    return out, None


def _t5_and_dcgan(torch, ops, card, launches, out, t5_seq2seq, dcgan_amp):
    """examples-encdec's T5 and DCGAN runs; the failure or None."""
    ops.reset_launches()
    t0 = time.perf_counter()
    t5 = t5_seq2seq.main([])
    wall = time.perf_counter() - t0
    got = nonzero(ops.launch_counts())
    add_launches(launches, got)
    want = t5_example_launches(1500, 8)
    out["t5_seq2seq"] = dict(losses=t5["losses"][-1], accuracy=t5["accuracy"],
                             launches=got, wall_s=wall,
                             step_ms=median_wall(t5["step_ms"]),
                             generate_s=t5["generate_s"],
                             loss_scale=t5["loss_scale"])
    print(f"phase examples-encdec: t5_seq2seq 1500 O2 steps in "
          f"{t5['train_s']:.1f} s (median step "
          f"{median_wall(t5['step_ms']):.2f} ms), final loss "
          f"{t5['losses'][-1]:.4f}, loss scale {t5['loss_scale']}; greedy "
          f"sort accuracy {t5['accuracy']:.4f} (JAX on the CPU "
          f"{JAX_T5_ACCURACY}; gate half of it), generate "
          f"{t5['generate_s']:.2f} s; launches {got} expected {want} "
          f"[{card}]")
    if not all(math.isfinite(v) for v in t5["losses"]):
        return "examples-encdec: a t5_seq2seq loss is not finite"
    if t5["accuracy"] < 0.5 * JAX_T5_ACCURACY:
        return (f"examples-encdec: t5_seq2seq sort accuracy "
                f"{t5['accuracy']} under half of JAX's {JAX_T5_ACCURACY}")
    if not launches_ok(got, want):
        return (f"examples-encdec: t5_seq2seq launched {got}, expected "
                f"{want}")
    del t5
    torch.cuda.empty_cache()

    ops.reset_launches()
    dc = dcgan_amp.main([])
    got = nonzero(ops.launch_counts())
    out["dcgan_amp"] = dict(losses_d=dc["losses_d"], losses_g=dc["losses_g"],
                            scale_d=dc["scale_d"], scale_g=dc["scale_g"],
                            step_ms=median_wall(dc["step_ms"]), launches=got)
    print(f"phase examples-encdec: dcgan_amp 20 O2 iterations: errD "
          f"{dc['losses_d'][0]:.4f} -> {dc['losses_d'][-1]:.4f}, errG "
          f"{dc['losses_g'][0]:.4f} -> {dc['losses_g'][-1]:.4f}; loss "
          f"scales D {dc['scale_d']} G {dc['scale_g']}; median iteration "
          f"{median_wall(dc['step_ms']):.2f} ms; launches {got} (none "
          f"expected) [{card}]")
    if not all(math.isfinite(v) for v in dc["losses_d"] + dc["losses_g"]):
        return "examples-encdec: a dcgan_amp loss is not finite"
    if got:
        return f"examples-encdec: dcgan_amp launched {got}"
    return None


def serve_example_launches(L: int, Ld: int, N: int, B: int, K: int,
                           loops: int) -> dict:
    """serving_llama's launches. A forward of the target: 2L + 1 RMS
    norms and 2L RoPE (q and k); of the int8 copy the same and 7 int8
    GEMMs a layer and the head's; of the ``Ld``-layer draft 2Ld + 1 and
    2Ld. Forwards: greedy, ragged, each ragged row alone (B - 1), beam,
    int8 N each; speculative 1 + ``loops`` of the target and 1 + loops
    (K + 1) of the draft; the prefix prefill, and a turn N continued
    plus N flat, twice. The flash forward at every prefill from an
    empty cache (L a target call, Ld the draft's): 9 + (B - 1) target
    prefills (a continued turn's prefill is a chunk decode)."""
    tf = (3 + (B - 1)) * N + 1 + loops + 1 + 4 * N
    df = 1 + loops * (K + 1)
    return {"layer_norm_fwd": (tf + N) * (2 * L + 1) + df * (2 * Ld + 1),
            "rope": (tf + N) * 2 * L + df * 2 * Ld,
            "int8_mm": N * (INT8_PER_LAYER * L + 1),
            "flash_fwd": (8 + (B - 1)) * L + Ld}


# ---- the planner's pricing and search, elastic re-planning ---------------

#: the example's tiny model under ``--plan auto`` at one device: 2
#: layers, 8 microbatches (its default 4 x the flags' dp 2), 2 steps
PLAN_EX = ["--plan", "auto", "--layers", "2", "--steps", "2",
           "--microbatches", "4"]


def run_planner(torch, ops, card, launches):
    """planner: the planner CLI's ``--smoke`` on the card (the generation
    detected from the device name; the tiny plan re-planned byte for
    byte, the banked gpt2 and llama_longctx prices, ``examples/llama_3d
    --plan auto`` 2 steps through the kernels, launches exact); plans
    for `BANKED_SHAPES` llama8b at 8 and 16 devices and gpt2 at 1
    (arithmetic only), each re-planned byte for byte; the example's
    ``--plan PATH`` replay of the plan its ``--plan auto`` run banked:
    the same plan and the same losses bit for bit; the one-step peak of
    the bench llama_3d plan at `L3D_PAR_DEPTH` layers
    (`planner.memory.step_memory_analysis`, in a one-rank NCCL group)
    beside its predicted total (train-llama-3d holds the full depth's). Adds the example
    runs' launches to ``launches``."""
    import shutil
    import tempfile
    from apex1_tpu_torch import planner
    from apex1_tpu_torch.core.capability import default_generation
    from apex1_tpu_torch.examples import llama_3d
    from apex1_tpu_torch.planner.__main__ import main as planner_main
    from apex1_tpu_torch.planner.memory import step_memory_analysis
    out = {}
    gen = default_generation()
    want = scaled(llama_step_launches(2, 8), 2)
    ops.reset_launches()
    t0 = time.perf_counter()
    code = planner_main(["--smoke"])
    torch.cuda.synchronize()
    got = nonzero(ops.launch_counts())
    add_launches(launches, got)
    out["smoke"] = dict(code=code, wall_s=time.perf_counter() - t0,
                        launches=got)
    print(f"phase planner: `python -m apex1_tpu_torch.planner --smoke` on "
          f"the card ({gen}) exit {code} in {out['smoke']['wall_s']:.2f} s;"
          f" launches {got} expected {want} [{card}]")
    if code != 0 or not launches_ok(got, want):
        return out, (f"planner: the CLI smoke exited {code}, launched "
                     f"{got}, expected {want}")
    for name, n in (("llama8b", 8), ("llama8b", 16), ("gpt2", 1)):
        t0 = time.perf_counter()
        a = planner.plan_json(planner.make_plan(planner.BANKED_SHAPES[name],
                                                n))
        plan_s = time.perf_counter() - t0
        b = planner.plan_json(planner.make_plan(planner.BANKED_SHAPES[name],
                                                n))
        p = json.loads(a)
        pr = p["predicted"]
        out[f"{name}_{n}"] = dict(
            mesh=p["mesh"], schedule=p["schedule"], zero=p["zero"]["enabled"],
            sp=p["kernel_flags"]["sp_boundary"],
            step_ms=pr["calibrated_step_ms"], bound=pr["bound"],
            mfu=pr["mfu"], hbm_gib=p["memory"]["total"],
            n_enumerated=p["search"]["n_enumerated"],
            n_hbm_rejected=p["search"]["n_hbm_rejected"], same=a == b,
            plan_s=plan_s)
        print(f"phase planner: {name} on {n} device(s) ({p['generation']}): "
              f"{p['search']['n_enumerated']} legal, "
              f"{p['search']['n_hbm_rejected']} over memory; pick "
              f"{p['search']['ranked_top'][0]['mesh']}, "
              f"{pr['calibrated_step_ms']:.3f} ms a step "
              f"({pr['calibration']['source']}), bound {pr['bound']}, mfu "
              f"{pr['mfu']:.3f}, {p['memory']['total']:.2f} of "
              f"{p['memory']['budget']:.2f} GiB; searched in {plan_s:.3f} s;"
              f" re-plan byte for byte {a == b} [{card}]")
        if a != b or p["generation"] != gen:
            return out, (f"planner: {name} on {n} devices re-planned "
                         f"differently or priced at {p['generation']}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    try:
        ops.reset_launches()
        auto = llama_3d.main(PLAN_EX)
        path = planner.save_plan(auto["plan"], os.path.join(tmp, "plan.json"))
        replay = llama_3d.main(PLAN_EX[:1] + [path] + PLAN_EX[2:])
        torch.cuda.synchronize()
        got = nonzero(ops.launch_counts())
        add_launches(launches, got)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = (replay["losses"] == auto["losses"] and planner.plan_json(
        replay["plan"]) == planner.plan_json(auto["plan"]))
    out["replay"] = dict(auto=auto["losses"], replay=replay["losses"],
                         same=same, launches=got)
    print(f"phase planner: llama_3d {' '.join(PLAN_EX)} losses "
          f"{auto['losses']}; --plan PATH of its banked plan: losses "
          f"{replay['losses']}, plan and losses bit for bit {same}; "
          f"launches {got} expected {scaled(want, 2)} [{card}]")
    if not (same and launches_ok(got, scaled(want, 2))):
        return out, "planner: the --plan PATH replay is not --plan auto's"
    plan, cfg = l3d_planned("O2", L3D_PAR_DEPTH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nccl_dir = start_nccl(torch)
    try:
        mem = step_memory_analysis(cfg, device="cuda", seed=SEED)
    finally:
        stop_nccl(nccl_dir)
    torch.cuda.empty_cache()
    out["llama_3d_memory"] = dict(
        predicted_gib=plan["memory"]["total"],
        peak_gib=mem["peak_bytes"] / 2 ** 30,
        state_gib=mem["state_bytes"] / 2 ** 30, loss=mem["loss"],
        wall_s=time.perf_counter() - t0)
    m = out["llama_3d_memory"]
    print(f"phase planner: the bench's llama_3d plan at {L3D_PAR_DEPTH} "
          f"layers, one step (step_memory_analysis): peak {m['peak_gib']:.2f} GiB, the train "
          f"state {m['state_gib']:.2f} GiB, predicted {m['predicted_gib']:.2f}"
          f" GiB (predicted/measured {m['predicted_gib'] / m['peak_gib']:.4f}"
          f"), loss {m['loss']:.6f}, {m['wall_s']:.1f} s [{card}]")
    if not math.isfinite(m["loss"]):
        return out, f"planner: the llama_3d step's loss is {m['loss']}"
    return out, None


def run_elastic_drill(torch, ops, card, launches):
    """elastic-drill: `resilience.elastic.drill(2, 1)`: the drill's tiny
    llama_3d (4 layers, hidden 64, O2) trained on 2 gloo ranks of the CPU
    and killed after a seed-keyed step, then re-planned onto one device
    and resumed in a fresh process on the card, beside its control: the
    resumed losses and final params equal the control's bit for bit,
    leaves restacked, the episode rebuilt from the five spine events.
    Adds the resumed and control steps' launches to ``launches``."""
    from apex1_tpu_torch.resilience import elastic
    t0 = time.perf_counter()
    res = elastic.drill(2, 1, device="cuda")
    wall = time.perf_counter() - t0
    steps = 2 * (6 - res["kill_step"])
    want = scaled(llama_step_launches(4, 8), steps)
    got = res["launches"]
    add_launches(launches, got)
    out = dict(wall_s=wall, kill_step=res["kill_step"],
               old_mesh=res["old_mesh"], new_mesh=res["new_mesh"],
               losses=res["losses"], control=res["losses_control"],
               n_restacked=res["n_restacked"], n_leaves=res["n_leaves"],
               events=res["events"], replan=res["replan_event"],
               device=res["device"], launches=got,
               seconds=res["seconds"])
    print(f"phase elastic-drill: {res['old_mesh']} (2 gloo ranks) killed "
          f"after step {res['kill_step']} -> {res['new_mesh']} on "
          f"{res['device']} (priced at {res['replan_event']['generation']},"
          f" {res['replan_event']['generation_source']}): "
          f"{res['n_restacked']} of {res['n_leaves']} leaves restacked, "
          f"resumed losses {res['losses']} equal the control's bit for bit"
          f" {res['losses'] == res['losses_control']}; events "
          f"{res['events']}; launches {got} expected {want}; {wall:.1f} s "
          f"(the gloo leg {res['seconds']['train_leg']:.1f}, the card's "
          f"{res['seconds']['resume_leg']:.1f}) [{card}]")
    if not (res["device"] == "cuda" and res["n_restacked"] > 0
            and res["losses"] == res["losses_control"]
            and res["events"] == sorted(elastic.EPISODE_EVENTS)
            and launches_ok(got, want)):
        return out, f"elastic-drill: {out}"
    return out, None


def attr_cases(torch, ops):
    """The kernels of PERF.md §6 at their main shapes, for `run_tune`'s
    budget check: (rows, `vmem_model` check, launch params, dims,
    element size, a call that launches them once)."""
    from apex1_tpu_torch.ops import fused_collective as fc
    from apex1_tpu_torch.ops import lora_epilogue as le
    from apex1_tpu_torch.ops import paged_decode as pd
    from apex1_tpu_torch.ops import quantized as q
    from apex1_tpu_torch.ops.attention import flash_fwd_merge
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf, grad=False, scale=1.0):
        t = (torch.randn(*shape, generator=g, device="cuda") * scale).to(
            dtype)
        return t.requires_grad_(grad)

    def norm():
        x, w, b = rn(TB * TS, TH, grad=True), rn(TH, grad=True), rn(
            TH, grad=True)
        ops.layer_norm(x, w, b).float().sum().backward()

    def softmax():
        x = rn(TB, THEADS, TS, TS, dtype=torch.float32, grad=True)
        ops.scaled_upper_triang_masked_softmax(
            x, scale=0.125).sum().backward()

    def xent():
        x = rn(TB * TS, TV_PAD, grad=True)
        t = torch.randint(0, TV, (TB * TS,), device="cuda")
        ops.softmax_cross_entropy_loss(x, t, smoothing=0.1,
                                       num_classes=TV).sum().backward()

    def flash():
        q_, k_, v_ = (rn(TB, THEADS, TS, 64, grad=True) for _ in range(3))
        ops.flash_attention(q_, k_, v_, causal=True).float().sum().backward()

    def flash_bias():
        q_, k_, v_ = (rn(8, 16, 512, 64, grad=True) for _ in range(3))
        b_ = rn(1, 16, 512, 512, dtype=torch.float32, grad=True)
        ops.flash_attention(q_, k_, v_, bias=b_).float().sum().backward()

    def lxent():
        x = rn(TB * TS, TH, grad=True)
        w = rn(TV_PAD, TH, grad=True, scale=0.02)
        t = torch.randint(0, TV, (TB * TS,), device="cuda")
        ops.linear_cross_entropy(x, w, t, num_classes=TV).sum().backward()

    def rope():
        x = rn(LB, LS, LHEADS, LD, grad=True)
        cos, sin = ops.rope_tables(torch.arange(LS, device="cuda"), LD)
        ops.apply_rotary_pos_emb(x, cos, sin).float().sum().backward()

    def glu():
        ops.glu_fwd(rn(LB * LS, LH), rn(LH, LFFN, scale=LH ** -0.5),
                    rn(LH, LFFN, scale=LH ** -0.5))

    def bda():
        x, r_ = rn(TB * TS, TH, grad=True), rn(TB * TS, TH, grad=True)
        b_ = rn(TH, grad=True)
        ops.fused_bias_dropout_add(x, r_, p=0.1, seed=SEED,
                                   bias=b_).float().sum().backward()

    def int8():
        wq, s_ = q.quantize_int8(rn(5632, 2048, dtype=torch.float32,
                                    scale=0.02))
        q.int8_mm(rn(8, 2048), wq, s_)

    def paged():
        pages = 1 + 8 * 17
        pd.paged_attend(rn(8, THEADS, 1, 64), rn(pages, THEADS, 64, 64),
                        rn(pages, THEADS, 64, 64),
                        torch.arange(1, pages, dtype=torch.int32,
                                     device="cuda").reshape(8, 17),
                        torch.full((8,), 17 * 64 - 5, dtype=torch.int32,
                                   device="cuda"))

    def sample():
        pd.fused_sample(rn(8, TV_PAD, dtype=torch.float32),
                        torch.arange(8, dtype=torch.int32, device="cuda"),
                        torch.arange(8, dtype=torch.int32, device="cuda"),
                        temperature=0.7, vocab_size=TV)

    def lora():
        pages = 1 + 3 * 16
        le.lora_delta(rn(8, 2048), rn(pages, 2048, dtype=torch.float32),
                      rn(pages, LV, dtype=torch.float32),
                      torch.arange(8 * 16, dtype=torch.int32,
                                   device="cuda").reshape(8, 16) % 48 + 1)

    def chunk():
        fc.chunk_matmul(rn(8192, 2048), rn(2048, 8192, scale=0.02))

    def merge():
        q_, k_, v_ = (rn(1, 32 if i == 0 else 4, 4096, 64)
                      for i in range(3))
        flash_fwd_merge(q_, k_, v_, None, None, 0.125, True, 4096, 0,
                        torch.zeros(1, 32, 4096, 64, device="cuda"),
                        torch.full((1, 32, 4096), -1e30, device="cuda"))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    i8 = q.int8_plan(8, 5632, 2048)
    return [
        ("1-2", "layer_norm", {}, {"lanes": TH}, 2, norm),
        ("3-5", "flash_attention", {}, {"Dp": 64, "Sb": TS}, 2, flash),
        ("6", "flash_attention", {}, {"Dp": 64, "Sb": 512}, 2, flash_bias),
        ("7-11", "linear_xent", {}, {"Hp": TH}, 2, lxent),
        ("12", "rope", {}, {"lanes": LD // 2}, 2, rope),
        ("13", "fused_swiglu",
         {"tile_n": ops.fused_dense.glu_tile(LB * LS, LFFN, bf)[1]},
         {"Hp": LH, "Tb": LB * LS}, 2, glu),
        ("14-15", "bias_dropout_add", {}, {"lanes": TH}, 2, bda),
        ("16-17", "fused_softmax", {}, {"lanes": TS}, 4, softmax),
        ("18-19", "xentropy", {}, {"lanes": TV_PAD}, 2, xent),
        ("20", "int8_matmul", dict(zip(("bm", "bt", "splits", "kc"), i8)),
         {"N": 5632, "K": 2048, "Tb": 8}, 1, int8),
        ("21", "paged_decode",
         {"per": pd.paged_geometry(8, THEADS, THEADS, 1, 64, 64, 17)[1]},
         {"Dp": 64, "Rq": 1}, 2, paged),
        ("22", "fused_sample",
         {"splits": pd.sample_splits(8, TV_PAD, sms)[0]},
         {"Vp": TV_PAD, "R": 8}, 4, sample),
        ("23", "lora_epilogue", {"rows": le.lora_rows(8, LV, 16, sms)},
         {"Hp": 2048, "Vp": LV, "R": 16}, 2, lora),
        ("24-25, 27", "fused_collective_matmul",
         dict(zip(("block_m", "block_n"), fc.chunk_tile(8192, 8192, bf))),
         {"Kp": 2048}, 2, chunk),
        ("26", "fused_ag_flash", {}, {"Dp": 64, "Sb": 4096}, 2, merge),
    ]


def run_tune(torch, ops, card, launches):
    """tune: the tuning table and the budget model on the card. With an
    empty table (a temporary ``APEX1_TUNING_DIR``) every launcher
    resolves today's heuristic (the GLU's and the chunk product's tiles
    read from the launch records: the library's ``tile_n`` and
    ``tile_of``); the sweep (`tuning.sweep`) times the seven tunable
    specs at their main shapes, a few calls a candidate, and banks the
    winners there; a fresh `lookup` serves each winner, and each op
    launched through the table takes it and equals its plain version.
    Then every kernel of PERF.md §6 launches once at its main shape with
    the launch records on: each record's static + dynamic shared memory,
    registers a thread and threads a block must lie within a frame of its
    `vmem_model` check, which must fit the h100 row. Prints a line a
    kernel."""
    import shutil
    import tempfile

    from apex1_tpu_torch import tuning, vmem_model
    from apex1_tpu_torch.core.capability import smem_budget
    from apex1_tpu_torch.ops import _build
    from apex1_tpu_torch.tuning import sweep
    from apex1_tpu_torch.tuning.registry import SPECS
    t0 = time.perf_counter()
    errs, out = [], {"sweep": {}, "attrs": []}
    tmp = tempfile.mkdtemp(prefix="apex1_tune_")
    prev = os.environ.get("APEX1_TUNING_DIR")
    os.environ["APEX1_TUNING_DIR"] = tmp
    tuning.clear_cache()
    try:
        cases = {n: f(torch, "cuda", False) for n, f in sweep.CASES.items()}
        # 1. no table: today's parameters, and the two tiles the library
        # picks itself read back from what launched
        for name, case in cases.items():
            got, want = case.plan(), case.heuristic()
            if got != want:
                errs.append(f"tune: {name} without a table resolved {got}, "
                            f"today's heuristic {want}")
        print(f"  no table: {len(cases)} launchers resolve today's "
              f"heuristic: {not errs} [{card}]")
        for name, bn, smem in (
                ("fused_swiglu", cases["fused_swiglu"].heuristic()["tile_n"],
                 lambda bn: vmem_model.wg_gemm_smem(
                     bn, 4 if bn == 128 else 6, nb=2)),
                ("fused_collective_matmul",
                 cases["fused_collective_matmul"].heuristic()["block_n"],
                 lambda bn: vmem_model.wg_gemm_smem(bn, 4))):
            with _build.launch_records() as rec:
                cases[name].make(None)()
            torch.cuda.synchronize()
            launched = [r["dyn_smem"] for r in rec] == [smem(bn)]
            print(f"  no table: {name} launched the library's {bn}-column "
                  f"tile ({smem(bn)} B of dynamic shared memory): "
                  f"{launched} [{card}]")
            if not launched:
                errs.append(f"tune: {name} without a table launched {rec}, "
                            f"not the library's {bn}-column tile")
        # 2. the sweep into the empty directory, each winner served
        for name, case in cases.items():
            best, problems, _ = sweep.sweep_one(
                name, 5, lambda *a: print(" ", *a), device="cuda", card=card)
            errs += [f"tune: {p}" for p in problems]
            if best is None:
                continue
            tuning.clear_cache()
            served = tuning.lookup(case.kernel, case.dims, case.dtype)
            plan = case.plan()
            ok, worst = sweep.compare(torch, case.make(None)(), case.plain(),
                                      case.tol)
            torch.cuda.synchronize()
            out["sweep"][name] = dict(winner=best, heuristic=case.heuristic(),
                                      served=served, plan=plan, worst=worst)
            print(f"  {name}: winner {best} (today's {case.heuristic()}); "
                  f"lookup {served}; launched through the table {plan}, "
                  f"against the plain version worst {worst:.3g} "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if served != best or plan != best or not ok:
                errs.append(f"tune: {name} through the table: served "
                            f"{served}, plan {plan}, worst {worst}")
        problems = tuning.validate_tables(tmp)
        if problems:
            errs.append(f"tune: the swept tables are invalid: {problems}")
    finally:
        if prev is None:
            os.environ.pop("APEX1_TUNING_DIR", None)
        else:
            os.environ["APEX1_TUNING_DIR"] = prev
        tuning.clear_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    # 3. every kernel's attributes against its budget check
    budget = smem_budget("h100")
    for rows, check, blocks, dims, es, fn in attr_cases(torch, ops):
        fits, est = SPECS[check].check(blocks, dims, es, budget)
        with _build.launch_records() as rec:
            fn()
        torch.cuda.synchronize()
        for r in rec:
            frame = next((f for f in est if f.bounds(r)), None)
            line = dict(rows=rows, check=check, **r,
                        frame=None if frame is None else frame.kernel,
                        est_smem=None if frame is None else frame.smem,
                        est_regs=None if frame is None else frame.regs)
            out["attrs"].append(line)
            print(f"  row {rows:9s} {check:23s} static smem "
                  f"{r['static_smem']:6d} B + dynamic {r['dyn_smem']:6d} B, "
                  f"{r['regs']:3d} regs x {r['threads']:4d} threads (most "
                  f"{r['max_threads']}), local {r['local_bytes']} B: "
                  f"{'within ' + frame.kernel + ' ' + str(frame.smem) + ' B, '
                     + str(frame.regs) + ' regs' if frame else 'NOT BOUNDED'}"
                  f" [{card}]")
            if frame is None:
                errs.append(f"tune: row {rows} {check} launched {r}, past "
                            f"every frame of its check {list(est)}")
        if not rec or not fits:
            errs.append(f"tune: row {rows} {check}: {len(rec)} launches "
                        f"recorded, the check fits the h100 row {fits}")
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase tune: {len(out['sweep'])} specs swept and served, "
          f"{len(out['attrs'])} launches within their budget frames: "
          f"{out['wall_s']:.1f} s [{card}]")
    return out, ("; ".join(errs) if errs else None)


def obs_report(torch, ops, state, step, batch, label: str, card) -> dict:
    """One profiled step of a trainer: `utils.observability.trace`'s
    Chrome trace read by `obs.xspace`, beside `kernel_split` of the same
    profiler session."""
    import tempfile

    from apex1_tpu_torch.obs import xspace
    from apex1_tpu_torch.utils.observability import trace
    for _ in range(2):
        state, _ = step(state, *batch)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="apex1_obs_") as tmp:
        with trace(tmp) as prof:
            t1 = time.perf_counter()
            state, _ = step(state, *batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        split = kernel_split(torch, prof, 1, wall)
        rep = xspace.build_report(tmp, steps=1)
    ours = [o["name"][:60] for o in rep["ops"] if o["bucket"] == "kernel"]
    print(f"  {label}: {rep['plane_class']}, {rep['n_ops']} ops, "
          f"{rep['per_step_ms']:.3f} ms a step (kernel_split "
          f"{split['device_ms_per_step']:.3f}); buckets "
          f"{ {b: (v['ms'], v['share']) for b, v in rep['buckets'].items()} };"
          f" the port's kernels {ours[:6]} [{card}]")
    return dict(plane_class=rep["plane_class"], n_ops=rep["n_ops"],
                per_step_ms=rep["per_step_ms"],
                kernel_split_ms=split["device_ms_per_step"],
                buckets=rep["buckets"], kernels=ours, top=rep["ops"][:12])


def run_obs(torch, ops, card, launches):
    """obs: ``python -m apex1_tpu_torch.obs --smoke`` on the card (the
    spine, a traced tiny step's report, the port's own calibration
    corpus priced ``uncalibrated``), then `obs.xspace`'s reports of one
    GPT-2 124M O2 step (flash, the fused head: ``train``'s configuration
    at full width) and one ``llama_block`` O2 step: device rows, the
    port's kernels in the ``kernel`` bucket, ``per_step_ms`` within 5 %
    of `kernel_split`'s device ms of the same profiled step."""
    t0 = time.perf_counter()
    errs, out = [], {}
    smoke = subprocess.run([sys.executable, "-m", "apex1_tpu_torch.obs",
                            "--smoke"], cwd=HERE, capture_output=True,
                           text=True, timeout=600)
    lines = [ln for ln in smoke.stdout.splitlines()
             if ln.split(" ")[0] in ("spine", "trace", "calibrate", "OBS",
                                     "FAIL")]
    for ln in lines:
        print(f"  obs --smoke: {ln}")
    out["smoke"] = {"rc": smoke.returncode, "lines": lines}
    if smoke.returncode != 0 or "OBS SMOKE OK" not in smoke.stdout \
            or "uncalibrated" not in smoke.stdout:
        errs.append(f"obs: --smoke rc {smoke.returncode}: "
                    f"{(smoke.stdout + smoke.stderr)[-800:]}")
    for label, make in (
            ("GPT-2 124M O2 flash, fused head",
             lambda: make_trainer(torch, "O2", 12, SEED, use_flash=True,
                                  fuse_head=True)),
            ("llama_block O2", lambda: make_llama_trainer(
                torch, "O2", LLAYERS, SEED))):
        _, state, step, batch = make()
        rep = obs_report(torch, ops, state, step, batch, label, card)
        del state, step, batch
        torch.cuda.empty_cache()
        out[label] = rep
        off = abs(rep["per_step_ms"] / rep["kernel_split_ms"] - 1.0)
        if rep["plane_class"] != "device" or not rep["kernels"] \
                or rep["buckets"]["kernel"]["ms"] <= 0 or off > 0.05:
            errs.append(f"obs: {label}: {rep['plane_class']}, kernels "
                        f"{rep['kernels'][:3]}, per_step_ms "
                        f"{rep['per_step_ms']} against kernel_split "
                        f"{rep['kernel_split_ms']} ({off:.1%})")
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase obs: {out['wall_s']:.1f} s [{card}]")
    return out, ("; ".join(errs) if errs else None)


def run_serve_example(torch, ops, card, launches):
    """serve-example: serving_llama at its 1B config on the card (16
    layers, hidden 2048, 32 / 4 heads, ffn 5632, vocab 32000, O2; B 2,
    prompt 8, 16 new, 4 beams): each section's wall (ending in a
    synchronize), greedy tokens/s; the ragged rows against each row
    alone and speculative against greedy by the near-tie rule
    (`models.near_tie`); the int8 and prefix agreements; exact launches.
    Adds them to ``launches``."""
    from apex1_tpu_torch.examples import serving_llama
    ops.reset_launches()
    t0 = time.perf_counter()
    r = serving_llama.main([])
    wall = time.perf_counter() - t0
    got = nonzero(ops.launch_counts())
    add_launches(launches, got)
    cfg = r["cfg"]
    L, N, B = cfg.num_layers, 16, 2
    want = serve_example_launches(L, max(1, L // 4), N, B,
                                  serving_llama.DRAFT_K,
                                  int(r["rounds"].max()))
    rv, sv = r["ragged_verdict"], r["speculative_verdict"]
    out = dict(walls=r["walls"], tokens_per_s=r["greedy_tokens_per_s"],
               rounds=r["rounds"].tolist(), int8=r["int8_agreement"],
               prefix=r["prefix_agreement"], scores=r["scores"].tolist(),
               ragged_flips=rv["flips"], ragged_moved=rv["moved"],
               spec_flips=sv["flips"], spec_moved=sv["moved"],
               spec_floor=sv["floor"], launches=got, wall_s=wall)
    print(f"phase serve-example: serving_llama 1B (layers {L}, hidden "
          f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"vocab {cfg.vocab_size}, O2) B {B} prompt 8 new {N} in "
          f"{wall:.2f} s; section walls "
          f"{ {k: round(v, 3) for k, v in r['walls'].items()} } s; greedy "
          f"{r['greedy_tokens_per_s']:.1f} tokens/s [{card}]")
    print(f"phase serve-example: ragged rows against alone: first flips "
          f"(row, token, top-2 gap) {rv['flips']} moved {rv['moved']}; "
          f"speculative verify rounds {r['rounds'].tolist()}, first flips "
          f"against greedy {sv['flips']} moved {sv['moved']} (agreeing "
          f"difference {sv['floor']:.5f}); int8 agreement "
          f"{r['int8_agreement']:.3f}; prefix turns agreement "
          f"{r['prefix_agreement']}; best beam scores "
          f"{r['scores'].tolist()}; launches {got} expected {want} [{card}]")
    if rv["bad"]:
        return out, (f"serve-example: ragged rows differ from alone off a "
                     f"near-tie: {rv['bad']}")
    if not launches_ok(got, want):
        return out, f"serve-example: launches {got}, expected {want}"
    if not r["greedy"].min() >= 0 or r["greedy"].max() >= cfg.vocab_size:
        return out, "serve-example: a token outside the vocabulary"
    return out, None


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: chip_smoke.py runs on the GPU")
    if not os.path.isdir(os.path.join(HERE, "apex1_tpu_torch")):
        return fail("apex1_tpu_torch/ is not beside chip_smoke.py; run it "
                    "from the root of a checkout")
    sys.stdout.reconfigure(line_buffering=True)
    sys.path.insert(0, HERE)
    import apex1_tpu_torch.ops as ops
    from apex1_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")

    # wall seconds of each phase, build included
    phase_s, last = {}, [time.perf_counter()]

    def stamp(name):
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - last[0]
        last[0] = now

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"phase build: ok, {time.perf_counter() - t0:.1f} s wall "
          f"[{card}]")
    stamp("build")
    for line in _build.build_log().splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print(f"  ptxas: {line.strip()}")

    if "--compare" in sys.argv[1:]:
        parts = [a for a in sys.argv[1:] if a in COMPARE_PARTS]
        return compare_flash(torch, ops, card,
                             sys.argv[sys.argv.index("--compare") + 1],
                             parts or COMPARE_PARTS)

    if "--save-inflight" in sys.argv[1:]:
        return save_inflight(torch, ops, card)

    if "--gate-sweep" in sys.argv[1:]:
        paths = [p for p in ("kernels", "plain") if p in sys.argv[1:]]
        return gate_sweep(torch, ops, card, paths or ["kernels", "plain"])

    if "--only" in sys.argv[1:]:
        # a probe of some phases alone (no kernels line); the sharded
        # data-parallel ones inside a one-rank NCCL group
        only = {"generate-t5": run_generate_t5, "contrib": run_contrib,
                "serve-dense": run_serve_dense,
                "serve-fleet": run_serve_fleet, "disagg": run_disagg,
                "speculative": run_speculative,
                "train-resume": run_train_resume,
                "train-sentinel": run_train_sentinel,
                "examples": run_examples,
                "examples-encdec": run_examples_encdec,
                "serve-example": run_serve_example,
                "planner": run_planner, "elastic-drill": run_elastic_drill,
                "tune": run_tune, "obs": run_obs}
        grouped = {"train-fsdp": run_fsdp, "train-zero": run_zero,
                   "train-bert-lamb": run_bert_lamb,
                   "spatial-bottleneck": run_spatial,
                   "llama-3d-resume": run_llama_3d_resume,
                   "train-llama-3d": run_llama_3d,
                   "examples-parallel": run_examples_parallel}
        errs = []
        for phase in ([a for a in sys.argv[1:] if a in {**only, **grouped}]
                      or list(only) + list(grouped)):
            t0 = time.perf_counter()
            if phase in only:
                errs.append(only[phase](torch, ops, card, {})[1])
            else:
                nccl_dir = start_nccl(torch)
                try:
                    errs.append(grouped[phase](torch, ops, card, {})[1])
                finally:
                    stop_nccl(nccl_dir)
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s wall "
                  f"[{card}]")
        errs = [e for e in errs if e]
        return fail("; ".join(errs)) if errs else 0

    if "--profile" in sys.argv[1:]:
        runs = {"decode": lambda: profile_decode(torch),
                "train": lambda: profile_train(torch, use_flash=False),
                "train_flash": lambda: profile_train(torch, use_flash=True),
                "train_fused_head": lambda: profile_train(
                    torch, use_flash=True, fuse_head=True),
                "llama_block": lambda: profile_llama(torch, fused_mlp=False),
                "llama_block_fused_mlp": lambda: profile_llama(
                    torch, fused_mlp=True),
                "bert": lambda: profile_bert(torch, "bert"),
                "bert_large": lambda: profile_bert(torch, "bert_large"),
                "t5": lambda: profile_t5(torch),
                "resnet": lambda: profile_resnet(torch),
                "decode_int8": lambda: profile_decode_int8(torch),
                "serve_lora": lambda: profile_serve_lora(torch)}
        # the names after --profile pick some of them; none: all
        picked = [a for a in sys.argv[1:] if a in runs] or list(runs)
        prof = {name: runs[name]() for name in picked}
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "profile.json"),
                  "w") as f:
            json.dump({"card": card, **prof}, f, indent=1)
        print(f"phase profile: {json.dumps(prof)} [{card}]")
        return 0

    # 2. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    cgen = torch.Generator(device="cuda").manual_seed(SEED)
    checks, check_s = {}, {}
    for names, fn, g in (
            (("layer_norm_fwd",), check_layer_norm, gen),
            (("paged_attend",), check_paged_attend, gen),
            (("fused_sample",), check_fused_sample, gen),
            (("layer_norm_bwd",), check_layer_norm_bwd, cgen),
            (("softmax_fwd", "softmax_bwd"), check_softmax, cgen),
            (("xent_fwd", "xent_bwd"), check_xent, cgen),
            (("flash_fwd", "flash_dq", "flash_dkv", "flash_dbias"),
             check_flash, cgen),
            (("lxent_fwd", "lxent_dx", "lxent_dw"), check_lxent, cgen),
            (("rope",), check_rope, cgen),
            (("glu_fwd",), check_glu, cgen),
            (("bda_fwd", "bda_bwd"), check_bda, cgen),
            (("int8_mm",), check_int8_matmul, cgen),
            (("lora_delta",), check_lora_delta, cgen),
            (("chunk_matmul",), check_chunk_matmul, cgen),
            (("flash_fwd_merge",), check_flash_merge, cgen)):
        t0 = time.perf_counter()
        out = fn(torch, ops, g)
        checks.update(zip(names, out if len(names) > 1 else (out,)))
        check_s[fn.__name__] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    print(f"phase kernels: seconds per check {check_s} [{card}]")
    bad = []
    for name, rows in checks.items():
        for r in rows:
            # a tolerance (rtol, atol) bounds the worst element's error
            # over its allowance by 1; sampled ids (tol None) must match;
            # the flash and linear-xent backward must repeat their bits;
            # the packed statistics must equal the four bit for bit
            ok = r["worst"] <= 1 if r["tol"] else r["abs"] == 0
            ok = ok and r.get("same_bits", True)
            ok = ok and r.get("packed_equal", True)
            ok = ok and r.get("equal_bits", True)
            ok = ok and r.get("solo_bits", True) and r.get("zero_rows", True)
            lib, plain = ("-" if r[k] is None else f"{r[k]:.4f}"
                          for k in ("library_ms", "plain_ms"))
            tol = (r["rule"] if "rule" in r else
                   f"rtol={r['tol'][0]:g} atol={r['tol'][1]:g}*rms"
                   if r["tol"] else "ids exact")
            bits = ("" if "same_bits" not in r
                    else f" same bits twice {r['same_bits']}")
            if "packed_equal" in r:
                bits += f" packed == four {r['packed_equal']}"
            if "equal_bits" in r:
                bits += f" equal bits {r['equal_bits']}"
            if "solo_bits" in r:
                bits += (f" rows equal solo {r['solo_bits']} page-0 rows "
                         f"0.0 {r['zero_rows']}")
            if "both_ms" in r:
                bits += f" dx+dW together ms={r['both_ms']:.4f}"
            if "acc_ms" in r:
                bits += f" with acc ms={r['acc_ms']:.4f}"
            if "cold_ms" in r:
                bits += (f" cold ms={r['cold_ms']:.4f} library cold "
                         f"ms={r['library_cold_ms']:.4f}")
            if "one_ulp" in r:
                bits += " worst/one-ulp allowance " + ", ".join(
                    f"{k} {v:.3g}" for k, v in r["one_ulp"].items())
            print(f"phase kernels: {name} [{r['case']}] "
                  f"max_abs={r['abs']:.3g} worst/allowed={r['worst']:.3g} "
                  f"{tol}{bits} ms={r['ms']:.4f} "
                  f"plain_ms={plain} library_ms={lib} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"{'ok' if ok else 'MISMATCH'} [{card}]")
            if not ok:
                bad.append(f"{name} {r['case']}")
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")
    stamp("kernels")

    # 3. the engine: GPT-2 124M, O2, through the kernels
    ops.reset_launches()
    streams, eng, wall, step_ms, cfg = serve(torch, ENGINE_KW, depth=12,
                                             policy="O2", seed=SEED)
    launches = ops.launch_counts()
    main_launches = dict(launches)
    summ = eng.metrics.summary()
    n_fwd = (eng.metrics.get_counter("prefill_chunks")
             + eng.metrics.get_counter("decode_steps"))
    L = cfg.num_layers
    # serving launches no training kernel (it runs under inference mode)
    expect = {name: 0 for name in launches}
    expect.update({"layer_norm_fwd": n_fwd * (2 * L + 1),
                   "paged_attend": n_fwd * L, "fused_sample": n_fwd})
    n_tok = sum(len(s) for s in streams)
    statuses = {r.status for r in eng.results.values()}
    print(f"phase engine: GPT-2 124M O2 width {cfg.hidden_size} layers {L} "
          f"vocab {cfg.vocab_size}/{cfg.padded_vocab}; "
          f"{len(streams)} requests, {n_tok} tokens generated, "
          f"wall {wall:.2f} s, {n_tok / wall:.1f} tok/s, "
          f"mean decode-step wall {sum(step_ms) / len(step_ms):.2f} ms "
          f"over {len(step_ms)} steps, "
          f"prefill chunks {eng.metrics.get_counter('prefill_chunks')}, "
          f"decode steps {eng.metrics.get_counter('decode_steps')}, "
          f"prefix hit rate {summ.get('prefix_hit_rate', 0):.3f}, "
          f"ttft p50 {summ.get('ttft_p50_ms', 0):.1f} ms [{card}]")
    print(f"phase engine: launches {launches} expected {expect} "
          f"[{card}]")
    if statuses != {"done"} or any(len(s) != 64 for s in streams):
        return fail(f"engine: statuses {statuses}, lengths "
                    f"{sorted({len(s) for s in streams})}")
    for name, n in launches.items():
        if n != expect[name]:
            return fail(f"engine: {name} launched {n} times, expected "
                        f"{expect[name]}")
    for s in streams:
        if min(s) < 0 or max(s) >= cfg.vocab_size:
            return fail("engine: a token outside the vocabulary")
    del eng

    stamp("engine")

    # 4. parity: kernels against the plain versions, O0, depth 2
    kern, _, kwall, _, _ = serve(torch, ENGINE_KW, depth=2, policy="O0",
                                 seed=SEED + 1)
    with ops.force_impl("torch"):
        plain, _, pwall, _, _ = serve(torch, ENGINE_KW, depth=2,
                                      policy="O0", seed=SEED + 1)
    diff = sum(a != b for a, b in zip(kern, plain))
    print(f"phase parity: O0 depth 2, {len(kern)} requests, kernel wall "
          f"{kwall:.2f} s, plain wall {pwall:.2f} s, streams differing "
          f"{diff} [{card}]")
    if diff:
        return fail(f"parity: {diff} token streams differ between the "
                    f"kernels and the plain versions")

    stamp("parity")

    # 5-7. train (use_flash=False), train-flash, train-packed,
    # train-fused-head, train-fused-packed: GPT-2 124M, B x S tokens
    train_out = {}
    for phase, use_flash, packed, levels, fuse in (
            ("train", False, False, (("O2", 6), ("O2_fp16", 3)), False),
            ("train-flash", True, False, (("O2", 6), ("O2_fp16", 3)), False),
            ("train-packed", True, True, (("O2", 3),), False),
            ("train-fused-head", True, False, (("O2", 6), ("O2_fp16", 6)),
             True),
            ("train-fused-packed", True, True, (("O2", 3),), True)):
        train_out[phase], err = run_train_phase(
            torch, ops, card, phase, use_flash, packed, levels,
            main_launches, fuse_head=fuse)
        if err:
            return fail(err)
        stamp(phase)
    for level in ("O2", "O2_fp16"):
        f, m = train_out["train-fused-head"][level], \
            train_out["train-flash"][level]
        print(f"phase train-fused-head: {level} use_flash=True, "
              f"fuse_head=True vs False: step wall {f['step_wall_ms']:.2f} "
              f"vs {m['step_wall_ms']:.2f} ms, {f['tokens_per_s']:.0f} vs "
              f"{m['tokens_per_s']:.0f} tokens/s, peak memory "
              f"{f['peak_gib']:.2f} vs {m['peak_gib']:.2f} GiB [{card}]")

    # 8. train-parity: kernels against the plain versions, depth 2
    par = {}
    for use_flash, fuse in ((False, False), (True, False), (True, True)):
        label = f"use_flash={use_flash} fuse_head={fuse}"
        par[label] = train_parity(torch, ops, use_flash, fuse)
        err = check_train_parity(par[label], card, label, use_flash, fuse)
        if err:
            return fail(err)
    lf = par["use_flash=True fuse_head=True"]["kernel"]["o0"]["dense"][0][0]
    lm = par["use_flash=True fuse_head=False"]["kernel"]["o0"]["dense"][0][0]
    print(f"phase train-parity: O0 depth 2 step-1 loss on the same weights, "
          f"fuse_head=True {lf:.7f} vs fuse_head=False {lm:.7f}, relative "
          f"difference {abs(lf - lm) / abs(lm):.2e} [{card}]")
    if abs(lf - lm) > 1e-5 * abs(lm):
        return fail(f"train-parity: the fused head's loss {lf} is not the "
                    f"materialized head's {lm}")

    stamp("train-parity")

    # 9. dpo: GPT-2 124M, O2, a chunked-DPO step through the fused head
    dpo_out, err = run_dpo(torch, ops, card, main_launches)
    if err:
        return fail(err)

    stamp("dpo")

    # 10. generate: GPT-2 124M, O2, ragged prompts, dense cache
    run, gcfg = make_generator(torch, 12, "O2", SEED)
    gen_out = {}
    for temp in (0.0, 0.7):
        ops.reset_launches()
        toks, gwall = run(temp)
        counts = ops.launch_counts()
        for name, n in counts.items():
            main_launches[name] += n
        n_gen = toks.size
        gen_out[temp] = dict(wall_s=gwall, tokens_per_s=n_gen / gwall,
                             launches=counts)
        print(f"phase generate: GPT-2 124M O2 T={temp} {GEN_ROWS} prompts "
              f"of 32-{GEN_WIDTH} tokens, {GEN_NEW} new tokens each, "
              f"cache {GEN_SLOTS} slots; wall {gwall:.2f} s, "
              f"{n_gen / gwall:.1f} tok/s, flash_fwd launches "
              f"{counts['flash_fwd']} (prefill), launches "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]")
        if counts["flash_fwd"] != gcfg.num_layers:
            return fail(f"generate: the prefill launched flash_fwd "
                        f"{counts['flash_fwd']} times, expected "
                        f"{gcfg.num_layers}")
        if toks.min() < 0 or toks.max() >= gcfg.vocab_size:
            return fail("generate: a token outside the vocabulary")
    del run
    torch.cuda.empty_cache()

    stamp("generate")

    # 11. generate-parity: kernels against the plain versions, O0, depth 2
    from apex1_tpu_torch.models.near_tie import top2_gap
    run, gcfg = make_generator(torch, 2, "O0", SEED + 1)
    for temp in (0.0, 0.7):
        rec_k, rec_p = [], []
        kt, _ = run(temp, rec_k)
        with ops.force_impl("torch"):
            pt, _ = run(temp, rec_p)
        rows = sorted({int(r) for r in (kt != pt).nonzero()[0]})
        gaps = []
        for r in rows:
            t = int((kt[r] != pt[r]).nonzero()[0][0])
            gaps.append((r, t, top2_gap(rec_p[t], r, t, temp,
                                 gcfg.vocab_size)))
        print(f"phase generate-parity: O0 depth 2 T={temp}, streams "
              f"differing {len(rows)} of {GEN_ROWS}; (row, step, top-2 "
              f"gap relative) at the first differing token {gaps} [{card}]")
        if any(g >= 1e-4 for _, _, g in gaps):
            return fail(f"generate-parity T={temp}: streams differ where "
                        f"the top-2 gap is not a near-tie: {gaps}")
    del run

    stamp("generate-parity")

    # 12. train-llama: llama_block at full width, B x S tokens, remat
    llama_out = {}
    for phase, fused_mlp, packed, levels in (
            ("train-llama", False, False, (("O2", 6), ("O2_fp16", 3))),
            ("train-llama-fused-mlp", True, False, (("O2", 3),)),
            ("train-llama-packed", False, True, (("O2", 3),))):
        llama_out[phase], err = run_train_phase(
            torch, ops, card, phase, True, packed, levels, main_launches,
            fuse_head=True, fused_mlp=fused_mlp)
        if err:
            return fail(err)
    f, m = llama_out["train-llama-fused-mlp"]["O2"], \
        llama_out["train-llama"]["O2"]
    print(f"phase train-llama: O2 fused_mlp=True vs False: step wall "
          f"{f['step_wall_ms']:.2f} vs {m['step_wall_ms']:.2f} ms, "
          f"{f['tokens_per_s']:.0f} vs {m['tokens_per_s']:.0f} tokens/s, "
          f"peak memory {f['peak_gib']:.2f} vs {m['peak_gib']:.2f} GiB "
          f"[{card}]")

    stamp("train-llama")

    # 13. train-llama-parity: kernels against the plain versions, depth 2
    llama_out["parity"], err = run_llama_parity(torch, ops, card)
    if err:
        return fail(err)

    stamp("train-llama-parity")

    # 14. serve-llama, generate through llama_decoder, serve-llama-parity
    llama_out["serve"], err = run_serve_llama(torch, ops, card, main_launches)
    if err:
        return fail(err)

    stamp("serve-llama")

    # 15. the BERT slice: the bench's bert_dropout, bert, bert_large, and
    # bert_dropout on a padded batch; then its kernel-vs-plain parity
    bert_out = {}
    for phase, bench, levels, padded in (
            ("train-bert-dropout", "bert_dropout", (("O2", 6),), False),
            ("train-bert", "bert", (("O2", 6),), False),
            ("train-bert-large", "bert_large", (("O2", BERT_LARGE_STEPS),),
             False),
            ("train-bert-padded", "bert_dropout", (("O2", 6),), True)):
        bert_out[phase], err = run_bert_phase(
            torch, ops, card, phase, bench, levels, main_launches,
            padded=padded)
        if err:
            return fail(err)
    stamp("train-bert")
    bert_out["parity"], err = run_bert_parity(torch, ops, card)
    if err:
        return fail(err)
    stamp("train-bert-parity")

    # 16. train-gpt2-dropout: GPT-2 124M, flash, fused head, dropout 0.1
    train_out["train-gpt2-dropout"], err = run_train_phase(
        torch, ops, card, "train-gpt2-dropout", True, False, (("O2", 3),),
        main_launches, fuse_head=True, dropout=0.1)
    if err:
        return fail(err)
    stamp("train-gpt2-dropout")

    # 17-19. the T5 slice: train-t5 (the bench's t5), its kernel-vs-plain
    # parity, and the multihead attention modules
    t5_out = {}
    t5_out["train"], err = run_t5_phase(torch, ops, card, main_launches)
    if err:
        return fail(err)
    stamp("train-t5")
    t5_out["parity"], err = run_t5_parity(torch, ops, card)
    if err:
        return fail(err)
    stamp("train-t5-parity")
    t5_out["mha"], err = run_mha(torch, ops, card, main_launches)
    if err:
        return fail(err)
    stamp("mha")

    # 20-21. the bench's llama_longctx and decode
    llama_out["longctx"], err = run_longctx(torch, ops, card, main_launches)
    if err:
        return fail(err)
    stamp("train-llama-longctx")
    llama_out["decode"], err = run_decode(torch, ops, card, main_launches)
    if err:
        return fail(err)
    stamp("decode")

    # 23-26. the decode slice: the bench's decode_int8 and its parity,
    # multi-tenant LoRA with speculative verify and its parity
    dec_out = {}
    for phase, fn in (("decode-int8", run_decode_int8),
                      ("serve-lora", run_serve_lora)):
        dec_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    for phase, fn in (("decode-int8-parity", run_decode_int8_parity),
                      ("serve-lora-parity", run_serve_lora_parity)):
        dec_out[phase], err = fn(torch, ops, card)
        if err:
            return fail(err)
        stamp(phase)

    # 26-28. the optimizers and amp slice: the bench's resnet, its
    # kernel-vs-plain parity, and the bench's gpt2_fp16
    amp_out = {}
    for phase, fn in (("train-resnet", run_resnet),
                      ("train-gpt2-fp16", run_gpt2_fp16)):
        amp_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    amp_out["resnet-parity"], err = run_resnet_parity(torch, ops, card)
    if err:
        return fail(err)
    stamp("resnet-parity")

    # 29. the multi-GPU slice on a one-rank NCCL group: tensor and
    # sequence parallelism, context parallelism, the vocab-parallel head,
    # data parallelism, and the rdma form's ring-size check
    par_out = {}
    nccl_dir = start_nccl(torch)
    try:
        for phase, fn in (("tp-sp", run_tp_sp), ("cp", run_cp),
                          ("vp-ce", run_vp_ce), ("ddp", run_ddp)):
            par_out[phase], err = fn(torch, ops, card, main_launches)
            if err:
                return fail(err)
            stamp(phase)
        par_out["rdma"], err = run_rdma(torch, ops, card)
        if err:
            return fail(err)
        stamp("rdma")
        # 30-32. the pipeline and expert parallelism slice: the bench's
        # llama_3d at its one-card layout (scan, then 1F1B) and its
        # parity
        par_out["llama_3d"], err = run_llama_3d(torch, ops, card,
                                                main_launches)
        if err:
            return fail(err)
        stamp("train-llama-3d")
        par_out["llama_3d_parity"], err = run_llama_3d_parity(torch, ops,
                                                              card)
        if err:
            return fail(err)
        stamp("llama-3d-parity")
        # 33-36. the sharded data-parallel slice: ZeRO-3 by placement,
        # the distributed Adam and LAMB, the halo-exchanged bottleneck
        for phase, fn in (("train-fsdp", run_fsdp), ("train-zero", run_zero),
                          ("train-bert-lamb", run_bert_lamb),
                          ("spatial-bottleneck", run_spatial)):
            par_out[phase], err = fn(torch, ops, card, main_launches)
            if err:
                return fail(err)
            stamp(phase)
    finally:
        stop_nccl(nccl_dir)

    # 37-38. the T5 generation and contrib slice: the bench's t5 through
    # t5_generate (greedy, beam, sampled), the contrib modules
    slice_out = {}
    for phase, fn in (("generate-t5", run_generate_t5),
                      ("contrib", run_contrib)):
        slice_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    # 39-42. the serving-tier slice: the dense pool, the fleet, the
    # disaggregated pools, speculative decoding
    serve_out = {}
    for phase, fn in (("serve-dense", run_serve_dense),
                      ("serve-fleet", run_serve_fleet),
                      ("disagg", run_disagg),
                      ("speculative", run_speculative)):
        serve_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    # 43-45. the checkpointing and resilience slice: a preempted run
    # resumed bit for bit, the divergence sentinel's skip and rollback,
    # llama_3d resumed on its own stack and resharded onto another
    res_out = {}
    for phase, fn in (("train-resume", run_train_resume),
                      ("train-sentinel", run_train_sentinel)):
        res_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    nccl_dir = start_nccl(torch)
    try:
        res_out["llama-3d-resume"], err = run_llama_3d_resume(
            torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp("llama-3d-resume")
    finally:
        stop_nccl(nccl_dir)
    # 42. the host runtime and the examples
    res_out["examples"], err = run_examples(torch, ops, card, main_launches)
    if err:
        return fail(err)
    stamp("examples")
    # 43-45. the JAX package's other seven examples: the parallel ones in
    # a one-rank NCCL group, the encoder-decoder learners, the serving
    # walkthrough at its 1B config
    ex_out = {}
    nccl_dir = start_nccl(torch)
    try:
        ex_out["examples-parallel"], err = run_examples_parallel(
            torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp("examples-parallel")
    finally:
        stop_nccl(nccl_dir)
    for phase, fn in (("examples-encdec", run_examples_encdec),
                      ("serve-example", run_serve_example)):
        ex_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    # 46-47. the planner's pricing and search on the card, and the elastic
    # drill re-planning 2 gloo ranks onto the card
    # 48-49. the tuning table, the sweep and the budget model's frames
    # against the card's attributes; the trace reader's reports
    for phase, fn in (("planner", run_planner),
                      ("elastic-drill", run_elastic_drill),
                      ("tune", run_tune), ("obs", run_obs)):
        ex_out[phase], err = fn(torch, ops, card, main_launches)
        if err:
            return fail(err)
        stamp(phase)
    print(f"phase times: { {k: round(v, 1) for k, v in phase_s.items()} } "
          f"s wall [{card}]")

    # 48. the kernels line, the card, the last line. launches: the main
    # paths' runs (engine, the train phases, dpo, generate, train-llama,
    # serve-llama and its generate, the BERT phases, train-gpt2-dropout,
    # train-t5, mha, train-llama-longctx, decode, decode-int8, serve-lora,
    # train-resnet, train-gpt2-fp16, tp-sp, cp, vp-ce, ddp,
    # train-llama-3d, train-llama-3d-1f1b, train-fsdp's placed run,
    # train-zero's and train-bert-lamb's ZeRO runs, generate-t5's calls,
    # contrib's kernel cases, serve-dense's dense run, serve-fleet's
    # drill, disagg's clean run, speculative's greedy call, train-resume's
    # uninterrupted run, llama-3d-resume's two resumed steps, the
    # examples' gpt2_amp and imagenet_amp runs through the prefetcher,
    # examples-parallel's llama_distributed, gpt2_pp_tied and two
    # llama_3d runs, examples-encdec's t5_seq2seq, serve-example's
    # serving_llama, planner's three llama_3d runs, elastic-drill's
    # resumed and control steps)
    sources = {"layer_norm_fwd": ("apex1_tpu_torch/csrc/layer_norm.cu",
                                  "apex1_tpu/ops/layer_norm.py:110"),
               "paged_attend": ("apex1_tpu_torch/csrc/paged_attend.cu",
                                "apex1_tpu/ops/paged_decode.py:529"),
               "fused_sample": ("apex1_tpu_torch/csrc/fused_sample.cu",
                                "apex1_tpu/ops/paged_decode.py:300"),
               "layer_norm_bwd": ("apex1_tpu_torch/csrc/layer_norm_bwd.cu",
                                  "apex1_tpu/ops/layer_norm.py:135"),
               "softmax_fwd": ("apex1_tpu_torch/csrc/softmax.cu",
                               "apex1_tpu/ops/softmax.py:60"),
               "softmax_bwd": ("apex1_tpu_torch/csrc/softmax.cu",
                               "apex1_tpu/ops/softmax.py:95"),
               "xent_fwd": ("apex1_tpu_torch/csrc/xentropy.cu",
                            "apex1_tpu/ops/xentropy.py:88"),
               "xent_bwd": ("apex1_tpu_torch/csrc/xentropy.cu",
                            "apex1_tpu/ops/xentropy.py:114"),
               "flash_fwd": ("apex1_tpu_torch/csrc/flash_wg.cuh",
                             "apex1_tpu/ops/attention.py:584"),
               "flash_dq": ("apex1_tpu_torch/csrc/flash_wg.cuh",
                            "apex1_tpu/ops/attention.py:689"),
               "flash_dkv": ("apex1_tpu_torch/csrc/flash_wg.cuh",
                             "apex1_tpu/ops/attention.py:717"),
               "flash_dbias": ("apex1_tpu_torch/csrc/flash_wg.cuh",
                               "apex1_tpu/ops/attention.py:780"),
               "lxent_fwd": ("apex1_tpu_torch/csrc/linear_xent_fwd.cu",
                             "apex1_tpu/ops/linear_xent.py:384, :286, "
                             ":316"),
               "lxent_dx": ("apex1_tpu_torch/csrc/linear_xent_bwd.cu",
                            "apex1_tpu/ops/linear_xent.py:345"),
               "lxent_dw": ("apex1_tpu_torch/csrc/linear_xent_bwd.cu",
                            "apex1_tpu/ops/linear_xent.py:357"),
               "rope": ("apex1_tpu_torch/csrc/rope.cu",
                        "apex1_tpu/ops/rope.py:51"),
               "glu_fwd": ("apex1_tpu_torch/csrc/glu.cu",
                           "apex1_tpu/ops/fused_dense.py:201"),
               "bda_fwd": ("apex1_tpu_torch/csrc/bias_dropout_add.cu",
                           "apex1_tpu/ops/stochastic.py:210"),
               "bda_bwd": ("apex1_tpu_torch/csrc/bias_dropout_add.cu",
                           "apex1_tpu/ops/stochastic.py:234"),
               "int8_mm": ("apex1_tpu_torch/csrc/int8_matmul.cu",
                           "apex1_tpu/ops/quantized.py:106"),
               "lora_delta": ("apex1_tpu_torch/csrc/lora_delta.cu",
                              "apex1_tpu/ops/lora_epilogue.py:126"),
               "chunk_matmul": ("apex1_tpu_torch/csrc/chunk_matmul.cu",
                                "apex1_tpu/ops/fused_collective.py:158, "
                                ":177, :883"),
               "flash_fwd_merge": ("apex1_tpu_torch/csrc/flash_wg.cuh",
                                   "apex1_tpu/ops/fused_collective.py:496")}
    kernels = []
    for name, rows in checks.items():
        main_row = next(r for r in rows if r["main"])
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": main_launches[name],
            "max_abs_err": max(r["abs"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "checks": checks, "kernels": kernels,
                   "engine": {"wall_s": wall, "tokens": n_tok,
                              "step_ms": step_ms, "summary": summ},
                   "train": train_out, "train_parity": par,
                   "dpo": dpo_out, "generate": gen_out, "llama": llama_out,
                   "bert": bert_out, "t5": t5_out, "decode": dec_out,
                   "amp": amp_out, "parallel": par_out,
                   "t5_contrib": slice_out, "serving": serve_out,
                   "resilience": res_out, "examples": ex_out,
                   "phase_s": phase_s},
                  f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
