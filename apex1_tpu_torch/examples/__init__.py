"""The JAX package's ten examples on the port (each a script with a
``main(argv=None)`` that tests and ``chip_smoke.py`` call in-process;
each takes the JAX script's flags, with the same names and defaults,
and ``--device``):

- `gpt2_amp`: GPT-2 under amp from a token file through `TokenDataset`
  and `PrefetchLoader`; the resilient loop (checkpoints, sentinel,
  preemption) and the telemetry spine.
- `imagenet_amp`: ResNet-50 under amp with SyncBN and data parallelism
  over ranks, images normalized and prefetched.
- `distributed_data_parallel`: the data-parallel hello world.
- `llama_distributed`: a tiny Llama with its params placed by their TP
  specs (and ZeRO over fsdp) on the (dp, fsdp, tp) mesh.
- `gpt2_pp_tied`: GPT-2 blocks as pipeline stages with the embedding
  and LM head tied across the first and last stage.
- `llama_3d`: `models.llama_3d` on a hand layout checked by
  `planner.check_layout`, under the resilient runtime with the stated
  plan banked.
- `t5_seq2seq`: T5 trained to sort, then `t5_generate`.
- `rnnt_speech`: an LSTM transducer trained on synthetic phonemes, then
  greedy RNN-T decoding.
- `dcgan_amp`: two networks, two `Amp`s, flax-style batch norm as aux
  state.
- `serving_llama`: greedy, ragged, beam, int8, speculative and
  prefix-cached decoding of one Llama (1B on a card).

Run one with ``python -m apex1_tpu_torch.examples.<name> [args]`` (on
the CPU: ``--device cpu``, with ``--tiny`` where the script has it), or
under ranks with ``python -m apex1_tpu_torch.parallel.multiproc --nproc
N apex1_tpu_torch/examples/<name>.py [args]`` (the repo root on
``PYTHONPATH``).
"""
