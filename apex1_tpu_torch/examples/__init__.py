"""The JAX package's examples on the port (each a script with a
``main(argv=None)`` that tests and ``chip_smoke.py`` call in-process):

- `gpt2_amp`: GPT-2 under amp from a token file through `TokenDataset`
  and `PrefetchLoader`; the resilient loop (checkpoints, sentinel,
  preemption) and the telemetry spine.
- `imagenet_amp`: ResNet-50 under amp with SyncBN and data parallelism
  over ranks, images normalized and prefetched.
- `distributed_data_parallel`: the data-parallel hello world.

Run one with ``python -m apex1_tpu_torch.examples.<name> [args]``, or
under ranks with ``python -m apex1_tpu_torch.parallel.multiproc --nproc
N apex1_tpu_torch/examples/<name>.py [args]`` (the repo root on
``PYTHONPATH``). The other seven examples of the JAX package wait (ROADMAP.md queue A
item 15)."""
