"""The JAX package's quality and eval scripts, ported: `train_hard` (the
hard-scene training run) and `bench_eval` (eval throughput on its
checkpoint), each run as `python -m tngp_torch.scripts.<name>`."""
