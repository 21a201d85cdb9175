"""The benchmark of the PyTorch and CUDA port (`tngp_torch`): BENCHMARK.json
at the root of the repository names its cells; `run.py` runs one."""
