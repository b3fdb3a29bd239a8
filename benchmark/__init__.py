"""The benchmark of the PyTorch/CUDA port (`BENCHMARK.json`, `python3 -m
benchmark.run`)."""
