"""The benchmark of the PyTorch and CUDA port, `sgdnet_tpu_torch`.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once on the card and prints one JSON
line.  Nothing here imports JAX or the JAX package; only `adapter.py`
calls into the port.
"""
