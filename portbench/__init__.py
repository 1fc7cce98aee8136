"""portbench: the benchmark of vector_indexer_tpu_torch (the PyTorch and CUDA port).

Run one cell once with ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; see README.md. Nothing here imports JAX or the
JAX package, and ``reference.py`` imports nothing of the port.
"""
