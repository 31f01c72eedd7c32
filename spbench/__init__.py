"""The benchmark of ``sparse_linear_tpu_torch``, the PyTorch / CUDA port.

One run measures one cell of ``BENCHMARK.json`` on one NVIDIA GPU:

    python3 spbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``configs/<config>.json``: the operator family, its size and its
  guarantees (tolerance, precision);
* ``workloads/<cell>.json``: the cell's configuration, driver, traffic
  parameters and correctness limits;
* ``operators/<generator>.py``: the benchmark's own generators of triples;
* ``drivers/<driver>.py``: one kind of traffic (set-up, one request, the
  check of what the requests returned);
* ``metrics/<metric>.py``: one reader per metric;
* ``reference/``: the plain reference (plain PyTorch and NumPy, nothing of
  the port) that decides ``correct``.

Nothing here imports JAX or the JAX package ``sparse_linear_tpu``.
"""
