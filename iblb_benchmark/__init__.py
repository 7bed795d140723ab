"""The benchmark of cuda_iblb_11_tpu_torch on NVIDIA GPUs.

``python3 -m iblb_benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json once (run.py); the cell's
pieces are data found by name: configs/, traffic/, workloads/, metrics/
and counts/.  reference/ is the plain model the check (check.py) holds
the program to; control.py reads the check's limits' two sides.  A new
configuration or cell is added by files and appended BENCHMARK.json
entries alone: nothing here, and no test, keys on its name.  Nothing here
imports JAX or the JAX package.
"""
