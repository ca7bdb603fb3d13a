"""The benchmark of the PyTorch and CUDA port (``gpssim_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that measures or judges the program lives here:
the traffic generator (``workload``), the driver of the program's entry
points (``drive``), the profiler window and its reductions
(``tracing``), the peaks and bounds (``yardstick``), one reader per
per-layer metric (``metrics/``), and the plain reference that decides
``correct`` (``reference/``). It imports neither JAX nor the JAX
package.
"""
