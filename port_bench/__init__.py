"""The benchmark of ``sequential_monte_carlo_tpu_torch`` on one NVIDIA H100.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell once. Everything a
cell needs is found by name: ``BENCHMARK.json`` at the root, the cell's
``workloads/<cell>.json``, its ``configs/<config>.json``, one
``metrics/<metric>.py`` reader a metric and one ``entries/<entry>.py``
driver an entry point. The reference (``reference/``) and the counts
(``counts/``) are the yardstick and import nothing of the program.
"""
