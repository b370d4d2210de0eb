"""The benchmark of sickle_tpu_torch: whole-file paired-end trimming on one H100.

Run one cell once with ``python3 -m trimbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
names the cells.  Importing this package imports nothing.
"""
