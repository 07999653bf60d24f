"""The benchmark of ``siss_tpu_torch`` on one NVIDIA card.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything that belongs to one configuration, traffic mix, per-layer metric
or cell's limits is a file of its own, found by the name in the manifest
(``portbench.manifest``).
"""
