"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 -m bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line. Everything that belongs to one configuration
(``configs/<name>.json``), one traffic mix (``traffic/<name>.json``), one
cell's correctness limits (``checks/<cell>.json``) or one metric
(``metrics/<name>.py``) sits in a file of its own, found by name.
"""
