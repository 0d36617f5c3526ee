"""The benchmark of ``ray_tpu_torch`` on an NVIDIA H100.

``python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints its result as the last line of standard output. Every
cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), and the mix names its driver
(``drivers/<name>.py``); every per-layer metric is a reader of its own
(``metrics/<name>.py``). A cell, a configuration, a mix or a metric is added
as new files and new entries, without editing a file that is here."""
