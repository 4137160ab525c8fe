"""rtbench: the benchmark of refraction_tpu_torch on one CUDA card.

    python3 -m rtbench.run --workload ref_demo.orbit --seed 7 --seconds 10 --trace 0

`BENCHMARK.json` at the repository root names the cells; each cell's
configuration (``rtbench/configs/<name>.json``), traffic mix
(``rtbench/traffic/<name>.json``) and per-layer metric reader
(``rtbench/metrics/<name>.py``) is found by its name there. The plain
reference that decides ``correct`` is ``rtbench/reference``; it imports
nothing of the program.
"""
