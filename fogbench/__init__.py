"""The benchmark of the FLIC fog simulator's PyTorch and CUDA port
(``repro_torch``): ``python3 fogbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  Cells are in ``BENCHMARK.json``; see
``harness.py`` for what a run does."""
