"""The benchmark of the PyTorch/CUDA port (``repro_torch``): closed loops
of ODCL server rounds, one cell per entry of ``BENCHMARK.json``.  Run
``python3 odcl_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root."""
