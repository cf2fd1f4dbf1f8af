"""The PyTorch/CUDA port's benchmark: ``python benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` on the card and prints one JSON line."""
