"""Benchmark of the PyTorch / CUDA port, megatts2_hierspeechpp_torch.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Configurations, traffic mixes, per-layer metric readers and work
counts are files of their own under configs/, traffic/, metrics/ and
counts/, found by the names in BENCHMARK.json."""
