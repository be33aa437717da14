"""The benchmark of the PyTorch and CUDA port (`p64tpu_torch`).

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on one card and prints
one JSON line; `--list` prints the cells and their metrics.  See
`harness.py`.
"""
