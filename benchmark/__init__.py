"""The benchmark of the PyTorch/CUDA port (svision_tpu_torch).

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once; README.md in this
folder says how the cells, configurations, traffic mixes, drivers and
metrics are laid out as files.
"""
