"""The benchmark of tpudf_torch on one H100: `python benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`. BENCHMARK.json
at the root names the cells; each cell's configuration, traffic mix,
per-layer metric readers and output limits are files of their own under
this folder, found by name."""
