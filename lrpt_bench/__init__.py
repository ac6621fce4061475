"""The benchmark of meteor_demod_tpu_torch on one NVIDIA H100.

`python3 lrpt_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json from the root of a checkout.
Everything is found by name: a cell's configuration in configs/, its traffic
mix in traffic/, the driver of the mix's kind in drivers/, each per-layer
metric's reader in layer_metrics/, the kernel-name map in kernels/ and the
work counts in work/. The plain reference that decides `correct` lives in
reference/ and imports nothing of the program.
"""
