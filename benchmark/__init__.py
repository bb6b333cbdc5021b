"""The benchmark of conditioned_nerf_gan_torch on NVIDIA H100 cards.

`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once; see run.py.
"""
