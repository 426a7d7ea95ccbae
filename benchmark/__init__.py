"""The benchmark of prior_flow_tpu_torch on one NVIDIA card: ``python -m
benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
