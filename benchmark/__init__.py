"""The benchmark of ca_lanczos_tpu_torch (see harness.py and BENCHMARK.json)."""
