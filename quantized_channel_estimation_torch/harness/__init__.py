"""Benchmark harness (port of `quantized_channel_estimation_tpu.harness`)."""
