"""Metrics and I/O (port of `quantized_channel_estimation_tpu.utils`)."""
