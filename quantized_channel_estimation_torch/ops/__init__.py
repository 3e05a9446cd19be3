"""Numerical building blocks (port of
`quantized_channel_estimation_tpu.ops`)."""
