"""Estimators and their kernels (port of
`quantized_channel_estimation_tpu.estimators`)."""
