"""Data and tensor parallelism over `torch.distributed` (port of
`quantized_channel_estimation_tpu.parallel`)."""
