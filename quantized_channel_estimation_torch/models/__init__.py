"""Mixture models and the GMM estimator (port of
`quantized_channel_estimation_tpu.models`)."""
