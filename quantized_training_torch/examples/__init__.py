"""The port's example scripts, run as ``python -m
quantized_training_torch.examples.<name>``."""
