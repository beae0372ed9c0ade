"""PyTorch / CUDA port of the int8 layer-pipelined CNN engine for one
NVIDIA H100, beside the JAX reference package ``repro``."""
