"""PyTorch / CUDA port, for one NVIDIA H100, of the int8 layer-pipelined
CNN engine and the LM substrate's dense decoders, beside the JAX
reference package ``repro``."""
