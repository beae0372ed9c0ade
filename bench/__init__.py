"""The benchmark of the PyTorch/CUDA port (``repro_torch``): the int8 CNN
engine served on one GPU. Entry point: ``python3 bench/run.py``."""
