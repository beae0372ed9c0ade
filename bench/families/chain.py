"""The ``chain`` family: a linear chain of conv, max-pool and fc layers, ReLU
fused into every layer but the last, as ``repro_torch``'s ``CNNModel`` runs
it (AlexNet, VGG16). A configuration that names no family is of this one."""

from __future__ import annotations

from bench.core.drive import compile_program
from bench.core.inputs import make_params
from bench.reference.cnn_int8 import logits
from bench.roofline.counts import least_seconds, ops_per_frame

__all__ = ["make_params", "compile_program", "logits", "ops_per_frame",
           "least_seconds"]
