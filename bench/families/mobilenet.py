"""The ``mobilenet`` family: MobileNetV2's inverted residual graph, as
``repro_torch``'s ``CNNModel`` runs it: 1x1 expansions, 3x3 depthwise convs
(``groups`` equal to their channels) and ReLU6 (``relu6``) after both, linear
1x1 projections that add the block's input where they name a ``residual``
(no activation after the add), the global average pool and an fc. The
weights are the chain family's draw and the program is compiled as the
chain's is; the reference and the roofline counts are the family's own."""

from __future__ import annotations

from bench.core.drive import compile_program
from bench.families.resnet import make_params
from bench.reference.mobilenet_int8 import logits
from bench.roofline.mobilenet_counts import least_seconds, ops_per_frame

__all__ = ["make_params", "compile_program", "logits", "ops_per_frame",
           "least_seconds"]
