"""The ``resnet`` family: a residual CNN (ResNet-50 v1.5) whose layers may
read an earlier layer's output (``src``), add a skip before their ReLU
(``residual``), set their own padding and ReLU, and end in a global
average pool (``gap``), as ``repro_torch``'s ``CNNModel`` runs it. The
program is compiled as the chain's is; the reference and the roofline
counts are the residual graph's own."""

from __future__ import annotations

from bench.core import inputs
from bench.core.drive import compile_program
from bench.reference.resnet_int8 import logits
from bench.roofline.resnet_counts import least_seconds, ops_per_frame

__all__ = ["make_params", "compile_program", "logits", "ops_per_frame",
           "least_seconds"]


def make_params(cfg: dict, seed: int, device) -> dict:
    """The float weights of the conv and fc layers (the pools have none),
    drawn as the chain family draws them."""
    engines = [l for l in cfg["layers"] if l["kind"] in ("conv", "fc")]
    return inputs.make_params(dict(cfg, layers=engines), seed, device)
