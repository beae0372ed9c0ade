"""Compiler front door: import arbitrary CNNs into the serving zoo.
PyTorch twin of ``repro/compiler/__init__.py``.

The paper's flexible-pipeline flow (workload -> Algorithm-1/2
allocation -> pipelined engines) is model-agnostic by construction;
this package supplies the missing mapping layer that FPGA toolflows
put in front of such a fabric (Guo et al., arXiv:1712.08934):

``graph``        framework-neutral IR + JSON/dict ingestion (no deps)
``onnx_import``  optional ONNX ingestion (importlib-guarded)
``lower``        normalize/legalize the IR onto the engine contract
``calibrate``    PTQ calibration + int8 golden parity artifacts

:func:`import_source` is the one-call entry: anything describing a CNN
(in-memory :class:`Graph`, spec dict, ``.json`` path, ``.onnx`` path)
-> ``(CNNModel, params-or-None)`` ready for
``core.program.compile_model``; imported weights are tensors on
``device`` (default ``cuda``).
"""

from __future__ import annotations

import os
from typing import Any

from repro_torch.compiler.calibrate import (GoldenMismatch, check_golden,
                                            golden_frames, load_golden,
                                            make_golden, quantize,
                                            save_golden)
from repro_torch.compiler.graph import (Graph, GraphError, Node,
                                        UnsupportedOpError, from_spec,
                                        load_spec)
from repro_torch.compiler.lower import lower_graph
from repro_torch.compiler.onnx_import import load_onnx, onnx_available


def import_graph(source: Any) -> Graph:
    """Resolve any supported source into the neutral :class:`Graph`:
    a ``Graph`` passes through, a dict goes through :func:`from_spec`,
    a path dispatches on suffix (``.onnx`` -> the guarded ONNX reader,
    anything else -> the JSON spec loader)."""
    if isinstance(source, Graph):
        return source
    if isinstance(source, dict):
        return from_spec(source)
    if isinstance(source, (str, os.PathLike)):
        if str(source).lower().endswith(".onnx"):
            return load_onnx(source)
        return load_spec(source)
    raise TypeError(
        f"cannot import from {type(source).__name__}: expected a Graph, "
        f"a spec dict, or a path to a .json spec / .onnx file")


def import_source(source: Any, *, device=None):
    """Import + lower in one call: ``source`` -> engine-ready
    ``(CNNModel, params-or-None)``, imported weights on ``device``.
    Raises :class:`GraphError` / :class:`UnsupportedOpError` at the front
    door for anything the engine cannot run."""
    return lower_graph(import_graph(source), device=device)


__all__ = [
    "Graph", "GraphError", "Node", "UnsupportedOpError",
    "from_spec", "load_spec", "load_onnx", "onnx_available",
    "lower_graph", "import_graph", "import_source",
    "quantize", "make_golden", "check_golden", "GoldenMismatch",
    "golden_frames", "save_golden", "load_golden",
]
