"""Per-layer workload model.

The paper's allocator (Algorithms 1 and 2) operates on per-layer workload
numbers: MAC count ``pi_i = H*W*R*S*C*M``, weight volume, and activation row
sizes. This module provides those numbers for CNN graphs exactly as the
paper defines them. It is a copy of ``repro/core/workload.py`` without the
transformer-family workloads (``lm_layer_workloads``), which arrive with the
port's LM slice.

Conventions
-----------
* ``macs``: multiply-accumulates per *frame* (CNN) or per *token-batch unit*
  (LM; see :class:`LayerWorkload.unit`). GOP numbers in the paper count
  2 ops per MAC.
* ``weight_bytes``: bytes of parameters the layer must have resident to
  compute (at the workload's quantization width).
* All CNN spatial sizes follow the paper's Eq. (1): input is
  ``C x (H+R-1) x (W+S-1)`` (i.e. "same" padding), output ``M x H x W`` at
  stride 1; stride G divides the output size.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

# ---------------------------------------------------------------------------
# Generic layer workload record (what the allocator consumes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerWorkload:
    """One pipeline-stage candidate, reduced to what Algorithms 1/2 need."""

    name: str
    macs: int                       # MACs per frame / per microbatch-token-group
    weight_bytes: int               # resident parameter bytes
    act_in_bytes: int               # activation bytes consumed per unit
    act_out_bytes: int              # activation bytes produced per unit
    kind: str = "generic"           # conv | pool | fc | attn | mlp | moe | ...
    # CNN-specific fields used by the faithful FPGA allocator. For
    # non-conv layers they keep neutral defaults (R=S=1, G=1).
    R: int = 1
    S: int = 1
    stride: int = 1
    C: int = 1                      # input channels (parallelism bound)
    M: int = 1                      # output channels (parallelism bound)
    H: int = 1                      # output rows
    W: int = 1                      # output cols

    @property
    def flops(self) -> int:
        return 2 * self.macs


# ---------------------------------------------------------------------------
# CNN graphs (paper substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    in_ch: int
    out_ch: int
    kernel: int                     # R == S (all four paper models are square)
    stride: int = 1
    kind: Literal["conv", "fc", "pool"] = "conv"
    groups: int = 1                 # AlexNet's two-tower grouped convs
    out_size: int | None = None     # explicit output H=W (valid-padding cases)

    def out_hw(self, in_hw: int) -> int:
        if self.kind == "fc":
            return 1
        if self.out_size is not None:
            return self.out_size
        return in_hw // self.stride

    def padding(self, in_hw: int) -> tuple[int, int]:
        """Explicit (lo, hi) spatial padding reproducing each model's
        published output sizes (SAME for stride-1, VALID-like for the
        stride-k stems; asymmetric when the arithmetic demands it)."""
        out_hw = self.out_hw(in_hw)
        need = max((out_hw - 1) * self.stride + self.kernel - in_hw, 0)
        lo = need // 2
        return lo, need - lo


@dataclasses.dataclass(frozen=True)
class CNNModel:
    name: str
    input_hw: int
    input_ch: int
    layers: tuple[ConvLayer, ...]

    def layer_workloads(self, weight_bits: int = 16) -> list[LayerWorkload]:
        """Expand the graph into per-layer workloads (paper's pi/omega)."""
        wb = weight_bits // 8
        out: list[LayerWorkload] = []
        hw = self.input_hw
        for lyr in self.layers:
            o_hw = lyr.out_hw(hw)
            if lyr.kind == "pool":
                # Pooling has no MACs/weights; it is a pipeline stage that
                # only shrinks H (paper folds it into the stride product G).
                out.append(
                    LayerWorkload(
                        name=lyr.name, macs=0, weight_bytes=0,
                        act_in_bytes=hw * hw * lyr.in_ch * wb,
                        act_out_bytes=o_hw * o_hw * lyr.out_ch * wb,
                        kind="pool", R=lyr.kernel, S=lyr.kernel,
                        stride=lyr.stride, C=lyr.in_ch, M=lyr.out_ch,
                        H=o_hw, W=o_hw,
                    )
                )
            else:
                if lyr.kind == "fc":
                    h = w = 1
                    r = s = 1
                    macs = lyr.in_ch * lyr.out_ch
                    wbytes = lyr.in_ch * lyr.out_ch * wb
                    cin = lyr.in_ch
                else:
                    h = w = o_hw
                    r = s = lyr.kernel
                    cin_g = lyr.in_ch // lyr.groups
                    macs = h * w * r * s * cin_g * lyr.out_ch
                    wbytes = r * s * cin_g * lyr.out_ch * wb
                    cin = lyr.in_ch
                out.append(
                    LayerWorkload(
                        name=lyr.name, macs=macs, weight_bytes=wbytes,
                        act_in_bytes=hw * hw * cin * wb,
                        act_out_bytes=h * w * lyr.out_ch * wb,
                        kind=lyr.kind, R=r, S=s, stride=lyr.stride,
                        C=cin if lyr.kind == "fc" else lyr.in_ch // lyr.groups,
                        M=lyr.out_ch, H=h, W=w,
                    )
                )
            hw = o_hw
        return out

    @property
    def gop(self) -> float:
        """Model complexity in GOP (2 ops / MAC), as quoted by the paper."""
        return 2 * sum(l.macs for l in self.layer_workloads()) / 1e9


def _vgg_block(idx: int, n: int, cin: int, cout: int) -> list[ConvLayer]:
    ls = [ConvLayer(f"conv{idx}_{i+1}", cin if i == 0 else cout, cout, 3)
          for i in range(n)]
    ls.append(ConvLayer(f"pool{idx}", cout, cout, 2, stride=2, kind="pool"))
    return ls


def vgg16() -> CNNModel:
    layers: list[ConvLayer] = []
    layers += _vgg_block(1, 2, 3, 64)
    layers += _vgg_block(2, 2, 64, 128)
    layers += _vgg_block(3, 3, 128, 256)
    layers += _vgg_block(4, 3, 256, 512)
    layers += _vgg_block(5, 3, 512, 512)
    layers += [
        ConvLayer("fc6", 512 * 7 * 7, 4096, 1, kind="fc"),
        ConvLayer("fc7", 4096, 4096, 1, kind="fc"),
        ConvLayer("fc8", 4096, 1000, 1, kind="fc"),
    ]
    return CNNModel("vgg16", 224, 3, tuple(layers))


def alexnet() -> CNNModel:
    # Canonical two-tower AlexNet (grouped conv2/4/5). 1.45 GOP — matches
    # the paper's quoted complexity.
    layers = (
        ConvLayer("conv1", 3, 96, 11, stride=4, out_size=55),
        ConvLayer("pool1", 96, 96, 3, stride=2, kind="pool", out_size=27),
        ConvLayer("conv2", 96, 256, 5, groups=2, out_size=27),
        ConvLayer("pool2", 256, 256, 3, stride=2, kind="pool", out_size=13),
        ConvLayer("conv3", 256, 384, 3, out_size=13),
        ConvLayer("conv4", 384, 384, 3, groups=2, out_size=13),
        ConvLayer("conv5", 384, 256, 3, groups=2, out_size=13),
        ConvLayer("pool5", 256, 256, 3, stride=2, kind="pool", out_size=6),
        ConvLayer("fc6", 256 * 6 * 6, 4096, 1, kind="fc"),
        ConvLayer("fc7", 4096, 4096, 1, kind="fc"),
        ConvLayer("fc8", 4096, 1000, 1, kind="fc"),
    )
    return CNNModel("alexnet", 227, 3, layers)


def zfnet() -> CNNModel:
    # ZF-Net (Zeiler & Fergus). 2.33 GOP — paper quotes 2.34.
    layers = (
        ConvLayer("conv1", 3, 96, 7, stride=2, out_size=110),
        ConvLayer("pool1", 96, 96, 3, stride=2, kind="pool", out_size=55),
        ConvLayer("conv2", 96, 256, 5, stride=2, out_size=26),
        ConvLayer("pool2", 256, 256, 3, stride=2, kind="pool", out_size=13),
        ConvLayer("conv3", 256, 384, 3, out_size=13),
        ConvLayer("conv4", 384, 384, 3, out_size=13),
        ConvLayer("conv5", 384, 256, 3, out_size=13),
        ConvLayer("pool5", 256, 256, 3, stride=2, kind="pool", out_size=6),
        ConvLayer("fc6", 256 * 6 * 6, 4096, 1, kind="fc"),
        ConvLayer("fc7", 4096, 4096, 1, kind="fc"),
        ConvLayer("fc8", 4096, 1000, 1, kind="fc"),
    )
    return CNNModel("zf", 224, 3, layers)


def yolo() -> CNNModel:
    # YOLOv1-style 24-conv detector (448x448). Paper quotes 40.14 GOP.
    L = ConvLayer
    layers = [
        L("conv1", 3, 64, 7, stride=2),
        L("pool1", 64, 64, 2, stride=2, kind="pool"),
        L("conv2", 64, 192, 3),
        L("pool2", 192, 192, 2, stride=2, kind="pool"),
        L("conv3", 192, 128, 1),
        L("conv4", 128, 256, 3),
        L("conv5", 256, 256, 1),
        L("conv6", 256, 512, 3),
        L("pool6", 512, 512, 2, stride=2, kind="pool"),
    ]
    for i in range(4):
        layers += [L(f"conv{7+2*i}", 512, 256, 1), L(f"conv{8+2*i}", 256, 512, 3)]
    layers += [
        L("conv15", 512, 512, 1),
        L("conv16", 512, 1024, 3),
        L("pool16", 1024, 1024, 2, stride=2, kind="pool"),
        L("conv17", 1024, 512, 1),
        L("conv18", 512, 1024, 3),
        L("conv19", 1024, 512, 1),
        L("conv20", 512, 1024, 3),
        L("conv21", 1024, 1024, 3),
        L("conv22", 1024, 1024, 3, stride=2),
        L("conv23", 1024, 1024, 3),
        L("conv24", 1024, 1024, 3),
        L("fc25", 1024 * 7 * 7, 4096, 1, kind="fc"),
        L("fc26", 4096, 7 * 7 * 30, 1, kind="fc"),
    ]
    return CNNModel("yolo", 448, 3, tuple(layers))


CNN_MODELS = {"vgg16": vgg16, "alexnet": alexnet, "zf": zfnet, "yolo": yolo}


def total_params(layers: Sequence[LayerWorkload], dtype_bytes: int = 2) -> int:
    return sum(l.weight_bytes for l in layers) // dtype_bytes


def model_flops(layers: Sequence[LayerWorkload], train: bool) -> int:
    """MODEL_FLOPS = 6*N*D-style useful flops (fwd 2x, train 6x per MAC)."""
    fwd = 2 * sum(l.macs for l in layers)
    return 3 * fwd if train else fwd
