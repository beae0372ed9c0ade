"""Per-layer workload model.

The paper's allocator (Algorithms 1 and 2) operates on per-layer workload
numbers: MAC count ``pi_i = H*W*R*S*C*M``, weight volume, and activation row
sizes. This module provides those numbers for CNN graphs exactly as the
paper defines them, and for the transformer-family configs
(``lm_layer_workloads``, which the elastic re-plan of
``runtime/fault_tolerance.py`` feeds to the allocator). It began as a copy
of ``repro/core/workload.py``; the residual graph (ResNet-50 v1.5: explicit
padding, per-layer ReLU, layers that read an earlier output, the skip
added in an engine's epilogue, the global average pool) and MobileNetV2's
inverted residuals (ReLU6, depthwise convs, skips with no activation
after the add) are the port's own.

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
    """One layer of a CNN graph. The defaults make a linear chain: a layer
    reads the previous layer's output, ReLU follows every compute layer
    but the last, and the padding is derived from the output size.

    A residual graph (ResNet) sets, where it differs: ``pad``, the
    published ``(lo, hi)`` padding of both spatial dims (the output size
    then follows from it); ``relu``; ``src``, the name of the earlier
    layer whose output this one reads; ``residual``, the name of the
    earlier layer whose output is added to this one's accumulators before
    its ReLU (the bottleneck's skip). ``kind="gap"`` is the global
    average pool over the whole map (``kernel`` is the map's side).

    MobileNetV2 sets ``relu6``: ReLU6, ``min(max(x, 0), 6)``, a ReLU whose
    output is also held at 6 (``relu`` None or True with it); and makes
    its depthwise convs ``groups == in_ch == out_ch``
    (:attr:`depthwise`)."""

    name: str
    in_ch: int
    out_ch: int
    kernel: int                     # R == S (all four paper models are square)
    stride: int = 1
    kind: Literal["conv", "fc", "pool", "gap"] = "conv"
    groups: int = 1                 # AlexNet's two-tower grouped convs
    out_size: int | None = None     # explicit output H=W (valid-padding cases)
    pad: tuple[int, int] | None = None     # explicit (lo, hi) padding
    relu: bool | None = None        # None: every compute layer but the last
    src: str | None = None          # None: the previous layer's output
    residual: str | None = None     # the skip added before ReLU, if any
    relu6: bool = False             # ReLU6: the ReLU's output held at 6

    def __post_init__(self):
        if self.pad is not None:    # a list from a JSON file, too
            object.__setattr__(self, "pad", tuple(int(p) for p in self.pad))
        if self.relu6:
            if self.relu is False or not self.computes:
                raise ValueError(f"layer {self.name}: ReLU6 is a compute "
                                 f"layer's ReLU held at 6")
            object.__setattr__(self, "relu", True)

    @property
    def depthwise(self) -> bool:
        """Whether the layer is a depthwise conv: one input channel per
        output channel (``groups == in_ch == out_ch``)."""
        return self.kind == "conv" and 1 < self.groups == self.in_ch \
            == self.out_ch

    @property
    def computes(self) -> bool:
        """Whether the layer is an engine with weights (conv or fc)."""
        return self.kind in ("conv", "fc")

    def out_hw(self, in_hw: int) -> int:
        if self.kind in ("fc", "gap"):
            return 1
        if self.out_size is not None:
            return self.out_size
        if self.pad is not None:
            return (in_hw + sum(self.pad) - self.kernel) // self.stride + 1
        return in_hw // self.stride

    def padding(self, in_hw: int) -> tuple[int, int]:
        """Explicit (lo, hi) spatial padding: the layer's own ``pad``, or
        the padding that reproduces each model's published output sizes
        (SAME for stride-1, VALID-like for the stride-k stems; asymmetric
        when the arithmetic demands it)."""
        if self.pad is not None:
            return self.pad
        if self.kind == "gap":
            return 0, 0
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

    def __post_init__(self):
        seen: set[str] = set()
        for lyr in self.layers:
            for ref in (lyr.src, lyr.residual):
                if ref is not None and ref not in seen:
                    raise ValueError(f"{self.name}: layer {lyr.name} reads "
                                     f"{ref!r}, which is not an earlier "
                                     f"layer")
            if lyr.name in seen:
                raise ValueError(f"{self.name}: two layers named "
                                 f"{lyr.name!r}")
            seen.add(lyr.name)

    @property
    def linear(self) -> bool:
        """Whether every layer reads only the previous one's output."""
        return all(l.src is None and l.residual is None for l in self.layers)

    def sources(self) -> list[int]:
        """The index of the layer each layer reads (-1: the frames)."""
        index = {l.name: i for i, l in enumerate(self.layers)}
        return [index[l.src] if l.src is not None else i - 1
                for i, l in enumerate(self.layers)]

    def reads(self) -> list[tuple[int, ...]]:
        """The outputs each layer reads (-1: the frames): its source, then
        the skip it adds, where it adds one."""
        index = {l.name: i for i, l in enumerate(self.layers)}
        return [(src,) if l.residual is None else (src, index[l.residual])
                for src, l in zip(self.sources(), self.layers)]

    def in_sizes(self) -> list[int]:
        """Each layer's input side H = W."""
        out: list[int] = []
        for i, src in enumerate(self.sources()):
            hw = self.input_hw if src < 0 else \
                self.layers[src].out_hw(out[src])
            out.append(hw)
        return out

    def layer_workloads(self, weight_bits: int = 16) -> list[LayerWorkload]:
        """Expand the graph into per-layer workloads (paper's pi/omega). A
        projection shortcut is an engine like any conv; a residual add is
        free in its engine's epilogue; the global average pool, like a
        max pool, has no MACs."""
        wb = weight_bits // 8
        out: list[LayerWorkload] = []
        for lyr, hw in zip(self.layers, self.in_sizes()):
            o_hw = lyr.out_hw(hw)
            if not lyr.computes:
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


def _bottleneck(stage: int, block: int, cin: int, width: int, stride: int,
                prev: str) -> list[ConvLayer]:
    """One ResNet v1.5 bottleneck reading ``prev``: 1x1 to ``width``, 3x3
    (carrying the block's stride), 1x1 to 4 ``width`` with the skip added
    before the last ReLU. A block that changes the shape starts with its
    1x1 projection shortcut (no ReLU), which the 1x1 then reads past."""
    L, cout = ConvLayer, 4 * width
    p = f"layer{stage}.{block}."
    out: list[ConvLayer] = []
    skip = prev
    if stride != 1 or cin != cout:
        out.append(L(p + "downsample", cin, cout, 1, stride=stride,
                     pad=(0, 0), relu=False))
        skip = p + "downsample"
    out += [L(p + "conv1", cin, width, 1, pad=(0, 0), relu=True,
              src=prev if out else None),
            L(p + "conv2", width, width, 3, stride=stride, pad=(1, 1),
              relu=True),
            L(p + "conv3", width, cout, 1, pad=(0, 0), relu=True,
              residual=skip)]
    return out


def resnet50() -> CNNModel:
    """ResNet-50 v1.5 (He et al., arXiv:1512.03385, Table 1's 50-layer
    column; v1.5 puts each stage's stride 2 on the 3x3 conv, as MLPerf
    Inference runs it), BatchNorm folded into the convs: a 7x7/2 stem, a
    3x3/2 max pool, 16 bottlenecks in stages of 3, 4, 6, 3, the global
    average pool and a 2048 -> 1000 fc. 53 convs and the fc; 4.09 GMAC a
    224 x 224 frame. Published padding (k - 1) // 2 in front."""
    L = ConvLayer
    layers = [L("conv1", 3, 64, 7, stride=2, pad=(3, 3), relu=True),
              L("maxpool", 64, 64, 3, stride=2, kind="pool", pad=(1, 1))]
    cin = 64
    for stage, (blocks, width, stride) in enumerate(
            ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)), start=1):
        for b in range(blocks):
            layers += _bottleneck(stage, b, cin, width,
                                  stride if b == 0 else 1, layers[-1].name)
            cin = 4 * width
    layers += [L("avgpool", 2048, 2048, 7, kind="gap"),
               L("fc", 2048, 1000, 1, kind="fc")]
    return CNNModel("resnet50", 224, 3, tuple(layers))


def _divisible(v: float, d: int = 8) -> int:
    """``v`` rounded to the nearest multiple of ``d``, never more than 10%
    below ``v`` (torchvision's ``_make_divisible``)."""
    out = max(d, int(v + d / 2) // d * d)
    return out + d if out < 0.9 * v else out


# MobileNetV2's inverted residual blocks (Sandler et al., Table 2): the
# expansion t, output channels c, repeats n and the first repeat's stride s.
MOBILENET_V2_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                       (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                       (6, 320, 1, 1))


def mobilenet_v2(width: float = 1.0, input_hw: int = 224,
                 classes: int = 1000) -> CNNModel:
    """MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2) as
    torchvision's ``mobilenet_v2`` lays it out, BatchNorm folded into the
    convs: a 3x3/2 stem to 32 channels, 17 inverted residual blocks (a 1x1
    expansion by t, but in the first block, where t = 1; a 3x3 depthwise
    conv carrying the block's stride; a linear 1x1 projection, which adds
    the block's input where the stride is 1 and the width unchanged), a
    1x1 head to 1280, the global average pool and an fc. ReLU6 follows
    every conv but the projections; padding (k - 1) // 2. At width 1.0
    and 224 x 224: 52 convs (17 depthwise), 10 skips, 300,774,272 MACs a
    frame. ``width`` scales every width but the head's as torchvision's
    ``width_mult`` does (multiples of 8)."""
    L = ConvLayer
    cin = _divisible(32 * width)
    layers = [L("stem", 3, cin, 3, stride=2, pad=(1, 1), relu6=True)]
    i = 0
    for t, c, n, s in MOBILENET_V2_BLOCKS:
        cout = _divisible(c * width)
        for r in range(n):
            i += 1
            stride, p = (s if r == 0 else 1), f"block{i}."
            skip = layers[-1].name if stride == 1 and cin == cout else None
            hidden = cin * t
            if t != 1:
                layers.append(L(p + "expand", cin, hidden, 1, pad=(0, 0),
                                relu6=True))
            layers += [L(p + "dw", hidden, hidden, 3, stride=stride,
                         groups=hidden, pad=(1, 1), relu6=True),
                       L(p + "project", hidden, cout, 1, pad=(0, 0),
                         relu=False, residual=skip)]
            cin = cout
    head = _divisible(1280 * max(1.0, width))
    side = input_hw                     # the map the pool averages
    for lyr in layers:
        side = lyr.out_hw(side)
    layers += [L("head", cin, head, 1, pad=(0, 0), relu6=True),
               L("avgpool", head, head, side, kind="gap"),
               L("fc", head, classes, 1, kind="fc")]
    return CNNModel("mobilenetv2", input_hw, 3, tuple(layers))


CNN_MODELS = {"vgg16": vgg16, "alexnet": alexnet, "zf": zfnet, "yolo": yolo,
              "resnet50": resnet50, "mobilenetv2": mobilenet_v2}


# ---------------------------------------------------------------------------
# Transformer-family workloads (assigned architectures)
# ---------------------------------------------------------------------------


def lm_layer_workloads(
    cfg,
    *,
    seq_len: int,
    batch: int,
    mode: Literal["train", "prefill", "decode"] = "train",
    dtype_bytes: int = 2,
) -> list[LayerWorkload]:
    """Per-layer workload for a transformer config (see configs/base.py).

    ``macs`` counts the forward pass per global step (train multiplies by 3
    inside the allocator's time model, not here). ``decode`` counts one new
    token against a ``seq_len`` KV cache.
    """
    d = cfg.d_model
    toks = batch * (1 if mode == "decode" else seq_len)
    kv_len = seq_len
    n_ffn_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    out: list[LayerWorkload] = []

    emb_bytes = cfg.vocab * d * dtype_bytes
    out.append(LayerWorkload(
        name="embed", macs=0, weight_bytes=emb_bytes,
        act_in_bytes=toks * 4, act_out_bytes=toks * d * dtype_bytes,
        kind="embed", C=d, M=d))

    # Encoder layers (enc-dec archs): bidirectional attn + mlp, processing
    # the encoder sequence (same length by our shape convention).
    for i in range(cfg.n_enc_layers or 0):
        dh = cfg.head_dim
        w_attn = (d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
                  + cfg.n_heads * dh * d)
        w_ffn = n_ffn_mats * d * cfg.d_ff
        enc_toks = batch * seq_len if mode != "decode" else batch
        macs = enc_toks * (w_attn + w_ffn) \
            + enc_toks * kv_len * cfg.n_heads * dh * 2
        out.append(LayerWorkload(
            name=f"enc{i}", macs=macs,
            weight_bytes=(w_attn + w_ffn) * dtype_bytes,
            act_in_bytes=enc_toks * d * dtype_bytes,
            act_out_bytes=enc_toks * d * dtype_bytes,
            kind="enc", C=d, M=d, H=seq_len, W=batch))

    for i in range(cfg.n_layers):
        blk = cfg.block_kind(i)  # "attn" | "rglru" | "rwkv" | "moe" | ...
        macs = 0
        wbytes = 0
        if blk in ("attn", "attn_local", "moe", "mla", "mla_moe"):
            if blk.startswith("mla"):
                # MLA: q/kv low-rank projections + score/av + out proj.
                q_rank = getattr(cfg, "q_lora_rank", 0) or d
                kv_rank = getattr(cfg, "kv_lora_rank", 512)
                dh = cfg.head_dim
                rope_dim = getattr(cfg, "rope_head_dim", 64)
                nh = cfg.n_heads
                w_attn = (d * q_rank + q_rank * nh * (dh + rope_dim)
                          + d * (kv_rank + rope_dim)
                          + kv_rank * nh * (dh + dh)
                          + nh * dh * d)
            else:
                dh = cfg.head_dim
                w_attn = (d * cfg.n_heads * dh
                          + 2 * d * cfg.n_kv_heads * dh
                          + cfg.n_heads * dh * d)
            ctx = min(kv_len, getattr(cfg, "window", None) or kv_len) \
                if blk == "attn_local" else kv_len
            score_macs = toks * ctx * cfg.n_heads * cfg.head_dim * 2
            if cfg.n_enc_layers:   # enc-dec decoder: + cross-attention
                w_attn *= 2
                score_macs *= 2
            macs += toks * w_attn + score_macs
            wbytes += w_attn * dtype_bytes
        if blk in ("rglru",):
            # Griffin block: wx, wy, wo (3 d x dr) + 2 recurrence gates
            # (2 dr^2); the recurrence itself is elementwise.
            dr = cfg.lru_width or d
            w_rec = 3 * d * dr + 2 * dr * dr
            macs += toks * w_rec
            wbytes += w_rec * dtype_bytes
        if blk in ("rwkv",):
            # RWKV6 time-mix: r,k,v,g,o projections (5 d^2) + decay lora.
            w_rec = 5 * d * d
            macs += toks * w_rec
            wbytes += w_rec * dtype_bytes
        # FFN part
        if blk.endswith("moe"):
            n_act = cfg.moe_top_k + cfg.moe_n_shared
            w_ffn_tot = (cfg.moe_n_experts + cfg.moe_n_shared) * 3 * d * cfg.moe_d_ff
            macs += toks * n_act * 3 * d * cfg.moe_d_ff
            wbytes += w_ffn_tot * dtype_bytes
        elif blk == "rwkv":
            # channel mix: cm_wr (d^2) + cm_wk (d x ff) + cm_wv (ff x d)
            w_ffn = d * d + 2 * d * cfg.d_ff
            macs += toks * w_ffn
            wbytes += w_ffn * dtype_bytes
        else:
            macs += toks * n_ffn_mats * d * cfg.d_ff
            wbytes += n_ffn_mats * d * cfg.d_ff * dtype_bytes
        out.append(LayerWorkload(
            name=f"layer{i}", macs=macs, weight_bytes=wbytes,
            act_in_bytes=toks * d * dtype_bytes,
            act_out_bytes=toks * d * dtype_bytes,
            kind=blk, C=d, M=d, H=seq_len, W=batch))

    out.append(LayerWorkload(
        name="lm_head", macs=toks * d * cfg.vocab,
        # tied embeddings: the head reuses the embedding bytes (already
        # counted), but its MACs still happen.
        weight_bytes=(0 if cfg.tie_embeddings
                      else cfg.vocab * d * dtype_bytes),
        act_in_bytes=toks * d * dtype_bytes,
        act_out_bytes=toks * cfg.vocab * dtype_bytes,
        kind="head", C=d, M=cfg.vocab))
    return out


def total_params(layers: Sequence[LayerWorkload], dtype_bytes: int = 2) -> int:
    return sum(l.weight_bytes for l in layers) // dtype_bytes


def model_flops(layers: Sequence[LayerWorkload], train: bool) -> int:
    """MODEL_FLOPS = 6*N*D-style useful flops (fwd 2x, train 6x per MAC)."""
    fwd = 2 * sum(l.macs for l in layers)
    return 3 * fwd if train else fwd
