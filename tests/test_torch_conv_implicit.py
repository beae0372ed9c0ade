"""The implicit-GEMM conv route (``kernel.conv_int8_implicit``):
``gemm_int8``'s large-N kernel reading its patches straight from the NHWC
activation by TMA's im2col mode, so no patch matrix is written.

On the CPU: which convs take the route (``kernel.implicit_ok`` on each
configuration's layer list), the launch counts' ``"implicit"`` key, and the
wrapper's plain version. On the card (marked ``cuda``, skipped without
one): bit for bit against ``conv2d_int8_via(gemm_int8_ref, ...)`` on every
conv shape of VGG16, AlexNet and ResNet-50 at batch 16 and at ragged
batches (tiles that start mid-row and cross images), with and without the
skip and ``emit_int32``, at strides 1 and 2, asymmetric padding, groups,
and on every tiling. Run those with

    python -m pytest -m cuda tests/test_torch_conv_implicit.py

This file imports no JAX."""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.workload import CNN_MODELS
from repro_torch.kernels.conv2d_int8 import kernel, ops, ref
from repro_torch.kernels.conv2d_int8.kernel import gemm_int8, k_major_view

MODELS = ("vgg16", "alexnet", "resnet50")
# Per batch: launches of the implicit route, of the large-N kernel on
# patches made outside it (the stems, AlexNet's conv2 at Cg 48), and of
# the small-N kernel (the fc layers).
PATHS_PER_BATCH = {"vgg16": {"implicit": 12, "large_n": 1, "small_n": 3},
                   "alexnet": {"implicit": 5, "large_n": 3, "small_n": 3},
                   "resnet50": {"implicit": 52, "large_n": 1,
                                "small_n": 1}}


def conv_shapes(model_name: str) -> list[tuple]:
    """Every distinct conv of ``model_name``: (name, H = W, C, R = S,
    stride, (lo, hi) padding on both dims, groups, M, adds a skip), named
    by its first layer."""
    model = CNN_MODELS[model_name]()
    rows: dict = {}
    for lyr, hw in zip(model.layers, model.in_sizes()):
        if lyr.kind == "conv":
            key = (hw, lyr.in_ch, lyr.kernel, lyr.stride, lyr.padding(hw),
                   lyr.groups, lyr.out_ch, lyr.residual is not None)
            rows.setdefault(key, lyr.name)
    return [(name, *key) for key, name in rows.items()]


def _launches_by_route(model_name: str) -> dict:
    """The launches of one batch as the route rule splits them, from the
    layer list and ``implicit_ok`` on tensors of each layer's shapes."""
    model = CNN_MODELS[model_name]()
    paths = {"implicit": 0, "large_n": 0, "small_n": 0}
    for lyr, hw in zip(model.layers, model.in_sizes()):
        if lyr.kind == "fc":
            paths["small_n"] += 1
        elif lyr.kind == "conv":
            x = torch.zeros((1, hw, hw, lyr.in_ch), dtype=torch.int8)
            w = k_major_view(torch.zeros(
                (lyr.kernel, lyr.kernel, lyr.in_ch // lyr.groups,
                 lyr.out_ch), dtype=torch.int8))
            pad = lyr.padding(hw)
            implicit = kernel.implicit_ok(x, w, stride=lyr.stride,
                                          pad=(pad, pad), groups=lyr.groups)
            paths["implicit" if implicit else "large_n"] += lyr.groups
    return paths


@pytest.mark.parametrize("model_name", MODELS)
def test_route_rule_on_each_configuration(model_name):
    """The implicit route takes every conv whose group width is a
    multiple of 64 channels: VGG16's convs 2-13, AlexNet's conv3-5 (5 of
    its 8 conv launches), ResNet-50's 52 convs after the stem."""
    assert _launches_by_route(model_name) == PATHS_PER_BATCH[model_name]


def test_route_rule_refuses_what_tma_cannot_take():
    x = torch.zeros((2, 9, 9, 128), dtype=torch.int8)
    w = torch.zeros((3, 3, 128, 64), dtype=torch.int8)
    pad = ((1, 1), (1, 1))
    wk = k_major_view(w)
    assert kernel.implicit_ok(x, wk, stride=1, pad=pad)
    assert not kernel.implicit_ok(x, w, stride=1, pad=pad)     # row-major
    assert not kernel.implicit_ok(x[:, :, :, :96], k_major_view(
        w[:, :, :96]), stride=1, pad=pad)                # Cg 96, a view
    assert not kernel.implicit_ok(
        torch.zeros((2, 9, 9, 96), dtype=torch.int8),
        k_major_view(w[:, :, :96]), stride=1, pad=pad)    # Cg 96
    assert not kernel.implicit_ok(
        x.permute(0, 2, 1, 3), wk, stride=1, pad=pad)     # not NHWC-dense
    off = torch.zeros(x.numel() + 16, dtype=torch.int8)[1:x.numel() + 1]
    assert not kernel.implicit_ok(off.view(x.shape), wk, stride=1,
                                  pad=pad)                # off 16 bytes
    assert not kernel.implicit_ok(x, wk, stride=9, pad=pad)
    assert not kernel.implicit_ok(x, wk, stride=1, pad=((200, 1), (1, 1)))
    assert not kernel.implicit_ok(x.to(torch.int16), wk, stride=1, pad=pad)
    assert kernel.implicit_ok(x, k_major_view(torch.zeros(
        (3, 3, 64, 64), dtype=torch.int8)), stride=2, pad=((0, 1), (0, 1)),
        groups=2)


def test_conv_tilings_are_the_large_n_tilings_the_source_builds():
    """Every ``CONV_CASE`` instantiation of ``gemm_int8.cu`` is one of the
    large-N tilings ``plan_for`` may pick for the implicit route, and each
    of those is built."""
    text = Path(kernel.SOURCE).read_text()
    built = {(int(w), int(g)) for w, g in
             re.findall(r"^\s*CONV_CASE\((\d+), (\d+)\)", text, re.M)}
    assert built == {(p.width, p.warpgroups) for p in kernel.plans(65)}


def test_launch_counts_carry_the_implicit_key():
    counts = kernel.launch_counts()
    assert "implicit" in kernel.PATHS and "implicit" in counts
    delta = dict.fromkeys(counts, 0)
    delta.update(launches=3, implicit=2, large_n=1, residual=1)
    kernel.add_launches(delta)
    after = kernel.launch_counts()
    assert {k: after[k] - counts[k] for k in after} == delta
    kernel.add_launches(delta, -1)
    assert kernel.launch_counts() == counts
    saved = dict(gemm_int8.launches_by_path), gemm_int8.launches, \
        gemm_int8.residual_launches
    try:
        kernel.reset_launches()
        assert kernel.launch_counts() == dict.fromkeys(counts, 0)
    finally:
        gemm_int8.launches_by_path, gemm_int8.launches, \
            gemm_int8.residual_launches = saved


def _case(gen, B, H, C, R, M, groups, device="cpu"):
    x = torch.randint(-128, 128, (B, H, H, C), generator=gen,
                      dtype=torch.int8).to(device)
    w = torch.randint(-128, 128, (R, R, C // groups, M), generator=gen,
                      dtype=torch.int8).to(device)
    shift = torch.randint(-4, 20, (M,), generator=gen,
                          dtype=torch.int32).to(device)
    bias = torch.randint(-2 ** 24, 2 ** 24, (M,), generator=gen,
                         dtype=torch.int32).to(device)
    return x, w, shift, bias


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    gen = torch.Generator().manual_seed(3)
    x, w, shift, bias = _case(gen, 2, 7, 128, 3, 48, 2)
    pad = ((0, 1), (1, 0))
    before = kernel.launch_counts()
    got = kernel.conv_int8_implicit(x, k_major_view(w), shift, bias,
                                    stride=2, pad=pad, groups=2, relu=True)
    assert kernel.launch_counts() == before
    assert torch.equal(got, ref.conv2d_int8_ref(
        x, w, shift, bias, stride=2, padding=pad, groups=2, relu=True))
    with pytest.raises(ValueError, match="cannot take"):
        kernel.conv_int8_implicit(x, w, shift, bias, stride=2, pad=pad,
                                  groups=2)
    with pytest.raises(ValueError, match="residual"):
        kernel.conv_int8_implicit(
            x, k_major_view(w), shift, bias, stride=2, pad=pad, groups=2,
            residual=torch.zeros((2, 4, 4, 48), dtype=torch.int8),
            res_shift=shift)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator().manual_seed(0)


def _check(gen, B, H, C, R, stride, pad, groups, M, *, skip=False,
           emit_int32=False, relu=True) -> None:
    """One conv on the card through ``ops.conv2d_int8``: ``groups``
    launches on the implicit route and none other, bit for bit against
    the plain version on the same CUDA tensors."""
    x, w, shift, bias = _case(gen, B, H, C, R, M, groups, "cuda")
    wk = k_major_view(w)
    Ho = (H + sum(pad) - R) // stride + 1
    extra = {}
    if skip:
        extra = {"residual": torch.randint(
            -128, 128, (B, Ho, Ho, M), generator=gen,
            dtype=torch.int8).cuda(),
            "res_shift": torch.randint(-24, 32, (M,), generator=gen,
                                       dtype=torch.int32).cuda()}
    kw = dict(stride=stride, padding=(pad, pad), groups=groups, relu=relu,
              emit_int32=emit_int32, **extra)
    before = kernel.launch_counts()
    got = ops.conv2d_int8(x, wk, shift, bias, **kw)
    torch.cuda.synchronize()
    after = kernel.launch_counts()
    ran = {k: after[k] - before[k] for k in after}
    assert ran == {"launches": groups, "large_n": 0, "small_n": 0,
                   "dp4a": 0, "implicit": groups,
                   "residual": groups if skip else 0, "depthwise": 0,
                   "quantize_in": 0}
    want = ref.conv2d_int8_via(ref.gemm_int8_ref, x, w, shift, bias, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _card_cases() -> list:
    cases = []
    for model_name in MODELS:
        for name, H, C, R, stride, pad, groups, M, skip in \
                conv_shapes(model_name):
            if C // groups % 64:
                continue
            for B in (16, 1, 3, 17):
                cases.append(pytest.param(
                    B, H, C, R, stride, pad, groups, M, skip,
                    id=f"{model_name}-{name}-b{B}"))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,R,stride,pad,groups,M,skip", _card_cases())
def test_every_conv_shape_of_the_three_models(gen, B, H, C, R, stride, pad,
                                              groups, M, skip):
    _check(gen, B, H, C, R, stride, pad, groups, M, skip=skip)


# (B, H, C, R, stride, pad, groups, M): asymmetric padding both ways, a
# 1x1 at stride 2, a 64-channel 1x1 (one 64-byte box and one past K), a
# 5x5, a group width of 192 in two groups, M narrower than a tile.
EDGE_CASES = [
    (3, 13, 128, 3, 2, (1, 0), 1, 72),
    (2, 15, 64, 3, 1, (0, 2), 1, 130),
    (5, 28, 256, 1, 2, (0, 0), 1, 512),
    (17, 9, 64, 1, 1, (0, 0), 1, 64),
    (4, 11, 128, 5, 1, (2, 2), 1, 96),
    (3, 13, 384, 3, 1, (1, 1), 2, 256),
    (1, 7, 512, 3, 1, (1, 1), 1, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("skip,emit_int32,relu", [(False, True, False),
                                                  (True, False, True),
                                                  (True, True, False)])
def test_skip_and_emit_int32_at_the_edges(gen, case, skip, emit_int32, relu):
    _check(gen, *case, skip=skip, emit_int32=emit_int32, relu=relu)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", kernel.plans(65), ids=lambda p: (
    f"{p.width}x{64 * p.warpgroups}"))
@pytest.mark.parametrize("case", [(3, 14, 128, 3, 1, (1, 1), 1, 200),
                                  (17, 9, 192, 3, 2, (0, 1), 1, 96)])
def test_every_tiling(gen, monkeypatch, plan, case):
    """Each large-N tiling forced in place of ``plan_for``'s choice, with
    the skip, on a ragged N and M (128- and 64-byte boxes)."""
    monkeypatch.setattr(kernel, "plan_for", lambda *shape: plan)
    _check(gen, *case, skip=True)


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", MODELS)
def test_chain_launch_counts_and_exactness(gen, model_name):
    """One batch of 16 through each full-width model on the kernel route:
    the launches split as ``PATHS_PER_BATCH`` says, none on dp4a, and the
    accumulators equal the oracle route's."""
    from repro_torch.serving.server import (compile_for_serving,
                                            synthetic_stream)
    prog = compile_for_serving(model_name, device="cuda")
    runner = prog.compile_runner(route="kernel")
    xq = torch.as_tensor(runner.quantize(synthetic_stream(model_name, 16)),
                         device="cuda")
    before = kernel.launch_counts()
    acc = runner.fn(xq)
    torch.cuda.synchronize()
    after = kernel.launch_counts()
    ran = {p: after[p] - before[p] for p in kernel.PATHS}
    assert ran == {**PATHS_PER_BATCH[model_name], "dp4a": 0}
    assert torch.equal(acc, prog.compile_runner(route="oracle")(xq))
