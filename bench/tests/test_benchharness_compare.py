"""The comparison that decides ``correct``, and the trace's helpers."""

from __future__ import annotations

import json

import numpy as np

from bench.core import compare
from bench.core.trace import short_name


def _ref():
    return np.arange(12, dtype=np.float32).reshape(3, 4)


def test_exact_answers_read_zero_and_are_correct():
    ref = _ref()
    idx = np.array([0, 1, 2, 0])
    r = compare.compare([ref[i].copy() for i in idx], idx, ref)
    assert r == {"wrong_frames": 0, "max_logit_gap": 0.0}
    assert compare.correct(r)


def test_one_ulp_or_a_missing_answer_is_not_correct():
    ref = _ref()
    idx = np.array([0, 1, 2])
    outs = [ref[i].copy() for i in idx]
    outs[1][2] = np.nextafter(outs[1][2], np.float32(np.inf))
    r = compare.compare(outs, idx, ref)
    assert r["wrong_frames"] == 1 and r["max_logit_gap"] > 0
    assert not compare.correct(r)
    r = compare.compare([ref[0], None, ref[2]], idx, ref)
    assert r["wrong_frames"] == 1 and not compare.correct(r)


def test_non_finite_or_misshapen_answers_stay_valid_json():
    ref = _ref()
    idx = np.array([0, 1])
    bad = ref[1].copy()
    bad[0] = np.nan
    r = compare.compare([ref[0], bad], idx, ref)
    assert r["wrong_frames"] == 1
    json.loads(json.dumps(compare.report(r)), parse_constant=_refuse)
    r = compare.compare([ref[0][:2], ref[1][:2]], idx, ref)
    assert r["wrong_frames"] == 2
    json.loads(json.dumps(compare.report(r)), parse_constant=_refuse)


def _refuse(name):
    raise ValueError(f"{name} is not JSON")


def test_kernel_names_are_shortened_but_kept_apart():
    copy = ("void at::native::elementwise_kernel<128, 4, at::native::"
            "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
            "at::TensorIteratorBase&)::{lambda()#3}>(int)")
    gemm = ("void (anonymous namespace)::gemm_wgmma<64, 1, 1, false>("
            "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::"
            "WgParams)")
    assert short_name(copy) == "elementwise_kernel[direct_copy_kernel_cuda]"
    assert short_name(gemm) == "gemm_wgmma<64, 1, 1, false>"
    assert short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
