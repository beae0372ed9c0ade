"""Configuration families: the harness finds a configuration's weights,
program, reference and roofline counts through
``bench/families/<family>.py``, so a new kind of network enters as files
alone."""

from __future__ import annotations

import json
import re

import pytest

from bench.core import spec
from bench.reference import cnn_int8
from bench.roofline import counts
from bench.tests import tiny

CONFIGS = sorted(p.stem for p in (spec.ROOT / "bench" / "configs").glob(
    "*.json"))


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("tiny-family"))


def test_a_config_without_the_key_is_of_the_chain_family():
    fam = spec.family({"name": "no-key"})
    assert fam.__name__ == "bench.families.chain"
    assert fam.logits is cnn_int8.logits
    assert fam.ops_per_frame is counts.ops_per_frame
    assert fam.least_seconds is counts.least_seconds


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_resolves_to_a_family_with_the_five_functions(name):
    cfg = spec.config(name)
    path = spec.ROOT / "bench" / "families" / \
        f"{cfg.get('family', 'chain')}.py"
    assert path.is_file()
    fam = spec.family(cfg)
    for f in spec.FAMILY_FUNCTIONS:
        assert callable(getattr(fam, f)), f


@pytest.mark.parametrize("name", ["alexnet", "vgg16"])
def test_chain_counts_equal_the_roofline_counts_exactly(name):
    cfg = spec.config(name)
    fam = spec.family(cfg)
    assert fam.ops_per_frame(cfg) == counts.ops_per_frame(cfg)
    assert fam.least_seconds(cfg, 16, 1979e12, 3.35e12) == \
        counts.least_seconds(cfg, 16, 1979e12, 3.35e12)


def test_an_unknown_family_is_refused_naming_the_missing_path(tmp_path):
    missing = tmp_path / "bench" / "families" / "nosuch.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        spec.family({"name": "x", "family": "nosuch"}, tmp_path)


def test_a_family_that_lacks_a_function_is_refused(tmp_path):
    d = tmp_path / "bench" / "families"
    d.mkdir(parents=True)
    (d / "partial.py").write_text(
        "def make_params(cfg, seed, device):\n    return {}\n")
    with pytest.raises(AttributeError, match="compile_program, logits"):
        spec.family({"name": "x", "family": "partial"}, tmp_path)


def test_a_cell_of_an_unknown_family_is_refused_by_spec(tmp_path):
    """The refusal comes from ``spec.cell``, which ``run.main`` calls
    before it looks for a card."""
    root = tiny.checkout(tmp_path)
    path = root / "bench" / "configs" / "tiny.json"
    path.write_text(json.dumps(dict(tiny.CONFIG, family="nosuch")))
    with pytest.raises(FileNotFoundError, match="nosuch.py"):
        spec.cell("tiny-b4-closed", root)


@pytest.mark.parametrize("cell,correct", [
    ("tiny-probe-b4-closed", True), ("tiny-probe-ulp-b4-closed", False)])
def test_a_family_added_as_files_supplies_the_reference(checkout, cell,
                                                        correct):
    """The probe family exists only in the tiny checkout; its reference
    one ulp off turns ``correct`` false."""
    assert spec.cell(cell, checkout).family.__name__ == \
        "bench.families.probe"
    r = tiny.run(checkout, cell)
    assert r["correct"] is correct and r["failed"] == 0
    wrong = r["compared"]["wrong_frames"]["value"]
    gap = r["compared"]["max_logit_gap"]["value"]
    if correct:
        assert (wrong, gap) == (0, 0.0)
    else:
        assert wrong >= 1 and gap > 0.0
