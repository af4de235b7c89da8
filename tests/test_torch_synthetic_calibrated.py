"""The port's ``make_calibrated_bundle`` (``io/synthetic.py``) draws the
JAX package's bundle bit for bit: every array of the VCFs, panels,
frequency table and windows, and the generative ``truth`` that
``tools/oracle_ceiling.py`` decodes against, for the same seed and
shapes."""

import numpy as np
import pytest

from rag_snvbert_tpu.io.synthetic import make_calibrated_bundle as jmake
from rag_snvbert_tpu_torch.io.synthetic import make_calibrated_bundle as tmake

SHAPES = {
    "small": dict(n_train_samples=6, n_ref_samples=8, n_sites=240,
                  n_windows=2),
    # fewer train samples than populations (n_pops is capped), a
    # shorter block scale and a higher private-mutation rate
    "tiny-cohort": dict(n_train_samples=2, n_ref_samples=5, n_sites=150,
                        n_windows=3, n_founders=24, block_kb=10.0,
                        mu=1e-3),
}


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 21])
def test_calibrated_bundle_is_bit_identical(seed, shape):
    j, t = jmake(seed=seed, **SHAPES[shape]), tmake(seed=seed, **SHAPES[shape])
    for name in ("train", "ref"):
        jv, tv = getattr(j, name), getattr(t, name)
        for field in ("gt", "pos", "chrom", "ref", "alt", "ids"):
            _assert_same(getattr(jv, field), getattr(tv, field),
                         f"{name}.{field}")
        assert jv.samples == tv.samples
    for name in ("panel", "ref_panel"):
        jp, tp = getattr(j, name), getattr(t, name)
        assert jp.samples == tp.samples and jp.pop_list == tp.pop_list
        assert jp.pop_to_class == tp.pop_to_class
    _assert_same(j.freq.freq, t.freq.freq, "freq")
    _assert_same(j.freq.pos, t.freq.pos, "freq.pos")
    _assert_same(j.window.window_info, t.window.window_info, "window")
    assert j.vocab.size == t.vocab.size
    assert j.truth is not None
    _assert_same(j.truth, t.truth, "truth")
