"""The port's learned parameter predictor (``repro_torch.core.learned``)
against the reference's ``repro.core.learned``.

Both are numpy CART trees and bootstrap forests seeded through
``np.random.default_rng``: predictions must equal the reference's bit for
bit (tolerance 0). ``TestLearned`` is the twin of
``tests/test_infra.py::TestLearned``: the forest's fit, and the cost
model's (``repro_torch.core.cost_model``).
"""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro.core import learned as jlearned
from repro_torch.core import learned as plearned
from repro_torch.core.cost_model import CostModel
from repro_torch.core.learned import RandomForestRegressor


def _data(seed, n=300, f=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, f))
    y = 2 * x[:, 0] + np.sin(3 * x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y, rng.uniform(-1, 1, (64, f))


@pytest.mark.parametrize("depth,leaf", [(6, 4), (3, 2), (8, 1)])
def test_tree_predictions_equal_reference(depth, leaf):
    x, y, xt = _data(1)
    a = jlearned.DecisionTreeRegressor(depth, leaf).fit(x, y)
    b = plearned.DecisionTreeRegressor(depth, leaf).fit(x, y)
    assert [vars(n) for n in a.nodes] == [vars(n) for n in b.nodes]
    np.testing.assert_array_equal(a.predict(xt), b.predict(xt))


@pytest.mark.parametrize("seed", [0, 3])
def test_forest_predictions_equal_reference(seed):
    x, y, xt = _data(seed)
    a = jlearned.RandomForestRegressor(n_trees=6, seed=seed).fit(x, y)
    b = plearned.RandomForestRegressor(n_trees=6, seed=seed).fit(x, y)
    np.testing.assert_array_equal(a.predict(xt), b.predict(xt))


def test_param_predictor_equals_reference():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(120, 16)).astype(np.float32)
    fa = jlearned.ParamPredictor.featurize(q, 50_000, 64)
    fb = plearned.ParamPredictor.featurize(q, 50_000, 64)
    np.testing.assert_array_equal(fa, fb)
    best_probe = rng.integers(1, 17, len(q))
    best_ef = rng.integers(8, 129, len(q))
    a = jlearned.ParamPredictor().fit(fa, best_probe, best_ef)
    b = plearned.ParamPredictor().fit(fb, best_probe, best_ef)
    qt = plearned.ParamPredictor.featurize(
        rng.normal(size=(32, 16)).astype(np.float32), 50_000, 64)
    for ra, rb in zip(a.predict(qt), b.predict(qt)):
        np.testing.assert_array_equal(ra, rb)
    p, e = b.predict(qt)
    assert p.min() >= 1 and e.min() >= 8


class TestLearned:
    def test_forest_fits_function(self):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, (400, 3))
        y = 2 * x[:, 0] + np.sin(3 * x[:, 1]) + 0.1 * rng.normal(size=400)
        f = RandomForestRegressor(n_trees=8, max_depth=6).fit(x[:300], y[:300])
        pred = f.predict(x[300:])
        ss_res = np.sum((y[300:] - pred) ** 2)
        ss_tot = np.sum((y[300:] - y[300:].mean()) ** 2)
        assert 1 - ss_res / ss_tot > 0.6

    def test_cost_model_fit_recovers_coefs(self):
        cm = CostModel(2.0, 0.03, 0.5)
        rng = np.random.default_rng(1)
        samples = [(int(10 ** rng.uniform(3, 7)), int(rng.uniform(32, 512)),
                    int(rng.uniform(0, 4)), int(rng.uniform(1, 32)))
                   for _ in range(200)]
        lat = [cm.cost(*s) + 0.01 * rng.normal() for s in samples]
        fit = CostModel().fit(samples, lat)
        assert fit.r2(samples, lat) > 0.99
        assert abs(fit.alpha - 2.0) < 0.2
