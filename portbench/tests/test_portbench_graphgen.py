"""The benchmark's graph: one graph a seed, with the configured degree,
homophily, feature density and splits within sampling error."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.graphgen import draw_graph

N, C, F, DEG = 40_000, 10, 32, 2.5


@pytest.fixture(scope="module")
def graph():
    return draw_graph(N, C, F, DEG, seed=2**31 + 99, device="cpu")


def test_a_seed_gives_one_graph(graph):
    again = draw_graph(N, C, F, DEG, seed=2**31 + 99, device="cpu")
    other = draw_graph(N, C, F, DEG, seed=2**31 + 100, device="cpu")
    for k in ("features", "labels", "edges", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(graph[k], again[k])
    assert not np.array_equal(graph["edges"][:100], other["edges"][:100])
    # the same sizes for every seed, but for the few duplicate edges dropped
    assert abs(len(graph["edges"]) - len(other["edges"])) < 0.002 * len(graph["edges"])


def test_layout(graph):
    e = graph["edges"]
    assert graph["features"].dtype == np.float32 and graph["features"].shape == (N, F)
    assert graph["labels"].dtype == np.int32 and e.dtype == np.int64 and e.shape[1] == 2
    assert (e[:, 0] < e[:, 1]).all() and len(np.unique(e[:, 0] * N + e[:, 1])) == len(e)
    assert graph["num_class"] == C and set(np.unique(graph["labels"])) == set(range(C))


def test_degree_and_homophily(graph):
    e, labels = graph["edges"], graph["labels"]
    m = int(N * DEG / 2)
    # self loops and duplicates are rare: the degree is a hair under the configured one
    assert 0.995 * DEG < 2 * len(e) / N <= DEG
    same = (labels[e[:, 0]] == labels[e[:, 1]]).mean()
    want = 0.75 + 0.25 / C  # kept in class, or sent anywhere and landing in class
    assert abs(same - want) < 4 * np.sqrt(want * (1 - want) / m)


def test_features(graph):
    x = graph["features"]
    nz = (x > 0).mean()
    # noise 0.02, or the class's centroid bit (0.06) kept at 0.5: about 0.049; the
    # centroids are few draws, so the tolerance is theirs
    assert 0.035 < nz < 0.065
    sums = x.sum(1)
    # entries are counts (0, 1 or 2) over their row's sum: a row is 0 or sums to 1
    assert np.allclose(sums[sums > 0], 1.0, atol=1e-6)


def test_splits(graph):
    train, val, test = graph["train_mask"], graph["val_mask"], graph["test_mask"]
    assert not (train & val).any() and not (train & test).any() and not (val & test).any()
    assert np.bincount(graph["labels"][train], minlength=C).tolist() == [20] * C
    assert val.sum() == 500 and test.sum() == 1000
