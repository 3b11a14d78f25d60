"""GPNN's spectral partition and its packed splits against the JAX package,
on the CPU.

The port's ``data/partition.py`` is a copy of the JAX package's numpy
code: on the same numpy operators the clusters are equal, exactly. A
split that the JAX package packed with ``num_cluster`` and saved is read
by the port's ``load_packed``, and the port's GPNN gives the flax GPNN's
predictions on it with the same parameters (1e-4, float32). The
``Predictor`` partitions a request by the same function as the pack.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lanczosnet_tpu.data import partition as jax_partition
from lanczosnet_tpu.data.dataset import pack_dataset as jax_pack_dataset
from lanczosnet_tpu.data.dataset import save_packed as jax_save_packed
from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_torch.data import partition
from lanczosnet_torch.data.dataset import load_packed, pack_dataset
from lanczosnet_torch.models import build_model
from lanczosnet_torch.serve import Predictor

from test_torch_dense_models import flax_params, jax_batch, model_config, port_model


@pytest.mark.parametrize("num_cluster", [1, 2, 3, 5])
def test_partition_equals_jax_on_the_same_operators(num_cluster):
    ds = jax_pack_dataset(synthetic_qm8_graphs(48, seed=3, n_lo=2, n_hi=20), n_max=24)
    ops0, mask = np.asarray(ds.ops[:, 0]), np.asarray(ds.mask)
    mask[5] = 0.0  # an empty graph
    want = jax_partition.spectral_partition_batch(ops0, mask, num_cluster)
    got = partition.spectral_partition_batch(ops0, mask, num_cluster)
    assert got.dtype == np.int32 and got.shape == (48, 24)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(partition.cluster_of_ops(np.asarray(ds.ops), mask, num_cluster), want)
    assert not got[5].any() and not (got * (1 - mask)).any()  # padding and empty graphs: 0
    if num_cluster > 1:
        assert (got.max(1) > 0).sum() > 40  # the real graphs are split


def test_kmeans_equals_jax():
    x = np.random.default_rng(0).standard_normal((40, 3))
    for k in (1, 2, 4, 40, 41):
        np.testing.assert_array_equal(partition._kmeans(x.copy(), k), jax_partition._kmeans(x.copy(), k))


def test_gpnn_on_a_jax_packed_split_matches_flax(tmp_path):
    graphs = synthetic_qm8_graphs(6, seed=4, n_lo=4, n_hi=16)
    jax_save_packed(jax_pack_dataset(graphs, n_max=16, num_cluster=2), tmp_path / "split.npz")
    ds = load_packed(tmp_path / "split.npz")
    assert ds.cluster is not None and ds.cluster.shape == (6, 16)
    b = {f: getattr(ds, f) for f in ("atom_type", "node_feat", "ops", "mask", "label",
                                     "ritz_val", "ritz_vec", "cluster")}
    cfg, _ = model_config("GPNN", "narrow")
    model = jax_build_model(cfg)
    params = flax_params(model, jax_batch(b))
    want = np.asarray(model.apply({"params": params}, jax_batch(b), deterministic=True))
    with torch.inference_mode():
        got = port_model(cfg, params, b)(ds.slice_batch(np.arange(6))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # without the partition the prediction differs: the cluster is read
    with torch.inference_mode():
        one = port_model(cfg, params, b)(
            dataclasses.replace(ds.slice_batch(np.arange(6)), cluster=None)).numpy()
    assert np.abs(one - got).max() > 1e-3


def test_predictor_partitions_requests_as_the_pack_does():
    graphs = synthetic_qm8_graphs(20, seed=9, n_hi=16)
    pack = pack_dataset(graphs, n_max=16, num_cluster=2, device="cpu")
    model = build_model(model_config("GPNN", "narrow")[0])
    model.init_weights(torch.Generator().manual_seed(0))
    pred = Predictor(model, model.state_dict(), n_max=16, batch_size=8, num_cluster=2, device="cpu")
    assert not pred._compact_ok(graphs[:8])
    with pytest.raises(ValueError, match="float32 wire"):
        pred._pack(graphs[:8], compact=True)
    clusters = [pred.graph_batch(*pred._pack(graphs[lo: lo + 8])).cluster.numpy()
                for lo in range(0, 20, 8)]
    np.testing.assert_array_equal(np.concatenate(clusters)[:20], pack.cluster)
    with torch.inference_mode():
        want = model(pack.slice_batch(np.arange(20))).numpy()
    np.testing.assert_allclose(pred.predict(graphs), want, rtol=0, atol=1e-4)
