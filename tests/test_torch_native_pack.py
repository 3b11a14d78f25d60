"""The native graph packer (``lanczosnet_torch/data/native.py`` over the
port's copy of ``native/graphpack.cc``) against the JAX package's
binding of the same source, on the CPU.

Its arrays equal JAX's ``native.pack_arrays`` bit for bit and the torch
path's (``batch_graphs`` + ``ops/normalize.py``) within 1e-6; an
oversize graph raises naming ``n_max``; ``pack_dataset`` takes it by
default and counts a fallback where it cannot be built. The tests skip,
naming g++, where g++ is missing. About 5 s on one worker.
"""

import shutil

import numpy as np
import pytest
import torch

from lanczosnet_tpu.data import native as jax_native
from lanczosnet_torch.core.graph_batch import batch_graphs
from lanczosnet_torch.data import native
from lanczosnet_torch.data.dataset import pack_dataset
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.ops.normalize import build_operator_stack


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native packer is built with g++")
    assert native.available()


@pytest.mark.parametrize("kind", ["sym", "row"])
def test_native_arrays_equal_jax_and_the_torch_path(gxx, kind):
    graphs = synthetic_qm8_graphs(40, seed=2, n_lo=3, n_hi=24)
    got = native.pack_arrays(graphs, 24, kind=kind, num_threads=3)
    want = jax_native.pack_arrays(graphs, 24, kind=kind)
    assert want is not None and set(got) == set(want) == {"atom_type", "ops", "mask"}
    for name in got:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    host = batch_graphs(graphs, 24)
    ops = build_operator_stack(torch.from_numpy(host["adj"]), torch.from_numpy(host["mask"]),
                               kind=kind).numpy()
    np.testing.assert_allclose(got["ops"], ops, atol=1e-6)
    np.testing.assert_array_equal(got["atom_type"], host["atom_type"])
    np.testing.assert_array_equal(got["mask"], host["mask"])


def test_oversize_raises_and_pack_dataset_counts_fallbacks(gxx, monkeypatch):
    graphs = synthetic_qm8_graphs(6, seed=4, n_lo=10, n_hi=20)
    with pytest.raises(ValueError, match="nodes > n_max=9"):
        native.pack_arrays(graphs, 9)
    with pytest.raises(ValueError, match="n_max=9"):
        pack_dataset(graphs, n_max=9, device="cpu")
    fast = pack_dataset(graphs, n_max=20, num_eig_vec=6, standardize=True, device="cpu")
    torch_path = pack_dataset(graphs, n_max=20, num_eig_vec=6, standardize=True, device="cpu",
                              use_native=False)
    for name in ("atom_type", "node_feat", "mask", "label", "ritz_val", "ritz_vec"):
        np.testing.assert_allclose(getattr(fast, name), getattr(torch_path, name), atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(fast.ops, torch_path.ops, atol=1e-6)
    # where the library cannot be had, the torch path packs and the call is counted
    monkeypatch.setattr(native, "_load", lambda: None)
    before = native.fallbacks.count
    again = pack_dataset(graphs, n_max=20, device="cpu")
    assert native.fallbacks.count == before + 1
    np.testing.assert_array_equal(again.ops, torch_path.ops)
