"""The port's LanczosNet against the flax model, on the CPU.

Both models get the same parameters (flax init, moved through
``lanczosnet_torch.weights``), the same operator stacks and the same
Ritz pairs, and run in eval mode. Predictions agree to 1e-4: float32
everywhere, the difference is only the order of summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.core.graph_batch import GraphBatch as JaxGraphBatch
from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.ops.lanczos import batched_lanczos_ritz
from lanczosnet_tpu.ops.normalize import build_operator_stack as jax_build_operator_stack
from lanczosnet_torch.core.graph_batch import GraphBatch, batch_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.lanczos_net import integer_pow
from lanczosnet_torch.weights import lanczos_net_state_dict

FLAGSHIP = dict(
    hidden_dim=[128, 128, 128], embed_dim=128, short_diffusion_dist=[1, 2, 3],
    long_diffusion_dist=[5, 7, 10, 20, 30], num_eig_vec=20,
    spectral_filter_kind="MLP", filter_hidden_dim=16, dropout=0.1,
)
NARROW = dict(
    hidden_dim=[16, 16], embed_dim=16, short_diffusion_dist=[1, 2],
    long_diffusion_dist=[3, 5], num_eig_vec=8, spectral_filter_kind="MLP",
    filter_hidden_dim=8, dropout=0.1,
)


def model_cfg(widths: dict) -> dict:
    return {"name": "LanczosNet", "num_atom": 8, "num_task": 16, **widths}


def numpy_batch(num: int, n_max: int, k: int, seed: int = 0) -> dict:
    """Padded QM8-like graphs with their operator stack and Ritz pairs,
    all computed by the JAX package, as numpy arrays."""
    graphs = synthetic_qm8_graphs(num, seed=seed, n_lo=4, n_hi=n_max)
    host = batch_graphs(graphs, n_max)
    ops = np.asarray(jax_build_operator_stack(host["adj"], host["mask"]))
    d, v = batched_lanczos_ritz(jnp.asarray(ops[:, 0]), jnp.asarray(host["mask"]), k)
    return {**host, "ops": ops, "ritz_val": np.asarray(d), "ritz_vec": np.asarray(v)}


def jax_batch(b: dict) -> JaxGraphBatch:
    return JaxGraphBatch(
        atom_type=b["atom_type"], node_feat=b["node_feat"], ops=b["ops"], mask=b["mask"],
        label=b["label"], ritz_val=b["ritz_val"], ritz_vec=b["ritz_vec"],
    )


def torch_batch(b: dict) -> GraphBatch:
    t = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    return GraphBatch(
        atom_type=t["atom_type"], node_feat=t["node_feat"], ops=t["ops"], mask=t["mask"],
        ritz_val=t["ritz_val"], ritz_vec=t["ritz_vec"],
    )


def flax_model_and_params(cfg: dict, b: dict):
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0), jax_batch(b), deterministic=True)["params"]
    return model, jax.tree.map(np.asarray, params)


def port_model(cfg: dict, params) -> torch.nn.Module:
    model = build_model(cfg)
    model.load_state_dict(lanczos_net_state_dict(params), strict=True)
    return model.eval()


@pytest.mark.parametrize(
    "widths,batch,n_max",
    [
        (NARROW, 6, 16),
        ({**NARROW, "spectral_filter_kind": "none"}, 6, 16),
        (FLAGSHIP, 4, 32),
    ],
    ids=["narrow", "narrow-no-filter-mlp", "flagship"],
)
def test_lanczos_net_matches_flax(widths, batch, n_max):
    cfg = model_cfg(widths)
    b = numpy_batch(batch, n_max, cfg["num_eig_vec"])
    model, params = flax_model_and_params(cfg, b)
    want = np.asarray(model.apply({"params": params}, jax_batch(b), deterministic=True))
    with torch.inference_mode():
        got = port_model(cfg, params)(torch_batch(b)).numpy()
    assert got.shape == want.shape == (batch, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_weight_map_raises_on_missing_or_extra_leaf():
    cfg = model_cfg(NARROW)
    _, params = flax_model_and_params(cfg, numpy_batch(2, 16, cfg["num_eig_vec"]))

    extra = {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        lanczos_net_state_dict(extra)

    missing_bias = {**params, "layer_0": {"kernel": params["layer_0"]["kernel"]}}
    with pytest.raises(KeyError, match="layer_0/bias"):
        lanczos_net_state_dict(missing_bias)

    readout = dict(params["AttentionReadout_0"])
    del readout["out_proj"]
    with pytest.raises(KeyError, match="out_proj"):
        lanczos_net_state_dict({**params, "AttentionReadout_0": readout})

    # a whole last layer gone: the map cannot know, the strict load does
    no_last = {k: v for k, v in params.items() if k != "layer_1"}
    with pytest.raises(RuntimeError, match="layers.1"):
        build_model(cfg).load_state_dict(lanczos_net_state_dict(no_last), strict=True)


def test_integer_pow_is_exact_like_jax():
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 257).astype(np.float32)
    for t in (1, 2, 3, 5, 7, 10, 20, 30):
        want = np.asarray(jax.lax.integer_pow(jnp.asarray(x), t))
        got = integer_pow(torch.from_numpy(x), t).numpy()
        # the same products in the same order: equal, but for XLA's
        # flushing of subnormal results to zero
        np.testing.assert_allclose(got, want, rtol=0, atol=np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(np.sign(got[np.abs(want) > 0]), np.sign(want[np.abs(want) > 0]))


@pytest.mark.parametrize(
    "overrides,item",
    [
        ({"name": "GCN"}, "A7"),
        ({"name": "GPNN"}, "A7"),
        ({"name": "AdaLanczosNet", "dtype": "bfloat16"}, "A3"),
        ({"dtype": "bfloat16"}, "A3"),
        ({"sum_dense": True}, "A3"),
    ],
)
def test_unported_options_name_their_roadmap_item(overrides, item):
    """These options raised naming their ROADMAP item (A3, A7) until they
    were ported; they build now, and nothing in the registry refuses by
    those names."""
    model = build_model({**model_cfg(NARROW), **overrides})
    assert type(model).__name__ == overrides.get("name", "LanczosNet")
    if "dtype" in overrides:
        assert model.dtype == torch.bfloat16
    assert getattr(model, "sum_dense", False) == overrides.get("sum_dense", False)


def test_factored_path_names_its_roadmap_item():
    """Above 128 nodes the model takes the factored path (it raised
    naming ROADMAP A3 before that path was ported). ``sum_dense``, the
    last of A3 on it, is ported: on the factored path the layer is the
    ``Linear`` on the concat, as in the JAX package, so both give the
    same output."""
    cfg = model_cfg(NARROW)
    model = build_model(cfg).eval()
    n, k = 130, cfg["num_eig_vec"]
    batch = GraphBatch(
        atom_type=torch.ones(1, n, dtype=torch.int32), node_feat=torch.zeros(1, n, 0),
        ops=torch.zeros(1, 5, n, n), mask=torch.ones(1, n),
        ritz_val=torch.zeros(1, k), ritz_vec=torch.zeros(1, n, k),
    )
    out = model(batch)
    assert out.shape == (1, 16) and torch.isfinite(out).all()
    summed = build_model({**cfg, "sum_dense": True}).eval()
    summed.load_state_dict(model.state_dict(), strict=True)
    assert torch.equal(summed(batch), out)
