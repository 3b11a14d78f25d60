"""The port's nine sparse node classifiers against the flax models, on the CPU.

Each model gets the flax model's parameters (its init traced with
``jax.eval_shape`` and filled from a numpy seed, moved through
``weights.py:sparse_state_dict``), the same COO operator, features and
extras (the Ritz pairs, the partition), and runs in eval mode at a
narrow width: N=160 nodes, F=12, hidden [16, 16].

Tolerances: float32 logits 1e-4 (only the order of summation differs);
bfloat16 logits within twice the bfloat16-versus-float32 distance
of the flax bfloat16 logits (the distance between flax's bfloat16 and
float32 logits, measured here per model: both lie within it of the
float32 logits), and each model's bfloat16 logits within 2% of the
largest float32 logit of the float32 ones (0.46–1.5% measured here;
``chip_smoke.SPARSE_BF16_REL_DISTANCE``, the bound the card holds the
10M-node LanczosNet to);
``SparseAdaLanczosNet``'s ``kernel_embed`` gradient 1e-3 relative to
its largest entry (the gradient runs through two eigensolvers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lanczosnet_tpu.models import sparse_nodes as jmodels
from lanczosnet_tpu.ops import sparse as jsp
from lanczosnet_torch.models.sparse_nodes import build_sparse_model
from lanczosnet_torch.ops import sparse as tsp
from lanczosnet_torch.weights import STATE_DICT_MAPS, sparse_state_dict

N, F_IN, C, K = 160, 12, 4, 8
HIDDEN = (16, 16)
# model.name → (flax class, model: keys beyond the common ones)
MODELS = {
    "GCN": (jmodels.SparseGCN, {}),
    "ChebyNet": (jmodels.SparseChebyNet, {"poly_order": 3}),
    "GAT": (jmodels.SparseGAT, {"num_head": 4}),
    "DCNN": (jmodels.SparseDCNN, {"max_hop": 2}),
    "GraphSAGE": (jmodels.SparseGraphSAGE, {}),
    "MPNN": (jmodels.SparseMPNN, {"num_prop": 3}),
    "GPNN": (jmodels.SparseGPNN, {"num_prop": 2, "num_intra_prop": 1, "num_cut_prop": 1}),
    "LanczosNet": (jmodels.SparseLanczosNet, {"short_diffusion_dist": (1, 2),
                                              "long_diffusion_dist": (3, 5),
                                              "filter_hidden_dim": 8}),
    "AdaLanczosNet": (jmodels.SparseAdaLanczosNet, {"short_diffusion_dist": (1, 2),
                                                    "long_diffusion_dist": (3, 5),
                                                    "filter_hidden_dim": 8, "kernel_dim": 6,
                                                    "num_eig_vec": K}),
}


def graph(seed: int = 0):
    """A connected random graph with features and both operators."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(N - 1), np.arange(1, N)], 1)
    a, b = rng.integers(0, N, 400), rng.integers(0, N, 400)
    pairs = np.concatenate([chain, np.stack([a[a != b], b[a != b]], 1)])
    edges = np.unique(np.sort(pairs, 1), axis=0)
    x = rng.random((N, F_IN)).astype(np.float32)
    return edges, x


def flax_params(module, args, seed: int = 0) -> dict:
    """The flax init's tree, traced and filled from a numpy seed
    (matrices with variance 1/fan_in, vectors 0.1·N(0, 1))."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                deterministic=True))
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1.0 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes["params"])


def build_pair(name: str, dtype: str = "float32"):
    """(flax module, port module, flax args, port args, params)."""
    cls, extra = MODELS[name]
    edges, x = graph()
    kind = "row_stochastic" if name == "DCNN" else "sym"
    jop = getattr(jsp, f"sparse_{kind}_operator")(edges, N)
    top = getattr(tsp, f"sparse_{kind}_operator")(edges, N)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    module = cls(hidden_dim=HIDDEN, num_class=C, dropout=0.5, dtype=jdt, **extra)
    port = build_sparse_model({"name": name, "hidden_dim": list(HIDDEN), "dropout": 0.5,
                               "dtype": dtype, **extra}, F_IN, C)
    jargs, targs = [jnp.asarray(x), jop], [torch.from_numpy(x), top]
    if name == "LanczosNet":
        vals, vecs = jsp.sparse_lanczos_ritz(jop, K)
        jargs += [vals, vecs]
        targs += [torch.from_numpy(np.array(vals)), torch.from_numpy(np.array(vecs))]
    elif name == "GPNN":
        part = (np.arange(N) * 3 // N).astype(np.int32)
        jargs.append(jnp.asarray(part))
        targs.append(torch.from_numpy(part))
    params = flax_params(module, jargs)
    port.load_state_dict(sparse_state_dict(params), strict=True)
    return module, port.eval(), jargs, targs, params


def flax_logits(module, params, jargs) -> np.ndarray:
    return np.asarray(module.apply({"params": params}, *jargs, deterministic=True), np.float32)


@pytest.mark.parametrize("name", list(MODELS))
def test_sparse_model_float32_equals_flax(name):
    module, port, jargs, targs, params = build_pair(name)
    with torch.no_grad():
        got = port(*targs)
    assert got.shape == (N, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), flax_logits(module, params, jargs), atol=1e-4)
    assert STATE_DICT_MAPS[f"Sparse{name}"] is sparse_state_dict


def rel_distance(a: np.ndarray, ref: np.ndarray) -> float:
    """``max |a − ref|`` over ``max |ref|``."""
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_sparse_model_bfloat16_within_the_bf16_distance(name):
    module, port, jargs, targs, params = build_pair(name, "bfloat16")
    want = flax_logits(module, params, jargs)
    f32 = flax_logits(module.clone(dtype=jnp.float32), params, jargs)
    distance = np.abs(want - f32).max()
    with torch.no_grad():
        got = port(*targs)
    assert got.dtype == torch.bfloat16 and distance > 0
    got = got.float().numpy()
    # both bfloat16 models within the distance of the one float32 model,
    # so within twice of each other
    assert np.abs(got - want).max() <= 2 * distance
    # and the distance, relative to the logits' scale, within the bound
    # the card holds the 10M-node LanczosNet to
    assert rel_distance(want, f32) <= chip_smoke.SPARSE_BF16_REL_DISTANCE
    assert rel_distance(got, f32) <= chip_smoke.SPARSE_BF16_REL_DISTANCE


def test_sparse_ada_kernel_embed_gradient_equals_jax():
    module, port, jargs, targs, params = build_pair("AdaLanczosNet")
    labels = np.random.default_rng(1).integers(0, C, N)

    def jax_loss(p):
        logits = module.apply({"params": p}, *jargs, deterministic=True)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], 1))

    want = np.asarray(jax.grad(jax_loss)(params)["kernel_embed"]["kernel"]).T
    logits = port(*targs)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    got = port.kernel_embed.weight.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-3)


def test_sparse_weight_map_refuses_unknown_and_leftover_leaves():
    *_, params = build_pair("GCN")
    with pytest.raises(KeyError, match="stray"):
        sparse_state_dict({**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}})
    with pytest.raises(KeyError, match="not mapped"):
        sparse_state_dict({**params, "head": {**params["head"], "extra": np.zeros(2)}})


def test_remat_layers_only_where_the_jax_models_have_it():
    for name in MODELS:
        port = build_sparse_model({"name": name, "hidden_dim": [8]}, F_IN, C)
        if name in ("GCN", "LanczosNet"):
            port.set_remat_layers(True)
            assert port.remat_layers
        else:
            with pytest.raises(ValueError, match="no per-layer remat"):
                port.set_remat_layers(True)
    with pytest.raises(KeyError, match="nine model families"):
        build_sparse_model({"name": "Nope"}, F_IN, C)
