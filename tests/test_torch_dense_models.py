"""The port's seven other dense models against the flax models, on the CPU.

GCN, GraphSAGE, DCNN, ChebyNet, GAT, MPNN and GPNN each get the flax
model's parameters (flax init, moved through ``lanczosnet_torch.weights``),
the same operator stacks (and, for GPNN, the same partition) and run in
eval mode, at a narrow width (hidden [16, 16], N=16, batch 4) and at
the full width of ``configs/qm8_<model>.yaml`` (batch 2, N=32), with
either head. Predictions agree to 1e-4: float32 everywhere, the
difference is only the order of summation. Also here: the masked
primitives, the Chebyshev recurrence, the weight maps' refusals and the
initializers.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lanczosnet_tpu.core.graph_batch import GraphBatch as JaxGraphBatch
from lanczosnet_tpu.data.partition import spectral_partition_batch
from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.ops import masked as jax_masked
from lanczosnet_tpu.ops.lanczos import batched_lanczos_ritz
from lanczosnet_tpu.ops.normalize import build_operator_stack as jax_build_operator_stack
from lanczosnet_tpu.ops.poly import chebyshev_features as jax_chebyshev_features
from lanczosnet_torch.core.graph_batch import GraphBatch, batch_graphs
from lanczosnet_torch.models import MODEL_REGISTRY, build_model
from lanczosnet_torch.ops.masked import l2_normalize, masked_mean, masked_softmax
from lanczosnet_torch.ops.poly import chebyshev_features
from lanczosnet_torch.utils.config import loads
from lanczosnet_torch.weights import STATE_DICT_MAPS

REPO = Path(__file__).resolve().parents[1]
# model name → the config that trains it
CONFIGS = {
    "GCN": "qm8_gcn", "GraphSAGE": "qm8_graph_sage", "DCNN": "qm8_dcnn",
    "ChebyNet": "qm8_chebynet", "GAT": "qm8_gat", "MPNN": "qm8_mpnn", "GPNN": "qm8_gpnn",
    "LanczosNet": "qm8_lanczos_net", "AdaLanczosNet": "qm8_ada_lanczos_net",
}
DENSE = ("GCN", "GraphSAGE", "DCNN", "ChebyNet", "GAT", "MPNN", "GPNN")
NUM_TASK = 16


def config(name: str) -> tuple[dict, dict]:
    """The (model, dataset) sections of the config that trains ``name``."""
    cfg = loads((REPO / "configs" / f"{CONFIGS[name]}.yaml").read_text())
    return dict(cfg["model"]), dict(cfg["dataset"])


def model_config(name: str, width: str, **overrides) -> tuple[dict, str]:
    """The config's model section (``width`` ``full`` as written, ``narrow``
    with hidden [16, 16]) with ``num_atom``/``num_task`` merged in, and
    the config's ``operator_kind``."""
    mcfg, dcfg = config(name)
    if width == "narrow":
        mcfg["hidden_dim"] = [16, 16]
        if "embed_dim" in mcfg:
            mcfg["embed_dim"] = 16
        if "num_eig_vec" in mcfg:
            mcfg.update(num_eig_vec=8, long_diffusion_dist=[3, 5], filter_hidden_dim=8)
    mcfg.update(num_atom=int(dcfg["num_atom"]), num_task=NUM_TASK, **overrides)
    return mcfg, dcfg.get("operator_kind", "sym")


def numpy_batch(num: int, n_max: int, kind: str = "sym", num_cluster: int = 0,
                num_eig_vec: int = 0, seed: int = 0) -> dict:
    """Padded QM8-like graphs with the operator stack, the partition and
    the Ritz pairs computed by the JAX package, as numpy arrays."""
    graphs = synthetic_qm8_graphs(num, seed=seed, n_lo=4, n_hi=n_max)
    host = batch_graphs(graphs, n_max)
    ops = np.asarray(jax_build_operator_stack(host["adj"], host["mask"], kind=kind))
    out = {**host, "ops": ops, "cluster": None, "ritz_val": None, "ritz_vec": None}
    if num_cluster:
        out["cluster"] = spectral_partition_batch(ops[:, 0], host["mask"], num_cluster)
    if num_eig_vec:
        d, v = batched_lanczos_ritz(jnp.asarray(ops[:, 0]), jnp.asarray(host["mask"]), num_eig_vec)
        out["ritz_val"], out["ritz_vec"] = np.asarray(d), np.asarray(v)
    return out


def batch_for(cfg: dict, kind: str, num: int, n_max: int, seed: int = 0) -> dict:
    return numpy_batch(
        num, n_max, kind,
        num_cluster=int(cfg.get("num_partition", 2)) if cfg["name"] == "GPNN" else 0,
        num_eig_vec=int(cfg.get("num_eig_vec", 20)) if cfg["name"] == "LanczosNet" else 0,
        seed=seed,
    )


def jax_batch(b: dict) -> JaxGraphBatch:
    return JaxGraphBatch(
        atom_type=b["atom_type"], node_feat=b["node_feat"], ops=b["ops"], mask=b["mask"],
        label=b["label"], ritz_val=b["ritz_val"], ritz_vec=b["ritz_vec"], cluster=b["cluster"],
    )


def torch_batch(b: dict) -> GraphBatch:
    t = {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in b.items()}
    return GraphBatch(
        atom_type=t["atom_type"], node_feat=t["node_feat"], ops=t["ops"], mask=t["mask"],
        ritz_val=t["ritz_val"], ritz_vec=t["ritz_vec"], cluster=t["cluster"],
    )


def flax_params(model, batch: JaxGraphBatch, seed: int = 0) -> dict:
    """Parameters of the flax ``model`` as numpy: the tree of its init,
    traced without running it, filled from a numpy seed (matrices with
    variance 1/fan_in, vectors and biases 0.1·N(0, 1), so no bias is
    zero)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, deterministic=True))
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1.0 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes["params"])


def flax_predict(cfg: dict, b: dict, seed: int = 0):
    """(flax params as numpy, flax eval-mode predictions as numpy)."""
    model = jax_build_model(cfg)
    batch = jax_batch(b)
    params = flax_params(model, batch, seed)
    return params, np.asarray(model.apply({"params": params}, batch, deterministic=True))


def port_model(cfg: dict, params, b: dict) -> torch.nn.Module:
    """The port's model of ``cfg`` with the flax ``params``, in eval mode."""
    model = build_model({**cfg, "num_edge_type": b["ops"].shape[1] - 1,
                         "node_feat_dim": b["node_feat"].shape[-1]})
    model.load_state_dict(STATE_DICT_MAPS[cfg["name"]](params), strict=True)
    return model.eval()


@pytest.mark.parametrize("task", ["graph", "node"])
@pytest.mark.parametrize("width,num,n_max", [("narrow", 4, 16), ("full", 2, 32)],
                         ids=["narrow", "full"])
@pytest.mark.parametrize("name", DENSE)
def test_dense_model_matches_flax(name, width, num, n_max, task):
    cfg, kind = model_config(name, width, task=task)
    b = batch_for(cfg, kind, num, n_max)
    params, want = flax_predict(cfg, b)
    with torch.inference_mode():
        got = port_model(cfg, params, b)(torch_batch(b)).numpy()
    shape = (num, NUM_TASK) if task == "graph" else (num, n_max, NUM_TASK)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_models_read_the_jax_defaults():
    """Knobs a config leaves out take the JAX class's defaults."""
    base = {"num_atom": 8, "num_task": 4, "hidden_dim": [12, 8]}
    assert build_model({**base, "name": "GAT"}).layers[0].num_heads == 4
    assert build_model({**base, "name": "DCNN"}).max_hop == 3
    assert build_model({**base, "name": "ChebyNet"}).poly_order == 3
    assert build_model({**base, "name": "MPNN"}).num_prop == 3
    gpnn = build_model({**base, "name": "GPNN"})
    assert [k for k, *_ in gpnn.schedule] == ["intra", "cut", "intra", "cut", "dropout"] * 2
    # per-head width max(dim // heads, 1): layer 1 maps 4·3 features to 4·2
    assert tuple(build_model({**base, "name": "GAT"}).layers[1].w[0].weight.shape) == (8, 12)


def test_every_model_initializes_finite_and_runs():
    b = torch_batch(numpy_batch(3, 12, num_cluster=2, num_eig_vec=4))
    for name, cls in MODEL_REGISTRY.items():
        cfg = {"name": name, "num_atom": 8, "num_task": 4, "hidden_dim": [8, 8],
               "num_eig_vec": 4, "long_diffusion_dist": [3], "num_edge_type": 4}
        model = build_model(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        assert all(torch.isfinite(p).all() for p in model.parameters())
        with torch.no_grad():
            out = model.eval()(b)
        assert out.shape == (3, 4) and torch.isfinite(out).all(), name
    mpnn = build_model({"name": "MPNN", "num_atom": 8, "num_task": 4, "hidden_dim": [8]})
    mpnn.init_weights(torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (8 + 40))  # glorot on w_msg [8, 5·8]
    assert 0.5 * limit < float(mpnn.w_msg.detach().abs().max()) <= limit
    assert not mpnn.gru_b.detach().any()


@pytest.mark.parametrize("name", ["GAT", "MPNN", "GPNN"])
def test_weight_maps_refuse_missing_and_extra_leaves(name):
    cfg, kind = model_config(name, "narrow")
    b = batch_for(cfg, kind, 2, 12)
    params = flax_params(jax_build_model(cfg), jax_batch(b))
    to_torch = STATE_DICT_MAPS[name]
    with pytest.raises(KeyError, match="stray"):
        to_torch({**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}})
    # a leaf gone: the map refuses, or the strict load does where the map
    # cannot know (a GPNN Dense of the schedule)
    first = {"GAT": "layer_0", "MPNN": "w_msg", "GPNN": "cut_0_0_0"}[name]
    model = port_model(cfg, params, b)
    with pytest.raises((KeyError, RuntimeError), match="layer_1|w_msg|cut_0_0_0"):
        model.load_state_dict(to_torch({k: v for k, v in params.items() if k != first}))


def test_masked_softmax_matches_jax_and_gives_zeros_on_an_empty_row():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32) * 4
    mask = (rng.random((3, 5, 7)) < 0.5).astype(np.float32)
    mask[1, 2] = 0.0  # one row masked out entirely
    want = np.asarray(jax_masked.masked_softmax(logits, mask))
    got = masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert np.array_equal(got[1, 2], np.zeros(7, np.float32))
    np.testing.assert_allclose(got.sum(-1)[mask.sum(-1) > 0], 1.0, atol=1e-6)
    x = rng.standard_normal((4, 6, 3)).astype(np.float32)
    m = (rng.random((4, 6, 1)) < 0.6).astype(np.float32)
    np.testing.assert_allclose(
        masked_mean(torch.from_numpy(x), torch.from_numpy(m)).numpy(),
        np.asarray(jax_masked.masked_mean(x, m)), atol=1e-6)


def test_l2_normalize_clamps_the_squared_norm_like_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    x[:3] *= 1e-7 / np.linalg.norm(x[:3], axis=1, keepdims=True)  # rows of norm 1e-7
    want = np.asarray(jax_masked.l2_normalize(x))
    got = l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # at norm 1e-7 the squared norm is clamped to 1e-12: the row is
    # scaled by 1e6 and keeps norm 0.1, where F.normalize gives a unit row
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=1), 0.1, rtol=1e-5)
    unit = F.normalize(torch.from_numpy(x), dim=-1).numpy()
    assert np.abs(unit[:3] - want[:3]).max() > 0.5
    np.testing.assert_allclose(got[3:], unit[3:], atol=1e-6)


@pytest.mark.parametrize("order", [0, 1, 5, 10])
def test_chebyshev_features_match_jax(order):
    """Order 10 takes the JAX package's scan branch (above 8): the same
    values as the unrolled recurrence."""
    b = numpy_batch(3, 12)
    x = np.random.default_rng(order).standard_normal((3, 12, 5)).astype(np.float32)
    op = np.array(b["ops"][:, 0])
    want = np.asarray(jax_chebyshev_features(jnp.asarray(op), jnp.asarray(x), order))
    got = chebyshev_features(torch.from_numpy(op), torch.from_numpy(x), order).numpy()
    assert got.shape == want.shape == (3, order + 1, 12, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
