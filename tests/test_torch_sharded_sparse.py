"""The nine sparse models sharded over four ranks, against the JAX package.

Four ranks (``parallel/multihost.py:launch``, gloo on the CPU, one
thread a rank; they run ``tests/torch_rank_workers.py:model_checks`` and
import no JAX) build ``SparseCitationRunner`` in each of the three forms
(``edges``, ``nodes``, ``nodes_ring``) for each model, narrow: N=301
nodes (padded to 304 in the node forms), F=8, hidden [8, 8], float32,
dropout 0, the flax model's parameters moved through
``weights.py:sparse_state_dict``. The JAX package runs the same models
sharded on the conftest's CPU mesh (``make_mesh(4)`` and
``sharded_sparse_apply``), its Ritz pairs computed sharded in the node
forms. Edge-sharded, the JAX package's Lanczos scan repeats a ``psum``
that XLA:CPU's in-process collectives cannot run (they abort the
process), so there the JAX Ritz pairs and AdaLanczosNet's JAX logits are
those of one device: the same function.

Tolerances, float32, where only the order of summation differs:
- the whole graph's eval logits within 1e-5 of JAX's;
- one step's parameter gradients (the ranks' shares summed by the
  runner's one all-reduce) within 1e-5 of JAX's and of the port's own
  single-device ones, relative to each parameter's largest entry
  floored at 1e-2 of the model's largest (``assert_grads_close``);
  AdaLanczosNet's against JAX's within 1e-3 (``ADA_JAX_GRAD_TOL``);
- after two Adam steps (weight decay 5e-4), the parameters equal on
  every rank, bit for bit;
- LanczosNet's sharded Ritz values and ``V f(D) Vᵀ`` (f = D³, which
  does not see the vectors' signs) within 1e-5 of the single-device
  port's, and within 1e-4 of JAX's sharded ones (``RITZ_JAX_TOL``);
- GPNN's partition (rank 0's, of the whole graph with its padding
  nodes, then cut, as in the JAX runner) equal to that of the padded
  graph on one device.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_rank_workers as workers
from lanczosnet_tpu.models import sparse_nodes as jmodels
from lanczosnet_tpu.ops import sparse as jsp
from lanczosnet_tpu.parallel import mesh as jmesh
from lanczosnet_tpu.train.sparse_citation_runner import sharded_sparse_apply
from lanczosnet_torch.data.citation import synthetic_citation_edges
from lanczosnet_torch.parallel import multihost
from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner
from lanczosnet_torch.weights import sparse_state_dict
from test_torch_sparse_models import flax_params

TESTS = str(Path(__file__).resolve().parent)
D, N, F_IN, C, K = 4, 301, 8, 3, 8
HIDDEN = (8, 8)
MODES = ("edges", "nodes", "nodes_ring")
TOL = 1e-5
# against the JAX package where its Lanczos start vector enters: its
# jitted float32 cos of arguments up to 0.37·300² differs from the eager
# (and the port's) by up to 1e-3 on these node ids, so the two packages'
# K=8 Ritz pairs (far from converged) span slightly different Krylov
# spaces: Ritz values 2.1e-5 apart here, AdaLanczosNet's kernel_embed
# gradient 1.4e-4 (the bound of tests/test_torch_sparse_models.py)
RITZ_JAX_TOL = 1e-4
ADA_JAX_GRAD_TOL = 1e-3
# model.name → (flax class, model: keys beyond the common ones)
MODELS = {
    "GCN": (jmodels.SparseGCN, {}),
    "ChebyNet": (jmodels.SparseChebyNet, {"poly_order": 2}),
    "GAT": (jmodels.SparseGAT, {"num_head": 2}),
    "DCNN": (jmodels.SparseDCNN, {"max_hop": 2}),
    "GraphSAGE": (jmodels.SparseGraphSAGE, {}),
    "MPNN": (jmodels.SparseMPNN, {"num_prop": 2}),
    "GPNN": (jmodels.SparseGPNN, {"num_prop": 1, "num_intra_prop": 1, "num_cut_prop": 1,
                                  "num_partition": 2}),
    "LanczosNet": (jmodels.SparseLanczosNet, {"short_diffusion_dist": (1,),
                                              "long_diffusion_dist": (3,),
                                              "filter_hidden_dim": 4, "num_eig_vec": K}),
    "AdaLanczosNet": (jmodels.SparseAdaLanczosNet, {"short_diffusion_dist": (1,),
                                                    "long_diffusion_dist": (3,),
                                                    "filter_hidden_dim": 4, "kernel_dim": 4,
                                                    "num_eig_vec": K}),
}


def make_graph() -> dict:
    g = synthetic_citation_edges(N, num_class=C, feat_dim=F_IN, avg_degree=4.0, seed=3)
    g["features"] = np.random.default_rng(3).random((N, F_IN)).astype(np.float32)
    return g


def jax_operator(name: str, edges):
    kind = "row_stochastic" if name == "DCNN" else "sym"
    return getattr(jsp, f"sparse_{kind}_operator")(edges, N)


def flax_module(name: str):
    cls, extra = MODELS[name]
    return cls(hidden_dim=HIDDEN, num_class=C, dropout=0.0,
               **{k: v for k, v in extra.items() if k in cls.__dataclass_fields__})


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """The graph, each model's flax parameters, and what the four ranks
    and the single-device port found."""
    tmp = tmp_path_factory.mktemp("sharded")
    graph = make_graph()
    x = jnp.asarray(graph["features"])
    params, mcfgs = {}, {}
    for name, (_, extra) in MODELS.items():
        args = [x, jax_operator(name, graph["edges"])]
        if name == "LanczosNet":
            args += [jnp.zeros((K,)), jnp.zeros((N, K))]
        elif name == "GPNN":
            args.append(jnp.zeros((N,), jnp.int32))
        params[name] = flax_params(flax_module(name), args, seed=7)
        mcfgs[name] = {"name": name, "hidden_dim": list(HIDDEN), "dropout": 0.0, **extra}
    weights = {k: sparse_state_dict(v) for k, v in params.items()}
    torch.save({"graph": graph, "models": mcfgs, "weights": weights, "modes": MODES},
               tmp / "spec.pt")
    out = tmp / "out"
    out.mkdir()
    code = multihost.launch(D, "torch_rank_workers:model_checks",
                            [str(tmp / "spec.pt"), str(out)], device="cpu", store_dir=tmp,
                            threads=1, pythonpath=[TESTS], timeout=600)
    assert code == 0
    ranks = workers.read_ranks(out, D)
    single = {}
    for name, mcfg in mcfgs.items():
        cfg = {"seed": 5, "save_dir": str(tmp / f"single_{name}"), "dataset": {},
               "model": mcfg, "train": {}}
        runner = SparseCitationRunner(cfg, "cpu", graph=graph)
        runner.model.load_state_dict(weights[name])
        own = runner.extras
        for mode in MODES:
            if name == "GPNN":  # the sharded run's partition: of the padded graph
                runner.extras = (ranks[0][(name, mode)]["part"],)
            elif mode != MODES[0]:
                single[(name, mode)] = single[(name, MODES[0])]
                continue
            res = {"logits": runner.gathered_logits(), "own_extras": own,
                   "extras": runner.extras}
            runner.make_train_step(torch.optim.SGD(runner.model.parameters(), lr=0.0))()
            res["grads"] = {k: p.grad.clone() for k, p in runner.model.named_parameters()}
            single[(name, mode)] = res
    return {"graph": graph, "params": params, "ranks": ranks, "single": single}


def jax_extras(name: str, mode: str, setting, jop, mesh, sop, n_pad: int):
    """(extras, extra_specs) of the JAX model in ``mode``."""
    if name == "GPNN":
        part = setting["ranks"][0][(name, mode)]["part"].numpy().astype(np.int32)
        if mode == "edges":
            return (jnp.asarray(part),), None
        padded = np.concatenate([part, np.zeros(n_pad - N, np.int32)])
        return (jmesh.shard_node_array(padded, mesh, n_pad),), (P(jmesh.DATA_AXIS),)
    if name == "LanczosNet":
        if mode == "edges":
            return jsp.sparse_lanczos_ritz(jop, K), None
        ritz = jax.jit(jax.shard_map(lambda op: jsp.sparse_lanczos_ritz(op, K), mesh=mesh,
                                     in_specs=(sop.shard_specs(jmesh.DATA_AXIS),),
                                     out_specs=(P(), P(jmesh.DATA_AXIS))))(sop)
        return ritz, (P(), P(jmesh.DATA_AXIS))
    return None, None


def jax_logits(name: str, mode: str, setting) -> np.ndarray:
    graph, params = setting["graph"], setting["params"][name]
    module, jop = flax_module(name), jax_operator(name, graph["edges"])
    x = np.asarray(graph["features"])
    if name == "AdaLanczosNet" and mode == "edges":
        return np.asarray(module.apply({"params": params}, jnp.asarray(x), jop))
    mesh = jmesh.make_mesh(D)
    if mode == "edges":
        sop, n_pad, xs = jmesh.shard_sparse_op(jop, mesh), N, jnp.asarray(x)
    else:
        shard = jmesh.node_shard_sparse_op if mode == "nodes" else jmesh.ring_shard_sparse_op
        sop, n_pad = shard(jop, mesh)
        xs = jmesh.shard_node_array(np.concatenate([x, np.zeros((n_pad - N, F_IN), x.dtype)]),
                                    mesh, n_pad)
    extras, specs = jax_extras(name, mode, setting, jop, mesh, sop, n_pad)
    apply = jax.jit(lambda p, xs, sop, extras: sharded_sparse_apply(
        mesh, module, p, xs, sop, extras=extras, extra_specs=specs))
    return np.asarray(apply(params, xs, sop, extras))[:N]


def jax_grads(name: str, mode: str, setting) -> dict:
    """The JAX model's gradients of the masked mean cross-entropy on one
    device (the port's extras: the same Ritz pairs and partition)."""
    single = setting["single"][(name, mode)]
    if "jax_grads" in single:
        return single["jax_grads"]
    graph = setting["graph"]
    module, jop = flax_module(name), jax_operator(name, graph["edges"])
    extras = tuple(jnp.asarray(e.numpy()) for e in single["extras"])
    labels = jnp.asarray(graph["labels"].astype(np.int32))
    m = jnp.asarray(graph["train_mask"].astype(np.float32))

    def loss(p):
        logits = module.apply({"params": p}, jnp.asarray(graph["features"]), jop, *extras)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce * m) / jnp.sum(m)

    grads = jax.jit(jax.grad(loss))(setting["params"][name])
    single["jax_grads"] = sparse_state_dict(jax.tree.map(np.asarray, grads))
    return single["jax_grads"]


def assert_grads_close(got: dict, want: dict, what: str, tol: float = TOL) -> None:
    """Within ``tol`` of each parameter's largest entry, that floored at
    1e-2 of the model's largest entry: a gradient that is 0 but for rounding (GAT's last
    ``att_dst``, which the softmax does not see where every logit is past
    the leaky ReLU's kink; AdaLanczosNet's ``kernel_embed.bias``, which
    differences of embeddings do not see), or 500 times smaller than the
    largest (AdaLanczosNet's last filter MLP), is held to that."""
    assert set(got) == set(want)
    want = {k: torch.as_tensor(np.asarray(g)) for k, g in want.items()}
    floor = 1e-2 * max(float(g.abs().max()) for g in want.values())
    for key, g in want.items():
        scale = max(float(g.abs().max()), floor)
        torch.testing.assert_close(got[key] / scale, g / scale, rtol=0, atol=tol,
                                   msg=f"{what}: {key}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_model_equals_jax(setting, name, mode):
    ranks = setting["ranks"]
    mine = ranks[0][(name, mode)]
    assert mine["logits"].shape == (N, C)
    np.testing.assert_allclose(mine["logits"].numpy(), jax_logits(name, mode, setting),
                               rtol=0, atol=TOL)
    # every rank holds the same whole-graph logits and the same summed gradients
    for res in ranks[1:]:
        assert torch.equal(res[(name, mode)]["logits"], mine["logits"])
    assert_grads_close(mine["grads"], setting["single"][(name, mode)]["grads"],
                       "port, one device")
    assert_grads_close(mine["grads"], jax_grads(name, mode, setting), "JAX",
                       ADA_JAX_GRAD_TOL if name == "AdaLanczosNet" else TOL)
    for res in ranks[1:]:
        for key, g in res[(name, mode)]["grads"].items():
            assert torch.equal(g, mine["grads"][key]), key
        for key, p in res[(name, mode)]["params"].items():
            assert torch.equal(p, mine["params"][key]), key


def vfv(vals: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    v = vecs.astype(np.float64)
    return (v * vals.astype(np.float64) ** 3) @ v.T


@pytest.mark.parametrize("mode", MODES)
def test_sharded_ritz_pairs(setting, mode):
    vals, vecs = (t.numpy() for t in setting["ranks"][0][("LanczosNet", mode)]["ritz"])
    want_vals, want_vecs = (t.numpy() for t in setting["single"][("LanczosNet", mode)]["extras"])
    np.testing.assert_allclose(vals, want_vals, rtol=0, atol=TOL)
    np.testing.assert_allclose(vfv(vals, vecs), vfv(want_vals, want_vecs), rtol=0, atol=TOL)
    for res in setting["ranks"][1:]:
        assert torch.equal(torch.as_tensor(res[("LanczosNet", mode)]["ritz"][0]),
                           torch.as_tensor(vals))
    if mode == "edges":
        return
    graph = setting["graph"]
    mesh = jmesh.make_mesh(D)
    shard = jmesh.node_shard_sparse_op if mode == "nodes" else jmesh.ring_shard_sparse_op
    sop, _ = shard(jax_operator("LanczosNet", graph["edges"]), mesh)
    jvals, jvecs = jax_extras("LanczosNet", mode, setting, None, mesh, sop, 0)[0]
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=0, atol=RITZ_JAX_TOL)
    np.testing.assert_allclose(vfv(vals, vecs), vfv(np.asarray(jvals), np.asarray(jvecs)[:N]),
                               rtol=0, atol=RITZ_JAX_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_gpnn_partition_is_that_of_the_padded_graph(setting, mode):
    """Rank 0 partitions the whole graph with its padding nodes (none in
    edge mode), as the JAX runner does, and the ranks hold its cut."""
    from lanczosnet_torch.data.partition import sparse_spectral_partition
    from lanczosnet_torch.ops.sparse import sparse_sym_operator

    n_pad = N if mode == "edges" else -(-N // D) * D
    want = sparse_spectral_partition(sparse_sym_operator(setting["graph"]["edges"], n_pad), 2,
                                     seed=5)[:N]
    got = setting["ranks"][0][("GPNN", mode)]["part"]
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "edges":  # no padding: the single-device runner's own
        np.testing.assert_array_equal(got.numpy(),
                                      setting["single"][("GPNN", mode)]["own_extras"][0].numpy())
