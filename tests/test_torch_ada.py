"""The port's AdaLanczosNet and node-task LanczosNet against the flax
models, on the CPU.

Both sides get the same parameters (flax init, moved through
``lanczosnet_torch.weights``) and the same batch, and run in eval mode.
On the CPU the port's in-forward Lanczos is the plain version of the
kernel the graph's size picks: the streamed one at N=270 (unfused
path), the shared-memory one at N=32 (fused path); the JAX side runs
its ``lax.scan``. Tolerances, as ``PARITY.md`` records them for the
parity suite: the learned operator 1e-5, Ritz values 5e-4, outputs
1e-4; parameter gradients 2e-3 of each leaf's largest entry (they pass
through two eigensolvers and two orders of summation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.core.graph_batch import GraphBatch as JaxGraphBatch
from lanczosnet_tpu.data.citation import (
    pack_citation as jax_pack_citation,
    synthetic_citation_graph as jax_synthetic_citation_graph,
)
from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.ops.normalize import build_operator_stack as jax_build_operator_stack
from lanczosnet_tpu.train.node_step import masked_ce_loss as jax_masked_ce_loss
from lanczosnet_torch.core.graph_batch import GraphBatch, batch_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.train.node_step import masked_ce_loss
from lanczosnet_torch.weights import ada_lanczos_net_state_dict, lanczos_net_state_dict

ADA = dict(
    name="AdaLanczosNet", hidden_dim=[16, 16], embed_dim=16, kernel_dim=8,
    use_graph_support=True, short_diffusion_dist=[1, 2, 3], long_diffusion_dist=[5, 7],
    num_eig_vec=10, spectral_filter_kind="MLP", filter_hidden_dim=8, dropout=0.5,
)


def to_torch_batch(b: JaxGraphBatch) -> GraphBatch:
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    return GraphBatch(
        atom_type=t(b.atom_type), node_feat=t(b.node_feat), ops=t(b.ops), mask=t(b.mask),
        label=t(b.label), ritz_val=t(b.ritz_val), ritz_vec=t(b.ritz_vec),
        node_label=t(b.node_label),
    )


def citation_batch(num_eig_vec: int = 0):
    """Synthetic cora at scale 0.1 (N=270 > 128), packed by the JAX package."""
    graph = jax_synthetic_citation_graph("cora", seed=7, scale=0.1)
    batch, splits = jax_pack_citation(graph, pad_to=1, num_eig_vec=num_eig_vec)
    return batch, splits, int(graph["num_class"])


def qm8_batch(num: int = 8, n_max: int = 32) -> JaxGraphBatch:
    host = batch_graphs(synthetic_qm8_graphs(num, seed=0, n_lo=4, n_hi=n_max), n_max)
    ops = np.asarray(jax_build_operator_stack(host["adj"], host["mask"]))
    return JaxGraphBatch(
        atom_type=host["atom_type"], node_feat=host["node_feat"], ops=ops,
        mask=host["mask"], label=host["label"],
    )


def both_models(cfg: dict, batch: JaxGraphBatch, to_state_dict):
    flax_model = jax_build_model(cfg)
    params = flax_model.init(jax.random.PRNGKey(0), batch, deterministic=True)["params"]
    port_cfg = {
        **cfg, "num_edge_type": batch.ops.shape[1] - 1, "node_feat_dim": batch.node_feat.shape[-1],
    }
    port = build_model(port_cfg)
    port.load_state_dict(to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return flax_model, params, port.eval()


def flax_grads_as_state_dict(grads, to_state_dict):
    return to_state_dict(jax.tree.map(np.asarray, grads))


def assert_grads_match(port, want: dict, rel: float):
    got = {name: p.grad for name, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None and torch.isfinite(g).all(), name
        scale = max(float(want[name].abs().max()), 1e-6)
        np.testing.assert_allclose(
            g.numpy() / scale, want[name].numpy() / scale, atol=rel, err_msg=name
        )


def test_ada_lanczos_net_node_task_matches_flax_on_unfused_path():
    batch, splits, num_class = citation_batch()
    assert batch.mask.shape[1] == 270
    cfg = {**ADA, "task": "node", "num_atom": 2, "num_task": num_class}
    flax_model, params, port = both_models(cfg, batch, ada_lanczos_net_state_dict)
    tb = to_torch_batch(batch)

    want, inter = flax_model.apply(
        {"params": params}, batch, deterministic=True, mutable=["intermediates"]
    )
    inter = inter["intermediates"]
    h = port.encoder(tb.atom_type, tb.node_feat, tb.mask)
    s_op = port.learned_operator(h, tb)
    np.testing.assert_allclose(s_op.detach().numpy(), np.asarray(inter["s_op"][0]), atol=1e-5)
    ritz_val, _ = port.ritz_pairs(s_op, tb.mask)
    np.testing.assert_allclose(
        ritz_val.detach().numpy(), np.asarray(inter["ritz_val"][0]), atol=5e-4
    )
    got = port(tb)
    assert got.shape == (1, 270, num_class)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)

    sup = np.asarray(splits["train"])
    masked_ce_loss(got, tb.node_label, torch.from_numpy(sup)).backward()
    grads = jax.grad(lambda p: jax_masked_ce_loss(
        flax_model.apply({"params": p}, batch, deterministic=True), batch.node_label, sup
    ))(params)
    assert_grads_match(port, flax_grads_as_state_dict(grads, ada_lanczos_net_state_dict), 2e-3)


def test_ada_lanczos_net_graph_task_matches_flax_on_fused_path():
    batch = qm8_batch()
    cfg = {**ADA, "num_atom": 8, "num_task": 16, "dropout": 0.1}
    flax_model, params, port = both_models(cfg, batch, ada_lanczos_net_state_dict)
    tb = to_torch_batch(batch)
    want, inter = flax_model.apply(
        {"params": params}, batch, deterministic=True, mutable=["intermediates"]
    )
    inter = inter["intermediates"]
    h = port.encoder(tb.atom_type, tb.node_feat, tb.mask)
    s_op = port.learned_operator(h, tb)
    np.testing.assert_allclose(s_op.detach().numpy(), np.asarray(inter["s_op"][0]), atol=1e-5)
    np.testing.assert_allclose(
        port.ritz_pairs(s_op, tb.mask)[0].detach().numpy(),
        np.asarray(inter["ritz_val"][0]), atol=5e-4,
    )
    got = port(tb)
    assert got.shape == (8, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)

    label = np.asarray(batch.label)
    (got - torch.from_numpy(label)).abs().mean().backward()
    grads = jax.grad(lambda p: jnp.mean(jnp.abs(
        flax_model.apply({"params": p}, batch, deterministic=True) - label
    )))(params)
    assert_grads_match(port, flax_grads_as_state_dict(grads, ada_lanczos_net_state_dict), 2e-3)


def test_lanczos_net_node_task_matches_flax_on_unfused_path():
    """``cora_lanczos_net`` in small: precomputed Ritz pairs, the factored
    path at N=270 and the node head."""
    batch, _, num_class = citation_batch(num_eig_vec=10)
    cfg = {k: v for k, v in ADA.items() if k not in ("kernel_dim", "use_graph_support")}
    cfg.update(name="LanczosNet", task="node", num_atom=2, num_task=num_class)
    flax_model, params, port = both_models(cfg, batch, lanczos_net_state_dict)
    want = flax_model.apply({"params": params}, batch, deterministic=True)
    with torch.no_grad():
        got = port(to_torch_batch(batch))
    assert got.shape == (1, 270, num_class)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ada_lanczos_impl_names():
    cfg = {**ADA, "num_atom": 8, "num_task": 16}
    assert build_model(cfg).lanczos_impl == "auto"
    assert build_model({**cfg, "lanczos_impl": "plain"}).lanczos_impl == "plain"
    with pytest.raises(ValueError, match="lanczos_impl"):
        build_model({**cfg, "lanczos_impl": "scan"})
    # "kernel" on a CPU batch raises: the kernels run only on the card
    model = build_model({**cfg, "lanczos_impl": "kernel", "num_edge_type": 4}).eval()
    with pytest.raises(ValueError, match="CUDA"):
        model(to_torch_batch(qm8_batch(2)))


def test_ada_init_weights_is_seeded():
    cfg = {**ADA, "num_atom": 8, "num_task": 16}
    a, b, c = build_model(cfg), build_model(cfg), build_model(cfg)
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    c.init_weights(torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert "kernel_embed.weight" in sa
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["kernel_embed.weight"], sc["kernel_embed.weight"])
    assert float(sa["kernel_embed.bias"].abs().max()) == 0.0


def test_weight_map_of_ada_raises_on_stray_leaf():
    batch = qm8_batch(2)
    cfg = {**ADA, "num_atom": 8, "num_task": 16}
    params = jax.tree.map(
        np.asarray,
        jax_build_model(cfg).init(jax.random.PRNGKey(0), batch, deterministic=True)["params"],
    )
    with pytest.raises(KeyError, match="kernel_embed"):
        lanczos_net_state_dict(params)  # the LanczosNet map does not know the leaf
    no_embed = {k: v for k, v in params.items() if k != "kernel_embed"}
    with pytest.raises(KeyError, match="kernel_embed"):
        ada_lanczos_net_state_dict(no_embed)
