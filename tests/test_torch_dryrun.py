"""The multi-rank dry run (``python -m lanczosnet_torch.dryrun``) on the
CPU: four ranks in one launch run every axis of
``__graft_entry__.py:dryrun_multichip``, each sharded loss within 1e-5
relative of one device's and the artifact 0.0 from the Predictor. The
launch starts from the flax parameters of ``__graft_entry__._model()``
carried across by ``weights.py``, and the data-parallel (axis 1) and
tp=4 (axis 7) losses are held to the JAX train step's loss on those
parameters (1e-5 relative). About 20 s on one worker.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_tpu.train.step import init_state, make_train_step
from lanczosnet_torch import dryrun
from lanczosnet_torch.parallel import multihost
from lanczosnet_torch.weights import lanczos_net_state_dict

RANKS = 4


@pytest.fixture(scope="module")
def jax_first_step(tmp_path_factory):
    """The JAX dry run's first step (axis 1) on one CPU device: its loss,
    and its initial parameters saved for the port."""
    tmp = tmp_path_factory.mktemp("dryrun")
    model, batch = graft._model(), graft._tiny_batch(2 * RANKS)
    tx, _ = jax_build_optimizer({"optimizer": "Adam", "lr": 1e-3}, 1)
    state = init_state(model, batch, tx, seed=0)
    path = tmp / "state.pt"
    torch.save(lanczos_net_state_dict(jax.tree.map(np.asarray, state.params)), path)
    _, loss = make_train_step(model, tx)(state, batch, jnp.ones(2 * RANKS, jnp.float32))
    return float(loss), str(path), tmp


def test_the_dry_run_holds_every_axis_to_one_device_and_jax(jax_first_step, capfd):
    jloss, state_path, tmp = jax_first_step
    code = multihost.launch(RANKS, "lanczosnet_torch.dryrun:run_rank", [str(tmp), state_path],
                            device="cpu", store_dir=tmp, threads=1, timeout=300)
    out = capfd.readouterr().out
    assert code == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith(("{\"dryrun\"", "dryrun("))]
    result, ok = json.loads(lines[-2])["dryrun"], lines[-1]
    assert ok.startswith(f"dryrun({RANKS}): ok, dp_loss=")
    assert ok.endswith("export_roundtrip_max_err=0.00e+00")
    names = ["dp", "device_shuffle", "node_sharded", "edge_sharded_sparse",
             "node_sharded_sparse", "ring_sharded_sparse", "ring_gat", "tp4", "ring_ada",
             "ring_gpnn"]
    assert list(result["losses"]) == names
    for name, (sharded, one) in result["losses"].items():
        assert np.isfinite(sharded) and sharded == pytest.approx(one, rel=1e-5), name
    assert result["export_roundtrip_max_err"] == 0.0
    assert result["devices"] == ["cpu"] * RANKS and result["backend"] == "gloo"
    # axes 1 and 7 against the JAX train step on the same parameters
    for name in ("dp", "tp4"):
        assert result["losses"][name][0] == pytest.approx(jloss, rel=1e-5), name


def test_the_command_and_its_refusals(capsys):
    assert dryrun.tp_degree(8) == 4 and dryrun.tp_degree(6) == 2 and dryrun.tp_degree(3) == 1
    with pytest.raises(SystemExit):
        dryrun.main(["--ranks", "1", "--device", "cpu"])
    assert "--ranks must be at least 2" in capsys.readouterr().err
