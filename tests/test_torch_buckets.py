"""Size-bucketed QM8 training against the JAX package, on the CPU.

``data/buckets.py`` (bucket choice, merges, packs), the two piece
schedules of the resident trainer over buckets (chunk-interleaved and
paired), one paired step, and ``QM8Runner`` with ``dataset.buckets`` and
``train.bucket_pair`` end to end against the JAX runner. Tolerances:
operators 1e-6 (both packages pack through the same C++ packer, or the
torch path within 1e-6); Ritz values 1e-5 and V tanh(D) Vᵀ 1e-4 on the
graphs away from C1's band (``tests/test_torch_ops.py``; Ritz values
1e-4 at the bounds above K); a step's
parameters 1e-5 (SGD) and the runners' epoch losses 1e-5 relative (a
few steps of float32 rounding apart). About 55 s on one worker, most
of it the JAX runners' compiles.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanczosnet_tpu.data.buckets import pack_dataset_bucketed as jax_pack_bucketed
from lanczosnet_tpu.data.dataset import load_packed as jax_load_packed
from lanczosnet_tpu.data.dataset import save_packed as jax_save_packed
from lanczosnet_tpu.data.qm8 import synthetic_qm8_graphs as jax_synthetic_qm8_graphs
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.train import runner as jax_runner_mod
from lanczosnet_tpu.train import scan_epoch as jax_scan_epoch
from lanczosnet_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from lanczosnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from lanczosnet_tpu.train.scan_epoch import device_dataset as jax_device_dataset
from lanczosnet_tpu.train.step import TrainState
from lanczosnet_tpu.train.step import init_state as jax_init_state
from lanczosnet_tpu.utils.config import AttrDict
from lanczosnet_torch.data.buckets import bucket_of, group_by_bucket, pack_dataset_bucketed
from lanczosnet_torch.data.dataset import load_packed
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.runner import QM8Runner
from lanczosnet_torch.train.scan_epoch import (
    chunk_schedule,
    device_dataset,
    gather_batch,
    pair_schedule,
)
from lanczosnet_torch.train.step import make_pair_step
from lanczosnet_torch.weights import lanczos_net_state_dict

SMALL_LNET = {
    "name": "LanczosNet", "hidden_dim": [16, 16], "embed_dim": 16,
    "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5], "num_eig_vec": 6,
    "spectral_filter_kind": "MLP", "filter_hidden_dim": 8, "dropout": 0.0,
}
SMALL_GCN = {"name": "GCN", "hidden_dim": [16, 16], "embed_dim": 16, "dropout": 0.0}
BOUNDS = [8, 12, 16]


def sizes_of(graphs) -> list[int]:
    return [int(np.asarray(g["atom_type"]).shape[0]) for g in graphs]


def test_bucket_of_and_the_merges_equal_jax():
    assert bucket_of(5, BOUNDS) == 8 and bucket_of(8, BOUNDS) == 8 and bucket_of(9, BOUNDS) == 12
    with pytest.raises(ValueError, match="17 nodes > largest bucket 16"):
        bucket_of(17, BOUNDS)
    graphs = synthetic_qm8_graphs(40, seed=3, n_lo=4, n_hi=16)
    raw = {b: sum(bucket_of(n, BOUNDS) == b for n in sizes_of(graphs)) for b in BOUNDS}
    assert min(raw.values()) > 0
    # no merge; the smallest merged upward; the largest merged downward
    for min_count in (0, raw[8] + 1, raw[16] + 1):
        want, _ = jax_pack_bucketed(graphs, BOUNDS, min_count=min_count)
        got = group_by_bucket(graphs, BOUNDS, min_count)
        assert {b: len(gs) for b, gs in got.items()} == {b: len(d) for b, d in want.items()}
        for b, gs in got.items():
            assert max(sizes_of(gs)) <= b
    assert list(group_by_bucket(graphs, BOUNDS, 0)) == BOUNDS
    assert 8 not in group_by_bucket(graphs, BOUNDS, raw[8] + 1)
    merged_down = group_by_bucket(graphs, BOUNDS, raw[16] + 1)
    assert len(merged_down) < 3 and max(merged_down) == 16


def test_bucketed_packs_equal_jax_element_for_element():
    """Bounds [16, 24, 32] under K=20 (the 16 bound packs K > N), stats
    fitted on the union of the labels and reused by a second split."""
    graphs = synthetic_qm8_graphs(24, seed=5, n_lo=4, n_hi=28)
    other = synthetic_qm8_graphs(10, seed=6, n_lo=4, n_hi=28)
    bounds = [16, 24, 32]
    want, jstats = jax_pack_bucketed(graphs, bounds, standardize=True, num_eig_vec=20)
    got, stats = pack_dataset_bucketed(graphs, bounds, standardize=True, num_eig_vec=20,
                                       device="cpu")
    np.testing.assert_array_equal(stats.mean, jstats.mean)
    np.testing.assert_array_equal(stats.std, jstats.std)
    kept = total = 0
    for (b, g), (jb, w) in zip(got.items(), want.items()):
        assert b == jb and g.n_max == b and len(g) == len(w)
        for name in ("atom_type", "mask", "label", "node_feat"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        np.testing.assert_allclose(g.ops, w.ops, atol=1e-6)
        # 1e-5 where K ≥ N, as tests/test_torch_ops.py holds it; below K
        # the 20 steps of two orders of summation part by up to 1.8e-5 (a
        # graph of 25 nodes here), within the recursion's 1e-4 contract
        np.testing.assert_allclose(np.sort(g.ritz_val, -1), np.sort(w.ritz_val, -1),
                                   atol=1e-5 if b <= 20 else 1e-4)
        scan = jax.vmap(lambda s, m: jax_scan_w4(s, m))(jnp.asarray(g.ops[:, 0]),
                                                       jnp.asarray(g.mask))
        keep = ~np.asarray(scan)
        recon = lambda d, v: np.einsum("bnk,bk,bmk->bnm", v, np.tanh(d), v)  # noqa: E731
        np.testing.assert_allclose(recon(g.ritz_val, g.ritz_vec)[keep],
                                   recon(w.ritz_val, w.ritz_vec)[keep], atol=1e-4)
        kept, total = kept + int(keep.sum()), total + len(g)
    assert kept >= 0.75 * total, (kept, total)  # step 0's share: 6 of 8
    got2, _ = pack_dataset_bucketed(other, bounds, stats=stats, standardize=True, device="cpu")
    want2, _ = jax_pack_bucketed(other, bounds, stats=jstats, standardize=True)
    for g, w in zip(got2.values(), want2.values()):
        np.testing.assert_array_equal(g.label, w.label)


def jax_scan_w4(s, mask, k: int = 20):
    """Whether the JAX scan of one graph reaches a ‖w₄‖ in (1e-7, 1e-5)."""
    from lanczosnet_tpu.ops.lanczos import _lanczos_fwd_resid

    w_norm = jnp.linalg.norm(_lanczos_fwd_resid(s, mask, k, 1e-6)[5], axis=-1)
    return ((w_norm > 1e-7) & (w_norm < 1e-5)).any()


def bucket_config(save_dir, model: dict, **train) -> dict:
    return {
        "exp_name": "qm8_buckets", "runner": "QM8Runner", "seed": 1234, "save_dir": str(save_dir),
        "dataset": {"source": "synthetic", "name": "qm8", "n_max": 16, "num_atom": 8,
                    "num_train": 60, "num_val": 20, "num_test": 20, "standardize": True,
                    "operator_kind": "sym", "buckets": list(BOUNDS)},
        "train": {"optimizer": "SGD", "lr": 0.05, "wd": 0.0, "batch_size": 4,
                  "max_epoch": 2, "lr_decay": 0.3, "lr_decay_epoch": [10], "valid_epoch": 1,
                  "display_iter": 10, "is_resume": False, "bucket_chunk": 3, **train},
        "test": {"test_model": None},
        "model": dict(model),
    }


def epoch_losses(run_dir) -> list[float]:
    recs = [json.loads(ln) for ln in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [r["loss"] for r in recs if r["event"] == "epoch"]


@pytest.mark.parametrize("pair", [False, True], ids=["chunked", "paired"])
def test_piece_schedules_equal_the_jax_runners(tmp_path, monkeypatch, pair):
    """The JAX runner's own pieces, recorded where it calls its epoch
    programs (which record and return), against ``chunk_schedule`` /
    ``pair_schedule`` drawn from the same seed, over two epochs."""
    recorded = []

    def record_epoch(model, tx, **_):
        def fn(state, data, perm):
            recorded.append((data.mask.shape[1], np.asarray(perm)))
            return state, jnp.zeros(perm.shape[0])
        return fn

    def record_pair(model, tx, **_):
        def fn(state, da, pa, db, pb):
            recorded.append((da.mask.shape[1], np.asarray(pa), db.mask.shape[1], np.asarray(pb)))
            return state, jnp.zeros(pa.shape[0])
        return fn

    def no_eval(model):
        return lambda params, data, idx, valid: (jnp.zeros(16), jnp.ones(()))

    def tiny_state(model, batch, tx, seed=0):
        return TrainState(params={"w": jnp.zeros(1)}, opt_state=(), step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))

    monkeypatch.setattr(jax_runner_mod, "make_scan_train_epoch", record_epoch)
    monkeypatch.setattr(jax_runner_mod, "make_scan_eval", no_eval)
    monkeypatch.setattr(jax_runner_mod, "init_state", tiny_state)
    monkeypatch.setattr(jax_scan_epoch, "make_scan_pair_epoch", record_pair)
    cfg = bucket_config(tmp_path / "jax", SMALL_GCN, bucket_pair=pair)
    jax_runner = jax_runner_mod.build_runner(AttrDict.convert(cfg))
    jax_runner.train()
    sizes = {b: len(d) for b, d in jax_runner.datasets["train"].items()}
    assert len(sizes) == 3
    port = QM8Runner({**cfg, "save_dir": str(tmp_path / "port")}, "cpu")
    assert {b: len(d) for b, d in port.buckets("train").items()} == sizes
    rng = np.random.Generator(np.random.Philox(cfg["seed"]))
    bs, chunk = cfg["train"]["batch_size"], cfg["train"]["bucket_chunk"]
    want = []
    for _ in range(2):
        want += (pair_schedule(rng, sizes, bs // 2, chunk) if pair
                 else chunk_schedule(rng, sizes, bs, chunk))
    assert len(recorded) == len(want) > 3
    for got_piece, want_piece in zip(recorded, want):
        assert len(got_piece) == len(want_piece)
        for g, w in zip(got_piece, want_piece):
            np.testing.assert_array_equal(g, w)
    if pair:  # pieces of mixed sizes
        assert any(p[0] != p[2] for p in want)


def test_one_paired_step_equals_jax(tmp_path):
    """Two half-batches of two buckets of one JAX-packed split (read by
    both packages from npz), one SGD step from carried weights."""
    graphs = jax_synthetic_qm8_graphs(24, seed=11, n_lo=4, n_hi=16)
    want, _ = jax_pack_bucketed(graphs, [10, 16], standardize=True, num_eig_vec=6)
    jds, ds = {}, {}
    for b, d in want.items():
        jax_save_packed(d, tmp_path / f"{b}.npz")
        jds[b], ds[b] = jax_load_packed(tmp_path / f"{b}.npz"), load_packed(tmp_path / f"{b}.npz")
    (ba, bb), half = list(jds), 3
    ia, ib = np.array([[2, 0, 5]], np.int32), np.array([[1, 4, 3]], np.int32)
    jmodel = jax_build_model({**SMALL_LNET, "num_atom": 8, "num_task": 16})
    batch = jax.tree.map(jnp.asarray, jds[ba].slice_batch(np.arange(half)))
    params = jmodel.init(jax.random.PRNGKey(0), batch, deterministic=True)["params"]
    port = build_model({**SMALL_LNET, "num_atom": 8, "num_task": 16})
    port.load_state_dict(lanczos_net_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    tx, _ = jax_build_optimizer({"optimizer": "SGD", "lr": 0.1}, 1)
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(1))
    fn = jax_scan_epoch.make_scan_pair_epoch(jmodel, tx)
    state, jloss = fn(state, jax_device_dataset(jds[ba]), jnp.asarray(ia),
                      jax_device_dataset(jds[bb]), jnp.asarray(ib))
    optimizer, scheduler, clip = build_optimizer(port.parameters(), {"optimizer": "SGD", "lr": 0.1})
    step = make_pair_step(port, optimizer, scheduler, clip)
    cpu = torch.device("cpu")
    loss = step(gather_batch(device_dataset(ds[ba], cpu), torch.from_numpy(ia[0]).long()), half,
                gather_batch(device_dataset(ds[bb], cpu), torch.from_numpy(ib[0]).long()), half)
    assert float(loss) == pytest.approx(float(jloss[0]), abs=1e-6)
    wanted = lanczos_net_state_dict(jax.tree.map(np.asarray, state.params))
    for name, val in port.state_dict().items():
        np.testing.assert_allclose(val.numpy(), wanted[name].numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("pair", [True, False], ids=["paired", "chunked"])
def test_bucketed_runner_matches_the_jax_runner(tmp_path, pair):
    """The same graphs, buckets, initial weights (the JAX runner's init,
    carried through its msgpack) and schedules: epoch losses within 1e-5
    relative, the test MAE, and ``-t`` of each package's best checkpoint
    by the port."""
    cfg = bucket_config(tmp_path / "jax", SMALL_GCN, bucket_pair=pair)
    jcfg = AttrDict.convert(cfg)
    jax_runner = jax_runner_mod.build_runner(jcfg)
    first = next(iter(jax_runner.datasets["train"].values()))
    tx, _ = jax_build_optimizer(jcfg.train, 1)
    batch = jax.tree.map(lambda x: x[:4], jax_device_dataset(first))
    init = jax_init_state(jax_runner.model, batch, tx, seed=cfg["seed"])
    init_file = JaxCheckpointer(tmp_path / "init").save("init", init)
    jres = jax_runner.train()
    port_cfg = {**cfg, "save_dir": str(tmp_path / "port"),
                "train": {**cfg["train"], "resume_model": str(init_file)}}
    port = QM8Runner(port_cfg, "cpu")
    res = port.train()
    want, got = epoch_losses(tmp_path / "jax"), epoch_losses(tmp_path / "port")
    assert len(got) == 2 and got[1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert res["test_mae"] == pytest.approx(jres["test_mae"], rel=1e-5)
    assert port.test()["test_mae"] == pytest.approx(res["test_mae"], abs=1e-6)
    jax_best = tmp_path / "jax" / "checkpoints" / "best.msgpack"
    tested = QM8Runner({**cfg, "save_dir": str(tmp_path / "t"),
                        "test": {"test_model": str(jax_best)}}, "cpu").test()
    assert tested["test_mae"] == pytest.approx(jres["test_mae"], rel=1e-5)


def test_bucketed_refusals(tmp_path):
    cfg = bucket_config(tmp_path / "a", SMALL_GCN)
    packed = {**cfg, "dataset": {**cfg["dataset"], "source": "packed"}}
    with pytest.raises(ValueError, match="dataset.buckets needs raw graphs"):
        QM8Runner(packed, "cpu")
    streamed = QM8Runner({**cfg, "train": {**cfg["train"], "scan_epoch": False}}, "cpu")
    with pytest.raises(ValueError, match="scan_epoch must not be false with dataset.buckets"):
        streamed.train()
    one = {**cfg, "save_dir": str(tmp_path / "b"),
           "train": {**cfg["train"], "batch_size": 1, "bucket_pair": True}}
    with pytest.raises(ValueError, match="bucket_pair needs batch_size >= 2"):
        QM8Runner(one, "cpu").train()
