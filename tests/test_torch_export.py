"""``torch.export`` artifacts of the port's request program, on the CPU.

A narrow LanczosNet run (written as ``QM8Runner`` writes one) is
exported and loaded back; the artifact answers bit for bit as the
``Predictor`` it came from (max abs error 0.0) on both wires, behind
``MicroBatcher`` and ``ModelServer`` too. A GPNN artifact takes the
host's partition. An artifact for another device type or a newer format
is refused loudly. The Lanczos custom operator passes
``torch.library.opcheck`` and is one node of the exported graph.
"""

import json
import threading

import numpy as np
import pytest
import torch

from lanczosnet_torch import export as export_mod
from lanczosnet_torch.data.dataset import LabelStats
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.export import (
    ArtifactPredictor,
    export_predictor,
    is_artifact_dir,
    load_predictor,
)
from lanczosnet_torch.models import build_model
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.ops.precision import bf16_f32_accumulation, f32_matmul
from lanczosnet_torch.serve import MicroBatcher, Predictor
from lanczosnet_torch.serve_http import ModelServer
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.utils.config import dumps

N_MAX, BATCH = 16, 8
LNET = {"name": "LanczosNet", "hidden_dim": [16, 16], "embed_dim": 16,
        "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5], "num_eig_vec": 6,
        "spectral_filter_kind": "MLP", "filter_hidden_dim": 8, "dropout": 0.1}
GPNN = {"name": "GPNN", "hidden_dim": [16, 16], "embed_dim": 16, "num_partition": 2}


def write_run(run_dir, mcfg: dict, seed: int = 0):
    """A run directory as ``QM8Runner`` leaves one: ``config.yaml``, the
    ``best`` checkpoint of a seeded model and its meta (stats, width)."""
    cfg = {"exp_name": "tiny", "runner": "QM8Runner", "seed": seed,
           "dataset": {"source": "synthetic", "n_max": N_MAX, "num_atom": 8,
                       "operator_kind": "sym"},
           "model": dict(mcfg), "train": {"batch_size": BATCH}}
    run_dir.mkdir(parents=True)
    (run_dir / "config.yaml").write_text(dumps(cfg))
    model = build_model({**mcfg, "num_atom": 8, "num_task": 16})
    model.init_weights(torch.Generator().manual_seed(seed))
    labels = np.stack([g["label"] for g in synthetic_qm8_graphs(32, seed=seed, n_hi=N_MAX)])
    stats = LabelStats.fit(labels)
    Checkpointer(run_dir).save("best", {"model": model.state_dict()}, {
        "epoch": 0, "num_task": 16, "label_mean": stats.mean.tolist(),
        "label_std": stats.std.tolist()})
    return run_dir


@pytest.fixture(scope="module")
def lnet(tmp_path_factory):
    """(run dir, its Predictor, its artifact dir)."""
    tmp = tmp_path_factory.mktemp("export")
    run = write_run(tmp / "run", LNET)
    pred = Predictor.from_run_dir(run, batch_size=BATCH, device="cpu")
    return run, pred, export_predictor(pred, tmp / "artifact")


def requests(n=11, seed=5, scale=1.0):
    return [{**g, "adj": g["adj"] * scale}
            for g in synthetic_qm8_graphs(n, seed=seed, n_hi=N_MAX)]


@pytest.mark.parametrize("scale", [1.0, 0.5], ids=["compact-wire", "float32-wire"])
def test_round_trip_equals_the_predictor_bit_for_bit(lnet, scale):
    _, pred, art = lnet
    loaded = load_predictor(art, device="cpu")
    assert isinstance(loaded, ArtifactPredictor) and loaded.model is None
    graphs = requests(scale=scale)
    assert loaded._compact_ok(graphs) == (scale == 1.0)
    want, got = pred.predict(graphs), loaded.predict(graphs)
    assert got.shape == want.shape == (11, 16)
    np.testing.assert_array_equal(got, want)


def test_artifact_holds_the_contract_and_the_custom_op(lnet):
    _, pred, art = lnet
    assert is_artifact_dir(art) and not is_artifact_dir(art.parent / "run")
    meta = json.loads((art / "meta.json").read_text())
    assert meta["format_version"] == 1 and meta["device_type"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert (meta["n_max"], meta["batch_size"], meta["num_eig_vec"], meta["num_task"]) == (
        N_MAX, BATCH, 6, 16)
    np.testing.assert_array_equal(meta["label_std"], pred.stats.std)
    for name in ("request_program.pt2", "request_program_f32.pt2"):
        program = torch.export.load(art / name)
        assert "lanczosnet.lanczos_tridiag_resid" in program.graph_module.code
        dtypes = [s.arg.name for s in program.graph_signature.input_specs
                  if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
        assert len(dtypes) == (3 if name == "request_program.pt2" else 4)


def test_artifact_behind_microbatcher(lnet):
    _, pred, art = lnet
    loaded = load_predictor(art, device="cpu")
    loaded.warmup()
    graphs = requests(13, seed=2)
    mb = MicroBatcher(loaded, max_delay_ms=2.0)
    try:
        got = np.stack([f.result(timeout=60) for f in [mb.submit(g) for g in graphs]])
    finally:
        mb.close()
    np.testing.assert_array_equal(got, pred.predict(graphs))


def test_model_server_takes_artifact_and_run_dirs(lnet):
    run, pred, art = lnet
    srv = ModelServer.from_run_dirs({"art": art, "run": run}, batch_size=BATCH, device="cpu")
    try:
        assert isinstance(srv._predictors["art"], ArtifactPredictor)
        assert not isinstance(srv._predictors["run"], ArtifactPredictor)
        graphs = requests(5, seed=3)
        np.testing.assert_array_equal(srv.predict("art", graphs), srv.predict("run", graphs))
        assert [m["name"] for m in srv.models()] == ["art", "run"]
    finally:
        srv.close()


def test_wrong_device_artifact_is_loud(lnet, tmp_path):
    _, _, art = lnet
    meta = json.loads((art / "meta.json").read_text())
    for name in ("request_program.pt2", "request_program_f32.pt2"):
        (tmp_path / name).write_bytes((art / name).read_bytes())
    (tmp_path / "meta.json").write_text(json.dumps({**meta, "device_type": "cuda"}))
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        load_predictor(tmp_path, device="cpu")


def test_future_format_version_is_refused(lnet, tmp_path):
    _, _, art = lnet
    meta = json.loads((art / "meta.json").read_text())
    (tmp_path / "meta.json").write_text(json.dumps({**meta, "format_version": 2}))
    with pytest.raises(ValueError, match="newer"):
        load_predictor(tmp_path, device="cpu")


def test_export_cli(lnet, tmp_path, capsys):
    run, pred, _ = lnet
    export_mod.main([str(run), "-o", str(tmp_path / "cli_art"), "--batch-size", str(BATCH),
                     "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["artifact"] == str(tmp_path / "cli_art") and out["device_type"] == "cpu"
    graphs = requests(4, seed=8)
    np.testing.assert_array_equal(load_predictor(tmp_path / "cli_art", device="cpu")
                                  .predict(graphs), pred.predict(graphs))


def test_gpnn_artifact_takes_the_hosts_partition(tmp_path):
    run = write_run(tmp_path / "gpnn_run", GPNN, seed=3)
    pred = Predictor.from_run_dir(run, batch_size=BATCH, device="cpu")
    art = export_predictor(pred, tmp_path / "gpnn_art")
    assert not (art / "request_program.pt2").exists()  # no compact wire: no partition on it
    program = torch.export.load(art / "request_program_f32.pt2")
    users = [s for s in program.graph_signature.input_specs
             if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    assert [s.arg.name for s in users][-1] == "cluster"
    loaded = load_predictor(art, device="cpu")
    graphs = requests(10, seed=4)
    assert not loaded._compact_ok(graphs)
    np.testing.assert_array_equal(loaded.predict(graphs), pred.predict(graphs))


@pytest.mark.parametrize("n,k", [(12, 5), (130, 4)], ids=["shared-memory-shape", "stream-shape"])
def test_custom_op_passes_opcheck_and_equals_the_wrapper(n, k):
    rng = np.random.default_rng(n)
    s = rng.standard_normal((2, n, n)).astype(np.float32)
    s = torch.from_numpy(0.5 * (s + s.transpose(0, 2, 1)))
    mask = torch.ones(2, n)
    mask[1, n // 2:] = 0.0
    torch.library.opcheck(lanczos_cuda.lanczos_tridiag_resid_op, (s, mask, k, 1e-6, "auto"))
    got = torch.ops.lanczosnet.lanczos_tridiag_resid(s, mask, k, 1e-6, "auto")
    want = lanczos_cuda.lanczos_tridiag_cuda_resid(s, mask, k, 1e-6)
    assert len(got) == 6
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_precision_blocks_count_their_threads():
    """The TF32 and bfloat16-reduction flags are the process's: the last
    thread out of a block restores them, not the first."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = True
    matmul.allow_bf16_reduced_precision_reduction = True
    inside, leave = threading.Event(), threading.Event()

    def other():
        with f32_matmul(), bf16_f32_accumulation():
            inside.set()
            leave.wait(10)

    try:
        t = threading.Thread(target=other)
        t.start()
        assert inside.wait(10)
        with f32_matmul(), bf16_f32_accumulation():
            assert not matmul.allow_tf32
        assert not matmul.allow_tf32 and not matmul.allow_bf16_reduced_precision_reduction
        leave.set()
        t.join(10)
        assert matmul.allow_tf32 and matmul.allow_bf16_reduced_precision_reduction
    finally:
        leave.set()
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved
