"""Serialized inference artifacts (``torch.export``).

Counterpart of ``lanczosnet_tpu/export.py``. A trained model becomes a
directory that serves without the model code or its config:

    artifact/
      request_program.pt2       torch.export of the request program on the
                                compact wire: (adj uint8 [B,E,N,N], atom
                                int32 [B,N], node_feat [B,N,Fc]) →
                                predictions [B,T]: the operator stack, for
                                LanczosNet the Ritz pairs (Lanczos as the
                                custom operator lanczosnet::
                                lanczos_tridiag_resid, the eigh, the
                                rotation) and the model, with its
                                parameters (written only when the
                                predictor has the compact wire on: never
                                for GPNN, whose partition it cannot carry)
      request_program_f32.pt2   the same on the float32 wire: (adj float32,
                                atom, node_feat, mask [B,N]), and for GPNN
                                cluster [B,N], the partition the host
                                computes per request
      meta.json                 the packing contract (n_max, batch_size,
                                operator kind, cluster count, label stats
                                and their type, task width),
                                torch_version, device_type,
                                format_version

B, N, E and Fc are fixed at export, as in the JAX package. The program
is ``serve.RequestProgram``, the module ``Predictor`` runs per request,
traced under ``torch.no_grad()`` on the predictor's device; the custom
operator's body runs each time the loaded program runs, so
``lanczos_cuda.launches`` counts its kernel launches on the card.
``load_predictor`` refuses an artifact exported for another device type
or a newer format, and runs the program with TF32 off and bfloat16
products accumulating in float32, whatever the serving process's flags:
the precision blocks of the model code flip those flags only while the
program is traced, not inside the exported graph.

    from lanczosnet_torch.serve import Predictor
    from lanczosnet_torch.export import export_predictor, load_predictor

    export_predictor(Predictor.from_run_dir(run_dir), "artifact/")
    pred = load_predictor("artifact/")     # no model code or config read
    y = pred.predict(graphs)               # the Predictor API, MicroBatcher too

    python -m lanczosnet_torch.export RUN_DIR -o OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

# imported for its side effect too: the custom operator the programs call
# is registered before torch.export.load reads them
from lanczosnet_torch.ops import lanczos_cuda  # noqa: F401
from lanczosnet_torch.data.dataset import LabelStats
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.ops.precision import bf16_f32_accumulation, f32_matmul
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.utils.device import resolve_device

PROGRAM_COMPACT = "request_program.pt2"
PROGRAM_F32 = "request_program_f32.pt2"
META = "meta.json"
FORMAT_VERSION = 1


def export_predictor(predictor: Predictor, out_dir: str | Path) -> Path:
    """Write ``predictor``'s request program(s) and ``meta.json`` to
    ``out_dir``, on the predictor's device."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # traced on one synthetic molecule, ghost-padded to the batch as every
    # request is
    probe = synthetic_qm8_graphs(1, seed=0, n_lo=4, n_hi=min(8, predictor.n_max))
    wires = [(PROGRAM_F32, False)]
    if predictor.compact_wire:
        wires.append((PROGRAM_COMPACT, True))
    program = predictor.program.eval()
    with torch.no_grad(), f32_matmul(), bf16_f32_accumulation():
        for name, compact in wires:
            args = predictor.device_args(*predictor._pack(probe, compact=compact))
            exported = torch.export.export(program, args)
            torch.export.save(exported, out_dir / name)
    meta = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device_type": predictor.device.type,
        "n_max": predictor.n_max,
        "batch_size": predictor.batch_size,
        "num_eig_vec": predictor.num_eig_vec,
        "num_cluster": predictor.num_cluster,
        "operator_kind": predictor.operator_kind,
        "num_task": predictor.num_task,
        "label_mean": (np.asarray(predictor.stats.mean).tolist()
                       if predictor.stats is not None else None),
        "label_std": (np.asarray(predictor.stats.std).tolist()
                      if predictor.stats is not None else None),
        # the stats' own type, so the artifact un-standardizes exactly as
        # the exported Predictor does
        "label_dtype": (np.asarray(predictor.stats.mean).dtype.name
                        if predictor.stats is not None else None),
    }
    (out_dir / META).write_text(json.dumps(meta, indent=1))
    return out_dir


class ArtifactPredictor(Predictor):
    """A :class:`Predictor` whose request program is a loaded artifact's:
    the same ``predict``/``warmup``/``_dispatch`` API, so ``MicroBatcher``
    and ``ModelServer`` take it unchanged, and no model code runs but the
    host's packing (and, for GPNN, its partition)."""

    def __init__(self, programs: dict[str, torch.nn.Module], meta: dict, device: torch.device):
        self.device = device
        self.model = None
        self.program = None
        self._programs = programs
        self.n_max = int(meta["n_max"])
        self.batch_size = int(meta["batch_size"])
        self.num_eig_vec = int(meta["num_eig_vec"])
        self.num_cluster = int(meta["num_cluster"])
        self.operator_kind = str(meta["operator_kind"])
        self.num_task = int(meta["num_task"])
        # the compact wire is what the artifact ships
        self.compact_wire = PROGRAM_COMPACT in programs
        self.stats = None
        if meta.get("label_mean") is not None:
            dtype = np.dtype(meta.get("label_dtype") or "float32")
            self.stats = LabelStats(mean=np.asarray(meta["label_mean"], dtype),
                                    std=np.asarray(meta["label_std"], dtype))

    def _run(self, args: tuple[torch.Tensor, ...]) -> torch.Tensor:
        program = self._programs[PROGRAM_COMPACT if len(args) == 3 else PROGRAM_F32]
        with f32_matmul():  # TF32 off: the traced program pinned float32 products
            return program(*args)


def load_predictor(artifact_dir: str | Path,
                   device: str | torch.device | None = None) -> ArtifactPredictor:
    """Rebuild a drop-in Predictor from :func:`export_predictor`'s output
    on ``device`` (the card unless the caller names another), which must
    be of the device type the artifact was exported on."""
    artifact_dir = Path(artifact_dir)
    meta = json.loads((artifact_dir / META).read_text())
    if int(meta.get("format_version", 0)) > FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta['format_version']} is newer than this library "
            f"understands ({FORMAT_VERSION})")
    device = resolve_device(device)
    if meta.get("device_type") != device.type:
        raise ValueError(
            f"the artifact in {artifact_dir} was exported on {meta.get('device_type')!r} but "
            f"would serve on {device.type!r}: export it again on this device type")
    programs = {}
    for name in (PROGRAM_COMPACT, PROGRAM_F32):
        if (artifact_dir / name).exists():
            programs[name] = torch.export.load(artifact_dir / name).module()
    return ArtifactPredictor(programs, meta, device)


def is_artifact_dir(path: str | Path) -> bool:
    """True when ``path`` looks like :func:`export_predictor`'s output."""
    p = Path(path)
    return (p / PROGRAM_F32).exists() and (p / META).exists()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Export a trained run to a torch.export inference artifact")
    ap.add_argument("run_dir", help="training run directory (config.yaml + checkpoints/), "
                    "the port's or the JAX package's")
    ap.add_argument("-o", "--out", required=True, help="artifact directory")
    ap.add_argument("--tag", default="best", help="checkpoint tag")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="device to export on and serve on (default: the card)")
    args = ap.parse_args(argv)
    predictor = Predictor.from_run_dir(args.run_dir, tag=args.tag, batch_size=args.batch_size,
                                       device=args.device)
    out = export_predictor(predictor, args.out)
    print(json.dumps({"artifact": str(out), **json.loads((out / META).read_text())}))


if __name__ == "__main__":
    main()
