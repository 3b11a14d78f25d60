"""Per-step training losses of the flagship on one device and on the QM8
runner's meshes, step against step.

Each run trains ``configs/qm8_lanczos_net.yaml`` (one device, and with
``train.num_devices: 4``: dp=4) or ``configs/qm8_lanczos_net_tp4.yaml``
(dp=1 × tp=4, and with ``num_devices: 8``: dp=2 × tp=4) for 2 epochs
through ``python -m lanczosnet_torch.cli``, on the per-step path with
every step's loss logged, the runs sharing one pack cache (the same
batches, weights and dropout masks in every run). Printed: each run's
validation MAE, and each mesh's relative distance from one device's
loss, step by step; then one JSON line with every loss.

Run from the repository's root on a machine with a CUDA card:

    python3 scripts/torch_qm8_mesh_divergence.py            # Adam, as written
    python3 scripts/torch_qm8_mesh_divergence.py --sgd      # SGD at lr 0.1
    python3 scripts/torch_qm8_mesh_divergence.py --device cpu --num-train 128
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lanczosnet_torch.utils import config as config_io  # noqa: E402

RUNS = (("one", "qm8_lanczos_net", {}), ("tp4", "qm8_lanczos_net_tp4", {}),
        ("dp2_tp4", "qm8_lanczos_net_tp4", {"num_devices": 8}),
        ("dp4", "qm8_lanczos_net", {"num_devices": 4}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sgd", action="store_true", help="SGD at lr 0.1 in place of Adam")
    ap.add_argument("--device", default=None, help="the CLI's --device (the card by default)")
    ap.add_argument("--num-train", type=int, default=None, help="cut the train split")
    args = ap.parse_args(argv)
    out = {}
    with tempfile.TemporaryDirectory(prefix="qm8_mesh_divergence_") as root:
        root = Path(root)
        env = {**os.environ, "LANCZOSNET_TORCH_CACHE": str(root / "cache")}
        for name, src, train in RUNS:
            cfg = config_io.loads((ROOT / "configs" / f"{src}.yaml").read_text())
            cfg["exp_dir"] = str(root / name)
            cfg["train"].update({"max_epoch": 2, "scan_epoch": False, "display_iter": 1, **train})
            if args.sgd:
                cfg["train"].update(optimizer="SGD", lr=0.1)
            if args.num_train:
                cfg["dataset"]["num_train"] = args.num_train
            path = root / f"{name}.yaml"
            path.write_text(config_io.dumps(cfg))
            cmd = [sys.executable, "-m", "lanczosnet_torch.cli", "-c", str(path),
                   *(["--device", args.device] if args.device else [])]
            if subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL).returncode:
                raise SystemExit(f"{name}: the CLI failed")
            (run,) = (root / name).glob("*/*_train")
            recs = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
            out[name] = {"train": [r["loss"] for r in recs if r["event"] == "train"],
                         "val": [r["mae"] for r in recs if r["event"] == "val"]}
            print(name, "val MAE", out[name]["val"], flush=True)
    one = out["one"]["train"]
    for name, res in out.items():
        rel = [abs(a - b) / abs(b) for a, b in zip(res["train"], one)]
        first = next((i for i, x in enumerate(rel) if x > 1e-6), None)
        print(f"{name}: {len(rel)} steps, largest {max(rel):.2e} from one device, first step "
              f"past 1e-6: {first}\n  " + " ".join(f"{x:.1e}" for x in rel), flush=True)
    print(json.dumps({"optimizer": "SGD" if args.sgd else "Adam", "losses": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
