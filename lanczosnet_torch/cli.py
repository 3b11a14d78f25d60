"""Command-line entry of the port: the flags of ``run_exp.py``.

Counterpart of ``lanczosnet_tpu/cli.py``. Trains (or, with ``-t``,
tests) the experiment a config describes, on the card unless
``--device`` names another:

    python -m lanczosnet_torch.cli -c configs/qm8_lanczos_net.yaml
    python -m lanczosnet_torch.cli -c <config with test.test_model set> -t

The run directory is ``exp_dir/exp_name/run_id`` (``utils/config.py``);
it holds ``config.yaml``, ``run.log``, ``metrics.jsonl`` and
``checkpoints/``. The exit code is 0 when the run finished and 1 when it
raised; the traceback is in the log.

A config with ``train.num_devices: D > 1`` (``SparseCitationRunner``,
``CitationRunner``) runs on D ranks; a ``QM8Runner`` config with ``train.num_devices`` or
``train.tp`` > 1 on the dp·tp ranks of its mesh
(``parallel/mesh.py:mesh_shape``: ``num_devices`` defaults to ``tp``,
and devices past dp·tp are left out, as the JAX runner leaves them).
Outside a process group this command starts the ranks itself, local
processes (``parallel/multihost.py:launch``), and its exit code is
theirs; under ``torchrun --nproc-per-node D`` each rank joins the
group, and rank 0 mints the run directory for all. Rank r > 0 logs to
``run.rank<r>.log``. A group whose size is not the run's raises.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

import numpy as np

from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.train.runner import build_runner
from lanczosnet_torch.train.unported import refuse_unported
from lanczosnet_torch.utils.config import AttrDict, load_config, loads, parse_arguments
from lanczosnet_torch.utils.logger import get_logger, setup_logging


def num_ranks(config) -> int:
    """The ranks a config runs on: ``QM8Runner``'s mesh, dp·tp; the
    other runners' ``train.num_devices``. 1 where no mesh fits the
    config: the runner raises that, into the run's log."""
    tcfg = config.get("train") or {}
    if config.get("runner", "QM8Runner") != "QM8Runner":
        return int(tcfg.get("num_devices", 1) or 1)
    try:
        dp, tp = mesh.mesh_shape(int(tcfg.get("batch_size", 1)),
                                 int(tcfg.get("num_devices") or 0), int(tcfg.get("tp") or 1))
    except ValueError:
        return 1
    return dp * tp


def run(config, test: bool, log_level: str = "INFO", device=None) -> int:
    """Build the config's runner and train or test it → the exit code.
    In a sharded run every rank calls this, inside the group."""
    rank = multihost.world().rank if num_ranks(config) > 1 else 0
    name = "run.log" if rank == 0 else f"run.rank{rank}.log"
    setup_logging(Path(config.save_dir) / name, log_level, stream=rank == 0)
    log = get_logger()
    log.info("exp %s | run %s", config.exp_name, config.run_id)
    np.random.seed(int(config.seed))
    try:
        runner = build_runner(config, device)
        result = runner.test() if test else runner.train()
        log.info("done: %s", result)
        return 0
    except Exception:  # the entry point reports any failure as exit code 1
        log.error("run failed:\n%s", traceback.format_exc())
        return 1


def run_rank(config_path: str, test: bool, log_level: str, device) -> int:
    """A rank that ``launch`` started: the run directory's own config."""
    config = AttrDict.convert(loads(Path(config_path).read_text()))
    return run(config, test, log_level, device)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    if multihost.in_torchrun():
        # every rank got the same command: rank 0 mints the run identity
        comm = multihost.initialize(int(_peek_devices(args.config_file)), args.device).comm
        config = comm.broadcast_object(
            load_config(args.config_file, is_test=args.test, comment=args.comment)
            if comm.rank == 0 else None)
        return run(config, args.test, args.log_level, args.device)
    config = load_config(args.config_file, is_test=args.test, comment=args.comment)
    ndev = num_ranks(config)
    if ndev <= 1:
        return run(config, args.test, args.log_level, args.device)
    setup_logging(f"{config.save_dir}/run.log", args.log_level)
    log = get_logger()
    try:
        refuse_unported(config)
    except (NotImplementedError, ValueError):
        log.error("run failed:\n%s", traceback.format_exc())
        return 1
    asked = int(config.train.get("num_devices") or 0)
    if asked > ndev:
        log.info("train.num_devices=%d: the mesh takes %d ranks, %d devices are left out",
                 asked, ndev, asked - ndev)
    log.info("exp %s | run %s | config %s | starting %d ranks", config.exp_name,
             config.run_id, args.config_file, ndev)
    code = multihost.launch(ndev, "lanczosnet_torch.cli:run_rank",
                            [str(Path(config.save_dir) / "config.yaml"), args.test,
                             args.log_level, args.device],
                            device=args.device, store_dir=config.save_dir)
    log.info("%d ranks exited %d", ndev, code)
    return code


def _peek_devices(path: str) -> int:
    return num_ranks(loads(Path(path).read_text()))


if __name__ == "__main__":
    sys.exit(main())
