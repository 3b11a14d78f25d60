"""Command-line entry of the port: the flags of ``run_exp.py``.

Counterpart of ``lanczosnet_tpu/cli.py``. Trains (or, with ``-t``,
tests) the experiment a config describes, on the card:

    python -m lanczosnet_torch.cli -c configs/qm8_lanczos_net.yaml
    python -m lanczosnet_torch.cli -c <config with test.test_model set> -t

The run directory is ``exp_dir/exp_name/run_id`` (``utils/config.py``);
it holds ``config.yaml``, ``run.log``, ``metrics.jsonl`` and
``checkpoints/``. The exit code is 0 when the run finished and 1 when it
raised; the traceback is in the log.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np

from lanczosnet_torch.train.runner import build_runner
from lanczosnet_torch.utils.config import load_config, parse_arguments
from lanczosnet_torch.utils.logger import get_logger, setup_logging


def main(argv=None) -> int:
    args = parse_arguments(argv)
    config = load_config(args.config_file, is_test=args.test, comment=args.comment)
    setup_logging(f"{config.save_dir}/run.log", args.log_level)
    log = get_logger()
    np.random.seed(int(config.seed))
    log.info("exp %s | run %s | config %s", config.exp_name, config.run_id, args.config_file)
    try:
        runner = build_runner(config)
        result = runner.test() if args.test else runner.train()
        log.info("done: %s", result)
        return 0
    except Exception:  # the entry point reports any failure as exit code 1
        log.error("run failed:\n%s", traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(main())
