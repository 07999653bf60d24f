"""Command line of the PyTorch port: the counterpart of the JAX package's
``main.py``, reading the same ``configs/*.yaml``.

    python3 -m siss_tpu_torch.main --config-name=train_tshirt_mnist [key=value ...]
    python3 -m siss_tpu_torch.main --config-name=delete_tshirt \\
        checkpoint_path=<pretrain output_dir>/latest
    python3 -m siss_tpu_torch.main --config-name=train_classifier

Tasks run on ``--device`` (default ``cuda``; without a card that raises
unless ``--device cpu`` is given). ``output_dir`` gets a timestamp and a
random suffix unless the run resumes, and then it is the checkpoint's
directory.
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import os
import uuid

from siss_tpu_torch.config import get_object, load_config
from siss_tpu_torch.device import resolve_device

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


def _expand_multirun(overrides):
    """Cartesian product of comma-valued overrides (a Hydra sweep)."""
    axes = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        values = raw.split(",") if "," in raw and not raw.startswith("[") else [raw]
        axes.append([(key, v) for v in values])
    for combo in itertools.product(*axes):
        yield [f"{k}={v}" for k, v in combo]


def _run_one(config_name, overrides, config_dir, device):
    cfg = load_config(config_name, overrides, config_dir)
    if not cfg.get("resume_from_checkpoint"):
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        cfg.output_dir = os.path.join(str(cfg.output_dir), f"{stamp}_{uuid.uuid4().hex[:8]}")
    else:
        cfg.output_dir = os.path.dirname(str(cfg.resume_from_checkpoint))

    task_cls = get_object(str(cfg.task._target_))
    task = task_cls(cfg, device=device)
    print(f"[siss_tpu_torch] task={task_cls.__name__} device={task.device} "
          f"output_dir={cfg.output_dir}")
    task.run()
    return task


def main(argv=None):
    """Parse ``argv`` and run the task (or each task of a sweep); returns
    the tasks, whose ``step_seconds`` and ``eval_seconds`` a caller may read."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-name", required=True, dest="config_name")
    parser.add_argument("--config-dir", default=CONFIG_DIR)
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu must be asked for)")
    parser.add_argument("--multirun", "-m", action="store_true",
                        help="sweep: comma-separated override values expand to a cartesian "
                             "product of runs")
    args = parser.parse_intermixed_args(argv)  # options may follow the overrides
    device = resolve_device(args.device)

    runs = list(_expand_multirun(args.overrides)) if args.multirun else [args.overrides]
    tasks = []
    for i, ovs in enumerate(runs):
        if args.multirun:
            print(f"[siss_tpu_torch] multirun job {i}: {ovs}")
        tasks.append(_run_one(args.config_name, ovs, args.config_dir, device))
    return tasks


if __name__ == "__main__":
    main()
