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

Data parallelism: launched by ``torch.distributed.run`` with several ranks,

    python3 -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m siss_tpu_torch.main --config-name=delete_tshirt [--device cpu] ...

each rank joins one process group (``--dist-backend``: ``nccl`` on CUDA
and ``gloo`` on the CPU by default; ranks that share one card need
``gloo``), runs on ``cuda:LOCAL_RANK`` (or the ``--device cuda:N`` named)
and takes its share of every batch. Every rank uses rank 0's
``output_dir``. The config's ``mesh`` lays the ranks out as ``data × fsdp
× tensor`` (``mesh.fsdp=2`` splits the UNet's parameters, optimizer state
and EMA over pairs of ranks, ``mesh.tensor=2`` its attention, GEGLU and
resnet layers Megatron-style, and both together split a layer's blocks
once more over ``fsdp``); each rank prints the resolved mesh.

``--profile`` runs each task inside ``torch.profiler.profile`` and writes
its Chrome trace under ``output_dir/profile`` (``rank<r>.*.pt.trace.json``).
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import os
import uuid

from siss_tpu_torch.config import get_object, load_config
from siss_tpu_torch.parallel import (broadcast_object, destroy_distributed, is_initialized,
                                     maybe_initialize_distributed, rank, world_size)

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


def _run_profiled(task, output_dir: str) -> None:
    """``task.run()`` inside ``torch.profiler.profile``, its Chrome trace
    written under ``output_dir/profile`` (the CUDA activity too when the
    task runs on a card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if task.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace_dir = os.path.join(output_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir, worker_name=f"rank{rank()}")):
        task.run()
        if task.device.type == "cuda":
            torch.cuda.synchronize(task.device)


def _run_one(config_name, overrides, config_dir, device, profile=False):
    cfg = load_config(config_name, overrides, config_dir)
    if not cfg.get("resume_from_checkpoint"):
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        cfg.output_dir = os.path.join(str(cfg.output_dir), f"{stamp}_{uuid.uuid4().hex[:8]}")
    else:
        cfg.output_dir = os.path.dirname(str(cfg.resume_from_checkpoint))
    # Each rank drew its own stamp and suffix: all take rank 0's.
    cfg.output_dir = broadcast_object(str(cfg.output_dir))

    task_cls = get_object(str(cfg.task._target_))
    task = task_cls(cfg, device=device)
    ranks = f" rank={rank()}/{world_size()} mesh={task.mesh}" if is_initialized() else ""
    print(f"[siss_tpu_torch] task={task_cls.__name__} device={task.device}{ranks} "
          f"output_dir={cfg.output_dir}")
    if profile:
        _run_profiled(task, str(cfg.output_dir))
    else:
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
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend under torch.distributed.run with "
                             "several ranks (default nccl on cuda, gloo on cpu; ranks sharing "
                             "one card need gloo)")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler Chrome trace of the run under "
                             "output_dir/profile")
    args = parser.parse_intermixed_args(argv)  # options may follow the overrides
    started = not is_initialized()
    device = maybe_initialize_distributed(args.device, args.dist_backend)
    started = started and is_initialized()

    runs = list(_expand_multirun(args.overrides)) if args.multirun else [args.overrides]
    tasks = []
    try:
        for i, ovs in enumerate(runs):
            if args.multirun:
                print(f"[siss_tpu_torch] multirun job {i}: {ovs}")
            tasks.append(_run_one(args.config_name, ovs, args.config_dir, device, args.profile))
    finally:
        if started:
            destroy_distributed()
    return tasks


if __name__ == "__main__":
    main()
