"""``python3 -m siss_tpu_torch.main --profile``: the run goes inside
``torch.profiler.profile`` and writes a Chrome trace under
``output_dir/profile``, as the JAX command line's ``--profile`` writes a
JAX trace there (main.py). One tiny pretrain step on the CPU; the trace
carries the step's phases by their span names (``utils.spans``)."""

import json
from pathlib import Path

from test_torch_tasks import npz, only_run, pretrain_args  # noqa: F401  (fixture)
from siss_tpu_torch import main as cli


def test_profile_writes_a_trace(npz, tmp_path):  # noqa: F811
    (task,) = cli.main(pretrain_args(npz, tmp_path / "out", "num_epochs=1", "sampling_steps=0",
                                     "train_batch_size=64", "--profile"))
    run = Path(only_run(tmp_path / "out"))
    assert str(run) == str(task.cfg.output_dir)
    (trace,) = (run / "profile").glob("rank0*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any("conv" in n for n in names)
    assert {"train.step", "train.forward", "train.pull", "train.optimizer"} <= names
    assert (run / "checkpoint-1").is_dir()   # the run itself completed
