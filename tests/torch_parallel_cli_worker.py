"""The port's command line on one rank of ``torch.distributed.run``, with a
record of what the rank did, for tests/test_torch_parallel_cli.py:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_parallel_cli_worker.py <record dir> <siss_tpu_torch.main arguments>

It runs ``siss_tpu_torch.main.main`` on the arguments and writes
``<record dir>/rank<r>.pt``: the indices each data loader's sampler gave (in
the order the task built its loaders) and the model's whole parameters at
its last checkpoint bundle, which every rank builds. With ``STOP_RANK=<r>`` in
the environment, rank r starts with its preemption stop already requested,
as if a signal had reached it alone.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from siss_tpu_torch import main as cli  # noqa: E402
from siss_tpu_torch.data import loader  # noqa: E402
from siss_tpu_torch.tasks import base  # noqa: E402
from siss_tpu_torch.utils import preemption  # noqa: E402

RECORD = {"indices": [], "params": None}


class _Recording:
    """A sampler whose indices are appended to ``out`` as they are drawn."""

    def __init__(self, sampler, out):
        self.sampler, self.out = sampler, out

    def __iter__(self):
        for i in self.sampler:
            self.out.append(int(i))
            yield i


def main() -> None:
    torch.set_num_threads(2)
    record_dir, argv = sys.argv[1], sys.argv[2:]
    init = loader.BatchLoader.__init__

    def recording_init(self, dataset, sampler, batch_size, *args, **kwargs):
        RECORD["indices"].append([])
        init(self, dataset, _Recording(sampler, RECORD["indices"][-1]), batch_size,
             *args, **kwargs)

    bundle = base.Task.bundle

    def recording_bundle(state, generator):
        out = bundle(state, generator)
        RECORD["params"] = {k: v.detach().clone() for k, v in out["unet"].items()}
        return out

    loader.BatchLoader.__init__ = recording_init
    if os.environ.get("STOP_RANK") == os.environ["RANK"]:
        preemption._STOP.set()
    base.Task.bundle = staticmethod(recording_bundle)
    (task,) = cli.main(argv)
    RECORD["output_dir"] = str(task.cfg.output_dir)
    # the loaders' prefetch threads may still be drawing: keep a snapshot
    RECORD["indices"] = [list(x) for x in RECORD["indices"]]
    torch.save(RECORD, os.path.join(record_dir, f"rank{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    main()
