"""One rank of the 2-rank CPU data-parallel checks of
tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py <rank> <world size> <directory>

Joins a gloo process group through a file store in <directory>, reads the
inputs the test wrote there (``inputs.pt``), runs every case of
``torch_parallel_cases`` on its block of each global batch, checks the
collectives, and writes what it got to ``rank<r>.pt``.
"""

import itertools
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402
from siss_tpu_torch.data import InfiniteSampler  # noqa: E402
from siss_tpu_torch.parallel import (all_reduce_, any_rank, broadcast_object,  # noqa: E402
                                     destroy_distributed, gather_rows, initialize_distributed,
                                     make_rank_sampler, process_batch_slice, rank, rank_rows,
                                     world_size)

RANK, WORLD, DIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]


def collectives() -> dict:
    """gather_rows, all_reduce_ (buckets, a tensor reduced alone, channels_last,
    bf16), any_rank, broadcast_object, the stripes and an indivisible batch."""
    r = rank()
    out = {"gathered": gather_rows(torch.arange(6.0).reshape(3, 2) + 10 * r, axis=0),
           "gathered_axis1": gather_rows(torch.full((2, 1, 3), float(r)), axis=1)}
    cl = (torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5) + r)
    tensors = [torch.full((3,), 1.0 + r), cl.to(memory_format=torch.channels_last),
               torch.full((40,), 2.0 * (r + 1)), torch.full((5,), 0.5 + r, dtype=torch.bfloat16),
               torch.arange(4.0) * (r + 1)]
    all_reduce_(tensors, bucket_numel=16)
    out["all_reduced"] = [t.contiguous() for t in tensors]
    out["channels_last_kept"] = tensors[1].is_contiguous(memory_format=torch.channels_last)
    out["any_rank"] = [any_rank(r == 1, torch.device("cpu")), any_rank(False, torch.device("cpu"))]
    out["broadcast"] = broadcast_object(f"dir-of-rank-{r}")
    out["stripe"] = list(itertools.islice(iter(make_rank_sampler(InfiniteSampler, 16, seed=7)),
                                          16))
    try:
        process_batch_slice(3)
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        rank_rows(torch.zeros(3, 2))
    except ValueError as e:
        out["indivisible_rows"] = str(e)
    return out


def main() -> None:
    torch.set_num_threads(2)
    initialize_distributed("cpu", "gloo", rank=RANK, world_size=WORLD,
                           init_method=f"file://{os.path.join(DIR, 'store')}", timeout_s=120)
    assert (rank(), world_size()) == (RANK, WORLD)
    inputs = torch.load(os.path.join(DIR, "inputs.pt"), weights_only=False)
    result = {"collectives": collectives(),
              "steps": {name: cases.run_case(name, inputs) for name in cases.STEP_CASES},
              "pretrain": cases.run_pretrain(inputs),
              "evaluator": {name: cases.run_evaluator(name, inputs) for name in cases.EVAL_CASES}}
    torch.save(result, os.path.join(DIR, f"rank{RANK}.pt"))
    destroy_distributed()


if __name__ == "__main__":
    main()
