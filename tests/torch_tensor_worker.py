"""One rank of the CPU tensor checks of tests/test_torch_tensor.py.

    python tests/torch_tensor_worker.py <rank> <world size> <data> <tensor> <directory>

Joins a gloo process group through a file store in <directory>, lays the
ranks out as the ``data × tensor`` mesh, reads the inputs the test wrote one
level up (``inputs.pt``), runs the cases of ``torch_tensor_cases`` of the
world's model kinds on its block of each global batch (the ranks of a
tensor group share one), saves the checkpoint cases through
``CheckpointManager`` and writes what it got to ``rank<r>.pt``.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_tensor_cases as cases  # noqa: E402
from siss_tpu_torch.parallel import (MeshConfig, all_reduce_sum, destroy_distributed,  # noqa: E402
                                     initialize_distributed, make_rank_mesh, rank)
from siss_tpu_torch.utils import CheckpointManager  # noqa: E402
from torch_fsdp_worker import equal_to_rank0  # noqa: E402


def groups(mesh) -> dict:
    """Which ranks share each axis: the sum of 2^rank over each group."""
    r = rank()
    members = torch.tensor([2.0 ** r])
    return {"tensor_rank": mesh.tensor_rank, "batch_rank": mesh.batch_rank,
            "tensor_members": float(all_reduce_sum(members, mesh.tensor_group)),
            "data_members": (float(all_reduce_sum(members, mesh.data_group))
                             if mesh.data > 1 else 2.0 ** r)}


def main() -> None:
    RANK, WORLD, DATA, TENSOR, DIR = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                      int(sys.argv[4]), sys.argv[5])
    torch.set_num_threads(1)
    initialize_distributed("cpu", "gloo", rank=RANK, world_size=WORLD,
                           init_method=f"file://{os.path.join(DIR, 'store')}", timeout_s=200)
    mesh = make_rank_mesh(MeshConfig(data=DATA, tensor=TENSOR))
    assert (mesh.data, mesh.fsdp, mesh.tensor) == (DATA, 1, TENSOR)
    kinds = next(k for d, t, k in cases.WORLDS.values() if (d, t) == (DATA, TENSOR))
    inputs = torch.load(os.path.join(DIR, "..", "inputs.pt"), weights_only=False)
    result = {"groups": groups(mesh), "mesh": str(mesh), "steps": {}, "resumed": {},
              "equal": {}, "attention": cases.split_attention(mesh)}
    names = [n for n, c in cases.CASES.items() if c[0] in kinds]
    for name in names:
        res = cases.run_case(name, inputs, mesh)
        st = res.pop("state")
        # every rank takes part in both broadcasts, whatever the first gives
        equal = [equal_to_rank0(st["model"])]
        if st["ema"] is not None:
            equal.append(equal_to_rank0(st["ema"]["params"]))
        result["equal"][name] = all(equal)
        if name in cases.CHECKPOINT_CASES:
            CheckpointManager(os.path.join(DIR, "ckpt", name)).save_bundle(
                len(res["metrics"]), {"state": st})
        if RANK == 0:
            res["model"] = st["model"]
            res["ema"] = None if st["ema"] is None else st["ema"]["params"]
        result["steps"][name] = res
    for name in cases.CHECKPOINT_CASES:
        if name in names:
            res = cases.run_case(name, inputs, mesh, start=1, state_dict=inputs["resume"][name])
            result["resumed"][name] = {"metrics": res["metrics"], "loaded": res["loaded"],
                                       "model": res["state"]["model"] if RANK == 0 else None}
    result["pretrain"] = {kind: cases.run_pretrain(kind, inputs, mesh)
                          for kind in cases.PRETRAIN_KINDS if kind in kinds}
    result["evaluator"] = {name: cases.run_evaluator(name, inputs, mesh)
                           for name in cases.EVAL_CASES}
    torch.save(result, os.path.join(DIR, f"rank{RANK}.pt"))
    destroy_distributed()


if __name__ == "__main__":
    main()
