"""One rank of the CPU checks of tests/test_torch_tensor_fsdp.py.

    python tests/torch_tensor_fsdp_worker.py <rank> <world size> <data> <fsdp> <tensor> <directory>

Joins a gloo process group through a file store in <directory>, lays the
ranks out as the ``data × fsdp × tensor`` mesh, reads the inputs the test
wrote one level up (``inputs.pt``), runs every case of
``torch_tensor_fsdp_cases`` on its block of each global batch (the ranks of
a tensor group share one), saves the checkpoint cases through
``CheckpointManager`` and writes what it got to ``rank<r>.pt``.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_tensor_fsdp_cases as cases  # noqa: E402
from siss_tpu_torch.parallel import (MeshConfig, all_reduce_sum, destroy_distributed,  # noqa: E402
                                     initialize_distributed, make_rank_mesh, rank)
from siss_tpu_torch.utils import CheckpointManager  # noqa: E402
from torch_fsdp_worker import equal_to_rank0  # noqa: E402


def groups(mesh) -> dict:
    """This rank's coordinates, and which ranks share each axis and the
    fsdp × tensor plane: the sum of 2^rank over each group."""
    members = torch.tensor([2.0 ** rank()])

    def of(group, size):
        return float(all_reduce_sum(members, group)) if size > 1 else float(members)

    return {"fsdp_rank": mesh.fsdp_rank, "tensor_rank": mesh.tensor_rank,
            "batch_rank": mesh.batch_rank, "data": of(mesh.data_group, mesh.data),
            "fsdp": of(mesh.fsdp_group, mesh.fsdp), "tensor": of(mesh.tensor_group, mesh.tensor),
            "plane": of(mesh.plane_group, mesh.fsdp * mesh.tensor)}


def main() -> None:
    RANK, WORLD, DATA, FSDP, TENSOR, DIR = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                            int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    torch.set_num_threads(1)
    initialize_distributed("cpu", "gloo", rank=RANK, world_size=WORLD,
                           init_method=f"file://{os.path.join(DIR, 'store')}", timeout_s=300)
    mesh = make_rank_mesh(MeshConfig(data=DATA, fsdp=FSDP, tensor=TENSOR))
    assert (mesh.data, mesh.fsdp, mesh.tensor) == (DATA, FSDP, TENSOR)
    inputs = torch.load(os.path.join(DIR, "..", "inputs.pt"), weights_only=False)
    result = {"groups": groups(mesh), "mesh": str(mesh), "steps": {}, "resumed": {},
              "equal": {}}
    for name in cases.CASES:
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
        res = cases.run_case(name, inputs, mesh, start=1, state_dict=inputs["resume"][name])
        result["resumed"][name] = {"metrics": res["metrics"], "loaded": res["loaded"],
                                   "model": res["state"]["model"] if RANK == 0 else None}
    result["pretrain"] = {kind: cases.run_pretrain(kind, inputs, mesh)
                          for kind in cases.PRETRAIN_KINDS}
    result["evaluator"] = {name: cases.run_evaluator(name, inputs, mesh)
                           for name in cases.EVAL_CASES}
    torch.save(result, os.path.join(DIR, f"rank{RANK}.pt"))
    destroy_distributed()


if __name__ == "__main__":
    main()
