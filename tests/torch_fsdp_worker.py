"""One rank of the CPU fsdp checks of tests/test_torch_fsdp.py.

    python tests/torch_fsdp_worker.py <rank> <world size> <data> <fsdp> <directory>

Joins a gloo process group through a file store in <directory>, lays the
ranks out as the ``data × fsdp`` mesh, reads the inputs the test wrote one
level up (``inputs.pt``), runs every case of ``torch_fsdp_cases`` on its
block of each global batch, checks the collectives and the partial-sum
norms, saves the checkpoint cases through ``CheckpointManager`` and writes
what it got to ``rank<r>.pt`` (rank 0 adds the whole states).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_fsdp_cases as cases  # noqa: E402
from siss_tpu_torch.parallel import (MeshConfig, all_gather_along, all_reduce_sum,  # noqa: E402
                                     destroy_distributed, initialize_distributed,
                                     make_rank_mesh, rank, reduce_scatter_add_, shard_module)
from siss_tpu_torch.parallel import multihost  # noqa: E402
from siss_tpu_torch.train.step import DeletionStepConfig, _surgery, global_norm  # noqa: E402
from siss_tpu_torch.utils import CheckpointManager  # noqa: E402

from torch_fsdp_cases import COLLECTIVE_SHAPES, Leaves, surgery_trees, whole  # noqa: E402


def collectives(mesh, native: bool = False) -> dict:
    """The groups (which ranks share an axis), the gather and the
    reduce-scatter along dims 0, 1 and 3 of contiguous and channels_last
    tensors in small buckets, a whole leaf in the scatter, bf16. With
    ``native``, through the NCCL form of the gather and the reduce-scatter
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``), which gloo
    runs on CPU tensors too."""
    if native:
        form = multihost._native_collectives
        multihost._native_collectives = lambda group: True
        try:
            return collectives(mesh)
        finally:
            multihost._native_collectives = form
    r = rank()
    out = {"fsdp_rank": mesh.fsdp_rank,
           "fsdp_members": float(all_reduce_sum(torch.tensor([2.0 ** r]), mesh.fsdp_group)),
           "data_members": (float(all_reduce_sum(torch.tensor([2.0 ** r]), mesh.data_group))
                            if mesh.data > 1 else 2.0 ** r)}
    shapes = COLLECTIVE_SHAPES
    fulls = [whole(s, seed=i) for i, (s, _, _) in enumerate(shapes)]
    fulls = [f.to(memory_format=torch.channels_last) if cl else f
             for f, (_, _, cl) in zip(fulls, shapes)]
    n, me = mesh.fsdp, mesh.fsdp_rank
    mine = [f.narrow(d, me * (f.shape[d] // n), f.shape[d] // n).clone(
        memory_format=torch.preserve_format) for f, (_, d, _) in zip(fulls, shapes)]
    gathered = all_gather_along(mine, [d for _, d, _ in shapes], mesh.fsdp_group, bucket_numel=64)
    out["gathered"] = [g.contiguous() for g in gathered]
    out["gathered_channels_last"] = [g.is_contiguous(memory_format=torch.channels_last)
                                     for g in gathered]
    # each rank's whole tensors: r + 1 times the common ones; a whole leaf too
    contrib = [f * (r + 1) for f in fulls] + [whole((5,), seed=9) * (r + 1)]
    dims = [d for _, d, _ in shapes] + [None]
    accs = [torch.ones_like(m) for m in mine] + [torch.ones(5)]
    reduce_scatter_add_(contrib, dims, accs, mesh.fsdp_group, bucket_numel=64)
    out["scattered"] = [a.contiguous() for a in accs]
    bf = [whole((8, 6), torch.bfloat16, seed=7) * (r + 1)]
    bf_acc = [torch.zeros(8 // n, 6, dtype=torch.bfloat16)]
    reduce_scatter_add_(bf, [0], bf_acc, mesh.fsdp_group)
    out["scattered_bf16"] = bf_acc[0]
    return out


def norms(mesh) -> dict:
    """The surgery's norms, scale and result and ``global_norm`` on the
    blocks of ``surgery_trees``, for SISS and EraseDiff."""
    sharding = shard_module(Leaves(), mesh, min_size=1024)
    assert [lay.fsdp for lay in sharding.layouts] == [0, None], sharding.layouts
    out = {}
    for loss_fn in ("importance_sampling_with_mixture", "erasediff"):
        g_x, g_a = surgery_trees()
        g_x = [sharding.take(t, lay).clone() for t, lay in zip(g_x, sharding.layouts)]
        g_a = [sharding.take(t, lay).clone() for t, lay in zip(g_a, sharding.layouts)]
        out[f"norm_a_{loss_fn}"] = float(global_norm(g_a, sharding))
        metrics = {}
        final, pre = _surgery(DeletionStepConfig(loss_fn=loss_fn, scaling_norm=5.0, eta=10.0),
                              sharding, g_x, g_a, metrics)
        out[loss_fn] = {"metrics": {k: float(v) for k, v in metrics.items()},
                        "pre_clip_norm": float(pre),
                        "final": sharding.gather_along(final, sharding.layouts)}
    return out


def equal_to_rank0(sd: dict) -> bool:
    flat = torch.cat([v.reshape(-1).float() for v in sd.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    return torch.equal(ref, flat)


def main() -> None:
    RANK, WORLD, DATA, FSDP, DIR = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                    int(sys.argv[4]), sys.argv[5])
    torch.set_num_threads(1)
    initialize_distributed("cpu", "gloo", rank=RANK, world_size=WORLD,
                           init_method=f"file://{os.path.join(DIR, 'store')}", timeout_s=200)
    mesh = make_rank_mesh(MeshConfig(data=DATA, fsdp=FSDP))
    assert (mesh.data, mesh.fsdp) == (DATA, FSDP)
    inputs = torch.load(os.path.join(DIR, "..", "inputs.pt"), weights_only=False)
    result = {"collectives": collectives(mesh), "native": collectives(mesh, native=True),
              "norms": norms(mesh), "steps": {}, "resumed": {}, "equal": {}}
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
        else:
            del res["blocks"], res["loaded"]
        if RANK == 0:
            res["model"] = st["model"]
            res["ema"] = None if st["ema"] is None else st["ema"]["params"]
        result["steps"][name] = res
    for name in cases.CHECKPOINT_CASES:
        res = cases.run_case(name, inputs, mesh, start=1, state_dict=inputs["resume"][name])
        result["resumed"][name] = {"metrics": res["metrics"], "loaded": res["loaded"],
                                   "model": res["state"]["model"] if RANK == 0 else None}
    result["pretrain"] = cases.run_pretrain(inputs, mesh)
    result["evaluator"] = {name: cases.run_evaluator(name, inputs, mesh)
                           for name in cases.EVAL_CASES}
    torch.save(result, os.path.join(DIR, f"rank{RANK}.pt"))
    destroy_distributed()


if __name__ == "__main__":
    main()
