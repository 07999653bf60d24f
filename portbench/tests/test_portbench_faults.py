"""A run at CPU size with the timed path broken underneath comes out not
correct under the cell's own limits, for each fault the cell can have
(one chip: no exchange between chips to leave out)."""

import pytest
import torch

from portbench import faults, manifest, run
from portbench.tests.tiny import tiny_root

CELLS = ("celeb_unlearn_b64", "sd_unlearn_b16", "celeb_sample_ddpm50_b64", "sd_sample_ddim50_b8")
SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("tiny"), compute_dtype="bfloat16")


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(root, cell, fault):
    name = f"tiny_{cell}"
    traffic = manifest.traffic(manifest.cell(manifest.load(root), name)["traffic"], root)
    undo = faults.plant(fault, traffic["kind"], traffic, SEED)
    try:
        res = run.execute(name, SEED, 0.2, False, device="cpu", root=root, log=lambda *a: None)
    finally:
        undo()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_in_bfloat16_is_correct(root, cell):
    res = run.execute(f"tiny_{cell}", SEED, 0.2, False, device="cpu", root=root,
                      log=lambda *a: None)
    assert res["correct"], res["checks"]
