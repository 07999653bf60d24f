"""The reference against the port's plain paths at CPU size, and whole runs
of every cell at CPU size in float32, where the two must agree to
round-off."""

import pytest
import torch

from portbench import drive, manifest, run
from portbench.tests.tiny import tiny_root

CELLS = ("celeb_unlearn_b64", "sd_unlearn_b16", "celeb_sample_ddpm50_b64", "sd_sample_ddim50_b8")
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("config", ("celebahq_256", "sd_v1_4"))
def test_reference_forward_matches_the_port(root, config):
    man = manifest.load(root)
    model = drive.Model(manifest.config(man, f"tiny_{config}", root))
    device = torch.device("cpu")
    port, eps_apply = model.port(SEED, device)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3,) + model.image, generator=g)
    t = torch.tensor([0, 417, 999])
    cond = model.family.conditioning(model.unet, 3, g, device)
    from portbench.reference.nn import Params

    with torch.no_grad():
        want = model.ref_eps(Params(model.weights(SEED, device)), x, t, cond)
        got = eps_apply(port, x, t, cond)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), (got - want).abs().max()


def test_parameter_lists_are_the_ports(root):
    man = manifest.load(root)
    for config in ("celebahq_256", "sd_v1_4"):
        cfg = manifest.config(man, config)
        model = drive.Model(cfg)
        n = sum(torch.Size(s).numel() for s, _ in model.shapes.values())
        assert n == cfg["params"]
        port, _ = model.family.build_port(model.unet, cfg["port"], torch.float32, "meta")
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
            {k: s for k, (s, _) in model.shapes.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_float32_run_agrees_with_the_reference(root, cell):
    res = run.execute(f"tiny_{cell}", SEED, 0.2, False, device="cpu", root=root,
                      log=lambda *a: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] < 1e-4 for c in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks"
