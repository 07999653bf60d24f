"""The port's sampler service (siss_tpu_torch.serve) over a real socket on
the CPU, with a tiny UNet: the surface of tests/test_serve.py (healthz, a
PNG, the served key listed after a ``dpm`` request, 400 on a malformed
body, ``FileNotFoundError`` on a missing checkpoint), 500 on a fault of the
service itself, both checkpoint forms
(a port bundle and a state-dict file with legacy diffusers names), and the
served grid: equal to the port sampler's own call from the same seed, and
to the JAX package's ``Evaluator.make_grid_from_images`` of the same float
images. Requests sent at once from two threads get what they get alone.
"""

import io
import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.evaluate import Evaluator as JaxEvaluator
from siss_tpu_torch import serve
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.diffusion.sampling import sample_ddpm, sample_dpm_solver_2m
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.models.unet2d import UNet2DConfig, build_unet
from siss_tpu_torch.train import unet_eps_apply
from siss_tpu_torch.utils import CheckpointManager

TINY = dict(sample_size=16, in_channels=1, out_channels=1, block_out_channels=(16, 32),
            layers_per_block=1, down_block_types=("DownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "UpBlock2D"), norm_num_groups=8)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(bundle path, legacy state-dict file, the weights) for the
    ``tiny_serve`` arch, registered on the port's UNet2DConfig."""
    UNet2DConfig.tiny_serve = staticmethod(lambda: UNet2DConfig(**TINY))
    root = tmp_path_factory.mktemp("serve")
    sd = build_unet(UNet2DConfig(**TINY), seed=3, device="cpu").state_dict()
    bundle = CheckpointManager(str(root / "run")).save_bundle(2, {"unet": sd})
    legacy = {k.replace(".to_q.", ".query.").replace(".to_k.", ".key.")
              .replace(".to_v.", ".value.").replace(".to_out.0.", ".proj_attn."): v
              for k, v in sd.items()}
    assert any(".proj_attn." in k for k in legacy)
    torch.save(legacy, root / "unet.bin")
    yield bundle, str(root / "unet.bin"), sd
    del UNet2DConfig.tiny_serve


@pytest.fixture(scope="module")
def service(checkpoints):
    return serve.SamplerService(checkpoints[0], arch="tiny_serve", dtype=torch.float32,
                                device="cpu")


@pytest.fixture(scope="module")
def server(service):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def post(server, body: bytes):
    req = urllib.request.Request(f"{server}/sample", data=body,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req).read()


def sample(server, **req):
    return post(server, json.dumps(req).encode())


def healthz(server):
    return json.loads(urllib.request.urlopen(f"{server}/healthz").read())


def test_healthz(server):
    h = healthz(server)
    assert h["ok"] and h["model"] == "tiny_serve"


def test_sample_returns_png_and_caches_the_key(server):
    png = sample(server, n=1, steps=4, seed=1, sampler="dpm")
    assert png[:4] == b"\x89PNG"
    assert [1, 4, "dpm"] in healthz(server)["compiled"]


def test_bad_input_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        sample(server, n="x")
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server, b"{not json")
    assert e.value.code == 400


def test_a_fault_of_the_service_is_500(server, service, monkeypatch):
    """A well-formed request that the service fails on is its fault, not the
    client's: 500 with the error, and the key is not listed."""
    def broken(*args, **kw):
        raise RuntimeError("sampler failed")

    monkeypatch.setattr(serve, "sample_ddpm", broken)
    with pytest.raises(urllib.error.HTTPError) as e:
        sample(server, n=1, steps=5, seed=0, sampler="ddpm")
    assert e.value.code == 500
    assert json.loads(e.value.read()) == {"error": "sampler failed"}
    assert (1, 5, "ddpm") not in service.served_keys()
    for body in (b"[1, 2]", b'{"steps": null}'):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server, body)
        assert e.value.code == 400


def test_unknown_paths_are_404(server):
    for req in (f"{server}/nope", urllib.request.Request(f"{server}/nope", data=b"{}")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 404


def test_missing_checkpoint_raises(checkpoints, tmp_path):
    with pytest.raises(FileNotFoundError):
        serve.SamplerService(str(tmp_path / "absent"), arch="tiny_serve", device="cpu")


def test_both_checkpoint_forms_load(checkpoints, service):
    _, state_dict_file, sd = checkpoints
    other = serve.SamplerService(state_dict_file, arch="tiny_serve", dtype=torch.float32,
                                 device="cpu")
    for m in (service.model, other.model):
        got = m.state_dict()
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(got[k], v), k


def direct_images(service, n, steps, seed, sampler):
    """The port sampler's own call: NHWC floats in [0, 1]."""
    fn = sample_dpm_solver_2m if sampler == "dpm" else sample_ddpm
    x = fn(lambda x, t, c: unet_eps_apply(service.model, x, t, c),
           NoiseSchedule.create(1000, "linear", device="cpu"), (n, 16, 16, 1), steps,
           generator=torch.Generator().manual_seed(seed))
    return np.clip((x.numpy() + 1) / 2, 0, 1)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm"])
def test_served_grid_equals_the_sampler_and_jax_grid(server, service, sampler):
    png = sample(server, n=3, steps=3, seed=5, sampler=sampler)
    served = np.asarray(Image.open(io.BytesIO(png)))
    imgs = direct_images(service, 3, 3, 5, sampler)
    grid = Evaluator.make_grid_from_images(imgs)
    jax_grid = JaxEvaluator.make_grid_from_images(imgs)
    np.testing.assert_array_equal(grid, jax_grid)
    np.testing.assert_array_equal(served, (jax_grid * 255).astype(np.uint8)[..., 0])
    assert sample(server, n=3, steps=3, seed=5, sampler=sampler) == png
    assert sample(server, n=3, steps=3, seed=6, sampler=sampler) != png


def test_concurrent_requests_match_their_lone_answers(server):
    reqs = [dict(n=2, steps=3, seed=11, sampler="ddpm"), dict(n=2, steps=2, seed=12, sampler="dpm")]
    got = [None, None]

    def fetch(i):
        got[i] = sample(server, **reqs[i])

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [sample(server, **r) for r in reqs]
    assert {(2, 3, "ddpm"), (2, 2, "dpm")} <= {tuple(k) for k in healthz(server)["compiled"]}


def test_needs_a_card_unless_cpu_is_asked(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.SamplerService(checkpoints[0], arch="tiny_serve")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--checkpoint", checkpoints[0], "--arch", "tiny_serve"])


def test_a_cold_key_warms_once_under_many_threads(service, monkeypatch):
    """Twelve threads ask for one new key at once (a short switch interval
    to interleave them): the sampler runs once a request (eager PyTorch has
    no warm-up pass), the key is listed once, and each request gets its
    seed's images."""
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return sample_ddpm(*args, **kw)

    monkeypatch.setattr(serve, "sample_ddpm", counted)
    grids = [None] * 12

    def ask(i):
        grids[i] = service.sample_grid(n=1, steps=2, seed=i % 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 12
    assert service.served_keys().count((1, 2, "ddpm")) == 1
    for i, g in enumerate(grids):
        np.testing.assert_array_equal(g, grids[i % 3])
    assert not np.array_equal(grids[0], grids[1])


def test_the_command_line_serves(tmp_path):
    """``python3 -m siss_tpu_torch.serve --device cpu --port 0`` on a
    state-dict file: it prints the address it bound and answers there."""
    import os
    import re
    import subprocess
    from pathlib import Path

    from siss_tpu_torch.models.unet2d import build_unet

    path = tmp_path / "unet.bin"
    torch.save(build_unet(UNet2DConfig.mnist_tshirt(), seed=0, device="cpu").state_dict(), path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "siss_tpu_torch.serve", "--checkpoint", str(path), "--arch",
         "mnist_tshirt", "--device", "cpu", "--port", "0"],
        cwd=Path(__file__).resolve().parents[1], env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        url = re.search(r"http://\S+", line).group(0)
        assert "mnist_tshirt on cpu" in line
        assert healthz(url) == {"ok": True, "model": "mnist_tshirt", "compiled": []}
        assert sample(url, n=1, steps=1, seed=0)[:4] == b"\x89PNG"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
