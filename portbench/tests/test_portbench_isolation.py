"""Nothing a run or the reference loads is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and the reference loads nothing of the port. A run without a
card, or without the port beside the benchmark, gives no result."""

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import manifest, run
from portbench.tests.tiny import tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "siss_tpu"}


def _modules(code: str, cwd=manifest.ROOT) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=cwd, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(cwd)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    mods = _modules("import portbench.run, portbench.control, portbench.faults\n"
                    "import siss_tpu_torch.train, siss_tpu_torch.diffusion.sampling\n"
                    "import siss_tpu_torch.models.unet2d_cond, siss_tpu_torch.ops.build")
    assert "siss_tpu_torch" in mods and not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules("import portbench.reference.train, portbench.reference.sampling\n"
                    "import portbench.reference.unet2d, portbench.reference.unet2d_cond")
    assert not mods & (FORBIDDEN | {"siss_tpu_torch"})


def test_every_loop_and_metric_file_loads_no_jax():
    mods = _modules("from portbench import manifest\n"
                    "for p in (manifest.HERE / 'metrics').glob('*.py'):\n"
                    "    manifest.metric_reader(p.stem)\n"
                    "for p in (manifest.HERE / 'loops').glob('[!_]*.py'):\n"
                    "    manifest.loop(p.stem)\n"
                    "import portbench.drive, portbench.trace, portbench.roofline\n")
    assert not mods & FORBIDDEN


def test_a_metric_that_loads_jax_refuses_the_result(tmp_path, capsys):
    """The look at ``sys.modules`` comes last, after the metrics are read
    and the reference has run."""
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    (root / "portbench/metrics/leaky.py").write_text(
        "import sys, types\n\n\ndef read(ctx):\n"
        "    sys.modules['flax.core'] = types.ModuleType('flax.core')\n    return 1.0\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["end_to_end"].append({"name": "leaky", "unit": "n", "better": "lower", "bound": 0.05,
                              "source": "host_clock", "workloads": ["tiny_celeb_unlearn_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    try:
        with pytest.raises(SystemExit):
            run.execute("tiny_celeb_unlearn_b64", 3, 0.1, False, device="cpu", root=root,
                        log=lambda *a: None)
    finally:
        sys.modules.pop("flax.core", None)
    assert "the run loaded ['flax']; no result" in capsys.readouterr().err


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "siss_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == set()   # siss_tpu_torch* is not siss_tpu
    monkeypatch.setitem(sys.modules, "siss_tpu.losses", types.ModuleType("y"))
    assert run.forbidden_modules() == {"siss_tpu"}


def test_no_card_gives_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "celeb_unlearn_b64", "--seed", str(2 ** 31 + 9), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=manifest.ROOT,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(manifest.ROOT),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "{" not in out.stdout


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from portbench import run\n"
            "print(run.execute('celeb_unlearn_b64', 1, 0.1, False, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0 and "siss_tpu_torch" in out.stderr and "correct" not in out.stdout
