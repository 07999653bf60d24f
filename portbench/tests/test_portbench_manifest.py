"""The manifest keeps to the benchmark's contract, and a configuration, a
traffic mix, a per-layer metric and a new kind of traffic loop added as new
files with new manifest entries run without an edit to any file that was
there."""

import hashlib
import json
import re
from pathlib import Path

import torch

from portbench import manifest, run
from portbench.tests.tiny import tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_to_the_contract():
    man = manifest.load()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert man["paths"] == ["portbench"] and 1 <= man["run_seconds"] <= 51
    configs = {c["name"]: c for c in man["configs"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and manifest.config(man, c["name"])
        assert manifest.config(man, c["name"])["reduced"] == c["reduced"]
    assert {w["config"] for w in man["workloads"]} == set(configs)   # each config has a cell
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        manifest.traffic(w["traffic"])
        reported = {m["name"] for m in manifest.reported(man, "end_to_end", w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.reported(man, "per_layer", w["name"])
        assert set(manifest.limits(w["name"]))
    for m in man["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert callable(manifest.metric_reader(m["name"]))
    for m in man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert callable(manifest.metric_reader(m["name"]))
    assert len(json.dumps(man)) < 64 * 1024


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_new_files_and_entries_add_a_cell(tmp_path):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    before = _digests(root)
    man = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/tiny_celebahq_256.json").read_text())
    cfg["unet"]["block_out_channels"] = [16, 32]
    (root / "portbench/configs/added_unet.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "portbench/traffic/tiny_unlearn_b64_mb16.json").read_text())
    tr["microbatch"] = 2
    (root / "portbench/traffic/added_mix.json").write_text(json.dumps(tr))
    (root / "portbench/limits/added_cell.json").write_text(
        (root / "portbench/limits/celeb_unlearn_b64.json").read_text())
    (root / "portbench/metrics/added.metric.py").write_text(
        "def read(ctx):\n    return float(len(ctx.trace.kernels))\n")
    man["configs"].append({"name": "added_unet", "source": "https://example.org/added",
                           "file": "portbench/configs/added_unet.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "added_cell", "config": "added_unet", "traffic": "added_mix",
                             "chips": 1, "why": "a test"})
    man["end_to_end"][0]["workloads"].append("added_cell")
    man["per_layer"].append({"name": "added.metric", "unit": "n", "better": "higher",
                             "source": "device_trace", "layer": "device",
                             "moves": "train_img_per_s", "workloads": ["added_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    res = run.execute("added_cell", 5, 0.2, False, device="cpu", root=root, log=lambda *a: None)
    assert res["correct"] and set(res["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    names = [m["name"] for m in manifest.reported(man, "per_layer", "added_cell")]
    assert names == ["added.metric"]
    assert manifest.metric_reader("added.metric", root)(
        type("C", (), {"trace": type("T", (), {"kernels": [1, 2]})})) == 2.0
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())   # nothing that was there changed


ADDED_LOOP = '''"""One UNet forward a request on noise from the seed at t = 500."""
import time

import torch

from portbench.drive import generator
from portbench.reference.nn import Params


def _inputs(m, seed, device, rows):
    g = generator(device, seed, "requests", 0)
    x = torch.randn((rows,) + m.image, generator=g, device=device)
    t = torch.full((rows,), 500, dtype=torch.long, device=device)
    return x, t, m.family.conditioning(m.unet, rows, g, device)


class Work:
    per = "request"

    def __init__(self, model, traffic, seed, device):
        self.m, self.rows, self.seed, self.device = model, traffic["rows"], seed, device
        self.model, self.eps = model.port(seed, device)

    def set_up(self):
        self.out = None

    def window(self, seconds, trace, log):
        t0, n = time.perf_counter(), 0
        with torch.no_grad():
            while n == 0 or time.perf_counter() - t0 < seconds:
                x, t, c = _inputs(self.m, self.seed, self.device, self.rows)
                self.out, n = self.eps(self.model, x, t, c), n + 1
        return dict(attempted=n, failed=0, elapsed=time.perf_counter() - t0,
                    images=n * self.rows, trace=None, units=0, rows=self.rows, untraced_s=None)

    def answers(self):
        return self.out, None

    def release(self):
        del self.model


def reference(m, traffic, seed, device, inputs, precision="float32"):
    with torch.no_grad():
        return m.ref_eps(Params(m.weights(seed, device), precision),
                         *_inputs(m, seed, device, traffic["rows"]))


def compare(prog, ref, log=None):
    return {"eps_gap": float((prog.float() - ref).norm() / ref.norm())}
'''


def test_a_new_kind_of_loop_is_new_files_alone(tmp_path):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    before = _digests(root)
    (root / "portbench/loops/one_forward.py").write_text(ADDED_LOOP)
    (root / "portbench/traffic/one_forward_b2.json").write_text(
        json.dumps({"kind": "one_forward", "rows": 2}))
    (root / "portbench/limits/added_forward.json").write_text(json.dumps({"eps_gap": 1e-4}))
    (root / "portbench/metrics/forward_rows_per_s.py").write_text(
        "def read(ctx):\n    return ctx.images / ctx.elapsed\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "added_forward", "config": "tiny_sd_v1_4",
                             "traffic": "one_forward_b2", "chips": 1, "why": "a test"})
    man["end_to_end"].insert(0, {"name": "forward_rows_per_s", "unit": "rows/s",
                                 "better": "higher", "bound": 0.05, "source": "host_clock",
                                 "workloads": ["added_forward"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    res = run.execute("added_forward", 7, 0.1, False, device="cpu", root=root,
                      log=lambda *a: None)
    assert res["correct"] and set(res["checks"]) == {"eps_gap"}
    assert set(res["metrics"]) == {"forward_rows_per_s", "peak_mem_gib", "setup_s"}
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())   # nothing that was there changed
