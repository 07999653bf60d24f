"""A copy of the benchmark's data at CPU size, for the tests: each real
configuration with small widths, each traffic mix with small batches, and
one cell of each pair under the real cell's limits."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench import manifest

UNETS = {
    "celebahq_256": {"block_out_channels": [32, 64], "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
                     "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "layers_per_block": 1,
                     "norm_num_groups": 8, "sample_size": 16},
    "sd_v1_4": {"block_out_channels": [32, 64],
                "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
                "attention_head_dim": 4, "cross_attention_dim": 32, "norm_num_groups": 8,
                "sample_size": 16},
}
TRAFFIC = {"unlearn_step": {"microbatch": 4, "accumulation": 2, "pool": 3, "reference_rows": 2},
           "sample_requests": {"steps": 4, "images": 4, "checked_images": 2, "trace_calls": 2}}
# A configuration and cells out of the manifest whose files stay in the
# benchmark (PERF.md §7): their paths are still run here at CPU size.
SHELVED_CONFIGS = [{"name": "sd_v1_4",
                    "source": "https://huggingface.co/CompVis/stable-diffusion-v1-4",
                    "file": "portbench/configs/sd_v1_4.json", "reduced": [],
                    "why": "Stable Diffusion 1.4's UNet"}]
SHELVED = [{"name": "sd_unlearn_b16", "config": "sd_v1_4", "traffic": "unlearn_b16_mb16",
            "chips": 1, "why": "SD training"},
           {"name": "sd_sample_ddim50_b8", "config": "sd_v1_4", "traffic": "sample_ddim_cfg50_b8",
            "chips": 1, "why": "SD validation sampling"}]


def with_shelved(man: dict) -> dict:
    """The manifest with the shelved configuration and cells back in."""
    return {**man, "configs": man["configs"] + SHELVED_CONFIGS,
            "workloads": man["workloads"] + SHELVED}


def tiny_root(dest: Path, compute_dtype: str = "float32") -> Path:
    """A checkout at ``dest`` holding the benchmark with every cell ``<cell>``
    of the manifest, and each shelved one, as ``tiny_<cell>`` at CPU size."""
    shutil.copytree(manifest.ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = with_shelved(manifest.load())
    for c in list(man["configs"]):
        cfg = manifest.config(man, c["name"])
        cfg["unet"].update(UNETS[c["name"]])
        cfg["name"] = f"tiny_{c['name']}"
        cfg["compute_dtype"] = compute_dtype
        path = f"portbench/configs/tiny_{c['name']}.json"
        (dest / path).write_text(json.dumps(cfg))
        man["configs"].append({**c, "name": cfg["name"], "file": path})
    for w in list(man["workloads"]):
        tr = manifest.traffic(w["traffic"])
        tr.update(TRAFFIC[tr["kind"]])
        (dest / f"portbench/traffic/tiny_{w['traffic']}.json").write_text(json.dumps(tr))
        shutil.copy(dest / f"portbench/limits/{w['name']}.json",
                    dest / f"portbench/limits/tiny_{w['name']}.json")
        man["workloads"].append({**w, "name": f"tiny_{w['name']}", "config": f"tiny_{w['config']}",
                                 "traffic": f"tiny_{w['traffic']}"})
    for section in ("end_to_end", "per_layer"):
        for m in man[section]:
            if "workloads" in m:
                m["workloads"] = m["workloads"] + [f"tiny_{w}" for w in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(copy.deepcopy(man), indent=1))
    return dest
