"""The port's SD task through its command line on the CPU:
``python3 -m siss_tpu_torch.main --config-name=delete_sd --device cpu`` with
``model_variant=tiny`` at resolution 16 on a synthetic image folder, its
side files and a synthetic byte-level CLIP vocabulary.

It logs the JAX step's metric keys at image counts, the validation panels
and the noise-norm line series (one curve more at each validation), takes
``frac_deletion`` from ``clustering_info.json``, falls back to zero
conditioning without prompts, gives the same losses with the latent cache
on and off (rtol 1e-4, as ``tests/test_latent_cache.py``), resumes exactly
(2 + 1 steps against 3, bit for bit) and raises without a card unless the
CPU is asked for. With the SD metrics on (synthetic k-means centers, a
TorchScript embedder and a tiny CLIP vision folder) and the single-card
memory mode, it logs the JAX task's metric keys (read from
``siss_tpu/tasks/delete_sd.py``: a tiny JAX SD task takes minutes on a
CPU) with each metric's seconds; the Adafactor override, each step knob
and each remat policy run.
"""

import json
import os
import re

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_parity
from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch import main as cli
from test_torch_sd_tokenizer import _byte_vocab

N_IMAGES, RES = 6, 16
TINY = ("model_variant=tiny", f"resolution={RES}", "train_batch_size=2",
        "gradient_accumulation_steps=2", "num_inference_steps=4", "eval_batches=1",
        "gradient_checkpointing=false", "compute_dtype=float32")


@pytest.fixture(scope="module")
def sd_root(tmp_path_factory):
    """Images (one memorised), labels, clustering info, prompt files and a
    ``pretrained/tokenizer/`` holding only a byte-level vocabulary."""
    root = tmp_path_factory.mktemp("sd_task")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    labels = {}
    for i in range(N_IMAGES):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)).save(
            root / "images" / name)
        labels[name] = int(i == 0)
    (root / "kmeans_labels.json").write_text(json.dumps(labels))
    (root / "clustering_info.json").write_text(
        json.dumps({"frac_deletion": 1 / N_IMAGES, "mem_img_name": "img_0.png"}))
    (root / "og.json").write_text(json.dumps({"sylvester_stallone": "a photo of the cat"}))
    (root / "mod.json").write_text(json.dumps({"sylvester_stallone": "a cat in a photo"}))
    tok = root / "pretrained" / "tokenizer"
    tok.mkdir(parents=True)
    vocab, merges = _byte_vocab()
    (tok / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (tok / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                    encoding="utf-8")
    np.savez(root / "aug_prompt.npz",
             embeds=rng.normal(size=(1, 16, 32)).astype(np.float32))
    return root


def run_sd(root, out, *extra, device="cpu"):
    args = ["--config-name=delete_sd", f"base_dir={root}", f"output_dir={out}",
            f"pretrained_model_name_or_path={root / 'pretrained'}",
            f"og_prompts_path={root / 'og.json'}", f"modified_prompts_path={root / 'mod.json'}",
            *TINY, *extra]
    if device:
        args.append(f"--device={device}")
    (task,) = cli.main(args)
    return task


def rows_of(task):
    with open(os.path.join(str(task.cfg.output_dir), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_step_keys():
    """The metric keys of the JAX package's SISS step (traced, not run)."""
    params = torch_parity.tiny_params(channels=4)
    tx = optax.sgd(1.0)
    step = jax_build_step(torch_parity.jax_tiny_apply, jax_sd_schedule(), tx,
                          JaxStepConfig(loss_params=(("lambd", 0.5),), grad_accum_steps=2,
                                        t_min=999, t_max=1000))
    batch = {k: np.zeros((2, 2, 8, 8, 4), np.float32) for k in ("all", "deletion")}
    _, metrics = jax.eval_shape(step, JaxState.create(params, tx), batch,
                                jax.random.PRNGKey(0), {})
    return set(metrics)


def test_cli_run_logs_the_jax_keys(sd_root, tmp_path):
    task = run_sd(sd_root, tmp_path / "out", "training_steps=2")
    assert task.cfg.deletion.frac_deletion == pytest.approx(1 / N_IMAGES)
    assert task.cfg.data_files.mem_img_path.endswith("img_0.png")
    assert task.cfg.validation_prompts == ["a photo of the cat", "a cat in a photo"]
    assert task.cfg.using_augmented_prompt is False
    rows = rows_of(task)
    steps = [r for r in rows if "loss_x/mean" in r]
    assert [r["_step"] for r in steps] == [4, 8]  # image counts: bs 2 × accum 2
    for r in steps:
        assert set(r) - {"_step", "_time"} == jax_step_keys() | {"images_per_sec"}
        assert all(np.isfinite(v) for k, v in r.items() if k != "_time")
        assert r["gradient/scaling_factor"] > 0
    for pi in (0, 1):
        panels = [r["_step"] for r in rows if f"Generated Images (prompt {pi})/files" in r]
        assert panels == [4, 8]
        series = [r for r in rows if r.get("_name") == f"noise_norms/noise_norms_{pi}"]
        assert [r["_step"] for r in series] == [4, 8]
        assert [len(r["ys"]) for r in series] == [1, 2] and series[1]["keys"] == [0, 1]
        assert series[0]["xs"] == [0, 250, 500, 750] and series[0]["_xname"] == "Timestep"
        assert all(np.isfinite(v) for r in series for ys in r["ys"] for v in ys)
        assert series[1]["ys"][0] == series[0]["ys"][0]
    scalars = [r for r in rows if "noise_norms/text_step0" in r]
    assert [r["_step"] for r in scalars] == [4, 8]
    assert {f"noise_norms/{k}_step{s}" for k in ("uncond", "text") for s in range(4)} <= set(
        scalars[0])
    assert len(task.step_seconds) == 2 and len(task.eval_seconds) == 2
    assert [r["step"] for r in task.eval_records] == [1, 2]  # optimizer steps
    assert set(task.eval_records[0]) == {"step", "sampling", "decode", "norms"}
    assert os.path.isdir(os.path.join(str(task.cfg.output_dir), "checkpoint-2", "unet"))


def test_npz_prompt_and_zero_conditioning(sd_root, tmp_path, capsys):
    task = run_sd(sd_root, tmp_path / "npz", "training_steps=1",
                  f"validation_prompts=[{sd_root / 'aug_prompt.npz'}]")
    assert task.cfg.using_augmented_prompt is True
    assert any(r.get("_name") == "noise_norms/noise_norms_0" for r in rows_of(task))
    run_sd(sd_root, tmp_path / "zero", "training_steps=1", "og_prompts_path=/nonexistent.json",
           "modified_prompts_path=/nonexistent.json",
           f"pretrained_model_name_or_path={tmp_path / 'nothing'}")
    out = capsys.readouterr().out
    assert "no prompts/tokenizer; using zero conditioning" in out
    assert "no converted weights at" in out


def test_cached_and_uncached_losses_agree(sd_root, tmp_path):
    def losses(mode):
        task = run_sd(sd_root, tmp_path / mode, "training_steps=2", "eval_batches=0",
                      "random_flip=true", f"cache_latents={mode}")
        return [r for r in rows_of(task) if "loss_x/mean" in r]

    cached, plain = losses("true"), losses("false")
    assert len(cached) == len(plain) == 2
    for rc, rp in zip(cached, plain):
        for k in ("loss_x/mean", "loss_a/mean", "gradient/scaling_factor",
                  "gradient/norm_loss_a"):
            np.testing.assert_allclose(rc[k], rp[k], rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def straight_run(sd_root, tmp_path_factory):
    """3 steps straight, no validation."""
    return run_sd(sd_root, tmp_path_factory.mktemp("straight"), "training_steps=3",
                  "eval_batches=0")


def final_unets_equal(a, b):
    a = torch.load(os.path.join(str(a.cfg.output_dir), "checkpoint-3", "unet", "item.pt"))
    b = torch.load(os.path.join(str(b.cfg.output_dir), "checkpoint-3", "unet", "item.pt"))
    for k, v in a.items():
        torch.testing.assert_close(b[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["checkpoint-2", "latest"])
def test_resume_is_exact(sd_root, tmp_path, straight_run, which):
    """3 steps straight against 2 steps, then a resume from checkpoint-2 or
    the run's latest bundle."""
    straight = straight_run
    first = run_sd(sd_root, tmp_path / "resumed", "training_steps=2", "eval_batches=0",
                   "checkpointing_steps=1")
    run_dir = str(first.cfg.output_dir)
    resumed = run_sd(sd_root, tmp_path / "resumed", "training_steps=3", "eval_batches=0",
                     f"resume_from_checkpoint={run_dir}/{which}")
    assert str(resumed.cfg.output_dir) == run_dir
    want = [r for r in rows_of(straight) if "loss_x/mean" in r]
    got = [r for r in rows_of(resumed) if "loss_x/mean" in r]
    assert [r["_step"] for r in got] == [4, 8, 12]
    assert got[-1]["loss_x/mean"] == want[-1]["loss_x/mean"]
    final_unets_equal(straight, resumed)


def test_steps_per_call_runs_the_same_steps(sd_root, tmp_path, straight_run):
    """K = 2 steps a pass over 3 steps: the same updates, logged at the
    same image counts, validations at the passes' boundary crossings."""
    task = run_sd(sd_root, tmp_path / "k2", "training_steps=3", "eval_batches=0",
                  "+steps_per_call=2")
    rows = rows_of(task)
    assert [r["_step"] for r in rows if "loss_x/mean" in r] == [4, 8, 12]
    assert [r["step"] for r in task.eval_records] == [2, 3]
    final_unets_equal(straight_run, task)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
def test_without_a_card_the_run_raises(sd_root, tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        run_sd(sd_root, tmp_path / "gpu", "training_steps=1", device=None)


@pytest.mark.parametrize("override,item", [
    ("metrics.sscd={model_path: /nonexistent}", "11c"),
    ("metrics.fraction_deletion={classifier_path: /nonexistent}", "11c"),
    ("metrics.clip_iqa=true", "11c"),
    ("optimizer={_target_: adafactor}", "6b"),
])
def test_unported_options_raise(sd_root, tmp_path, monkeypatch, capsys, override, item):
    """The options of ROADMAP items 11c and 6b, which raised until they were
    ported, behave as in the JAX task: a missing SSCD model or CLIP folder
    disables its metric with a message, a missing k-means artifact raises,
    the Adafactor override trains."""
    monkeypatch.setenv("SISS_CLIP_DIR", str(tmp_path / "no_clip"))
    if "fraction_deletion" in override:
        with pytest.raises(FileNotFoundError):
            run_sd(sd_root, tmp_path / "x", "training_steps=1", override)
        return
    task = run_sd(sd_root, tmp_path / "x", "training_steps=1", override)
    out = capsys.readouterr().out
    assert ("metric disabled" in out) == override.startswith("metrics."), item
    assert [r["_step"] for r in rows_of(task) if "loss_x/mean" in r] == [4]
    assert not any(k.startswith("metrics/") for r in rows_of(task) for k in r)


def jax_validation_keys(prompts):
    """The JAX task's validation metric keys, from its source's f-strings."""
    with open("siss_tpu/tasks/delete_sd.py") as f:
        templates = set(re.findall(r'logs\[f"(metrics/[a-z_]+)_\{pi\}"\]', f.read()))
    return {f"{t}_{pi}" for t in templates for pi in range(prompts)}


class _Embedder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, stride=2)

    def forward(self, x):
        return self.conv(x).mean(dim=(2, 3))


@pytest.fixture(scope="module")
def metric_files(tmp_path_factory):
    """k-means centers (the memorised image and its negative), a TorchScript
    SSCD stand-in, and a CLIP folder holding a tiny vision tower with its
    config.json and the anchors."""
    from siss_tpu_torch.models.clip_vision import CLIPVisionConfig, build_clip_vision

    root = tmp_path_factory.mktemp("sd_metric_files")
    rng = np.random.default_rng(3)
    np.savez(root / "km.npz", centers=(rng.random((2, RES * RES * 3)) * 255).astype(np.float32))
    torch.manual_seed(0)
    torch.jit.save(torch.jit.script(_Embedder().eval()), str(root / "sscd.pt"))
    vision_cfg = dict(image_size=224, patch_size=32, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64, projection_dim=16)
    tower = build_clip_vision(CLIPVisionConfig.from_transformers(vision_cfg), device="cpu")
    (root / "clip" / "vision").mkdir(parents=True)
    torch.save(tower.state_dict(), root / "clip" / "vision" / "pytorch_model.bin")
    (root / "clip" / "vision" / "config.json").write_text(json.dumps(vision_cfg))
    np.savez(root / "clip" / "iqa_anchors.npz", good=rng.normal(size=16), bad=rng.normal(size=16))
    return root


MEMORY_MODE = ("adam_mu_dtype=bfloat16", "adam_nu_dtype=bfloat16",
               "deletion.grad_accum_dtype=bfloat16", "+deletion.param_cast_dtype=bfloat16")


def test_sd_metrics_and_memory_mode_log_the_jax_keys(sd_root, tmp_path, metric_files,
                                                     monkeypatch):
    monkeypatch.setenv("SISS_CLIP_DIR", str(metric_files / "clip"))
    task = run_sd(sd_root, tmp_path / "m", "training_steps=2", *MEMORY_MODE,
                  f"metrics.fraction_deletion={{classifier_path: {metric_files / 'km.npz'}}}",
                  f"metrics.sscd={{model_path: {metric_files / 'sscd.pt'}}}",
                  "metrics.clip_iqa=true")
    validations = [r for r in rows_of(task) if "noise_norms/text_step0" in r]
    assert [r["_step"] for r in validations] == [4, 8]
    want = jax_validation_keys(2)
    assert want == {f"metrics/{k}_{pi}" for k in ("deletion_fraction", "sscd", "sscd_max",
                                                 "clip_iqa") for pi in (0, 1)}
    for r in validations:
        assert {k for k in r if k.startswith("metrics/")} == want
        assert all(np.isfinite(r[k]) for k in want)
        assert r["metrics/deletion_fraction_0"] in (0.0, 1.0)   # one sample a prompt
        assert r["metrics/sscd_max_0"] >= r["metrics/sscd_0"]
        assert 0.0 <= r["metrics/clip_iqa_0"] <= 1.0
    assert [set(rec) for rec in task.eval_records] == 2 * [
        {"step", "sampling", "decode", "norms", "deletion_fraction", "sscd", "clip_iqa"}]
    assert "metrics" in task.setup_seconds
    state = torch.load(os.path.join(str(task.cfg.output_dir), "checkpoint-2", "state", "item.pt"),
                       weights_only=True)
    moments = next(iter(state["optimizer"]["state"].values()))
    assert moments["mu"].dtype == moments["nu"].dtype == torch.bfloat16
    summary = os.path.join(str(task.cfg.output_dir), "summary.json")
    fracs = [r["metrics/deletion_fraction_0"] for r in validations]
    if 0.0 in fracs:   # deletion_steps_0 in optimizer steps, the first time it is 0
        with open(summary) as f:
            assert json.load(f)["deletion_steps_0"] == 1 + fracs.index(0.0)


@pytest.mark.parametrize("override", [
    ("optimizer={_target_: adafactor, weight_decay: 1.0e-2}",
     "deletion.grad_accum_dtype=bfloat16"),
    ("+deletion.param_cast_dtype=bfloat16",),
    ("deletion.batched_dual_backward=true",),
    ("noise_offset=0.1",),
    ("input_perturbation=0.1",),
    ("gradient_checkpointing=true", "+remat_policy=dots"),
    ("gradient_checkpointing=true", "+remat_policy=dots_no_batch"),
], ids=["adafactor", "param_cast", "batched_dual_backward", "noise_offset",
        "input_perturbation", "remat_dots", "remat_dots_no_batch"])
def test_each_sd_option_runs(sd_root, tmp_path, override):
    task = run_sd(sd_root, tmp_path / "o", "training_steps=1", "eval_batches=0", *override)
    (row,) = [r for r in rows_of(task) if "loss_x/mean" in r]
    assert np.isfinite(row["loss_x/mean"]) and row["gradient/scaling_factor"] > 0
    if override[0].startswith("optimizer="):
        state = torch.load(os.path.join(str(task.cfg.output_dir), "checkpoint-1", "state",
                                        "item.pt"), weights_only=True)
        (group,) = state["optimizer"]["param_groups"]
        assert group["weight_decay"] == 1e-2 and group["decay_rate"] == 0.8
