"""The port's t-shirt unlearning task with the shipped metrics block and
every objective, on the CPU at a tiny width, through the command line
(``siss_tpu_torch.main``): the exact likelihood at step 0, each
``deletion.loss_fn`` with the JAX step's metric keys, the superfactor decay
(per microbatch, resumed, and its ``steps_per_call`` fallback), the
classifier task feeding the Inception Score and the membership losses, and
the IS fallback when the classifier is missing or does not fit.

The UNet is the tiny one of the other task tests with one resnet per level
and no mid-block attention: the shipped RK45 likelihood (rtol = atol =
1e-5) takes ~3,000 evaluations of an untrained UNet, ~11 ms each here.
"""

import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch import main as cli
from siss_tpu_torch.losses import LOSS_FUNCTIONS

SMALL_UNET = ["unet.block_out_channels=[16,32]", "unet.down_block_types=[DownBlock2D,DownBlock2D]",
              "unet.up_block_types=[UpBlock2D,UpBlock2D]", "+unet.norm_num_groups=8",
              "+unet.layers_per_block=1", "+unet.add_mid_attention=false"]
TASK_KEYS = {"images_per_sec", "metrics/deletion_class_fraction", "Sampled Images/files",
             "_step", "_time"}
IS_ON = ("metrics.inception_score={step_frequency: 1, num_imgs_to_generate: 8, batch_size: 4}",
         "metrics.membership_loss={step_frequency: 1, timesteps: [100, 500], class_cfg: "
         "{num_image_samples: 3, num_noise_samples: 2, eval_batch_size: 4}}")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    from siss_tpu_torch.data import make_synthetic_mnist_tshirt

    path = tmp_path_factory.mktemp("data") / "data.npz"
    images, labels = make_synthetic_mnist_tshirt(n_per_class=8)
    np.savez(path, images=images, labels=labels)
    return str(path)


def only_run(parent):
    (run,) = [p for p in Path(parent).iterdir() if p.is_dir()]
    return str(run)


@pytest.fixture(scope="module")
def base(npz, tmp_path_factory):
    out = tmp_path_factory.mktemp("base")
    cli.main(["--config-name=train_tshirt_mnist", "--device", "cpu", f"dataset.path={npz}",
              f"output_dir={out}", "num_epochs=1", "train_batch_size=16", "sampling_steps=0",
              "lr_warmup_steps=2", *SMALL_UNET])
    return only_run(out)


@pytest.fixture(scope="module")
def classifier_run(npz, tmp_path_factory):
    """The port's train_classifier task as shipped but for its length: 11
    classes on the npz, two steps at batch 8."""
    out = tmp_path_factory.mktemp("classifier")
    (task,) = cli.main(["--config-name=train_classifier", "--device", "cpu",
                        f"dataset.path={npz}", f"output_dir={out}", "training_steps=2",
                        "train_batch_size=8"])
    return str(task.cfg.output_dir)


def delete(npz, base, out, *extra):
    (task,) = cli.main(["--config-name=delete_tshirt", "--device", "cpu",
                        f"dataset_all.path={npz}", f"dataset_deletion.path={npz}",
                        f"dataset.path={npz}", f"output_dir={out}",
                        f"checkpoint_path={base}/latest", "train_batch_size=4", "eval_images=4",
                        "pipeline.num_inference_steps=4", *SMALL_UNET, *extra])
    with open(os.path.join(str(task.cfg.output_dir), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return task, rows


def jax_step_keys(loss_fn):
    """The JAX step's metric keys for ``loss_fn``, from tracing it."""
    tx = optax.sgd(1.0)
    params = {"w": jnp.asarray(0.5), "b": jnp.asarray(0.1)}
    step = jax_build_step(lambda p, x, t, c: p["w"] * x + p["b"], JaxSchedule.create(1000), tx,
                          JaxStepConfig(loss_fn=loss_fn,
                                        loss_params=(("lambd", 0.5), ("superfactor", 1.0))))
    batch = {k: jnp.zeros((1, 2, 8, 8, 1)) for k in ("all", "deletion")}
    _, metrics = jax.eval_shape(step, JaxState.create(params, tx), batch, jax.random.PRNGKey(0), {})
    return set(metrics)


def test_shipped_metrics_block_logs_the_likelihood(npz, base, tmp_path):
    """configs/delete_tshirt.yaml's metrics as shipped: RK45 on the first
    forget image at step 0 (every 30 steps), none at step 2."""
    task, rows = delete(npz, base, tmp_path, "training_steps=2", "sampling_steps=2")
    lik = [(r["_step"], r["metrics/likelihood"]) for r in rows if "metrics/likelihood" in r]
    assert [s for s, _ in lik] == [0] and math.isfinite(lik[0][1]) and lik[0][1] > 0
    assert [r["_step"] for r in rows if "metrics/deletion_class_fraction" in r] == [0, 2]
    (run,) = task.likelihood_runs
    assert run["nfe"] > 0 and run["nfe"] % 6 == 0 and run["bpd"] == lik[0][1]


def test_each_likelihood_evaluation_draws_a_fresh_probe(npz, base, tmp_path, monkeypatch):
    """Two likelihood evaluations in one run (steps 0 and 1) draw different
    Hutchinson probes from the task's one generator, as the JAX package
    draws a fresh key for each call; the first is the probe of a generator
    seeded with random_seed. One Euler step stands in for RK45 to keep the
    run short."""
    import torch

    from siss_tpu_torch.metrics import likelihood as lik

    probes = []
    draw = lik.LikelihoodEvaluator.draw_probe

    def recording_draw(self, shape, generator):
        probes.append(draw(self, shape, generator))
        return probes[-1]

    def one_euler_step(f, y0, t0, t1, **kw):
        return tuple(y + (t1 - t0) * d for y, d in zip(y0, f(tuple(y0), np.float32(t0)))), 6

    monkeypatch.setattr(lik.LikelihoodEvaluator, "draw_probe", recording_draw)
    monkeypatch.setattr(lik, "odeint_rk45", one_euler_step)
    task, rows = delete(npz, base, tmp_path, "training_steps=1", "sampling_steps=1",
                        "metrics.likelihood.step_frequency=1")
    assert [r["_step"] for r in rows if "metrics/likelihood" in r] == [0, 1]
    assert len(probes) == 2 and not torch.equal(probes[0], probes[1])
    seeded = torch.Generator().manual_seed(int(task.cfg.random_seed))
    assert torch.equal(probes[0], draw(lik.LikelihoodEvaluator(None, device="cpu"),
                                       probes[0].shape, seeded))


@pytest.mark.parametrize("loss_fn", LOSS_FUNCTIONS)
def test_every_objective_runs_in_the_task(npz, base, tmp_path, loss_fn):
    """Each deletion.loss_fn through the task logs the JAX step's keys."""
    _, rows = delete(npz, base, tmp_path, "training_steps=2", "sampling_steps=0",
                     "metrics.likelihood=null", f"deletion.loss_fn={loss_fn}",
                     "+deletion.loss_params.superfactor=1.0")
    step_rows = [r for r in rows if r["_step"] in (1, 2) and "gradient/pre_clip_norm" in r]
    assert len(step_rows) == 2
    assert set().union(*map(set, rows)) == jax_step_keys(loss_fn) | TASK_KEYS
    assert all(math.isfinite(v) for r in step_rows for k, v in r.items() if k != "_time")


def test_superfactor_decays_per_microbatch_and_resumes(npz, base, tmp_path, capsys):
    """superfactor × decay^accum after each step, logged; a resume from
    checkpoint-1 carries on from decay^(1·accum); steps_per_call > 1 falls
    back to one step per call with the JAX package's message."""
    kw = ("deletion.loss_fn=simple_neg_del", "+deletion.loss_params.superfactor=2.0",
          "deletion.superfactor_decay=0.9", "gradient_accumulation_steps=2", "sampling_steps=0",
          "metrics.likelihood=null", "training_steps=3")
    task, rows = delete(npz, base, tmp_path / "a", *kw, "checkpointing_steps=1",
                        "steps_per_call=2")
    assert "steps_per_call>1 incompatible with superfactor decay" in capsys.readouterr().out
    assert [r["superfactor"] for r in rows if "superfactor" in r] == pytest.approx(
        [2.0 * 0.9 ** 2, 2.0 * 0.9 ** 4, 2.0 * 0.9 ** 6])
    run_dir = str(task.cfg.output_dir)
    _, resumed = delete(npz, base, tmp_path / "a", *kw,
                        f"resume_from_checkpoint={run_dir}/checkpoint-1")
    again = [r for r in resumed if "superfactor" in r][-2:]
    assert [r["_step"] for r in again] == [2, 3]
    assert [r["superfactor"] for r in again] == pytest.approx([2.0 * 0.9 ** 4, 2.0 * 0.9 ** 6])


def test_classifier_feeds_inception_score_and_membership(npz, base, classifier_run, tmp_path):
    rows = [json.loads(line) for line in open(os.path.join(classifier_run, "metrics.jsonl"))]
    assert [r["_step"] for r in rows] == [0, 2] and 0 <= rows[-1]["final_accuracy"] <= 1
    assert sorted(os.listdir(os.path.join(classifier_run, "checkpoint-2"))) == ["classifier"]
    _, rows = delete(npz, base, tmp_path, "training_steps=1", "sampling_steps=1",
                     "metrics.likelihood=null", *IS_ON,
                     "metrics.classifier_cfg.classifier_args.num_classes=11",
                     f"metrics.classifier_cfg.classifier_ckpt={classifier_run}")
    keys = {"metrics/is_mean", "metrics/is_std"} | {
        f"membership_loss/{k}_t={t}" for k in ("all", "deletion", "ratio") for t in (100, 500)}
    for step in (0, 1):
        (row,) = [r for r in rows if r["_step"] == step and "metrics/deletion_class_fraction" in r]
        assert keys <= set(row) and all(math.isfinite(row[k]) for k in keys), row


@pytest.mark.parametrize("ckpt", ["shipped_classes", "missing"])
def test_inception_score_disabled_when_the_classifier_does_not_fit(npz, base, classifier_run,
                                                                   tmp_path, capsys, ckpt):
    """The shipped 10-class classifier against the 11-class checkpoint, or a
    checkpoint that is not there: IS is disabled with the JAX package's
    message, the run goes on, and nothing is created at the missing path."""
    path = classifier_run if ckpt == "shipped_classes" else str(tmp_path / "no" / "classifier")
    _, rows = delete(npz, base, tmp_path / "run", "training_steps=1", "sampling_steps=1",
                     "metrics.likelihood=null", *IS_ON,
                     f"metrics.classifier_cfg.classifier_ckpt={path}")
    out = capsys.readouterr().out
    assert "[delete_tshirt] inception classifier unavailable (" in out
    assert "); IS disabled" in out
    keys = set().union(*map(set, rows))
    assert "metrics/is_mean" not in keys and "membership_loss/ratio_t=100" in keys
    assert not (tmp_path / "no").exists()
