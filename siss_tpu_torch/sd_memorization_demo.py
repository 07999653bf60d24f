"""SD-stack synthetic memorization → SISS unlearning demo (end to end): port
of ``scripts/sd_memorization_demo.py``.

The reference's SD acceptance criteria are curves from a run whose starting
checkpoint has *memorized* a training image: the k-means
``deletion_fraction_i`` reaching 0 and the SSCD similarity decaying. Real
SD-1.4 weights are not in the repository, so this script manufactures the
same situation at tiny scale and drives the port's ``DeleteSD`` task over
it:

1. synthesise a dataset: smooth random colour-field "keep" images plus ONE
   distinctive high-contrast memorized image (32×32)
2. train the tiny ``AutoencoderKL`` to reconstruct the set (recon + KL), so
   latents decode back to recognisable images
3. overfit the tiny conditional UNet with the memorized image
   over-represented at a fixed prompt embedding (synthetic memorization);
   CFG sampling from that prompt then reproduces the memorized image
4. fit the 2-center k-means pixel classifier (memorized vs keep cluster),
   the ``.npz`` that ``KMeansMemClassifier`` reads
5. write a model directory (``unet/``, ``vae/``, ``text_encoder/``, state
   dicts under diffusers and transformers names) and run ``DeleteSD``'s
   SISS task over it (importance_sampling_with_mixture)
6. report before/after: deletion fraction, pixel MSE / cosine to the
   memorized image, and a keep-prompt control that must stay intact

Run:
    python3 -m siss_tpu_torch.sd_memorization_demo --out /tmp/sd_mem_demo

The random draws (VAE posterior noise, the pretraining batches, timesteps
and noise, the evaluation's start latents) come from ``torch.Generator``s
seeded from ``--seed``; the dataset and the prompt embeddings from numpy's
``default_rng(--seed)``, as in the JAX script. The unlearned UNet is read
from the task's last bundle, ``unlearn/checkpoint-<steps>/unet``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

#: The report's keys, in the order the summary prints them.
REPORT_KEYS = ("mem_fraction", "mem_mse", "mem_cosine", "keep_fraction", "keep_mse_to_keep0")


# ------------------------------------------------------------------ data
def make_dataset(root: str, n_keep: int, res: int, rng: np.random.Generator):
    """Smooth random color fields + one distinctive memorized pattern."""
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    labels = {}

    def smooth_field():
        yy, xx = np.mgrid[0:res, 0:res] / res
        img = np.zeros((res, res, 3))
        for c in range(3):
            fx, fy = rng.uniform(0.5, 2.5, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            amp, base = rng.uniform(0.3, 0.5), rng.uniform(0.25, 0.75)
            img[..., c] = base + amp * np.sin(2 * np.pi * fx * xx + px) * np.cos(2 * np.pi * fy * yy + py)
        return np.clip(img, 0, 1)

    for i in range(n_keep):
        name = f"keep_{i}.png"
        Image.fromarray((smooth_field() * 255).astype(np.uint8)).save(os.path.join(img_dir, name))
        labels[name] = 0

    # memorized image: magenta field, white X, checkerboard corner patch —
    # far outside the smooth-field family, trivially identifiable
    mem = np.zeros((res, res, 3))
    mem[..., 0], mem[..., 2] = 0.9, 0.9
    idx = np.arange(res)
    for d in (-1, 0, 1):
        on = (idx + d >= 0) & (idx + d < res)
        mem[idx[on], (idx + d)[on]] = 1.0
        mem[idx[on], res - 1 - (idx + d)[on]] = 1.0
    q = res // 4
    yy, xx = np.mgrid[0:q, 0:q]
    mem[:q, :q] = ((yy // 2 + xx // 2) % 2)[..., None].astype(float)
    Image.fromarray((mem * 255).astype(np.uint8)).save(os.path.join(img_dir, "memorized.png"))
    labels["memorized.png"] = 1

    with open(os.path.join(root, "kmeans_labels.json"), "w") as f:
        json.dump(labels, f)
    with open(os.path.join(root, "clustering_info.json"), "w") as f:
        json.dump({"frac_deletion": 1.0 / (n_keep + 1), "mem_img_name": "memorized.png"}, f)
    return img_dir, mem


def kmeans_centers(keep_imgs: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """The classifier's two centers in its 255-scaled pixel space: label 0
    the mean keep image (``keep_imgs`` in [−1, 1]), label 1 the memorized
    one (``mem`` in [0, 1])."""
    keep01 = (keep_imgs + 1.0) / 2.0
    return np.stack([keep01.reshape(len(keep01), -1).mean(0) * 255.0, mem.reshape(-1) * 255.0])


# ------------------------------------------------------------- the models
def demo_configs():
    """The tiny VAE, conditional UNet (einsum attention) and text tower:
    ``DeleteSD``'s ``model_variant=tiny``."""
    from siss_tpu_torch.models import AutoencoderKLConfig, CLIPTextConfig, UNet2DConditionConfig

    unet_cfg = UNet2DConditionConfig(**{**UNet2DConditionConfig.tiny().__dict__,
                                        "attention_impl": "einsum"})
    return unet_cfg, AutoencoderKLConfig.tiny(), CLIPTextConfig.tiny()


def vae_loss(vae, x_all: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Reconstruction MSE of the posterior sample ``mean + σ·noise`` plus
    1e-4 × the mean KL to N(0, 1)."""
    mean, logvar = vae.encode_moments(x_all)
    z = mean + torch.exp(0.5 * logvar) * noise
    rec = vae.decode(z * vae.config.scaling_factor)
    kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return torch.mean((rec - x_all) ** 2) + 1e-4 * kl


def draw_unet_batch(gen: torch.Generator, n: int, bs: int, mem_freq: float, latent_shape,
                    num_train_timesteps: int) -> dict:
    """One pretraining batch's draws: keep-image indices, each replaced by
    the memorized image (index n − 1) with probability ``mem_freq``, the
    unconditional rows (10%), the VAE posterior and ε noise, timesteps."""
    dev = gen.device
    idx = torch.randint(0, n - 1, (bs,), generator=gen, device=dev)
    idx = torch.where(torch.rand(bs, generator=gen, device=dev) < mem_freq, n - 1, idx)
    drop = torch.rand(bs, generator=gen, device=dev) < 0.1
    enc_noise = torch.randn((bs, *latent_shape), generator=gen, device=dev)
    noise = torch.randn((bs, *latent_shape), generator=gen, device=dev)
    t = torch.randint(0, num_train_timesteps, (bs,), generator=gen, device=dev)
    return {"idx": idx, "drop": drop, "enc_noise": enc_noise, "noise": noise, "t": t}


def unet_loss(unet, vae, schedule, x_all: torch.Tensor, e_all: torch.Tensor,
              draws: dict) -> torch.Tensor:
    """The ε-MSE of one pretraining batch: the drawn images' VAE latents
    noised to the drawn timesteps, conditioned on their prompts (zero on
    the unconditional rows)."""
    from siss_tpu_torch.diffusion import q_sample
    from siss_tpu_torch.train import cond_unet_eps_apply

    imgs, cond = x_all[draws["idx"]], e_all[draws["idx"]]
    cond = torch.where(draws["drop"][:, None, None], torch.zeros_like(cond), cond)
    with torch.no_grad():
        z = vae.encode_sample(imgs, noise=draws["enc_noise"])
    noisy = q_sample(schedule, z, draws["noise"], draws["t"])
    pred = cond_unet_eps_apply(unet, noisy, draws["t"], cond)
    return torch.mean((pred - draws["noise"]) ** 2)


#: Eager steps a CUDA-graphed ``fit`` runs before it captures the step.
WARMUP_STEPS = 3


def fit(params, steps: int, draw, loss_of, log, graphed: bool | None = None) -> None:
    """``steps`` Adam(2e-3) steps (optax's ``adam``) of ``loss_of(draw())``;
    ``log(i, loss)`` after each. On the card (``graphed`` unless it is
    False), after ``WARMUP_STEPS`` eager steps on a side stream, the step
    (forward, backward, fused Adam update) is captured as one CUDA graph
    and replayed, each step's draws copied into the graph's inputs: the
    counterpart of the JAX script's jitted step, where eager dispatch of
    its ~1,500 kernels a step would bound the loop by the host. The draws
    are made in the same order either way, and the eager loop runs the
    same fused Adam."""
    params = list(params)
    cuda = params[0].device.type == "cuda"
    opt = torch.optim.Adam(params, lr=2e-3, fused=cuda, capturable=cuda)

    def step(batch):
        loss = loss_of(batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss

    if not cuda or graphed is False:
        for i in range(steps):
            log(i, step(draw()))
        return
    side = torch.cuda.Stream(params[0].device)
    side.wait_stream(torch.cuda.current_stream(params[0].device))
    with torch.cuda.stream(side):
        for i in range(min(WARMUP_STEPS, steps)):
            log(i, step(draw()))
    torch.cuda.current_stream(params[0].device).wait_stream(side)
    if steps <= WARMUP_STEPS:
        return
    inputs = draw()
    graph = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        loss = loss_of(inputs)
        loss.backward()
        opt.step()
    for i in range(WARMUP_STEPS, steps):
        if i > WARMUP_STEPS:
            batch = draw()
            for dst, src in zip(_tensors(inputs), _tensors(batch)):
                dst.copy_(src)
        graph.replay()
        log(i, loss)


def _tensors(batch):
    return list(batch.values()) if isinstance(batch, dict) else [batch]


# ------------------------------------------------------------------ setup
def setup(args, device: torch.device) -> dict:
    from siss_tpu_torch.data import SDData
    from siss_tpu_torch.diffusion import sd_noise_schedule
    from siss_tpu_torch.models import build_clip_text, build_unet_cond, build_vae
    from siss_tpu_torch.utils.checkpoint import to_host

    root, res = args.out, args.resolution
    rng = np.random.default_rng(args.seed)
    os.makedirs(root, exist_ok=True)
    img_dir, mem = make_dataset(root, args.n_keep, res, rng)

    # the full set as [-1,1] arrays, memorized image last
    keep_ds = SDData("nondeletion", img_dir, os.path.join(root, "kmeans_labels.json"),
                     resolution=res)
    keep_imgs = np.stack([keep_ds[i][0] for i in range(len(keep_ds))])
    mem_img = mem * 2.0 - 1.0  # [-1,1] NHWC
    all_imgs = np.concatenate([keep_imgs, mem_img[None]]).astype(np.float32)
    n = len(all_imgs)
    x_all = torch.from_numpy(all_imgs).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    unet_cfg, vae_cfg, text_cfg = demo_configs()

    # ---- 2. VAE: recon + small KL until decode(encode(x)) ≈ x
    vae = build_vae(vae_cfg, seed=args.seed, device=device)
    latent_shape = (res // vae_cfg.scale_factor, res // vae_cfg.scale_factor,
                    vae_cfg.latent_channels)

    def vae_log(i, loss):
        if i % 200 == 0 or i == args.vae_steps - 1:
            print(f"[vae] step {i} recon+kl {loss.item():.5f}")

    fit(vae.parameters(), args.vae_steps,
        lambda: torch.randn((n, *latent_shape), generator=gen, device=device),
        lambda noise: vae_loss(vae, x_all, noise), vae_log)
    vae.requires_grad_(False).eval()

    # ---- 3. UNet: overfit with the memorized image over-represented
    embeds = rng.normal(0, 0.5, (n, text_cfg.max_position_embeddings,
                                 text_cfg.hidden_size)).astype(np.float32)
    mem_embed = embeds[-1]  # the memorized image's "prompt"
    unet = build_unet_cond(unet_cfg, seed=args.seed + 1, device=device)
    schedule = sd_noise_schedule(device=device)
    e_all = torch.from_numpy(embeds).to(device)

    def unet_log(i, loss):
        if i % 500 == 0 or i == args.pretrain_steps - 1:
            print(f"[unet] step {i} eps-mse {loss.item():.5f}")

    fit(unet.parameters(), args.pretrain_steps,
        lambda: draw_unet_batch(gen, n, args.pretrain_batch, args.mem_freq, latent_shape,
                                schedule.num_train_timesteps),
        lambda draws: unet_loss(unet, vae, schedule, x_all, e_all, draws), unet_log)

    # ---- 4. kmeans centers in the classifier's 255-scaled pixel space
    np.savez(os.path.join(root, "kmeans_centers.npz"), centers=kmeans_centers(keep_imgs, mem))

    # ---- the model directory the task reads
    text = build_clip_text(text_cfg, seed=args.seed + 2, device="cpu")
    model_dir = os.path.join(root, "model")
    for sub, model, fname in (("unet", unet, "diffusion_pytorch_model.bin"),
                              ("vae", vae, "diffusion_pytorch_model.bin"),
                              ("text_encoder", text, "pytorch_model.bin")):
        path = os.path.join(model_dir, sub)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        torch.save(to_host(model.state_dict()), os.path.join(path, fname))
    np.savez(os.path.join(root, "aug_prompt.npz"), embeds=mem_embed[None])
    np.savez(os.path.join(root, "keep_prompt.npz"), embeds=embeds[0][None])
    np.save(os.path.join(root, "mem_img01.npy"), mem)
    np.save(os.path.join(root, "keep_img01.npy"), (keep_imgs[0] + 1.0) / 2.0)

    # ---- verify memorization before unlearning
    report = evaluate(args, device, unet=unet.eval(), tag="before")
    with open(os.path.join(root, "before.json"), "w") as f:
        json.dump(report, f, indent=2)
    if report["mem_fraction"] < 0.9:
        print(f"[WARN] weak memorization (fraction {report['mem_fraction']}); "
              "raise --pretrain-steps/--mem-freq")
    return report


# ------------------------------------------------------------------ eval
def evaluate(args, device: torch.device, unet=None, checkpoint=None, tag="") -> dict:
    """Sample from the memorized prompt + a keep prompt; score both."""
    from PIL import Image

    from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline, sd_noise_schedule
    from siss_tpu_torch.metrics.kmeans_mem import KMeansMemClassifier
    from siss_tpu_torch.models import AutoencoderKL, UNet2DCondition
    from siss_tpu_torch.train import cond_unet_eps_apply
    from siss_tpu_torch.utils.checkpoint import load_frozen

    root, res = args.out, args.resolution
    unet_cfg, vae_cfg, _ = demo_configs()
    vae = load_frozen(lambda: AutoencoderKL(vae_cfg), os.path.join(root, "model", "vae"), device)
    if unet is None:
        unet = load_frozen(lambda: UNet2DCondition(unet_cfg),
                           checkpoint or os.path.join(root, "model", "unet"), device)

    pipeline = StableDiffusionPipeline(
        unet_apply=cond_unet_eps_apply, unet=unet, vae_decode=vae.decode,
        schedule=sd_noise_schedule(device=device), latent_channels=vae_cfg.latent_channels,
        vae_scale_factor=vae_cfg.scale_factor)
    clf = KMeansMemClassifier.load(os.path.join(root, "kmeans_centers.npz"), device)
    mem01 = np.load(os.path.join(root, "mem_img01.npy"))
    keep01 = np.load(os.path.join(root, "keep_img01.npy"))

    def run_prompt(path):
        pe = pipeline.load_prompt_embeds(path, device)
        pe = pe.expand(args.eval_images, *pe.shape[-2:])
        with torch.inference_mode():
            imgs, _ = pipeline(pe, torch.zeros_like(pe),
                               torch.Generator(device=device).manual_seed(args.seed + 7),
                               height=res, width=res,
                               num_inference_steps=args.num_inference_steps,
                               guidance_scale=args.guidance_scale)
        return imgs

    mem_gen = run_prompt(os.path.join(root, "aug_prompt.npz"))
    keep_gen = run_prompt(os.path.join(root, "keep_prompt.npz"))

    def cosine(a, b):
        a, b = a.reshape(len(a), -1), b.reshape(-1)
        return (a @ b) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b) + 1e-8)

    report = {
        "mem_fraction": float(clf.fraction(mem_gen)),
        "mem_mse": float(np.mean((mem_gen - mem01) ** 2)),
        "mem_cosine": float(cosine(mem_gen, mem01).mean()),
        "keep_fraction": float(clf.fraction(keep_gen)),
        "keep_mse_to_keep0": float(np.mean((keep_gen - keep01) ** 2)),
    }
    print(f"[eval:{tag}] {json.dumps(report)}")
    grid = np.concatenate(list(mem_gen[:4]) + list(keep_gen[:4]), axis=1)
    Image.fromarray((grid * 255).astype(np.uint8)).save(os.path.join(root, f"samples_{tag}.png"))
    return report


# ---------------------------------------------------------------- unlearn
def unlearn(args, device: torch.device) -> list:
    """``DeleteSD``'s SISS run over the model directory; the
    ``metrics/deletion_fraction_0`` series as (image count, fraction)."""
    from siss_tpu_torch.config import load_config
    from siss_tpu_torch.tasks import DeleteSD

    root = args.out
    cfg = load_config("delete_sd", [
        f"base_dir={root}",
        f"output_dir={root}/unlearn",
        "model_variant=tiny",
        "mesh.data=1",
        f"pretrained_model_name_or_path={root}/model",
        f"validation_prompts=[{root}/aug_prompt.npz]",
        "og_prompts_path=/nonexistent.json",
        "modified_prompts_path=/nonexistent.json",
        f"resolution={args.resolution}",
        f"train_batch_size={args.unlearn_batch}",
        "gradient_accumulation_steps=2",
        f"training_steps={args.unlearn_steps}",
        f"learning_rate={args.unlearn_lr}",
        f"deletion.scaling_norm={args.scaling_norm}",
        f"deletion.t_min={args.t_min}",
        f"deletion.t_max={args.t_max}",
        f"validation_steps={args.validation_steps}",
        f"eval_batches={args.eval_images}",
        "eval_batch_size=1",
        f"num_inference_steps={args.num_inference_steps}",
        "gradient_checkpointing=false",
        "random_flip=false",
    ])
    cfg["metrics"]["fraction_deletion"] = {
        "classifier_path": os.path.join(root, "kmeans_centers.npz")}
    DeleteSD(cfg, device=device).run()

    with open(os.path.join(root, "unlearn", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    frac = [(r["_step"], r["metrics/deletion_fraction_0"]) for r in rows
            if "metrics/deletion_fraction_0" in r]
    print(f"[unlearn] deletion_fraction_0 series: {frac}")
    return frac


def main(argv=None) -> dict:
    """Returns the before and after reports and the unlearning's
    ``deletion_fraction_0`` series, as far as ``--phase`` runs."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="/tmp/sd_mem_demo")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--n-keep", type=int, default=8)
    p.add_argument("--vae-steps", type=int, default=1200)
    p.add_argument("--pretrain-steps", type=int, default=3000)
    p.add_argument("--pretrain-batch", type=int, default=16)
    p.add_argument("--mem-freq", type=float, default=0.33,
                   help="probability a pretraining row is the memorized image")
    # The JAX script's defaults, which unlearned fully on its TPU run:
    # deletion_fraction 1.0 -> 0.0 by step 100 with lr 1e-3, scaling_norm
    # 50, the full t range. The 0.4M-param tiny UNet needs stronger
    # settings than SD-1.4's reference values (lr 1e-4 / scaling_norm 5 /
    # t≡999).
    p.add_argument("--unlearn-steps", type=int, default=100)
    p.add_argument("--unlearn-batch", type=int, default=4)
    p.add_argument("--unlearn-lr", type=float, default=1e-3)
    p.add_argument("--scaling-norm", type=float, default=50.0)
    p.add_argument("--t-min", type=int, default=0,
                   help="999 gives the reference-exact t≡999 quirk; the tiny demo "
                        "unlearns far faster with the full range")
    p.add_argument("--t-max", type=int, default=1000)
    p.add_argument("--validation-steps", type=int, default=20)
    p.add_argument("--eval-images", type=int, default=8)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--phase", choices=("all", "setup", "unlearn", "report"), default="all")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from siss_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    # fp32 with TF32 off, as the port's fp32 tasks run, and cuDNN's
    # deterministic algorithms, so that a run on the card repeats as the
    # JAX program does: with the others the outcome moved from run to run.
    # The switches are set back as they were when the demo ends.
    switches = ((torch.backends.cuda.matmul, "allow_tf32", False),
                (torch.backends.cudnn, "allow_tf32", False),
                (torch.backends.cudnn, "deterministic", True))
    saved = [getattr(obj, name) for obj, name, _ in switches]
    for obj, name, value in switches:
        setattr(obj, name, value)
    out = {}
    try:
        if args.phase in ("all", "setup"):
            out["before"] = setup(args, device)
        if args.phase in ("all", "unlearn"):
            out["series"] = unlearn(args, device)
        if args.phase in ("all", "report"):
            with open(os.path.join(args.out, "before.json")) as f:
                before = out["before"] = json.load(f)
            final = os.path.join(args.out, "unlearn", f"checkpoint-{args.unlearn_steps}", "unet")
            after = out["after"] = evaluate(args, device, checkpoint=final, tag="after")
            with open(os.path.join(args.out, "after.json"), "w") as f:
                json.dump(after, f, indent=2)
            print("\n=== SD synthetic-memorization unlearning demo ===")
            for k in REPORT_KEYS[:4]:
                print(f"  {k:14s} before {before[k]:8.4f} → after {after[k]:8.4f}")
    finally:
        for (obj, name, _), value in zip(switches, saved):
            setattr(obj, name, value)
    return out


if __name__ == "__main__":
    main()
