"""Wen et al. inference-time memorization mitigation: port of
``examples/inference_time_mitigation.py``. Inspects per-token text-cond
gradients, then optimizes an augmented prompt embedding and saves it for
use as ``validation_prompts[0]`` in delete_sd or as ``sd_inference
--prompt-embeds``.

  python3 -m siss_tpu_torch.examples.inference_time_mitigation --model <sd dir> \\
      --prompt "memorized caption ..." --iters 10 --out aug_prompt.npz

``--model`` is read as ``sd_inference``'s is. Both the gradients and the
optimization start from latents drawn from a generator seeded with
``--seed``: the same latents, as the JAX script's one key gives.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None, config=None) -> dict:
    """``config``: as ``sd_inference.sd_configs``. Returns the per-token
    gradient norms, the augmented embeddings and the file's path."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--target-steps", type=int, nargs="+", default=[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="aug_prompt.npz")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.examples.sd_inference import build_pipeline, encode, image_size

    device = resolve_device(args.device)
    pipe = build_pipeline(args.model, device, config)
    pe, ue = encode(pipe, args.prompt), encode(pipe, "")
    hw = image_size(pipe)

    def generator():
        return torch.Generator(device=device).manual_seed(args.seed)

    token_grads = pipe.get_text_cond_grad(pe, ue, generator(), height=hw, width=hw,
                                          target_steps=args.target_steps)
    print("per-token ∥∂‖ε_text−ε_uncond‖/∂embeds∥:", np.round(token_grads, 3).tolist())

    aug = pipe.aug_prompt(pe, ue, generator(), height=hw, width=hw,
                          target_steps=args.target_steps, lr=args.lr, optim_iters=args.iters)
    embeds = aug.cpu().numpy()
    np.savez(args.out, embeds=embeds)
    print(f"wrote {args.out} (shape {embeds.shape})")
    return {"token_grads": token_grads, "embeds": embeds, "out": args.out}


if __name__ == "__main__":
    main()
