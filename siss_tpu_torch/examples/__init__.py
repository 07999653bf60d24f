"""The example scripts of ``examples/`` on the PyTorch port, each run as a
module:

    python3 -m siss_tpu_torch.examples.celeb_sampler --checkpoint <bundle> --out grid.png
    python3 -m siss_tpu_torch.examples.likelihood_eval --checkpoint <bundle> --images a.png
    python3 -m siss_tpu_torch.examples.membership_curve --checkpoint <bundle> --npz data.npz
    python3 -m siss_tpu_torch.examples.sd_inference --model <sd dir> --prompt "..."
    python3 -m siss_tpu_torch.examples.inference_time_mitigation --model <sd dir> --prompt "..."
    python3 -m siss_tpu_torch.examples.sscd_score --model sscd.pt --target mem.png --images a.png

Each keeps its JAX script's options, names and defaults, and adds
``--device`` (default ``cuda``; without a card it raises unless ``cpu`` is
asked for). ``main(argv=None, config=None)`` returns what the script
prints; ``config`` replaces the model architecture (tests run tiny ones;
``sscd_score``, whose model is a TorchScript file, takes none).
Checkpoints are read in the port's formats: a bundle item, a diffusers
directory or a state-dict file (``utils.hf_convert.load_unet2d``), and for
SD a directory with ``unet/``, ``vae/``, ``text_encoder/`` and
``tokenizer/`` (``sd_inference.build_pipeline``). ``examples/webster_prompts.py``
imports neither package and has no copy here.
"""
