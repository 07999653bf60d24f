"""The attention kernels' time against their roofline, at the
self-attention sites the configuration puts in the flash kernels' scope
(``flash_sites`` of its family). Kernels are found by name, so the metric
follows the work to another implementation: the port's ``flash::``, and a
library's ``fmha``, ``flash`` or ``attention``. The bound counts, per
call, the products the attention needs and each operand byte once, at the
configuration's compute type (``portbench.roofline``); a training
microbatch makes one forward and two backward calls at each site, a
sampler call one forward."""

from portbench import roofline

NAMES = ("flash", "fmha", "attention")


def read(ctx):
    sites = ctx.family.flash_sites(ctx.config["unet"])
    seconds = ctx.trace.seconds_where(lambda n: any(k in n.lower() for k in NAMES))
    if not sites or seconds <= 0:
        return None
    dtype = ctx.config["compute_dtype"]
    esize, peak = roofline.BYTES[dtype], roofline.PEAK_FLOPS[dtype]
    if ctx.kind == "unlearn_step":
        B, calls = ctx.traffic["microbatch"], ctx.traffic["accumulation"]
        per_site = lambda H, N, d: calls * (roofline.attention_fwd(B, H, N, d, esize, peak)  # noqa: E731
                                            + 2 * roofline.attention_bwd(B, H, N, d, esize, peak))
    else:
        per_site = lambda H, N, d: roofline.attention_fwd(ctx.rows, H, N, d, esize, peak)  # noqa: E731
    bound = ctx.units * sum(per_site(*site) for site in sites)
    return 100.0 * bound / seconds
