"""The yardstick's arithmetic against hand counts, the FLOP constants
recounted from the reference, and the trace's reduction on made-up
events."""

import math
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import drive, manifest, roofline, trace
from portbench.reference.nn import Params
from portbench.tests.tiny import with_shelved


def test_attention_bounds_by_hand():
    # (1, 8, 4096, 40) in bf16: 4·B·H·N²·d = 21.47 GFLOP forward, 8·… backward.
    fwd = roofline.attention_fwd(1, 8, 4096, 40, 2, 989e12)
    assert fwd == pytest.approx(4 * 8 * 4096 ** 2 * 40 / 989e12)
    assert fwd * 1e3 == pytest.approx(0.0217, abs=1e-4)
    assert roofline.attention_bwd(1, 8, 4096, 40, 2, 989e12) == pytest.approx(2 * fwd)
    # A small head dim is bound by its bytes: reads q, k, v, writes o and lse.
    small = roofline.attention_fwd(4, 2, 128, 8, 2, 989e12)
    assert small == pytest.approx((4 * 4 * 2 * 128 * 8 * 2 + 4 * 4 * 2 * 128) / 3.35e12)


def test_siss_bounds_by_hand():
    # The celeb microbatch [16, 256·256·3] in fp32: four reads → 0.0150 ms.
    assert roofline.siss_reduce(16, 196608) * 1e3 == pytest.approx(0.01502, abs=1e-5)
    assert roofline.siss_bwd(16, 196608) == pytest.approx(5 * 16 * 196608 * 4 / 3.35e12)


@pytest.mark.parametrize("config", ("celebahq_256", "sd_v1_4"))
def test_forward_flops_recounted_from_the_reference(config):
    cfg = manifest.config(with_shelved(manifest.load()), config)
    model = drive.Model(cfg)
    P = Params({k: torch.empty(s, device="meta") for k, (s, _) in model.shapes.items()})
    x = torch.empty((1,) + model.image, device="meta")
    t = torch.empty((1,), dtype=torch.long, device="meta")
    cond = model.family.conditioning(model.unet, 1, None, "meta")
    with FlopCounterMode(display=False) as counter:
        model.ref_eps(P, x, t, cond)
    assert counter.get_total_flops() == cfg["forward_flop_per_image"]
    assert round(cfg["forward_flop_per_image"] / 1e9, 2) == {"celebahq_256": 497.03,
                                                            "sd_v1_4": 803.27}[config]


def test_sd_flash_sites():
    cfg = manifest.config(with_shelved(manifest.load()), "sd_v1_4")
    sites = drive.Model(cfg).family.flash_sites(cfg["unet"])
    assert sorted(sites) == [(8, 1024, 80)] * 5 + [(8, 4096, 40)] * 5


class _Ev:
    def __init__(self, name, start, end, cuda, annotation=False):
        self._n, self._s, self._e, self._c, self._a = name, start, end, cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_trace_union_gaps_and_families():
    events = [_Ev("cudaLaunchKernel", 90, 95, False), _Ev("cudaMemcpyAsync", 600, 700, False),
              _Ev("sm90_xmma_fprop_conv", 100, 300, True),
              _Ev("vectorized_elementwise_kernel", 250, 500, True),   # overlaps: counted once
              _Ev("multi_tensor_apply_kernel", 800, 900, True),
              _Ev("gpu_user_annotation", 0, 1000, True, True)]
    tr = trace.reduce_events(events, window_s=1e-6)
    assert tr.window_s == 1e-6
    assert tr.busy_s == pytest.approx(500e-9)
    gaps = dict(tr.gaps)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(300e-9)
    assert sum(v for k, v in gaps.items() if k.startswith("the span's ends")) == pytest.approx(200e-9)
    fams = tr.by_family()
    assert fams["convolution (cuDNN)"] == pytest.approx(200e-9)
    assert fams["optimizer / foreach"] == pytest.approx(100e-9)
    assert tr.breakdown()["device_ops"][0][0] == "vectorized_elementwise_kernel"


def _ctx(kind, config, mix, kernels, window_s=2.0, busy_s=1.5, units=2, untraced_s=0.5):
    cfg = manifest.config(with_shelved(manifest.load()), config)
    traffic = manifest.traffic(mix)
    rows = (traffic["microbatch"] * traffic["accumulation"] if kind == "unlearn_step"
            else traffic["images"] * (2 if traffic["sampler"] == "ddim_cfg" else 1))
    tr = trace.Trace(window_s=window_s, kernels=kernels, busy_s=busy_s, gaps=[])
    return types.SimpleNamespace(kind=kind, config=cfg, traffic=traffic, trace=tr, units=units,
                                 rows=rows, family=manifest.family(cfg["family"]),
                                 untraced_s=untraced_s, images=3 * rows, elapsed=4.0,
                                 peak_bytes=3 * 2 ** 30, setup_s=21.5)


def test_metric_readers_by_hand():
    man = manifest.load()
    read = {m["name"]: manifest.metric_reader(m["name"])
            for m in man["per_layer"] + man["end_to_end"]}
    read["attention_roofline_pct"] = manifest.metric_reader("attention_roofline_pct")
    ctx = _ctx("unlearn_step", "sd_v1_4", "unlearn_b16_mb16",
               [("void flash::sm90::fwd_kernel<40>", 0.1), ("void siss::reduce<float>", 0.001),
                ("vectorized_elementwise_kernel", 0.3), ("copy_kernel", 0.1),
                ("multi_tensor_apply_kernel", 0.2)])
    flops = 5 * 803273441280 * 16
    assert read["train_mfu"](ctx) == pytest.approx(100 * flops / 0.5 / 989e12)
    assert read["device_idle_pct.train"](ctx) == pytest.approx(25.0)
    assert read["unet_copy_cast_ms.train"](ctx) == pytest.approx(200.0)
    assert read["optimizer_ms.train"](ctx) == pytest.approx(100.0)
    sites = [(8, 4096, 40)] * 5 + [(8, 1024, 80)] * 5
    bound = 2 * sum(roofline.attention_fwd(16, *s, 2, 989e12)
                    + 2 * roofline.attention_bwd(16, *s, 2, 989e12) for s in sites)
    assert read["attention_roofline_pct"](ctx) == pytest.approx(100 * bound / 0.1)
    siss = 2 * (roofline.siss_reduce(16, 16384) + 2 * roofline.siss_bwd(16, 16384))
    assert read["siss_roofline_pct"](ctx) == pytest.approx(100 * siss / 0.001)
    assert read["train_img_per_s"](ctx) == pytest.approx(12.0)
    assert read["peak_mem_gib"](ctx) == 3.0 and read["setup_s"](ctx) == 21.5
    none = _ctx("unlearn_step", "sd_v1_4", "unlearn_b16_mb16", [], untraced_s=None)
    assert read["train_mfu"](none) is None
    celeb = _ctx("unlearn_step", "celebahq_256", "unlearn_b64_mb16",
                 [("vectorized_elementwise_kernel", 1.0)])
    assert read["attention_roofline_pct"](celeb) is None   # no flash site
    assert read["siss_roofline_pct"](celeb) is None        # nothing traced to read
    samp = _ctx("sample_requests", "sd_v1_4", "sample_ddim_cfg50_b8",
                [("void flash::sm90::fwd_kernel<40>", 0.04)], units=5, untraced_s=0.08)
    assert read["sample_mfu"](samp) == pytest.approx(100 * 803273441280 * 16 / 0.08 / 989e12)
    assert math.isclose(read["device_idle_pct.sample"](samp), 25.0)
    assert read["sample_img_per_s"](samp) == pytest.approx(12.0)
    fwd = 5 * sum(roofline.attention_fwd(16, *s, 2, 989e12) for s in sites)
    assert read["attention_roofline_pct"](samp) == pytest.approx(100 * fwd / 0.04)
