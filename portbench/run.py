"""One run of one cell of the benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic names its loop, ``portbench/loops/<kind>.py``: set-up
(process start to the first timed step or request: imports, the kernel
library's build or load, weights and inputs from the seed, the loop's
set-up), then the loop's window of ``--seconds``. With ``--trace 1`` a few
steps or UNet calls in the middle of the window run under
``torch.profiler``. Each metric the cell reports is read by its file under
``portbench/metrics/``: the end-to-end ones without ``--trace``, the
per-layer ones with it. Then the program gives its answers, is released,
and the plain float32 reference (``portbench.reference``) decides
``correct``. Last, the run refuses a result if it has loaded JAX or the JAX
package. Earlier lines of standard output name the card and its power
limit, the port's kernel launches per step or request and the tracing's
overhead; the last line is the result. Each number compared is printed
beside its limit, as the last lines of standard error and under the
result's last key, ``checks``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

from portbench import compare, drive, manifest  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "siss_tpu"}


def card_lines(device) -> list:
    if device.type != "cuda":
        return [f"device: {device} (no card)"]
    lines = [f"card: {torch.cuda.get_device_name(device)}, {torch.cuda.device_count()} visible"]
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        lines.append(f"nvidia-smi: {out}")
    except (OSError, subprocess.TimeoutExpired) as err:
        lines.append(f"nvidia-smi: not read ({err})")
    return lines


def forbidden_modules() -> set:
    return {name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN


def execute(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
            root=manifest.ROOT, log=print, control=None) -> dict:
    """One run of ``workload``; the result line as a dict. ``control``: a
    precision in which the reference is also computed, in the program's
    place, and compared with the float32 reference (``portbench.control``);
    its numbers come under the result's key ``control``."""
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    config = manifest.config(man, cell["config"], root)
    traffic = manifest.traffic(cell["traffic"], root)
    limits = manifest.limits(workload, root)
    loop = manifest.loop(traffic["kind"], root)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        if not torch.cuda.is_available():
            raise SystemExit("portbench: torch.cuda.is_available() is False; no result")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"portbench: {cell['chips']} cards needed, "
                             f"{torch.cuda.device_count()} visible; no result")
        torch.cuda.set_device(device)
    for line in card_lines(device):
        log(line)
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])

    from siss_tpu_torch import ops

    model = drive.Model(config)
    work = loop.Work(model, traffic, seed, device)
    work.set_up()
    drive.sync(device)
    setup_s = time.perf_counter() - T0

    ops.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = work.window(seconds, trace, log)
    drive.sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"launches a {work.per}: " + json.dumps({k: v / window["attempted"]
                                                  for k, v in ops.launch_counts.items()}))

    ctx = types.SimpleNamespace(kind=traffic["kind"], config=config, traffic=traffic,
                                family=model.family, setup_s=setup_s, peak_bytes=peak, **window)
    metrics = {}
    for m in manifest.reported(man, "per_layer" if trace else "end_to_end", workload):
        value = manifest.metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {}
    if trace:
        tr = window["trace"]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        log("device time by family: " + json.dumps(tr.by_family()))

    prog, inputs = work.answers()
    work.release()
    del work
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = loop.reference(model, traffic, seed, device, inputs)
    numbers = loop.compare(prog, ref, log)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    if control is not None:
        result["control"] = loop.compare(
            loop.reference(model, traffic, seed, device, inputs, control), ref)
    correct = window["failed"] == 0 and compare.judge(numbers, limits)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {sorted(found)}; no result", file=sys.stderr)
        raise SystemExit(3)
    for k, c in checks.items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']:.6g}"
        print(f"check {k}: {c['value']:.6g} ({limit})", file=sys.stderr)
    return {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
            "metrics": metrics, "device": dev, **result, "checks": checks}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
