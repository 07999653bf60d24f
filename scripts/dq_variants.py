#!/usr/bin/env python3
"""Make edited copies of the port's bf16 dQ kernel, one per design variant
that ``PERF.md`` reports, to time beside the kernel as shipped.

    python3 scripts/dq_variants.py OUT_DIR [NAME ...]
    python3 scripts/time_flash_kernels.py --root OUT_DIR/NAME --label NAME

Each variant is ``OUT_DIR/NAME/siss_tpu_torch``, a copy of this checkout's
package with one edit of ``ops/csrc/flash_bwd_dq_sm90.cu``:

- ``exp2f``: exp2f in place of the one-instruction ex2.approx;
- ``k128``: 128-key K/V tiles at head dims up to 40 (64 elsewhere);
- ``s4``: a ring of 4 stages in place of 3;
- ``pipe``: each consumer warpgroup issues S and dP of key tile t + 1
  beside dQ += dS K of tile t, and forms dS of tile t + 1 while that
  product runs.

Time them in turns with the shipped kernel on one card (A, B, ..., B, A).
An edit whose text no longer matches the source raises.
"""
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = "siss_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu"

LOOP_START = "  mbar_wait(qdo_full, 0);\n"
LOOP_END = "#pragma unroll\n  for (int hf = 0; hf < 2; ++hf) {\n    const int row"

PIPELINED = r'''  // S and dP of key tile t + 1 are issued beside dQ += dS K of tile t, so
  // the tensor cores run that product while this warpgroup forms dS of
  // tile t + 1.
  auto issue_s_dp = [&](int t, float (&sc)[kKeys / 2], float (&dp)[kKeys / 2]) {
    const int s = t % kStages;
    const uint64_t kd = desc_k_major(smem_u32(ks + s * kTileBytes), kKeys);
    const uint64_t vd = desc_k_major(smem_u32(vs + s * kTileBytes), kKeys);
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kKeys>(sc, qd + k_step(i, rows), kd + k_step(i, kKeys), i);
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kKeys>(dp, dod + k_step(i, rows), vd + k_step(i, kKeys), i);
    wgmma_commit();
  };
  auto form_ds = [&](float (&sc)[kKeys / 2], float (&dp)[kKeys / 2], uint32_t (&dsa)[kKeys / 16][4]) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          const float p = fast_exp2(fmaf(sc[i], scale_log2, -lse_log2[hf]));
          dp[i] = (dp[i] - di_row[hf]) * p * scale;
        }
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) dsa[i][r] = pack_bf16(dp[8 * i + 2 * r], dp[8 * i + 2 * r + 1]);
  };
  auto issue_dq = [&](int t, uint32_t (&dsa)[kKeys / 16][4]) {
    const uint64_t km = desc_mn_major(smem_u32(ks + (t % kStages) * kTileBytes), kKeys);
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i) wgmma_rs<D>(acc, dsa[i], km + mn_step(i));
    wgmma_commit();
  };

  uint32_t dsa[kKeys / 16][4];  // bf16 dS of the tile whose dQ product is next
  mbar_wait(qdo_full, 0);
  {
    float sc[kKeys / 2], dp[kKeys / 2];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s_dp(0, sc, dp);
    wgmma_wait_all();
    pin(sc);
    pin(dp);
    form_ds(sc, dp, dsa);
  }
  for (int t = 0; t + 1 < tiles; ++t) {
    float sc[kKeys / 2], dp[kKeys / 2];
    uint32_t next[kKeys / 16][4];
    mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
    pin(acc);
    pin(dsa);
    wgmma_fence();
    issue_s_dp(t + 1, sc, dp);
    issue_dq(t, dsa);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    pin(sc);
    pin(dp);
    form_ds(sc, dp, next);
    wgmma_wait_all();
    pin(acc);
    pin(dsa);
    if (lane == 0) mbar_arrive(&empty[t % kStages]);
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) dsa[i][r] = next[i][r];
  }
  pin(acc);
  pin(dsa);
  wgmma_fence();
  issue_dq(tiles - 1, dsa);
  wgmma_wait_all();
  pin(acc);
  if (lane == 0) mbar_arrive(&empty[(tiles - 1) % kStages]);

'''


def edit(text, old, new):
    """``text`` with ``old`` replaced by ``new``; raise if ``old`` is gone."""
    if old not in text:
        raise ValueError(f"{SRC} no longer holds: {old!r}")
    return text.replace(old, new)


def variants(src):
    """{name: the kernel's source with that variant's edit}."""
    start, end = src.index(LOOP_START), src.index(LOOP_END)  # the consumer loop
    return {
        "exp2f": edit(src, "fast_exp2(fmaf(sc[i], scale_log2, -lse_log2[hf]))",
                      "exp2f(fmaf(sc[i], scale_log2, -lse_log2[hf]))"),
        "k128": edit(src, "static constexpr int kKeys = 64;",
                     "static constexpr int kKeys = D <= 40 ? 128 : 64;"),
        "s4": edit(src, "static constexpr int kStages = 3;", "static constexpr int kStages = 4;"),
        "pipe": src[:start] + PIPELINED + src[end:],
    }


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out, names = Path(sys.argv[1]), sys.argv[2:]
    src = (REPO / SRC).read_text()
    for name, text in variants(src).items():
        if names and name not in names:
            continue
        root = out / name
        if root.exists():
            shutil.rmtree(root)
        shutil.copytree(REPO / "siss_tpu_torch", root / "siss_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (root / SRC).write_text(text)
        print(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
