#!/usr/bin/env python3
"""Make edited copies of the port's flash-attention kernels, one per design
variant that ``PERF.md`` reports, to time beside the kernels as shipped.

    python3 scripts/flash_variants.py OUT_DIR [NAME ...]
    python3 scripts/time_flash_kernels.py --root OUT_DIR/NAME --label NAME [--dtype ...]

Each variant is ``OUT_DIR/NAME/siss_tpu_torch``, a copy of this checkout's
package with one edit. Of the bf16 dQ kernel, ``ops/csrc/flash_bwd_dq_sm90.cu``:

- ``exp2f``: exp2f in place of the one-instruction ex2.approx;
- ``k128``: 128-key K/V tiles at head dims up to 40 (64 elsewhere);
- ``s4``: a ring of 4 stages in place of 3;
- ``pipe``: each consumer warpgroup issues S and dP of key tile t + 1
  beside dQ += dS K of tile t, and forms dS of tile t + 1 while that
  product runs.

Of the fp32 3xTF32 forward, ``ops/csrc/flash_fwd_tf32x3.cu`` and
``flash_tf32x3.cuh`` (time these with ``--dtype float32``):

- ``fwd_chained``: every product accumulated straight into S and O by the
  tensor cores (no fresh accumulator per 8-deep step or key tile);
- ``fwd_w2``: blocks of 2 warps in place of 4;
- ``fwd_mt1``: one 16-row m-tile per warp at every head dim (two at
  D <= 40 as shipped);
- ``fwd_g1``: one key group per block at every head dim (two at D = 64 and
  80 as shipped);
- ``fwd_pvstep``: O += P V added to O once per 8-deep step at every head
  dim (once per key tile at D = 64 and 80 as shipped);
- ``fwd_s2acc``: S = Q K^T as two running sums, hi hi in one and the small
  terms in another, added once a tile (not once per 8-deep step);
- ``fwd_hicvt``: hi rounded by cvt.rna.tf32.f32 (four instructions) at
  every head dim, in place of the integer rounding of its bits (two; the
  same bits but for NaN) at all but D = 80;
- ``fwd_hibits``: hi rounded by integer operations at D = 80 too (by
  cvt.rna there as shipped; ptxas spills);
- ``fwd_hibits_s2``: ``fwd_hibits`` with S's k-steps unrolled by 2 at
  D = 80, which stops the spill;
- ``fwd_nosplit``: operands handed to the tensor cores unsplit, lo = 0
  (timing only: the products lose fp32 accuracy), to see what the split
  costs;
- ``fwd_fastexp``: __expf in place of expf (timing only), to see what the
  accurate exponential costs.

Of the fp32 3xTF32 dK/dV, ``ops/csrc/flash_bwd_dkv_tf32x3.cu`` (time these
with ``--dtype float32``):

- ``dkv_mt1``: one 16-key m-tile per warp at every head dim (two at
  D <= 40 as shipped);
- ``dkv_q64``: 64-query Q/dO tiles at D <= 40 (32 as shipped; at D = 64
  and 80 two groups' 64-query rings would not fit in shared memory);
- ``dkv_g1``: one query group per block at every head dim (two at D = 64
  and 80 as shipped);
- ``dkv_chained``: dV += P^T dO and dK += dS^T Q accumulated straight into
  dK and dV by the tensor cores (no fresh accumulator per 8-deep step);
- ``dkv_unrolled``: S^T's and dP^T's 8-deep steps fully unrolled with two
  m-tiles too (rolled there as shipped; ptxas spills);
- ``dkv_hicvt``: hi rounded by cvt.rna with two m-tiles (by the integer
  rounding of its bits as shipped).

Of the fp32 3xTF32 dQ, ``ops/csrc/flash_bwd_dq_tf32x3.cu`` (time these with
``--dtype float32``):

- ``dq32_mt1``: one 16-row m-tile per warp at every head dim (two at
  D <= 40 as shipped);
- ``dq32_g1``: one key group per block at every head dim (two at D = 64
  and 80 as shipped);
- ``dq32_chained``: dQ += dS K accumulated straight into dQ by the tensor
  cores (no fresh accumulator per 8-deep step);
- ``dq32_regs1``: Q's hi fragments kept in registers at D = 40, 64 and 80
  (every part in shared memory as shipped; ptxas spills).

Time them in turns with the shipped kernel on one card (A, B, ..., B, A).
An edit whose text no longer matches the source raises.
"""
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DQ = "siss_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu"
FWD = "siss_tpu_torch/ops/csrc/flash_fwd_tf32x3.cu"
FWD_H = "siss_tpu_torch/ops/csrc/flash_tf32x3.cuh"
DKV = "siss_tpu_torch/ops/csrc/flash_bwd_dkv_tf32x3.cu"
DQ32 = "siss_tpu_torch/ops/csrc/flash_bwd_dq_tf32x3.cu"

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


def edit(path, *pairs):
    """{path: its text with each (old, new) of ``pairs`` applied in turn};
    raise if an ``old`` is gone."""
    text = (REPO / path).read_text()
    for old, new in pairs:
        if old not in text:
            raise ValueError(f"{path} no longer holds: {old!r}")
        text = text.replace(old, new)
    return {path: text}


def variants():
    """{name: {path: the source with that variant's edit}}."""
    src = (REPO / DQ).read_text()
    start, end = src.index(LOOP_START), src.index(LOOP_END)  # the consumer loop
    return {
        "exp2f": edit(DQ, ("fast_exp2(fmaf(sc[i], scale_log2, -lse_log2[hf]))",
                           "exp2f(fmaf(sc[i], scale_log2, -lse_log2[hf]))")),
        "k128": edit(DQ, ("static constexpr int kKeys = 64;",
                          "static constexpr int kKeys = D <= 40 ? 128 : 64;")),
        "s4": edit(DQ, ("static constexpr int kStages = 3;", "static constexpr int kStages = 4;")),
        "pipe": {DQ: src[:start] + PIPELINED + src[end:]},
        "fwd_chained": {**edit(FWD_H, ("  float step[4] = {0.f, 0.f, 0.f, 0.f};\n"
                                       "  mma3(step, ah, al, bh, bl);\n#pragma unroll\n"
                                       "  for (int i = 0; i < 4; ++i) d[i] += step[i];",
                                       "  mma3(d, ah, al, bh, bl);")),
                        **edit(FWD, ("static constexpr bool kPvPerTile = kGroups == 2;",
                                     "static constexpr bool kPvPerTile = false;"))},
        "fwd_w2": edit(FWD, ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")),
        "fwd_mt1": edit(FWD, ("static constexpr int kMT = D <= 40 ? 2 : 1;",
                              "static constexpr int kMT = 1;")),
        "fwd_g1": edit(FWD, ("static constexpr int kGroups = D == 64 || D == 80 ? 2 : 1;",
                             "static constexpr int kGroups = 1;")),
        "fwd_pvstep": edit(FWD, ("static constexpr bool kPvPerTile = kGroups == 2;",
                                 "static constexpr bool kPvPerTile = false;")),
        "fwd_s2acc": edit(FWD, (
            "        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;\n",
            "        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;\n    float sl[kMT][kKeys / 8][4] = {};\n"), (
            "for (int mt = 0; mt < kMT; ++mt) mma3_add(s[mt][j], ah[mt], al[mt], bh, bl);\n      }\n    }",
            "for (int mt = 0; mt < kMT; ++mt) {\n          mma(sl[mt][j], al[mt], bh);\n"
            "          mma(sl[mt][j], ah[mt], bl);\n          mma(s[mt][j], ah[mt], bh);\n        }\n"
            "      }\n    }\n#pragma unroll\n    for (int mt = 0; mt < kMT; ++mt)\n#pragma unroll\n"
            "      for (int j = 0; j < kKeys / 8; ++j)\n#pragma unroll\n"
            "        for (int i = 0; i < 4; ++i) s[mt][j][i] += sl[mt][j][i];")),
        "fwd_hicvt": edit(FWD, ("static constexpr bool kHiCvt = D == 80;",
                                "static constexpr bool kHiCvt = true;")),
        "fwd_hibits": edit(FWD, ("static constexpr bool kHiCvt = D == 80;",
                                 "static constexpr bool kHiCvt = false;")),
        "fwd_hibits_s2": edit(FWD, ("static constexpr bool kHiCvt = D == 80;",
                                    "static constexpr bool kHiCvt = false;"),
                              ("s[mt][j][i] = 0.f;\n#pragma unroll\n",
                               "s[mt][j][i] = 0.f;\n#pragma unroll(D == 80 ? 2 : kSteps)\n")),
        "fwd_nosplit": edit(FWD_H, ("  hi = kHiCvt ? to_tf32(x) : to_tf32_bits(x);\n"
                                    "  lo = to_tf32(x - __uint_as_float(hi));",
                                    "  hi = __float_as_uint(x);\n  lo = 0u;")),
        "fwd_fastexp": edit(FWD, ("expf(", "__expf(")),
        "dkv_mt1": edit(DKV, ("static constexpr int kMT = D <= 40 ? 2 : 1;",
                              "static constexpr int kMT = 1;")),
        "dkv_q64": edit(DKV, ("static constexpr int kQ = 32;",
                              "static constexpr int kQ = D <= 40 ? 64 : 32;")),
        "dkv_g1": edit(DKV, ("static constexpr int kGroups = D == 64 || D == 80 ? 2 : 1;",
                             "static constexpr int kGroups = 1;")),
        "dkv_chained": edit(DKV, ("mma3_add(dva[mt][n],", "mma3(dva[mt][n],"),
                            ("mma3_add(dka[mt][n],", "mma3(dka[mt][n],")),
        "dkv_unrolled": edit(DKV, ("static constexpr int kUnrollS = kMT == 2 ? 1 : D / 8;",
                                   "static constexpr int kUnrollS = D / 8;")),
        "dkv_hicvt": edit(DKV, ("static constexpr bool kHiCvt = false;",
                                "static constexpr bool kHiCvt = kMT == 2;")),
        "dq32_mt1": edit(DQ32, ("static constexpr int kMT = D <= 40 ? 2 : 1;",
                                "static constexpr int kMT = 1;")),
        "dq32_g1": edit(DQ32, ("static constexpr int kGroups = D == 64 || D == 80 ? 2 : 1;",
                               "static constexpr int kGroups = 1;")),
        "dq32_chained": edit(DQ32, ("mma3_add(dqa[mt][n],", "mma3(dqa[mt][n],")),
        "dq32_regs1": edit(DQ32, ("static constexpr int kRegParts = D <= 16 ? 4 : D == 128 ? 1 : 0;",
                                  "static constexpr int kRegParts = D <= 16 ? 4 : 1;")),
    }


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out, names = Path(sys.argv[1]), sys.argv[2:]
    for name, edits in variants().items():
        if names and name not in names:
            continue
        root = out / name
        if root.exists():
            shutil.rmtree(root)
        shutil.copytree(REPO / "siss_tpu_torch", root / "siss_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for path, text in edits.items():
            (root / path).write_text(text)
        print(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
