"""Stage 1's three routes on one card: the deep wgmma kernel (bf16, 256 < DA
<= 512) checked and timed against the FMA kernel, the plain twin and the
bare bf16 product, with ``chip_smoke.py``'s own helpers.

    python3 tools/time_stage1_routes.py [--quick]

Prints the card's name and power limit, the ptxas lines (registers, spills)
of the deep kernel's instantiations, then: bit-equality with the twin on
integer inputs at DA 257, 294, 300, 390, 510 and 512 (and a ragged batch of
333 at DA 294), each launch counted on its route; then (without
``--quick``) the times at phase 3b's [256 x 294] x [294 x 1,015,808] and at
the full catalog's [4096 x DA] x [DA x 1,867,776] for DA 294, 390 and 510,
beside the DA <= 256 kernel at DA 198 for context.  Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from otto_tpu_torch.ops import _kernels  # noqa: E402
from otto_tpu_torch.ops import fused_retrieval as fr  # noqa: E402
from otto_tpu_torch.utils.runtime import device_line  # noqa: E402

N_3B = 1_015_808  # phase 3b's padded table: 1,000,000 items
N_FULL = 1_867_776  # the full catalog's: 1,855,603 items


def counts() -> dict:
    f = fr.fused_stage1
    return {"wgmma": f.launches, "wgmma_deep": f.deep_launches, "fma": f.fma_launches}


def ptxas_lines(report: str) -> None:
    """The report's lines for the deep kernel's instantiations."""
    name = None
    for line in report.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
        if name and "fused_stage1_deep_kernel" in name and (
                "registers" in line or "spill" in line):
            steps = re.search(r"ILi(\d+)E", name)
            print(f"deep K_STEPS={steps.group(1) if steps else '?'}: {line.strip()}")


def operands(g, b, da, n_pad, integer: bool):
    dev = torch.device("cuda", 0)
    if integer:
        q = torch.randint(-8, 9, (b, da), generator=g, device=dev).to(torch.bfloat16)
        q[:, -1] = 64
        t = torch.randint(-8, 9, (da, n_pad), generator=g, device=dev).to(torch.bfloat16)
        return q, t
    q = torch.randn((b, da), generator=g, device=dev)
    q[:, -1] = 128.0
    t = torch.randn((da, n_pad), generator=g, device=dev)
    t[-1] = 1.0
    return q.to(torch.bfloat16), t.to(torch.bfloat16)


def check_depths(g) -> None:
    for da, b, n_pad in ((257, 130, 2 * fr.CHUNK), (294, 130, 2 * fr.CHUNK),
                         (294, 333, 3 * fr.CHUNK), (300, 130, 2 * fr.CHUNK),
                         (390, 130, 2 * fr.CHUNK), (510, 130, 2 * fr.CHUNK),
                         (512, 130, 2 * fr.CHUNK)):
        q, t = operands(g, b, da, n_pad, integer=True)
        before = counts()
        k = fr.fused_stage1(q, t)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in counts().items()}
        r = fr._stage1_reference(q, t)
        equal = torch.equal(k.view(torch.int32), r.view(torch.int32))
        print(f"DA={da} B={b} N_pad={n_pad}: launches {moved}, bit-equal {equal}", flush=True)
        cs.check(moved == {"wgmma": 0, "wgmma_deep": 1, "fma": 0}, f"DA={da}: route {moved}")
        cs.check(equal, f"DA={da} B={b}: the deep route differs from the twin")


def close(k, r, what: str) -> float:
    live = r >= 1.0
    cs.check(torch.equal(live, k >= 1.0), f"{what}: live windows differ")
    rel = ((k - r).abs() / r.abs())[live].max().item()
    same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
    print(f"{what}: max rel err {rel:.3e} (limit 2^-15), same window position {same:.6f} "
          "(limit 0.999)", flush=True)
    cs.check(rel <= 2.0**-15 and same >= 0.999, f"{what}: outside the bars")
    return rel


def time_shape(g, b, da, n_pad, fma_reps: int, twin: bool) -> None:
    q, t = operands(g, b, da, n_pad, integer=False)
    what = f"[{b} x {da}] x [{da} x {n_pad}]"
    k = fr.fused_stage1(q, t)
    if twin:
        close(k, fr._stage1_reference(q, t), f"deep route {what}")
    del k
    cs.check(fr.stage1_route(q.dtype, da) == "wgmma_deep", f"{what} is not on the deep route")
    out = torch.empty((b, n_pad // fr.WINDOW), dtype=torch.float32, device=q.device)
    ms = [cs.cuda_ms(torch, lambda: fr.fused_stage1(q, t), 5) for _ in range(2)]
    fma_ms = (cs.cuda_ms(torch, lambda: _kernels.launch_fused_stage1_fma(q, t, out), fma_reps)
              if fma_reps else None)
    plain_ms = cs.cuda_ms(torch, lambda: fr._stage1_reference(q, t), 1) if twin else None
    mm_ms, slices = cs.matmul_yardstick_ms(torch, q, t, 3)
    bound = cs.stage1_bound(q, t)
    best = min(ms)
    fma = f"{fma_ms:.3f} ms ({fma_ms / best:.1f}x the deep route)" if fma_ms else "not run"
    plain = f"{plain_ms:.3f} ms" if plain_ms else "not run"
    print(f"deep route {what}: {ms[0]:.4f} / {ms[1]:.4f} ms; FMA kernel {fma}; twin {plain}; "
          f"torch.matmul bf16 product alone ({slices} slices) {mm_ms:.3f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]}): {100 * bound[0] / best:.1f}% of it", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_stage1_routes: needs a CUDA card", file=sys.stderr)
        return 2
    print(device_line("cuda"), flush=True)
    path = _kernels.build()
    _kernels.lib()
    ptxas_lines(path.with_suffix(".ptxas.txt").read_text())
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    check_depths(g)
    if "--quick" in sys.argv:
        return 0
    time_shape(g, 256, 294, N_3B, fma_reps=3, twin=True)
    time_shape(g, 4096, 294, N_FULL, fma_reps=1, twin=True)
    for da in (390, 510):
        time_shape(g, 4096, da, N_FULL, fma_reps=0, twin=False)
    q, t = operands(g, 4096, 198, N_FULL, integer=False)
    ms = cs.cuda_ms(torch, lambda: fr.fused_stage1(q, t), 5)
    bound = cs.stage1_bound(q, t)
    print(f"context: the DA <= 256 wgmma kernel [4096 x 198] x [198 x {N_FULL}]: {ms:.4f} ms; "
          f"bound {bound[0]:.4f} ms ({bound[1]}): {100 * bound[0] / ms:.1f}% of it", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
