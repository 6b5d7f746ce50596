"""``topk_roofline_share``: the catalog scan's share of its roofline.

For each ``FusedRetriever.topk`` call of the traced window (B query rows
over the N x D catalog) the bound is the larger of its operations, 2 * B *
N * D at the H100's 989 TFLOP/s (bf16 tensor), and its bytes, a bf16 table
read once, 2 * N * D at 3.35 TB/s.  The share is the calls' summed bound
over the device time of every kernel launched inside the benchmark's
``bench::topk`` ranges around the calls.  The count is the scoring's own
work, not the compensated kernel's three products over 3 * (D + 2) rows, so
a kernel at its own roofline reads about a third.
"""

from benchkit.peaks import peaks_for

RANGE = "bench::topk"


def bound_seconds(rows: int, n: int, d: int, peaks) -> float:
    return max(2.0 * rows * n * d / peaks.bf16_flops, 2.0 * n * d / peaks.hbm_bytes_per_s)


def read(ctx: dict):
    tr, peaks = ctx.get("trace"), peaks_for(ctx["device_name"])
    if tr is None or peaks is None or not ctx.get("topk_rows"):
        return None
    seconds = tr.device_seconds_in(RANGE)
    if not seconds:
        return None
    cfg = ctx["config"]
    bound = sum(bound_seconds(b, cfg["n_aids"], cfg["dim"], peaks) for b in ctx["topk_rows"])
    return 100.0 * bound / seconds
