"""``serve_mfu``: serving's share of the card's bf16 tensor peak.

Each model-route session scored in the traced window counts one encoder
forward (``benchkit.flops``) and its dot products with the whole catalog,
2 * N * D; over the window's seconds, over 989 TFLOP/s, the H100's dense
bf16 tensor rate (the catalog scan runs on the tensor cores in bf16; the
work counts one product, so no implementation can read above 100%).
Sessions on the recency route do no model work and are not counted.
"""

from benchkit.flops import encoder_flops, score_flops
from benchkit.peaks import peaks_for


def read(ctx: dict):
    tr, peaks = ctx.get("trace"), peaks_for(ctx["device_name"])
    if tr is None or peaks is None or not ctx.get("model_sessions_traced"):
        return None
    cfg = ctx["config"]
    work = ctx["model_sessions_traced"] * (encoder_flops(cfg) + score_flops(cfg, cfg["n_aids"]))
    return 100.0 * work / tr.window_s / peaks.bf16_flops
