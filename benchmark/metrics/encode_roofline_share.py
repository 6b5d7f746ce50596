"""``encode_roofline_share``: the session encoder's share of its roofline.

Each model-route session of the traced window counts one encoder forward
(``benchkit.flops.encoder_flops``); the rows that pad a batch count as no
work.  The bound is those operations at the H100's float32 rate, 67
TFLOP/s (the encoder runs in float32 with TF32 off); the share is the bound
over the device time of every kernel launched inside the program's
``otto::encode`` spans (``SequenceModel.session_vectors``' batch loop).
"""

from benchkit.flops import encoder_flops
from benchkit.peaks import peaks_for

RANGE = "otto::encode"


def read(ctx: dict):
    tr, peaks = ctx.get("trace"), peaks_for(ctx["device_name"])
    if tr is None or peaks is None or not ctx.get("model_sessions_traced"):
        return None
    seconds = tr.device_seconds_in(RANGE)
    if not seconds:
        return None
    work = ctx["model_sessions_traced"] * encoder_flops(ctx["config"])
    return 100.0 * work / seconds / peaks.f32_flops
