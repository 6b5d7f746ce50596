"""``retriever_build_ms.serve``: the card's time building the fused
retriever's table in a serving call, in ms.

The device time of every kernel and copy launched inside the program's
``otto::retrieval.build`` spans (``FusedRetriever.__init__``: the
compensated bf16 table, built anew by each ``full_sort_topk`` call), over
the traced window's ``otto::serve`` calls.
"""

from benchkit.spans import calls

RANGE = "otto::retrieval.build"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None:
        return None
    n, seconds = calls(tr), tr.device_seconds_in(RANGE)
    if not n or seconds is None:
        return None
    return 1e3 * seconds / n
