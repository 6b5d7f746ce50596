"""``route_ms.serve``: the host's routing of a serving call, in ms.

The host duration of the program's ``otto::serve.route`` spans (the
distinct-aid counts, the last aids, the vocabulary lookup and the three
route masks of ``sequence_serving_predictions``) on the traced window's
thread, over the window's ``otto::serve`` calls.
"""

from benchkit.spans import host_ms_per_call


def read(ctx: dict):
    tr = ctx.get("trace")
    return None if tr is None else host_ms_per_call(tr, ("otto::serve.route",))
