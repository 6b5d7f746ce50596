"""``pack_ms.serve``: the event store's gather and packing of a serving
call, in ms.

The host duration of the program's ``otto::sessions.select`` spans
(``EventStore.select_sessions``) and ``otto::sessions.pack`` spans
(``EventStore.pack``, and apart from it the upload of what it packed) on
the traced window's thread, both routes, over the window's
``otto::serve`` calls.
"""

from benchkit.spans import host_ms_per_call


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return host_ms_per_call(tr, ("otto::sessions.select", "otto::sessions.pack"))
