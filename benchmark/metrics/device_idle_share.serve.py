"""``device_idle_share.serve``: the share of the traced window of a
serving cell in which no kernel or copy ran on the card."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
