"""Bits of every stream written in the window over their pixels: what
storing and sending the images costs."""


def read(run):
    items = [it for c in run.ok_calls for it in c.items]
    px = sum(it["h"] * it["w"] for it in items)
    if not px:
        return None
    return 8.0 * sum(it["bytes"] for it in items) / px
