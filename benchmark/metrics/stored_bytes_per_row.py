"""File bytes on disk per row written in the window: the space that the
write's speed trades against."""


def read(ctx):
    rows = sum(a["rows"] for _p, a in ctx.done)
    if not rows:
        return None
    return sum(a["bytes"] for _p, a in ctx.done) / rows
