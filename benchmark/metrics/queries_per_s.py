"""Queries answered over the whole window, one client waiting for each
answer: every query the window completed (the one in flight at its end
finishes and counts) over the window's seconds."""


def read(ctx):
    if not ctx.done or ctx.window_s <= 0:
        return None
    return len(ctx.done) / ctx.window_s
