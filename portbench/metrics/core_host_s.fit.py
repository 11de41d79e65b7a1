"""Core distances: the time inside the window's ``core_distances`` spans
in which the card ran nothing (their wall less the profile's busy time
under them), summed over the fits, seconds a fit."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    idle = tl.idle_us("core_distances") if tl else None
    if not idle or not ctx.get("fits"):
        return None
    return sum(idle) / 1e6 / ctx["fits"]
