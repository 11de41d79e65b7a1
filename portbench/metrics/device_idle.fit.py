"""Device idle share of the traced window: the part in which no kernel,
copy or set ran, from the profiler's timeline, the mean over the cards."""


def read(ctx):
    idle = ctx["profile"]["idle_share"]
    return sum(idle.values()) / len(idle) if idle else None
