"""Host finalize: the fits' ``tree_*`` trace events (host work, host
clock) summed over the window, seconds a fit."""


def read(ctx):
    if not ctx.get("fits"):
        return None
    walls = [f["wall_s"] for stage, f in ctx["events"] if stage.startswith("tree_")]
    return sum(walls) / ctx["fits"] if walls else None
