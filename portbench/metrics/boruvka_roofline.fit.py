"""Borůvka rounds' segment-min kernels (B1, B9 of the sharded fit): the
least time of every recorded launch (its cross-component pairs) over the
device time of the ``segmin`` kernels in the window, as a percent."""

from portbench import profile, recorder, roofline


def record():
    return recorder.SegminRecorder()


def read(ctx):
    bounds = ctx["recorded"].bounds()
    if not bounds:
        return None
    return roofline.share(sum(bounds), profile.device_s(ctx["profile"], "segmin"))
