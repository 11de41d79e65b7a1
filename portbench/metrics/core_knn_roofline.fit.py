"""Core distances' k-best kernels (K2, B3, the rectangular B2 of the
sharded fit): the least time of every recorded launch over the device time
of the ``knn_kbest`` kernels in the window, as a percent."""

from portbench import profile, recorder, roofline

KBEST = ("knn_kbest", "knn_kbest_panel", "knn_smallest")


def record():
    return recorder.LaunchRecorder(KBEST)


def read(ctx):
    launches = ctx["recorded"].launches
    if not launches:
        return None
    bound = sum(roofline.kbest_bound(name, args) for name, args in launches)
    return roofline.share(bound, profile.device_s(ctx["profile"], "knn_kbest"))
