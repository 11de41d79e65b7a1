"""Predictor's k-best kernel (B2 on a bucket): the least time the window's
real query rows need against the training set (padding rows not counted)
over the device time of the ``knn_kbest`` kernels, as a percent. The rows
are those ``Predictor._stage`` staged in the window."""

from portbench import profile, recorder, roofline


def record():
    from hdbscan_tpu_torch.serve.predict import Predictor

    return recorder.CallRecorder(Predictor, "_stage")


def read(ctx):
    calls = ctx["recorded"].calls
    if not calls:
        return None
    n, d = ctx["training_shape"]
    k = ctx["k"]
    bound = sum(roofline.bound_s(float(len(args[1])) * n * (roofline.pair_ops(d, "dot") + 1),
                                 (n + len(args[1])) * d * 4 + len(args[1]) * k * 8)
                for args, _ in calls)
    return roofline.share(bound, profile.device_s(ctx["profile"], "knn_kbest"))
