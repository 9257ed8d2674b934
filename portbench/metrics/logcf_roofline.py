"""The scalar exact-CF kernel's share of its roofline: the least time its
calls' work needs (``roofline.logcf_work``) over the device time of the
operations launched inside the calls."""
from portbench import roofline

INSTRUMENT = ("repro_torch.kernels.pb_cf", "logcf", roofline.logcf_work)


def read(ctx):
    return roofline.share(ctx, "logcf")
