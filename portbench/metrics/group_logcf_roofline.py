"""The grouped exact-CF kernel's share of its roofline: the least time its
calls' work needs (``roofline.group_logcf_work``) over the device time of
the operations launched inside the calls."""
from portbench import roofline

INSTRUMENT = ("repro_torch.kernels.group_cf", "group_logcf",
              roofline.group_logcf_work)


def read(ctx):
    return roofline.share(ctx, "group_logcf")
