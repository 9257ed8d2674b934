"""The grouped cumulant kernel's share of its roofline in a sweep: the
least time its calls' work needs (``roofline.group_cumulant_sums_work``)
over the device time of the operations launched inside the calls."""
from portbench import roofline

INSTRUMENT = ("repro_torch.kernels.group_cumulants", "group_cumulant_sums",
              roofline.group_cumulant_sums_work)


def read(ctx):
    return roofline.share(ctx, "group_cumulant_sums")
