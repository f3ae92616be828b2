"""``pairwise_sqdist``'s share of its roofline, in %: the least time of
its calls' shapes (``costs.pairwise_sqdist``) over the profiler's device
time of its kernels (``csrc/pairwise_l2.cu``)."""
from odcl_bench import costs
from odcl_bench.metrics_common import roofline

KERNELS = ("pairwise_sqdist_kernel", "pairwise_stream_kernel")


def cost(args):
    a, b = args[0], args[1]
    return costs.pairwise_sqdist(a[-2], b[-2], a[-1],
                                 a[0] if len(a) == 3 else 1)


def read(ctx):
    return roofline(ctx, ("pairwise_sqdist",), KERNELS, cost)
