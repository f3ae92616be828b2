"""``kmeans_assign``'s share of its roofline, in %: the least time of its
calls' shapes (``costs.kmeans_assign``) over the profiler's device time
of its kernels (``csrc/kmeans_assign.cu``)."""
from odcl_bench import costs
from odcl_bench.metrics_common import roofline

KERNELS = ("assign_small_kernel", "assign_stream_kernel")


def cost(args):
    points, centers = args[0], args[1]
    return costs.kmeans_assign(points[0], centers[0], points[1])


def read(ctx):
    return roofline(ctx, ("kmeans_assign",), KERNELS, cost)
