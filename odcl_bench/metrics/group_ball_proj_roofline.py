"""``group_ball_proj``'s share of its roofline, in %: the least time of
its calls' shapes (``costs.group_ball_proj``, with the radii each call
stores) over the profiler's device time of its kernels
(``csrc/group_prox.cu``)."""
import math

from odcl_bench import costs
from odcl_bench.metrics_common import roofline

KERNELS = ("group_ball_proj",)


def cost(args):
    v, radius = args[0], args[1]
    return costs.group_ball_proj(math.prod(v[:-1]), v[-1],
                                 getattr(radius, "stored", 1))


def read(ctx):
    return roofline(ctx, ("group_ball_proj", "group_ball_proj_batched"),
                    KERNELS, cost)
