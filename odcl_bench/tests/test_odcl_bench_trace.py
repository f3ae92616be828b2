"""The traced run's arithmetic on made-up intervals: the device's busy
union, the host event that spans each idle gap, a kernel's durations by
name."""
from odcl_bench import trace


def test_busy_intervals_merge():
    assert trace._merge([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == \
        [[0, 2.5], [3, 4]]


def test_each_gap_takes_the_innermost_host_event():
    host = sorted([(0, 10, "round"), (1, 3, "ingest"), (2, 2.5, "aten::mm"),
                   (5, 9, "finalize")])
    assert trace._innermost(host, [0.5, 2.2, 2.8, 4, 6, 11]) == \
        ["round", "aten::mm", "ingest", "round", "finalize", "host code"]


def test_kernel_time_matches_names_by_part():
    kernels = {"void assign_stream_kernel<true>(x)": [1.0, 2.0],
               "void other(x)": [5.0]}
    assert trace.kernel_time(kernels, ("assign_stream_kernel",)) == [1.0, 2.0]
