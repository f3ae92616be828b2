"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels (built in a checkout's first run, loaded after),
the uploads made on the card, the federation ingested, one warm round."""


def read(ctx):
    return ctx["setup_s"]
