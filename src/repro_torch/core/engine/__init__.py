"""The device aggregation engine: Lloyd loop, aggregators, staleness
policies, the one-shot round (``aggregate``) and the streaming, mutable
``session``."""
