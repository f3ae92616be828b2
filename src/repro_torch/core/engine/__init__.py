"""The device aggregation engine: Lloyd loop, aggregators, the one-shot
round (``aggregate``) and the streaming ``session``."""
