"""Device time between CUDA events around ``render_gbuffer_frame``, mean
per frame over the window, in ms."""


def read(rec):
    return rec.get("render_ms") if rec else None
