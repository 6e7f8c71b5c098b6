"""Device time between CUDA events around ``apply_frame_fast_padded``,
mean per frame over the window, in ms."""


def read(rec):
    return rec.get("denoise_ms") if rec else None
