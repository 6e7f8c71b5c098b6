"""Share of the roofline of the denoiser's 28 convs: their bound (each
conv's bytes moved once over HBM bandwidth or its operations over the
bfloat16 peak, whichever is slower; counted from shapes in counts.py)
over the union of device intervals of every kernel launched inside the
denoise span, in %."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    span = prof.get("spans", {}).get("denoise")
    if not span or not span["device_s"] or "denoise_bound_s" not in rec:
        return None
    return 100.0 * rec["denoise_bound_s"] * prof["units"] / span["device_s"]
