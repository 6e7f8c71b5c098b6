"""Share of the roofline of the kernel-predicting denoiser's nine 5x5 convs:
their bound (each conv's bytes moved once over HBM bandwidth or its
operations over the bfloat16 peak, whichever is slower, summed; counted
from the published shapes in counts_kpcn.py) over the union of device
intervals of the kernels launched inside the program's
``denoise.kpcn.convs`` span, in %.  Silent where that span launched no
kernel (the CPU, or a program without it)."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    span = prof.get("spans", {}).get("denoise.kpcn.convs")
    if not span or not span["device_s"] or "conv_bound_s" not in rec:
        return None
    return 100.0 * rec["conv_bound_s"] * prof["units"] / span["device_s"]
