"""Share of the roofline of the kernel-predicting denoiser's per-pixel
kernel apply: its bytes (each pixel's k*k bfloat16 logits, 3 float32
radiance values and 3 float32 results, moved once; counts_kpcn.py) over
HBM bandwidth, over the union of device intervals of the kernels launched
inside the program's ``denoise.kpcn.apply`` span, in %.  Silent where that
span launched no kernel (the CPU, or a program without it)."""


def read(rec):
    prof = (rec or {}).get("profile") or {}
    span = prof.get("spans", {}).get("denoise.kpcn.apply")
    if not span or not span["device_s"] or "apply_bound_s" not in rec:
        return None
    return 100.0 * rec["apply_bound_s"] * prof["units"] / span["device_s"]
