"""Reads of the device by the host (the program's ``sync.*`` counters)
inside ``render.frame``, summed over the records the program kept of the
window and divided by their number
(ai_path_tracer_denoiser_tpu_torch/utils/timers.py).  Silent where no card
was timed, or where the program keeps no spans."""


def read(rec):
    if not rec or rec.get("render_ms") is None:
        return None
    from ai_path_tracer_denoiser_tpu_torch.utils import timers
    records = getattr(timers, "records", None)
    frames = records("render.frame") if records else []
    if not frames:
        return None
    reads = sum(v for r in frames for k, v in r["counts"].items() if k.startswith("sync."))
    return reads / len(frames)
