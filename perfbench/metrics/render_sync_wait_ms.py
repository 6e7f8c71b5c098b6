"""Host time inside the program's ``sync.*`` spans (its reads of the device,
each draining the queue before it) within ``render.frame``, median per frame
over the records the program kept of the window
(ai_path_tracer_denoiser_tpu_torch/utils/timers.py), in ms.  Silent where no
card was timed, or where the program keeps no spans."""
import statistics


def read(rec):
    if not rec or rec.get("render_ms") is None:
        return None
    from ai_path_tracer_denoiser_tpu_torch.utils import timers
    records = getattr(timers, "records", None)
    ns = [sum(v for k, v in r["spans"].items() if k.startswith("sync."))
          for r in (records("render.frame") if records else ())]
    return 1e-6 * statistics.median(ns) if ns else None
