"""Host seconds from a frame's start to the return of its denoise call,
mean over the window, in ms: the app loop's dispatch."""


def read(rec):
    return rec.get("dispatch_ms") if rec and "frames" in rec else None
