"""The share of the profiled slice with no kernel, copy or set on the
card, %."""


def read(rd):
    sl = rd["slice"]
    if not sl or sl["window_s"] <= 0 or not sl["device_ops"]:
        return None
    return 100.0 * max(0.0, sl["window_s"] - sl["busy_s"]) / sl["window_s"]
