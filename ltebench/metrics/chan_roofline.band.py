"""The channelizer's share of its bytes roofline, %: the least time for the
channelizer's work of the calls in the profiled slice
(`band_trace.channelizer`: the wide capture read once, the lanes written
once) over the device time of the operations launched inside the program's
span `channelize` there (the upload's copy included).  None without such
operations (a program without the span, or no card)."""

from ltebench import band_trace


def read(rd):
    sl = rd["slice"]
    if not sl or not sl["calls"]:
        return None
    t = sl.get("inside", {}).get("channelize", 0.0)
    if t <= 0:
        return None
    st, cfg = rd["state"], rd["ctx"]["config"]
    ratio = round(float(cfg["sample_rate"])) // 1_920_000
    least = sum(band_trace.channelizer(st["n_wide"], len(c), ratio)[0]
                for c in st["centres"]) / len(st["centres"])
    return 100.0 * least * sl["calls"] / t
