"""The streaming channelizer's share of its roofline, %: the least time for
the channelizer's work of the profiled slice's segments
(`wide_trace.channelizer`: the direct form's FFMAs at one an instruction,
or the wide pairs read and the lanes written once, whichever is longer; of
the wide payload samples the slice uploaded, the counter `wide_samples`, in
the segments it channelized, the spans `wide.mix`) over the device time of
the channelizer's own kernels launched inside `wide.mix` there
(`wide_trace.channelizer_s`; not the phase origins' copy).  None without
such kernels, samples or segments (a program without the span or the
counter, or no card)."""

from ltebench import wide_trace


def read(rd):
    sl = rd["slice"]
    if not sl or sl.get("chan_s", 0.0) <= 0 or not sl.get("wide_samples") \
            or not sl.get("segments"):
        return None
    cfg = rd["ctx"]["config"]
    ratio = round(float(cfg["sample_rate"])) // 1_920_000
    least = wide_trace.channelizer(sl["wide_samples"], sl["segments"],
                                   len(rd["state"]["offsets"]), ratio)[0]
    return 100.0 * least / sl["chan_s"]
