"""The pipeline's mean scan depth over the window of the live band
monitor: the half-frame steps dispatched over the dispatches
(`api.stream_counts`); shallow dispatches mean the host sets the pace
(none against a program without the counters)."""


def read(rd):
    counts = rd["state"].get("counts")
    if not counts or not counts.get("dispatches"):
        return None
    return counts["steps"] / counts["dispatches"]
