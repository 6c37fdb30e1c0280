"""The program's host waits for the card (`trigger.host_syncs`, all names)
over the window, a `channel_scan` call."""


def read(rd):
    st = rd["state"]
    if not st.get("calls"):
        return None
    return st["syncs"] / st["calls"]
