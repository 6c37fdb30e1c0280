"""Device kernels, copies and sets in the profiled slice, a call: the length
of the host's launch chain that the call enqueues."""


def read(rd):
    sl = rd["slice"]
    if not sl or not sl["calls"] or not sl["device_ops"]:
        return None
    return sl["device_ops"] / sl["calls"]
