"""The hand-written CUDA kernels' wrappers (one module a kernel) and their
build (`build.py`).  Each wrapper module counts its kernel's launches in its
`launches`; on the CPU the plain versions run and the counts stay 0."""


def modules() -> dict:
    """Every hand kernel's wrapper module by short name: "mf" (matched
    filter), "pb" (pass B), "tti" (TTI chain), "vit" (Viterbi), "ring" (CFO
    ring), "chan" (the channelizer's mixer and decimator), "front" (pass
    C's front end: its `launches` counts calls, two kernels each beside the
    ring's)."""
    from . import (cfo_ring, channelize, matched_filter, pass_b,
                   pass_c_front, tti_chain, viterbi)
    return {"mf": matched_filter, "pb": pass_b, "tti": tti_chain,
            "vit": viterbi, "ring": cfo_ring, "chan": channelize,
            "front": pass_c_front}


def launch_counts() -> dict:
    """Every hand kernel's launches so far in this process, by the short
    names of `modules()`."""
    return {k: m.launches for k, m in modules().items()}
