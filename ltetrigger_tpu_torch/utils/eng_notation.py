"""Engineering-notation parsing/formatting (replaces gnuradio.eng_notation,
used by the reference CLI's -s/-f/-c/--throttle flags,
examples/cell_search_file.py:144-167)."""

_SUFFIXES = {
    "E": 1e18, "P": 1e15, "T": 1e12, "G": 1e9, "M": 1e6, "k": 1e3,
    "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15, "a": 1e-18,
}


def str_to_num(value: str) -> float:
    """"15.36M" -> 15360000.0; plain numbers pass through."""
    s = value.strip()
    if not s:
        raise ValueError("empty engineering-notation value")
    if s[-1] in _SUFFIXES:
        return float(s[:-1]) * _SUFFIXES[s[-1]]
    return float(s)


def num_to_str(value: float) -> str:
    for suf, mag in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(value) >= mag:
            v = value / mag
            return f"{v:g}{suf}"
    return f"{value:g}"
