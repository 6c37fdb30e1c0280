#!/usr/bin/env python
"""Generate docs/API_torch.md — the rendered API reference of the PyTorch
port, ltetrigger_tpu_torch (docs/gen_api.py renders the JAX package's).

The docstrings are the source of truth; this script renders the public
functions and classes of the port's counterparts of docs/gen_api.py's
modules, plus the port's own `ops.kernels.{matched_filter,pass_b,
tti_chain,viterbi,cfo_ring,pass_c_front,channelize,build}`, `ops.device` and
`runtime.native`,
into one markdown file.  Deterministic; imports torch and
the port, nothing of JAX.

Usage:  python docs/gen_api_torch.py          (writes docs/API_torch.md)
        python docs/gen_api_torch.py --check  (fails if API_torch.md is
                                               stale)
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODULES = [
    "ltetrigger_tpu_torch",
    "ltetrigger_tpu_torch.models.api",
    "ltetrigger_tpu_torch.models.multi",
    "ltetrigger_tpu_torch.models.wideband",
    "ltetrigger_tpu_torch.models.trigger",
    "ltetrigger_tpu_torch.runtime.cellstore",
    "ltetrigger_tpu_torch.runtime.native",
    "ltetrigger_tpu_torch.runtime.chunkbuf",
    "ltetrigger_tpu_torch.parallel.mesh",
    "ltetrigger_tpu_torch.parallel.sharded",
    "ltetrigger_tpu_torch.ops.correlate",
    "ltetrigger_tpu_torch.ops.sync",
    "ltetrigger_tpu_torch.ops.cfo",
    "ltetrigger_tpu_torch.ops.pbch",
    "ltetrigger_tpu_torch.ops.viterbi",
    "ltetrigger_tpu_torch.ops.resample",
    "ltetrigger_tpu_torch.ops.channelize",
    "ltetrigger_tpu_torch.ops.cplx",
    "ltetrigger_tpu_torch.ops.dft",
    "ltetrigger_tpu_torch.ops.device",
    "ltetrigger_tpu_torch.ops.kernels.matched_filter",
    "ltetrigger_tpu_torch.ops.kernels.pass_b",
    "ltetrigger_tpu_torch.ops.kernels.tti_chain",
    "ltetrigger_tpu_torch.ops.kernels.viterbi",
    "ltetrigger_tpu_torch.ops.kernels.cfo_ring",
    "ltetrigger_tpu_torch.ops.kernels.pass_c_front",
    "ltetrigger_tpu_torch.ops.kernels.channelize",
    "ltetrigger_tpu_torch.ops.kernels.build",
    "ltetrigger_tpu_torch.ltecore.constants",
    "ltetrigger_tpu_torch.ltecore.synth",
    "ltetrigger_tpu_torch.ltecore.refrx",
    "ltetrigger_tpu_torch.apps.cell_search_file",
    "ltetrigger_tpu_torch.apps.snr_sweep",
    "ltetrigger_tpu_torch.apps.live_monitor",
    "ltetrigger_tpu_torch.apps.wideband_scan",
    "ltetrigger_tpu_torch.apps.run_flowgraph",
    "ltetrigger_tpu_torch.utils.eng_notation",
    "ltetrigger_tpu_torch.utils.profiling",
]


def _sig(obj) -> str:
    """The signature, with the checkout's own path (in defaults such as
    run_flowgraph's GRC_DIR) as <repo>, so the file does not depend on
    where the repository lies."""
    try:
        return str(inspect.signature(obj)).replace(ROOT, "<repo>")
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent: str = "") -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + ln for ln in d.splitlines())


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def render() -> str:
    out = ["# ltetrigger_tpu_torch — API reference",
           "",
           "Generated by `docs/gen_api_torch.py` from the live docstrings "
           "of the PyTorch port.  Regenerate with "
           "`python docs/gen_api_torch.py`.",
           ""]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        out.append(f"## `{modname}`")
        out.append("")
        md = _doc(mod)
        if md:
            out.append(md)
            out.append("")
        members = sorted(vars(mod).items())
        for name, obj in members:
            if not _is_public(name):
                continue
            if getattr(obj, "__module__", None) != modname:
                continue
            if inspect.isclass(obj):
                out.append(f"### class `{name}{_sig(obj)}`")
                out.append("")
                cd = _doc(obj)
                if cd:
                    out.append(cd)
                    out.append("")
                for mname, meth in sorted(vars(obj).items()):
                    if not _is_public(mname):
                        continue
                    if isinstance(meth, property):
                        out.append(f"* **`{mname}`** (property) — "
                                   + (inspect.getdoc(meth) or "").strip()
                                   .split("\n")[0])
                    elif inspect.isfunction(meth):
                        out.append(f"* **`{mname}{_sig(meth)}`**")
                        d1 = _doc(meth, "  ")
                        if d1:
                            out.append("")
                            out.append(d1)
                    else:
                        continue
                    out.append("")
            elif inspect.isfunction(obj):
                out.append(f"### `{name}{_sig(obj)}`")
                out.append("")
                fd = _doc(obj)
                if fd:
                    out.append(fd)
                    out.append("")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def main():
    path = os.path.join(ROOT, "docs", "API_torch.md")
    text = render()
    if "--check" in sys.argv:
        with open(path) as f:
            if f.read() != text:
                print("docs/API_torch.md is stale — run python "
                      "docs/gen_api_torch.py")
                return 1
        print("docs/API_torch.md up to date")
        return 0
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
