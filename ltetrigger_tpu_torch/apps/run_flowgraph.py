#!/usr/bin/env python
"""Headless GRC-flowgraph runner: load a .grc file, build the graph from the
port's block descriptors (ltetrigger_tpu_torch/grc/*.block.yml), and run it.

The PyTorch port of ltetrigger_tpu/apps/run_flowgraph.py.  It parses a GRC
3.10 YAML flowgraph, looks each `ltetrigger_tpu_torch_*` block up in the
descriptors, instantiates it by evaluating the descriptor's OWN
`templates.imports` / `templates.make` strings (so the descriptors are
executed metadata, not documentation), wires stream and message connections,
and drives samples through: no GNU Radio installation required.  The
trigger block's `device` parameter (default cuda) says where it runs.

Supported block set = what the shipped demos use: `blocks_file_source`
(complex64 file, repeat), `analog_noise_source_x` (gaussian),
`blocks_multiply_const_vxx`, `blocks_add_xx`, `variable`, and every
ltetrigger_tpu_torch_* descriptor: enough to run both demo shapes
(examples/ltetrigger_demo_torch.grc and the signal + noise adder graph of
examples/snr_ltetrigger_demo_torch.grc).  The stream scheduler evaluates
the block DAG one chunk per tick into the streaming pipeline
(Trigger.process); message connections map to the trigger's
on_track/on_drop event surface.  Needs PyYAML.

CLI:
    python -m ltetrigger_tpu_torch.apps.run_flowgraph \
        examples/ltetrigger_demo_torch.grc [--time-out 2]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys
import time

import numpy as np

GRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "grc"


def load_descriptors(grc_dir=GRC_DIR) -> dict:
    """id -> parsed block.yml for every shipped descriptor."""
    import yaml
    descs = {}
    for p in sorted(pathlib.Path(grc_dir).glob("*.block.yml")):
        with open(p) as f:
            d = yaml.safe_load(f)
        descs[d["id"]] = d
    return descs


def load_flowgraph(path) -> dict:
    import yaml
    with open(path) as f:
        fg = yaml.safe_load(f)
    if "blocks" not in fg or "connections" not in fg:
        raise ValueError(f"{path} is not a GRC flowgraph")
    return fg


def _coerce(desc_param, raw):
    dtype = desc_param.get("dtype")
    if dtype == "real":
        return float(raw)
    if dtype in ("int",):
        return int(raw)
    if dtype == "bool":
        return raw in (True, "True", "true", "1")
    return raw


def _make_from_descriptor(desc: dict, params: dict):
    """Instantiate a block by evaluating the descriptor's own templates."""
    ns: dict = {}
    exec(desc["templates"]["imports"], ns)           # noqa: S102 — the
    # descriptors are repo-controlled artifacts, same trust level as code
    make = desc["templates"]["make"]
    declared = {p["id"]: p for p in desc.get("parameters", [])}

    def sub(m):
        pid = m.group(1)
        val = _coerce(declared.get(pid, {}), params.get(
            pid, declared.get(pid, {}).get("default")))
        return repr(val)

    expr = re.sub(r"\$\{(\w+)\}", sub, make)
    for a in desc.get("asserts", []):
        cond = re.sub(r"\$\{(\w+)\}", sub, a)
        if not eval(cond, ns):                       # noqa: S307
            raise ValueError(f"flowgraph assert failed: {a}")
    return eval(expr, ns)                            # noqa: S307


_STREAM_IDS = ("blocks_file_source", "analog_noise_source_x",
               "blocks_multiply_const_vxx", "blocks_add_xx")


class FlowgraphRunner:
    """One parsed flowgraph, instantiated and runnable."""

    def __init__(self, path, grc_dir=GRC_DIR):
        self.fg = load_flowgraph(path)
        self.descs = load_descriptors(grc_dir)
        self.blocks: dict = {}
        self.vars: dict = {}
        self.stream_specs: dict = {}                 # name -> (id, params)
        for b in self.fg["blocks"]:
            bid, name = b["id"], b["name"]
            params = b.get("parameters", {})
            if bid == "variable":
                self.vars[name] = params.get("value")
            elif bid in _STREAM_IDS:
                if bid == "blocks_file_source" \
                        and params.get("type", "complex") != "complex":
                    raise ValueError(
                        "only complex64 file sources are supported")
                self.stream_specs[name] = (bid, params)
                self.blocks[name] = None
            elif bid in self.descs:
                self.blocks[name] = _make_from_descriptor(self.descs[bid],
                                                          params)
            else:
                raise ValueError(f"unsupported block id {bid!r} "
                                 f"(block {name!r})")
        self._wire()

    def _num(self, raw, default=0.0) -> float:
        """Evaluate a numeric GRC parameter (literal or variable name)."""
        if raw is None:
            return default
        if isinstance(raw, (int, float)):
            return float(raw)
        if raw in self.vars:
            return self._num(self.vars[raw], default)
        return float(eval(str(raw), {"__builtins__": {}},  # noqa: S307 —
                          dict(self.vars)))   # repo-controlled artifact

    def _wire(self) -> None:
        from ..models.api import Trigger
        from ..runtime.cellstore import CellStore

        self.stream_in: dict = {}                    # dst name -> [srcs]
        self.sinks: list[tuple[str, Trigger]] = []
        for src, sp, dst, dp in self.fg["connections"]:
            s, d = self.blocks.get(src), self.blocks.get(dst)
            if src in self.stream_specs:
                if isinstance(d, Trigger):
                    self.sinks.append((src, d))
                    self.stream_in.setdefault(f"__trigger__{dst}",
                                              []).append(src)
                elif dst in self.stream_specs:
                    self.stream_in.setdefault(dst, []).append(src)
                else:
                    raise ValueError(
                        f"stream edge into unsupported block {dst!r}")
            elif isinstance(s, Trigger) and isinstance(d, CellStore):
                # PMT message port -> cellstore sink (reference
                # msg_connect trigger.{track,drop} -> cellstore)
                if sp == dp == "track":
                    prev = s.on_track
                    s.on_track = (lambda c, _d=d, _p=prev:
                                  (_d.track_cell(c),
                                   _p(c) if _p else None))
                elif sp == dp == "drop":
                    prev = s.on_drop
                    s.on_drop = (lambda cid, _d=d, _p=prev:
                                 (_d.drop_cell_id(cid),
                                  _p(cid) if _p else None))
                else:
                    raise ValueError(f"unknown message ports {sp}->{dp}")
            else:
                raise ValueError(
                    f"unsupported connection {src}.{sp} -> {dst}.{dp}")
        self.triggers = {}
        for name, blk in self.blocks.items():
            if isinstance(blk, Trigger):
                self.triggers[name] = blk
        if not self.sinks:
            raise ValueError("flowgraph has no stream path into a trigger")

    def _tick(self, name: str, pos: int, n: int, out: dict, rng):
        """Chunk [pos, pos+n) of stream block `name` (memoized per tick)."""
        if name in out:
            return out[name]
        bid, params = self.stream_specs[name]
        if bid == "blocks_file_source":
            iq = self._files[name]
            repeat = params.get("repeat") in (True, "True", "true")
            if repeat:
                chunk = np.take(iq, np.arange(pos, pos + n), mode="wrap")
            else:
                chunk = iq[pos:pos + n]
                if chunk.size < n:
                    chunk = np.concatenate(
                        [chunk, np.zeros(n - chunk.size, np.complex64)])
        elif bid == "analog_noise_source_x":
            amp = self._num(params.get("amp"), 1.0)
            chunk = (amp * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
                     / np.sqrt(2)).astype(np.complex64)
        elif bid == "blocks_multiply_const_vxx":
            (src,) = self.stream_in[name]
            chunk = self._tick(src, pos, n, out, rng) \
                * np.complex64(self._num(params.get("const"), 1.0))
        elif bid == "blocks_add_xx":
            chunk = np.zeros(n, np.complex64)
            for src in self.stream_in[name]:
                chunk = chunk + self._tick(src, pos, n, out, rng)
        else:  # pragma: no cover — guarded at construction
            raise ValueError(bid)
        out[name] = chunk.astype(np.complex64)
        return out[name]

    def run(self, time_out: float = 2.0, chunk_samples: int = 19200,
            seed: int = 0) -> dict:
        """Drive the stream DAG into the trigger(s) until a trigger with
        exit_on_success fires or stream-time `time_out` elapses.
        Returns {cellstore_name: [cell dicts]}."""
        self._files = {
            name: np.fromfile(params["file"], dtype=np.complex64)
            for name, (bid, params) in self.stream_specs.items()
            if bid == "blocks_file_source"}
        rng = np.random.default_rng(seed)
        total = int(time_out * 1.92e6)
        fed = 0
        t_end = time.time() + 10 * time_out + 30     # wall-clock safety
        trigger_feed = {k[len("__trigger__"):]: v
                        for k, v in self.stream_in.items()
                        if k.startswith("__trigger__")}
        while fed < total and time.time() < t_end:
            out: dict = {}
            for tname, srcs in trigger_feed.items():
                chunk = np.zeros(chunk_samples, np.complex64)
                for src in srcs:
                    chunk = chunk + self._tick(src, fed, chunk_samples,
                                               out, rng)
                self.triggers[tname].process(chunk)
            fed += chunk_samples
            if any(t.done for t in self.triggers.values()):
                break
        for t in self.triggers.values():
            t.flush()
        out2 = {}
        from ..runtime.cellstore import CellStore
        for name, blk in self.blocks.items():
            if isinstance(blk, CellStore):
                out2[name] = [c.to_dict() for c in blk.cells()]
        return out2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="run_flowgraph")
    p.add_argument("flowgraph", help="path to a .grc YAML flowgraph")
    p.add_argument("--time-out", type=float, default=2.0,
                   help="stream seconds to feed before stopping")
    args = p.parse_args(argv)
    runner = FlowgraphRunner(args.flowgraph)
    out = runner.run(time_out=args.time_out)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
