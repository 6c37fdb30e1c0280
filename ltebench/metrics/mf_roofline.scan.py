"""Pass A's share of its roofline, %: the least time for the pass-A work
of the calls in the profiled slice (`roofline.pass_a`, from the calls'
shapes) over the matched-filter kernels' device time there (`mf_stage_kernel`,
`mf_wgmma_kernel`)."""

from ltebench import roofline


def read(rd):
    sl = rd["slice"]
    if not sl or not sl["calls"]:
        return None
    t = sum(v for k, v in sl["by_name"].items() if "::mf_" in k or k.startswith("mf_"))
    if t <= 0:
        return None
    cfg = rd["ctx"]["config"]
    least, _ = roofline.pass_a(int(cfg["channels"]), int(cfg["steps"]),
                               cfg["precision"]["pass_a"] == "bfloat16")
    return 100.0 * least * sl["calls"] / t
