"""serve_mfu: the traced requests' counted posterior FLOPs
(``work.served_work``) over the traced window, as a % of the float32 peak
(67 TFLOP/s; the card's power limit is in the result's device entry)."""

from benchmark import work


def read(run):
    if not run.tr or not run.tr["items"]:
        return None
    rows = [e["rows"] for e in run.log if e.get("traced")]
    flops = work.served_work(run.config, run.traffic["endpoint"], rows)[0]
    return 100.0 * flops / (run.tr["window_s"] * work.FP32_PEAK)
