"""train_mfu: the least float32 operations of the traced trains
(``work.train_flops``) over the traced window's seconds, as a percentage of
the card's float32 peak (67 TFLOP/s)."""

from benchmark import work


def read(run):
    if not run.tr or not run.tr["items"]:
        return None
    cfg = run.config
    flops = work.train_flops(int(cfg["num_domain"]), int(cfg["num_boundary"]),
                             int(cfg["dim"]) + 1, int(cfg["gn_steps"]))
    return 100.0 * flops * run.tr["items"] / (run.tr["window_s"] * work.FP32_PEAK)
