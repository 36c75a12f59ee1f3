"""device_idle (device_idle.serve, device_idle.train): the share of the
traced window in which no operation ran on the device, %."""


def read(run):
    if not run.tr or run.tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.tr["busy_s"] / run.tr["window_s"])
