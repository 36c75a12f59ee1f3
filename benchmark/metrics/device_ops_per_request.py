"""device_ops_per_request: device operations (kernels, copies, sets) in the
traced window over the requests in it."""


def read(run):
    if not run.tr or not run.tr["items"] or not run.tr["ops"]:
        return None
    return len(run.tr["ops"]) / run.tr["items"]
