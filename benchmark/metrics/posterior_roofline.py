"""posterior_roofline: the least time the traced requests' counted posterior
work could take (``work.served_work``) over the device time of the
posterior kernels (every device operation whose name holds
``fused_posterior``, the reduce too), %."""

from benchmark import work

KERNEL = "fused_posterior"


def read(run):
    if not run.tr:
        return None
    kernel_s = sum(b - a for name, a, b in run.tr["ops"] if KERNEL in name)
    if kernel_s <= 0:
        return None
    rows = [e["rows"] for e in run.log if e.get("traced")]
    return 100.0 * work.served_work(run.config, run.traffic["endpoint"], rows)[1] / kernel_s
