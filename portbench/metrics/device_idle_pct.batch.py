"""Layer: device (H100). The share of the traced window's wall time (host
clock) in which no operation ran on the device: 1 - the union of the device
intervals of one ``torch.profiler`` trace of the device's activity over the
window's time."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
