"""SECAM's chroma program on the card through its hand-written kernel
(hacktv_tpu_torch/csrc/secam_chroma.cu, which also runs the luma
band-reject), by the program's counters `secam.kernel_windows` and
`secam.windows` (hacktv_tpu_torch/telemetry.py): the kernel's windows
over every SECAM window the process ran (the counters only grow, from
zero at the process's start; a graph's replay adds to both), in %.  None
where the program has either counter missing, or ran no SECAM window."""


def from_counters(counters: dict):
    kernel = counters.get("secam.kernel_windows")
    windows = counters.get("secam.windows")
    if kernel is None or not windows:
        return None
    return 100.0 * kernel / windows


def read(ctx):
    from hacktv_tpu_torch import telemetry
    return from_counters(telemetry.counters())
