"""device_ops_per_attempt: the device kernels and copies of one traced
solve request (``torch.profiler``, device activity only), over its LM
attempts."""


def read(run):
    t = run.traced.get("device")
    if run.mix.kind != "solve" or t is None:
        return None
    return len(t.device_events) / run.traced_records["device"]["nattempts"]
