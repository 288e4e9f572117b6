"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over set-up and
window, read when the window closes, in GiB."""


def read(run):
    return run.peak_bytes / float(1 << 30) if run.peak_bytes > 0 else None
