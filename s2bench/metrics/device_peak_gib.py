"""Peak device memory the process allocated over set-up and the window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30
