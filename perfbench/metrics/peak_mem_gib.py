"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` at its start, in GiB."""


def read(t):
    peak = t.info.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
