"""peak_mem_gib.train: torch.cuda.max_memory_allocated() in the train
worker, reset once the state is built, read after the window."""


def read(r):
    b = r.get("memory_peak_bytes")
    return b / 2 ** 30 if b else None
