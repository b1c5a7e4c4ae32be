"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), on the fullest card."""

LAYER = "device"
MOVES = "subread_bases_per_s"
UNIT = "GiB"


def read(obs):
    if not obs.peak_bytes:
        return None
    return obs.peak_bytes / 2 ** 30
