"""Peak device memory the program held during the window:
`torch.cuda.max_memory_allocated()` after a reset at the end of set-up, in
GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
