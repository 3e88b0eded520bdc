"""Set-up: from the process's start to the window's start (host clock):
imports, the weights drawn on the card, the serving mode's packing, kernel
builds where the checkout has none yet, and the warm-up of the cell's own
shapes and decode programs."""


def read(ctx):
    return ctx.setup_s
