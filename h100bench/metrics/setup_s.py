"""Set-up seconds: from the start of the command to the start of the
measured window (imports, the kernel library's load or build, NCCL's
start, plans, the field, warm-up pairs), the largest over the ranks."""


def read(ctx):
    return ctx.setup_s
