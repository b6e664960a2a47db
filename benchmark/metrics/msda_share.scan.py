"""The deformable-attention sampling kernel's (``csrc/ms_deform_attn.cu``)
device time over the card's busy time in the traced scan, in %: how much of
the card's work the new mechanism is. None where the trace holds no launch
of it (a program without the kernel)."""


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s("ms_deform_attn")
    busy_s = sum(run.trace.busy_s(c) for c in run.cards)
    if kernel_s <= 0 or busy_s <= 0:
        return None
    return 100.0 * kernel_s / busy_s
