"""Kernel B1 (csrc/select.cu, select_kernel): the least time its work
needs (vobench.roofline.b1_work over each call's frames) over its device
time, in %."""

from vobench import roofline
from vobench.metrics._stage import kernel_seconds


def read(ctx):
    seconds, launches = kernel_seconds(ctx, "select_kernel")
    if not launches:
        return None
    port = ctx.cell.config["port"]
    nbytes, instr = roofline.b1_work(ctx.frames_per_call, port["image_height"],
                                     port["image_width"], port["orb"])
    return 100.0 * len(ctx.calls) * roofline.least_seconds(nbytes, instr) / seconds
