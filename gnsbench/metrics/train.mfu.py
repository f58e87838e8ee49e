"""GraphSAGE step, whole: the model FLOPs of the window's steps (counted
from each batch's real block rows by ``gnsbench.flops.sage_step_flops``)
over the window's seconds at the H100's float32 peak outside the tensor
cores (67 TFLOP/s: the program keeps TF32 off)."""
from gnsbench.flops import F32_FLOPS

UNIT = "%"


def read(run):
    if not run.flops or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.flops / (run.window_s * F32_FLOPS)
