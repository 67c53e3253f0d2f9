"""The whole step's share of the card's f32 peak: the model's FLOPs per
call (convolutions and products by torch.utils.flop_counter on the
reference at the cell's shapes, plus the hand kernels' counted
operations) over the mean host-clock time of a ``step`` call in the
untraced window times 67 TFLOP/s, in %."""

F32_FLOPS_PER_S = 67e12


def read(trace):
    if trace.kind != "stream" or not trace.call_s or not trace.work.get("flops"):
        return None
    return 100.0 * trace.work["flops"] / (trace.call_s * F32_FLOPS_PER_S)
