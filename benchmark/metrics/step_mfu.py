"""The whole step's share of the card's float32 peak: the steps' model
FLOPs (``roofline/w2v_step.py``) over the profiled window's wall time.
TF32 is off, so the float32 rate outside the tensor cores is the peak."""


def read(ctx):
    w = ctx.get("window")
    if w is None or not ctx.get("flops") or not ctx.get("peaks"):
        return None
    return 100.0 * ctx["flops"] / w.window_s / ctx["peaks"]["fp32_flops"]
