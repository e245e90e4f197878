"""The train loop's host wait for its next batch, in ms a step, over the
window call (``train_metrics["stall_ms_per_step"]``)."""


def read(ctx):
    train = ctx.get("train")
    return None if not train else float(train["stall_ms_per_step"])
