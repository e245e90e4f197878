"""The input pipeline's producer time a step over the window call: its
summed time in the batch source (``render_s``: with the native
prefetcher its queue wait and the batch copy) and in the pinned copies
to the card (``transfer_s``), from ``train_metrics["pipeline"]``."""


def read(ctx):
    train = ctx.get("train")
    pipe = (train or {}).get("pipeline") or {}
    if "render_s" not in pipe or not train.get("steps"):
        return None
    return 1e3 * (pipe["render_s"] + pipe["transfer_s"]) / train["steps"]
